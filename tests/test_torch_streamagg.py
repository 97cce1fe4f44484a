"""Stream aggregation in the port (ops/streamagg.SegmentAggKernel and the
executor/agg.StreamAgg operator) against the JAX package's.

SegmentAggKernel: the same sorted chunks go through the reference's
kernel and the port's (on the CPU, where the count and sum lanes take
ops/segsum's plain version) and must give the same GroupResults: NULL
keys, string-code keys, two keys, groups that span chunks (merged by
HashAggregator), an all-padding (0-row) chunk, and COUNT, SUM, AVG, MIN,
MAX and FIRST_ROW. StreamAgg: in the shapes of
tests/test_exec_family.py::TestStreamAgg, the reference's StreamAggExec
over a session's table and the port's StreamAgg over the same chunks
must give the same rows, on the sorter leg (sorted_input=False) and on
the streaming leg (sorted_input=True, a key ordered like the primary
key), at superchunks of 1,024 rows so that groups span them. Int64 lanes
exact; float sums within 1e-12 relative (summation order may differ).
"""

import numpy as np
import pytest
import torch

from tidb_tpu import config as jconfig
from tidb_tpu import sqltypes as st
from tidb_tpu.chunk import Chunk
from tidb_tpu.executor import ExecContext as JExecContext
from tidb_tpu.executor import build_executor
from tidb_tpu.expression import AggDesc, AggFunc, ColumnRef, col
from tidb_tpu.ops import hashagg as jh
from tidb_tpu.ops import streamagg as jstream
from tidb_tpu.plan import physical as ph
from tidb_tpu.plan.resolver import PlanSchema, SchemaCol
from tidb_tpu.session import Session
from tidb_tpu.store.storage import new_mock_storage
from tidb_tpu_torch import config as pconfig
from tidb_tpu_torch import convert, memtrack
from tidb_tpu_torch.executor import ExecContext, ExecStats
from tidb_tpu_torch.executor.agg import StreamAgg
from tidb_tpu_torch.executor.scan import TableScan
from tidb_tpu_torch.ops import hashagg as pha
from tidb_tpu_torch.ops import streamagg as pstream

from test_torch_hashagg import (_val_eq, assert_group_results_equal,
                                assert_results_equal, port_chunk)

# one intra-op thread: these tests share the CPU with parallel test workers
torch.set_num_threads(1)

INT = st.new_int_field()
DBL = st.new_double_field()
STR = st.new_string_field()


def _sorted_chunks(seed=3, n=6000, sizes=(1500, 2500, 2000)):
    """(k int with NULLs, s string, v double with NULLs, w int) sorted by
    (k, s), cut into chunks: groups span the cuts."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 300, n)
    kv = rng.random(n) > 0.05
    s = np.array(["aa", "bb", "cc"], dtype=object)[rng.integers(0, 3, n)]
    v = rng.normal(size=n).round(4) * 10
    vv = rng.random(n) > 0.1
    w = rng.integers(-1000, 1000, n)
    k = np.where(kv, k, 0)
    order = np.lexsort((s, k, kv))     # NULL keys first, then by (k, s)
    cols = [k[order], s[order], v[order], w[order]]
    valid = [kv[order], np.ones(n, bool), vv[order], np.ones(n, bool)]
    out, start = [], 0
    for size in sizes:
        out.append(Chunk.from_arrays(
            [INT, STR, DBL, INT], [c[start:start + size] for c in cols],
            [m[start:start + size] for m in valid]))
        start += size
    return out


AGGS = [AggDesc(AggFunc.COUNT, None), AggDesc(AggFunc.SUM, col(2, DBL)),
        AggDesc(AggFunc.AVG, col(2, DBL)), AggDesc(AggFunc.MIN, col(3, INT)),
        AggDesc(AggFunc.MAX, col(2, DBL)), AggDesc(AggFunc.SUM, col(3, INT)),
        AggDesc(AggFunc.FIRST_ROW, col(1, STR)),
        AggDesc(AggFunc.COUNT, col(2, DBL))]


@pytest.mark.parametrize("keys", [[0], [1], [0, 1]],
                         ids=["int-with-nulls", "string-codes", "two-keys"])
def test_segment_kernel_matches_reference(keys):
    fts = [INT, STR]
    groups = [col(j, fts[j]) for j in keys]
    chunks = _sorted_chunks()
    if keys == [1]:
        # a string key alone: sort each chunk's rows by it
        chunks = [c.take(np.argsort(c.columns[1].data, kind="stable"))
                  for c in chunks]
    jk = jstream.SegmentAggKernel(groups, AGGS)
    pk = pstream.SegmentAggKernel([convert.expr_from(g) for g in groups],
                                  [convert.agg_from(a) for a in AGGS],
                                  device="cpu")
    jagg = jh.HashAggregator(AGGS, groups)
    pagg = pha.HashAggregator(pk.aggs, pk.group_exprs)
    for ch in chunks:
        jg, pg = jk(ch), pk(port_chunk(ch))
        assert_group_results_equal(pg, jg)
        assert len(pg.keys) == len(set(pg.keys))
        jagg.update(jg)
        pagg.update(pg)
    assert_results_equal(pagg.results(), jagg.results())


def test_all_padding_chunk():
    empty = _sorted_chunks()[0].take(np.empty(0, dtype=np.int64))
    groups = [col(0, INT)]
    jg = jstream.SegmentAggKernel(groups, AGGS)(empty)
    pk = pstream.SegmentAggKernel([convert.expr_from(g) for g in groups],
                                  [convert.agg_from(a) for a in AGGS],
                                  device="cpu")
    pg = pk(port_chunk(empty))
    assert pg.keys == jg.keys == []
    assert len(pg.counts) == len(jg.counts) == 0


def test_segment_kernel_cache_and_nbytes():
    groups = [convert.expr_from(col(0, INT))]
    aggs = [convert.agg_from(a) for a in AGGS[:2]]
    a = pstream.segment_kernel_for(groups, aggs, device="cpu")
    assert pstream.segment_kernel_for(groups, aggs, device="cpu") is a
    ch = _sorted_chunks()[0]
    jk = jstream.SegmentAggKernel([col(0, INT)], AGGS[:2])
    assert a.dispatch_nbytes(port_chunk(ch)) == jk.dispatch_nbytes(ch)
    assert a.scratch_nbytes(port_chunk(ch)) == jk.scratch_nbytes(ch)


# -- the operator against StreamAggExec ----------------------------------


@pytest.fixture(scope="module")
def sess():
    s = Session(new_mock_storage())
    s.execute("CREATE DATABASE d")
    s.execute("USE d")
    s.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, g BIGINT, v DOUBLE, "
              "s VARCHAR(16), b BIGINT)")
    rng = np.random.default_rng(5)
    g = rng.integers(0, 40, 5000)
    v = rng.uniform(-10, 10, 5000).round(3)
    names = np.array(["aa", "bb", "cc", "dd"])[rng.integers(0, 4, 5000)]
    rows = []
    for i in range(5000):
        gv = "NULL" if i % 97 == 0 else str(g[i])
        rows.append(f"({i}, {gv}, {v[i]}, '{names[i]}', {i // 7})")
    s.execute("INSERT INTO t VALUES " + ",".join(rows))
    return s


def _reader(sess):
    node = sess.plan("SELECT id, g, v, s, b FROM t")
    while not isinstance(node, ph.PhysTableReader):
        node = node.children[0]
    return node


OVERLAY = {"tidb_tpu_superchunk_rows": 1024, "tidb_tpu_device_min_rows": 1}


def _reference_rows(sess, reader, group_cols, aggs, sorted_input,
                    overlay=None):
    groups = [ColumnRef(i, reader.schema.cols[i].ft) for i in group_cols]
    schema = PlanSchema([reader.schema.cols[i] for i in group_cols] + [
        SchemaCol(f"_a{j}", "", a.result_ft) for j, a in enumerate(aggs)])
    plan = ph.PhysStreamAgg(schema=schema, children=[reader],
                            group_exprs=groups, aggs=aggs,
                            sorted_input=sorted_input)
    ctx = JExecContext(sess.storage, sess._read_ts(), None)
    with jconfig.session_overlay(dict(OVERLAY, **(overlay or {}))):
        out = []
        for ch in build_executor(plan).chunks(ctx):
            out.extend(ch.to_pylist())
        chunks = list(build_executor(reader).chunks(
            JExecContext(sess.storage, sess._read_ts(), None)))
    return out, groups, chunks


def _port_rows(reader, chunks, groups, aggs, sorted_input, overlay=None):
    cols = [(c.name, convert.field_type(c.ft.tp, c.ft.flen, c.ft.frac,
                                        c.ft.collation))
            for c in reader.schema.cols]
    op = StreamAgg(TableScan("t", cols), [convert.expr_from(g)
                                          for g in groups],
                   [convert.agg_from(a) for a in aggs],
                   sorted_input=sorted_input)
    # the scan yields 1,000-row chunks, so the sorter spills runs
    pieces = [port_chunk(c).slice(i, i + 1000) for c in chunks
              for i in range(0, c.num_rows, 1000)]
    ctx = ExecContext(torch.device("cpu"), {"t": pieces}, ExecStats())
    root = memtrack.statement_root(None)
    with pconfig.session_overlay(dict(
            OVERLAY, tidb_tpu_sort_spill_rows=1500, **(overlay or {}))), \
            memtrack.tracking(root):
        (chunk,) = op.chunks(ctx)
    return chunk.to_pylist(), ctx.stats, root


def _rows_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert _val_eq(x, y), (a, b)


@pytest.mark.parametrize("case", ["sum-count-min-avg", "string-keys",
                                  "max-first-row"])
def test_sorter_leg_matches_stream_agg_exec(sess, case):
    reader = _reader(sess)
    vref = ColumnRef(2, reader.schema.cols[2].ft)
    sref = ColumnRef(3, reader.schema.cols[3].ft)
    group_cols, aggs = {
        "sum-count-min-avg": ([1], [AggDesc(AggFunc.SUM, vref),
                                    AggDesc(AggFunc.COUNT, None),
                                    AggDesc(AggFunc.MIN, vref),
                                    AggDesc(AggFunc.AVG, vref)]),
        "string-keys": ([3, 1], [AggDesc(AggFunc.COUNT, None),
                                 AggDesc(AggFunc.MAX, vref)]),
        "max-first-row": ([1], [AggDesc(AggFunc.MAX, vref),
                                AggDesc(AggFunc.FIRST_ROW, sref)]),
    }[case]
    want, groups, chunks = _reference_rows(sess, reader, group_cols, aggs,
                                           False)
    got, stats, root = _port_rows(reader, chunks, groups, aggs, False)
    # FIRST_ROW of a group is the first of its rows in the order the sort
    # leaves among equal keys, which both sorters keep stable
    _rows_equal(got, want)
    assert len(got) == {"sum-count-min-avg": 41, "string-keys": 4 * 41,
                        "max-first-row": 41}[case]
    # 1,000-row chunks into runs of 1,500: two runs and a tail of 1,000
    assert stats.sort_spilled_runs == 2
    assert stats.device_batches == 5 and not stats.fallbacks
    assert root.total() == 0 and root.total_peak > 0


@pytest.mark.parametrize("superchunk", [1024, 0])
def test_sorted_input_leg_matches_stream_agg_exec(sess, superchunk):
    """superchunk 0: no dispatch-ahead pipeline, each part runs through
    the kernel synchronously (the reference's per-batch feed)."""
    reader = _reader(sess)
    vref = ColumnRef(2, reader.schema.cols[2].ft)
    aggs = [AggDesc(AggFunc.SUM, vref), AggDesc(AggFunc.COUNT, None),
            AggDesc(AggFunc.MIN, ColumnRef(1, reader.schema.cols[1].ft))]
    overlay = {"tidb_tpu_superchunk_rows": superchunk}
    want, groups, chunks = _reference_rows(sess, reader, [4], aggs, True,
                                           overlay)
    got, stats, root = _port_rows(reader, chunks, groups, aggs, True,
                                  overlay)
    _rows_equal(got, want)
    assert len(got) == -(-5000 // 7)
    # 1,000-row scan chunks: five 1,024-row superchunks, or one part of
    # StreamAgg._SLICE rows
    assert stats.sort_spilled_runs == 0
    assert stats.device_batches == (5 if superchunk else 1)
    assert root.total() == 0
