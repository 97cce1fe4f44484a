"""The port's spill sorter (executor/extsort.py) against the JAX
package's, on the same seeded numpy chunks.

Both sorters take the same chunks (an int key with NULLs, a float, a
string with NULLs) and must yield the same rows in the same order: in
memory, spilled to disk by `run_rows`, and spilled by the quota action
of a statement root; ascending and descending keys, NULLs first
ascending and last descending. The sorter's ledger reads 0 after close.
`order_from_keys` must give the reference's permutation. Values are
compared exactly: tolerance 0.
"""

import numpy as np
import pytest

from tidb_tpu import memtrack as jmemtrack
from tidb_tpu import sqltypes as st
from tidb_tpu.chunk import Chunk
from tidb_tpu.executor import extsort as jextsort
from tidb_tpu.expression import col
from tidb_tpu_torch import convert
from tidb_tpu_torch import memtrack as pmemtrack
from tidb_tpu_torch.executor import extsort as pextsort

from test_torch_hashagg import port_chunk

INT = st.new_int_field()
DBL = st.new_double_field()
STR = st.new_string_field()


def _chunks(seed=6, sizes=(700, 1300, 900, 1100)):
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        k = rng.integers(0, 50, n)
        kv = rng.random(n) > 0.1
        s = np.array(["pear", "apple", "fig", "kiwi", ""], dtype=object)[
            rng.integers(0, 5, n)]
        sv = rng.random(n) > 0.15
        s[~sv] = ""
        out.append(Chunk.from_arrays(
            [INT, DBL, STR], [k, rng.normal(size=n).round(3), s],
            [kv, np.ones(n, dtype=bool), sv]))
    return out


def _rows(chunks):
    """Every row as a tuple of (valid, value) pairs, in order."""
    out = []
    for ch in chunks:
        cols = [[(bool(v), x if v else None) for x, v in zip(c.data, c.valid)]
                for c in ch.columns]
        out.extend(zip(*cols))
    return out


BY = {
    "int asc": [(0, False)],
    "int desc, str asc": [(0, True), (2, False)],
    "str desc, float asc": [(2, True), (1, False)],
}


def _by(spec, to_port):
    fts = [INT, DBL, STR]
    return [((convert.expr_from(col(j, fts[j])) if to_port
              else col(j, fts[j])), desc) for j, desc in spec]


def _sorted_rows(mod, memtrack, by, chunks, run_rows, quota=0):
    """Rows the sorter yields, its spilled runs, and the ledger left."""
    root = memtrack.statement_root(None, quota=quota, label="sort")
    node = root.node(object())
    with memtrack.tracking(root):
        sorter = mod.SpillSorter(by, run_rows=run_rows, block_rows=1000,
                                 tracker=node)
        for ch in chunks:
            sorter.add(ch)
        runs = len(sorter._runs)
        rows = _rows(list(sorter.sorted_chunks()))
        sorter.close()
    return rows, runs, root.total()


@pytest.mark.parametrize("spec", sorted(BY))
@pytest.mark.parametrize("how", ["memory", "run_rows", "quota"])
def test_order_matches_reference(spec, how):
    jchunks = _chunks()
    pchunks = [port_chunk(c) for c in jchunks]
    run_rows = 1500 if how == "run_rows" else 1 << 20
    # the quota sits between one and two chunks' bytes: the action sheds
    # the buffer to disk instead of cancelling
    quota = 2 * pmemtrack.chunk_bytes(pchunks[1]) if how == "quota" else 0
    jrows, jruns, jleft = _sorted_rows(jextsort, jmemtrack,
                                       _by(BY[spec], False), jchunks,
                                       run_rows, quota)
    prows, pruns, pleft = _sorted_rows(pextsort, pmemtrack,
                                       _by(BY[spec], True), pchunks,
                                       run_rows, quota)
    assert prows == jrows
    assert len(prows) == sum(c.num_rows for c in pchunks)
    assert pruns == jruns and (pruns > 0) == (how != "memory")
    assert pleft == jleft == 0


def test_spilled_rows_equal_in_memory_rows():
    pchunks = [port_chunk(c) for c in _chunks(seed=11)]
    by = _by([(0, False), (1, True)], True)
    mem, runs0, _ = _sorted_rows(pextsort, pmemtrack, by, pchunks, 1 << 20)
    spilled, runs, left = _sorted_rows(pextsort, pmemtrack, by, pchunks,
                                       1000)
    assert runs0 == 0 and runs == 2 and spilled == mem and left == 0


def test_sorter_spilled_runs_and_close_releases_buffer():
    root = pmemtrack.statement_root(None, label="sort")
    node = root.node(object())
    with pmemtrack.tracking(root):
        sorter = pextsort.SpillSorter(_by([(0, False)], True),
                                      run_rows=1000, tracker=node)
        for ch in _chunks(seed=2, sizes=(900, 900, 500)):
            sorter.add(port_chunk(ch))
        assert sorter.spilled and sorter.spilled_runs == 1
        assert root.total() > 0          # the keys and the tail
        sorter.close()                   # abandoned before the merge
    assert root.total() == 0
    assert root.run_spill_actions() == 0     # the action is unhooked


def test_order_from_keys_matches_reference():
    rng = np.random.default_rng(1)
    n = 5000
    keys = [(rng.integers(0, 30, n), rng.random(n) > 0.2, True),
            (rng.normal(size=n).round(1), rng.random(n) > 0.1, False),
            (np.array(["b", "a", "c"], dtype=object)[rng.integers(0, 3, n)],
             np.ones(n, dtype=bool), True)]
    np.testing.assert_array_equal(pextsort.order_from_keys(keys, n),
                                  jextsort.order_from_keys(keys, n))
