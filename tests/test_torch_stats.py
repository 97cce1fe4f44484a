"""ANALYZE in the port (ops/stats.device_sort, statistics.build_column_stats)
against the JAX package's, on the same seeded numpy inputs.

`device_sort` (torch.sort, here on the CPU) must equal the reference's
jit-traced sort over int32, int64, float32 and float64, with NaNs, at
lengths that are not powers of two. `build_column_stats` must give the
reference's histogram (`to_obj()`) and CMSketch table on
ScaledTpch(0.05) lineitem columns (300,060 rows, above the 2^17-row
threshold where the sort goes to the device), on a column with NULLs, on
small columns (numpy's sort) and on a string column. Sorted values and
every statistic are exact: tolerance 0.
"""

import numpy as np
import pytest
import torch

from tidb_tpu import sqltypes as st
from tidb_tpu import statistics as jstats
from tidb_tpu.benchmarks import tpch as jtpch
from tidb_tpu.chunk import Column as JColumn
from tidb_tpu.ops import stats as jops_stats
from tidb_tpu_torch import statistics as pstats
from tidb_tpu_torch.benchmarks import tpch as ptpch
from tidb_tpu_torch.chunk import Column as PColumn
from tidb_tpu_torch.ops import stats as pops_stats

# one intra-op thread: these tests share the CPU with parallel test workers
torch.set_num_threads(1)


def _data(dtype, n, seed):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        x = rng.integers(-1000, 1000, n).astype(dtype)
        x[::97] = info.max             # equal to the padding value
        x[1::89] = info.min
        return x
    x = (rng.normal(size=n) * 100).astype(dtype)
    x[::53] = np.nan
    x[1::71] = -0.0
    x[2::67] = np.inf
    return x


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32,
                                   np.float64])
@pytest.mark.parametrize("n", [1, 1000, (1 << 17) - 1, (1 << 17) + 3])
def test_device_sort_matches_reference(dtype, n):
    x = _data(dtype, n, n)
    got = pops_stats.device_sort(x, "cpu")
    want = np.asarray(jops_stats.device_sort(x))
    assert got.dtype == want.dtype and got.shape == (n,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.sort(x))


def test_device_sort_pads_to_a_bucket():
    x = _data(np.int64, 1500, 1)
    padded = pops_stats.pad_for_sort(x)
    assert padded.size == 2048 and (padded[1500:] == np.iinfo(
        np.int64).max).all()
    assert pops_stats.pad_for_sort(padded) is padded


def _same_stats(p, j):
    assert p.hist.to_obj() == j.hist.to_obj()
    assert p.cms.count == j.cms.count
    np.testing.assert_array_equal(p.cms.table, j.cms.table)


@pytest.fixture(scope="module")
def lineitem():
    d = jtpch.ScaledTpch(0.05, 42)
    pd = ptpch.ScaledTpch(0.05, 42)
    return d, ptpch.table_chunks(pd, ["lineitem"], 1 << 16)["lineitem"]


@pytest.mark.parametrize("name", ["l_orderkey", "l_quantity",
                                  "l_discount", "l_shipdate",
                                  "l_receiptdate"])
def test_build_column_stats_on_lineitem(lineitem, name):
    d, chunks = lineitem
    col = ptpch.table_column(chunks, "lineitem", name)
    assert len(col) == d.counts["lineitem"] >= pstats._DEVICE_SORT_MIN
    ref = JColumn(st.new_int_field(), col.data.copy(), col.valid.copy())
    _same_stats(pstats.build_column_stats(col, device="cpu"),
                jstats.build_column_stats(ref))
    got = ptpch.analyze_columns(None, [name], "cpu", chunks=chunks)[name]
    _same_stats(got, jstats.build_column_stats(ref))


@pytest.mark.parametrize("n", [500, (1 << 17) + 5])
def test_build_column_stats_with_nulls_and_floats(n):
    rng = np.random.default_rng(n)
    valid = rng.random(n) > 0.2
    for data in (rng.integers(0, 5000, n), rng.normal(size=n).round(2)):
        p = PColumn(st.new_int_field(), data, valid)
        j = JColumn(st.new_int_field(), data.copy(), valid.copy())
        ps = pstats.build_column_stats(p, n_buckets=64, device="cpu")
        _same_stats(ps, jstats.build_column_stats(j, n_buckets=64))
        assert ps.hist.null_count == int((~valid).sum())
        # estimation over the copied histogram agrees too
        v = float(np.median(data))
        assert ps.hist.less_row_count(v) == \
            jstats.build_column_stats(j, n_buckets=64).hist.less_row_count(v)


def test_build_column_stats_strings():
    rng = np.random.default_rng(4)
    data = np.array(["x", "yy", "abc", "Q"], dtype=object)[
        rng.integers(0, 4, 800)]
    valid = rng.random(800) > 0.1
    ps = pstats.build_column_stats(
        PColumn(st.new_string_field(), data, valid), device="cpu")
    js = jstats.build_column_stats(
        JColumn(st.new_string_field(), data.copy(), valid.copy()))
    _same_stats(ps, js)
    assert ps.equal_count("yy") == js.equal_count("yy")


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_build_column_stats_narrow_dtypes(dtype):
    # the other two of the four dtypes that sort on the device
    n = (1 << 17) + 5
    rng = np.random.default_rng(8)
    data = rng.integers(0, 3000, n).astype(dtype)
    if dtype == np.float32:
        data /= 8
    valid = np.ones(n, bool)
    ps = pstats.build_column_stats(PColumn(st.new_int_field(), data, valid),
                                   device="cpu")
    _same_stats(ps, jstats.build_column_stats(
        JColumn(st.new_int_field(), data.copy(), valid.copy())))
    assert ps.hist.ndv == np.unique(data).size


def test_histogram_round_trips():
    h = pstats.build_histogram([1, 5, 9, 12], [3, 1, 7, 2], n_buckets=2)
    j = jstats.build_histogram([1, 5, 9, 12], [3, 1, 7, 2], n_buckets=2)
    assert h.to_obj() == j.to_obj()
    assert pstats.Histogram.from_obj(h.to_obj()) == h
    for v in (0, 5, 6, 12, 13):
        assert h.equal_row_count(v) == j.equal_row_count(v)
        assert h.between_row_count(1, v) == j.between_row_count(1, v)
