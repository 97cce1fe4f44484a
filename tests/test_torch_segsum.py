"""The port's segment-sum (tidb_tpu_torch/ops/segsum.py) against the JAX
package's Pallas kernel (run in interpret mode, as tests/test_pallas_agg.py
runs it) and against jax.ops.segment_sum.

On the CPU the port's dispatcher runs its plain torch version; the CUDA
kernel itself is held against that plain version on the card by
chip_smoke.py. Tolerances: float32 rtol 1e-5 / atol 1e-4 (the Pallas
kernel sums a one-hot matmul, the port index_add_, in another order);
float64 rtol 1e-12; int64 exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tidb_tpu.ops import pallas_agg as pa
from tidb_tpu_torch.ops import segsum

# one intra-op thread: these tests share the CPU with parallel test workers
torch.set_num_threads(1)

if not pa._HAS_PALLAS:
    pytest.skip("pallas unavailable in this jax build",
                allow_module_level=True)


def port(values, ids, c, valid=None):
    out = segsum.segment_sum(
        torch.from_numpy(values), torch.from_numpy(ids.astype(np.int32)), c,
        valid=None if valid is None else torch.from_numpy(valid))
    return out.numpy()


def pallas(values, ids, c, valid=None):
    return np.asarray(pa.segment_sum_pallas(
        jnp.asarray(values), jnp.asarray(ids.astype(np.int32)), c,
        interpret=True,
        valid=None if valid is None else jnp.asarray(valid)))


@pytest.mark.parametrize("n,k,c", [(8, 1, 4), (512, 3, 16),
                                   (1000, 2, 128), (4096, 4, 512),
                                   (777, 1, 33)])
def test_matches_pallas(n, k, c):
    rng = np.random.default_rng(42)
    vals = rng.normal(size=(n, k)).astype(np.float32)
    ids = rng.integers(0, c, n)
    np.testing.assert_allclose(port(vals, ids, c), pallas(vals, ids, c),
                               rtol=1e-5, atol=1e-4)


def test_empty_segments_are_zero():
    vals = np.ones((64, 2), dtype=np.float32)
    ids = np.zeros(64, dtype=np.int32)
    got = port(vals, ids, 8)
    np.testing.assert_array_equal(got, pallas(vals, ids, 8))
    assert got[0, 0] == 64.0 and np.all(got[1:] == 0.0)


def test_padding_rows_never_leak():
    vals = np.full((5, 1), 7.0, dtype=np.float32)
    ids = np.array([0, 1, 0, 1, 2], dtype=np.int32)
    got = port(vals, ids, 3)
    np.testing.assert_array_equal(got, pallas(vals, ids, 3))
    np.testing.assert_allclose(got[:, 0], [14.0, 14.0, 7.0])


def test_dispatcher_int64_exact():
    """int64 lanes near 2^60: exact, as jax.ops.segment_sum (any float
    path would round them)."""
    rng = np.random.default_rng(3)
    n, k, c = 3000, 12, 6
    vals = rng.integers(-(1 << 60), 1 << 60, size=(n, k), dtype=np.int64)
    ids = rng.integers(0, c, n).astype(np.int32)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(vals),
                                          jnp.asarray(ids), num_segments=c))
    np.testing.assert_array_equal(port(vals, ids, c), want)


@pytest.mark.parametrize("n,k,c", [(8, 1, 4), (512, 3, 16),
                                   (1000, 2, 128), (777, 1, 33)])
def test_masked_matches_pallas(n, k, c):
    rng = np.random.default_rng(7)
    vals = rng.normal(size=(n, k)).astype(np.float32)
    ids = rng.integers(0, c, n)
    valid = rng.random(n) < 0.6
    np.testing.assert_allclose(port(vals, ids, c, valid),
                               pallas(vals, ids, c, valid),
                               rtol=1e-5, atol=1e-4)


def test_masked_per_lane_mask():
    rng = np.random.default_rng(11)
    n, k, c = 600, 3, 32
    vals = rng.normal(size=(n, k)).astype(np.float32)
    ids = rng.integers(0, c, n)
    valid = rng.random((n, k)) < 0.5
    np.testing.assert_allclose(port(vals, ids, c, valid),
                               pallas(vals, ids, c, valid),
                               rtol=1e-5, atol=1e-4)


def test_masked_kills_nan_under_dead_mask():
    vals = np.array([[1.0], [np.nan], [2.0]], dtype=np.float32)
    ids = np.array([0, 0, 0], dtype=np.int32)
    valid = np.array([True, False, True])
    got = port(vals, ids, 2, valid)
    assert got[0, 0] == 3.0 == pallas(vals, ids, 2, valid)[0, 0]


def test_dispatcher_masked_int64():
    vals = np.array([[10], [20], [30]], dtype=np.int64)
    ids = np.array([0, 0, 1], dtype=np.int32)
    valid = np.array([True, False, True])
    want = np.asarray(pa.segment_sum(jnp.asarray(vals), jnp.asarray(ids), 2,
                                     valid=jnp.asarray(valid)))
    got = port(vals, ids, 2, valid)
    assert got.tolist() == want.tolist() == [[10], [30]]


@pytest.mark.parametrize("dtype", [np.float64, np.int64])
@pytest.mark.parametrize("mask", ["none", "row", "lane"])
def test_wide_dtypes_match_jax(dtype, mask):
    """float64 and int64 lanes, masked per row / per lane / not at all,
    vs the JAX dispatcher's where + segment_sum."""
    rng = np.random.default_rng(5)
    n, k, c = 2000, 5, 40
    if dtype == np.int64:
        vals = rng.integers(-(1 << 58), 1 << 58, size=(n, k))
    else:
        vals = rng.normal(size=(n, k)) * 1e6
    ids = rng.integers(0, c, n).astype(np.int32)
    valid = {"none": None, "row": rng.random(n) < 0.7,
             "lane": rng.random((n, k)) < 0.7}[mask]
    want = np.asarray(pa.segment_sum(
        jnp.asarray(vals), jnp.asarray(ids), c,
        valid=None if valid is None else jnp.asarray(valid)))
    got = port(vals, ids, c, valid)
    if dtype == np.int64:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12)


def test_out_of_range_ids_dropped_like_jax():
    """jax.ops.segment_sum drops ids outside [0, C); torch's index_add_
    would raise, so the plain version masks them."""
    vals = np.arange(1, 7, dtype=np.int64)
    ids = np.array([0, 3, -1, 1, 7, 1], dtype=np.int32)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(vals),
                                          jnp.asarray(ids), num_segments=3))
    got = port(vals, ids, 3)
    assert got.shape == (3,)           # 1-D in -> 1-D out
    assert got.tolist() == want.tolist() == [1, 10, 0]


def test_import_builds_nothing_and_counts_no_cpu_launch():
    before = segsum.launches
    port(np.ones((16, 2), np.float32), np.zeros(16, np.int32), 2)
    assert segsum.launches == before
    assert segsum._lib is None


def test_unsupported_device_raises():
    v = torch.ones(4, 1, device="meta")
    with pytest.raises(ValueError):
        segsum.segment_sum(v, torch.zeros(4, dtype=torch.int32,
                                          device="meta"), 2)


def test_build_command_targets_hopper():
    """The kernel builds as route (b): nvcc into a plain-C shared library
    for sm_90a, from the source in the repository."""
    flags = " ".join(segsum.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-shared" in flags and "-fPIC" in flags
    assert segsum.SOURCE.exists()
    assert segsum.BUILD_DIR.name == "_build"
