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


# The launch plan (ops/segsum.launch_plan) is pure Python: the kernel's
# shapes, windows and shared-memory budget are held here on the CPU.

Q1_SHAPE = dict(elem=8, num_segments=4096, k=12, mask_mode=2)


def test_plan_q1_shape_is_windowed_with_several_blocks_per_sm():
    plan = segsum.launch_plan(limits=segsum.H100, **Q1_SHAPE)
    assert plan.variant == "window"
    assert 13 <= plan.window < 4096     # Q1's codes 0..11 and slot C-1
    assert plan.blocks_per_sm >= 2
    assert plan.threads % 32 == 0 and plan.tile % plan.threads == 0
    assert plan.grid(1 << 18) == min(132 * plan.blocks_per_sm,
                                     (1 << 18) // plan.tile)


def test_plan_small_table_is_whole():
    plan = segsum.launch_plan(8, 6, 12, 2, segsum.H100)
    assert plan.variant == "table" and plan.window == 6
    assert plan.blocks_per_sm >= 2
    plan = segsum.launch_plan(4, 1, 5, 1, segsum.H100)
    assert plan.variant == "table" and plan.window == 1


@pytest.mark.parametrize("elem", [4, 8])
@pytest.mark.parametrize("mask_mode", [0, 1, 2])
@pytest.mark.parametrize("k", [1, 3, 5, 12, 13, 64, 200])
@pytest.mark.parametrize("c", [1, 6, 4096, 1 << 20])
def test_plan_fits_shared_memory(elem, mask_mode, k, c):
    """Shared bytes never exceed the H100's opt-in 232,448 per block, and
    what the plan asks for covers the staged tile and every warp's
    table."""
    plan = segsum.launch_plan(elem, c, k, mask_mode, segsum.H100)
    assert plan.smem <= 232448
    assert (plan.smem + 1024) * plan.blocks_per_sm <= 233472
    need = (segsum.stage_bytes(elem, k, mask_mode, plan.tile)
            + plan.threads // 32 * plan.window * k * elem)
    assert need <= plan.smem
    assert 1 <= plan.window <= c
    assert 32 <= plan.tile <= segsum.MAX_TILE and plan.tile % 32 == 0
    assert plan.tile % plan.threads == 0 and plan.threads <= 256


def test_plan_rejects_lanes_wider_than_shared_memory():
    with pytest.raises(ValueError):
        segsum.launch_plan(8, 4096, 2000, 2, segsum.H100)


def test_plan_never_oversubscribes_registers():
    """__launch_bounds__(256, 4) caps registers at 64 a thread: a plan
    never asks an SM for more than 32 warps."""
    for c in (1, 6, 64):
        for k in (1, 3, 12):
            plan = segsum.launch_plan(4, c, k, 0, segsum.H100)
            warps = plan.blocks_per_sm * plan.threads // 32
            assert warps * 32 * segsum.REGS_PER_THREAD <= 65536


def test_plan_is_cached_and_queries_the_card_once(monkeypatch):
    queries = []

    def query(index):
        queries.append(index)
        return segsum.H100
    monkeypatch.setattr(segsum, "_query_device_limits", query)
    monkeypatch.setattr(segsum, "_limits", {})
    monkeypatch.setattr(segsum, "_plans", {})
    dev = torch.device("cuda", 0)
    first = segsum.plan_for(torch.int64, 4096, 12, 2, dev)
    assert segsum.plan_for(torch.int64, 4096, 12, 2, dev) is first
    assert first == segsum.launch_plan(limits=segsum.H100, **Q1_SHAPE)
    segsum.plan_for(torch.float32, 6, 1, 0, dev)
    assert queries == [0]


def test_plan_for_resolves_the_current_device(monkeypatch):
    """A device without an index is the current device: its limits are
    read, and its plans cached, under that device's index."""
    queries = []

    def query(index):
        queries.append(index)
        return segsum.H100
    monkeypatch.setattr(segsum, "_query_device_limits", query)
    monkeypatch.setattr(segsum, "_limits", {})
    monkeypatch.setattr(segsum, "_plans", {})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    plan = segsum.plan_for(torch.int64, 4096, 12, 2, torch.device("cuda"))
    assert segsum.plan_for(torch.int64, 4096, 12, 2,
                           torch.device("cuda", 1)) is plan
    assert queries == [1]
    segsum.plan_for(torch.int64, 4096, 12, 2, torch.device("cuda", 0))
    assert queries == [1, 0]


def test_plan_window_holds_q1_slots():
    """Q1's own segment_sum call (captured from the port's Q1 kernel on
    generated lineitem) lands every id inside the default plan's window:
    codes below W - 1 and the dead slot C - 1."""
    from tidb_tpu_torch.benchmarks import segsum_bench
    (v, ids, m, c), = segsum_bench.q1_inputs(torch.device("cpu"), count=1)
    assert v.shape == (1 << 18, 12) and v.dtype == torch.int64
    assert m.shape == v.shape and c == 4096
    plan = segsum.launch_plan(8, c, 12, 2, segsum.H100)
    slots = set(torch.unique(ids).tolist())
    assert c - 1 in slots and len(slots) == 7
    assert all(s < plan.window - 1 or s == c - 1 for s in slots)


def test_ptxas_report_parses_each_variant():
    log = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113"
           "segsum_kernelIxLi2EEEvPKT_PKiPKhPS1_xiiii' for 'sm_90a'\n"
           "ptxas info    : Function properties for _ZN12_GLOBAL__N_113"
           "segsum_kernelIxLi2EEEvPKT_PKiPKhPS1_xiiii\n"
           "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill "
           "loads\n"
           "ptxas info    : Used 40 registers, used 1 barriers, 400 bytes "
           "cmem[0]\n")
    assert segsum.ptxas_report(log) == [
        {"dtype": "int64", "mask": 2, "spill_stores": 8, "spill_loads": 4,
         "registers": 40}]


class _FakeEvent:
    def __init__(self, enable_timing=False):
        self.stamp = None

    def record(self):
        self.stamp = len(_FakeEvent.clock)
        _FakeEvent.clock.append(self)

    def elapsed_time(self, end):
        return 0.25 * (end.stamp - self.stamp)


class _FakeAverage:
    def __init__(self, key, device_us, count):
        self.key, self.count = key, count
        self.device_type = "DeviceType.CUDA" if device_us else "DeviceType.CPU"
        self.self_device_time_total = device_us


@pytest.mark.parametrize("device_us", [0.0, 800.0])
def test_device_ms_falls_back_to_cuda_events(monkeypatch, device_us):
    """device_ms reads the profiler's device records; where a window holds
    none (CUPTI delivered no kernel record), it profiles twice more and
    then times each call between two CUDA events instead of failing."""
    import contextlib
    import torch.profiler
    from tidb_tpu_torch.benchmarks import segsum_bench
    windows = []

    @contextlib.contextmanager
    def profile(activities):
        prof = type("Prof", (), {})()
        prof.key_averages = lambda: [
            _FakeAverage("aten::index_add_", 0.0, 40),
            _FakeAverage("indexFuncLargeIndex", device_us, 40)]
        windows.append(prof)
        yield prof
    _FakeEvent.clock = []
    monkeypatch.setattr(torch.profiler, "profile", profile)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    calls = []
    ms = segsum_bench.device_ms(lambda x: calls.append(x), [(1,), (2,)],
                                iters=40, warmup=4)
    if device_us:
        assert ms == pytest.approx(0.02) and len(windows) == 1
        assert len(calls) == 4 + 40
    else:
        # each call sits between its own pair of events: 0.25 ms apart
        assert ms == pytest.approx(0.25) and len(windows) == 3
        assert len(calls) == 4 + 3 * 40 + 40
