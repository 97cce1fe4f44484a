"""The port's kernel profiling plane (tidb_tpu_torch/profiler.py) against
the JAX package's (tidb_tpu/profiler.py): the same calls on both
registries give the same rows (construction vs reuse, the first
dispatch's attribution, escalations and fallback reasons, bounded
fingerprints, the true-LRU bound), the same memtrack billing and shed
drain, and the same roofline arithmetic. The port's peak is the card's
datasheet figure looked up by its full name (the H100 SXM part's 3,350
GB/s), never by a substring; elsewhere a measured memcpy rate. End to
end, Q1 from the port's store records its coprocessor dispatches on one
`hashagg` row, with bytes, and on the reader's runtime stats."""

import pytest
import torch

from tidb_tpu import config as jconfig
from tidb_tpu import profiler as jprofiler
from tidb_tpu_torch import config as pconfig
from tidb_tpu_torch import memtrack as pmemtrack
from tidb_tpu_torch import profiler as pprofiler

# one intra-op thread: these tests share the CPU with parallel test workers
torch.set_num_threads(1)

PKGS = {"jax": (jprofiler, jconfig), "port": (pprofiler, pconfig)}
# row fields that depend on the wall clock or the process's plane (its
# configuration count included: other tests reconfigure the JAX mesh)
_VOLATILE = ("last_used", "mesh", "generation", "achieved_gbps",
             "roofline_fraction")


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    profiler, config = PKGS[request.param]
    profiler.reset_for_tests()
    yield profiler, config
    profiler.reset_for_tests()


def _rows(profiler):
    rows = [{k: v for k, v in r.items() if k not in _VOLATILE}
            for r in profiler.snapshot()]
    for r in rows:
        if r["fingerprint"] == "fp-s":      # timed by dispatch_section
            r["busy_ns"] = r["busy_ns"] > 0
    return sorted(rows, key=lambda r: (r["family"], r["fingerprint"]))


def _scenario(profiler):
    """The reference test suite's registry cases, one after another."""
    a = profiler.profile("hashagg", "fp-1")
    assert profiler.profile("hashagg", "fp-1") is a
    assert profiler.profile("hashagg", "fp-2") is not a
    assert profiler.profile("streamagg", "fp-1") is not a
    prof = profiler.profile("hashagg", "fp-c")
    profiler.note_construct(prof, reuse=False)
    profiler.note_dispatch(prof, 5_000, nbytes=1024)   # the first one
    profiler.note_dispatch(prof, 1_000, nbytes=1024)
    profiler.note_construct(prof, reuse=True)
    pre = profiler.profile("hashagg", "fp-r")          # predates the row
    profiler.note_construct(pre, reuse=True)
    profiler.note_dispatch(pre, 1_000, nbytes=512)
    frag = profiler.profile("fragment", "fp-e")
    profiler.note_escalation(frag)
    for reason in ("capacity", "capacity", "unsupported"):
        profiler.note_kernel_fallback(frag, reason)
    profiler.note_bytes(frag, nbytes=10, out_nbytes=2, encoded=3,
                        decoded=4)
    profiler.note_busy(frag, 77)
    long = profiler.profile("hashagg", "x" * 500)
    assert len(long.fingerprint) == 16
    sec = profiler.profile("hashagg", "fp-s")
    with pytest.raises(ValueError):
        with profiler.dispatch_section(sec, nbytes=512):
            raise ValueError("dispatch blew up")       # success-only
    with profiler.dispatch_section(sec, nbytes=512) as s:
        s.out_nbytes = 64
    return _rows(profiler)


def test_same_calls_same_rows():
    got = {}
    for name, (profiler, _cfg) in PKGS.items():
        profiler.reset_for_tests()
        try:
            got[name] = _scenario(profiler)
        finally:
            profiler.reset_for_tests()
    assert got["port"] == got["jax"]
    rows = {(r["family"], r["fingerprint"]): r for r in got["port"]}
    c = rows[("hashagg", "fp-c")]
    assert (c["compiles"], c["reuses"], c["dispatches"]) == (1, 1, 2)
    assert (c["compile_ns"], c["busy_ns"], c["bytes_in"]) == \
        (5_000, 6_000, 2048)
    assert c["compile_cache"] == "cached"
    assert rows[("hashagg", "fp-r")]["compile_cache"] == "reuse"
    assert rows[("fragment", "fp-e")]["fallback_reasons"] == \
        {"capacity": 2, "unsupported": 1}
    assert rows[("hashagg", "fp-s")]["dispatches"] == 1


def test_lru_bound_and_eviction(pkg):
    profiler, config = pkg
    old = config.get_var("tidb_tpu_kernel_profile_cap")
    config.set_var("tidb_tpu_kernel_profile_cap", 16)
    try:
        before = profiler.registry().stats()["evictions"]
        for i in range(24):
            profiler.profile("hashagg", f"fp-{i}")
        reg = profiler.registry()
        assert len(reg) == 16
        st = reg.stats()
        assert st["evictions"] - before == 8 and st["cap"] == 16
        fps = {p["fingerprint"] for p in profiler.snapshot()}
        assert fps == {f"fp-{i}" for i in range(8, 24)}
    finally:
        config.set_var("tidb_tpu_kernel_profile_cap", old)


def test_disabled_profiling_returns_none(pkg):
    profiler, config = pkg
    old = config.get_var("tidb_tpu_kernel_profile")
    config.set_var("tidb_tpu_kernel_profile", 0)
    try:
        assert profiler.profile("hashagg", "fp") is None
        profiler.note_construct(None, reuse=True)
        profiler.note_dispatch(None, 100)
        profiler.note_busy(None, 100)
        profiler.note_bytes(None, nbytes=10)
        profiler.note_escalation(None)
        profiler.note_kernel_fallback(None, "x")
        with profiler.dispatch_section(None, nbytes=1):
            pass
        assert not profiler.stats()["enabled"]
    finally:
        config.set_var("tidb_tpu_kernel_profile", old)


def test_entries_billed_eviction_and_clear_release(pkg):
    profiler, config = pkg
    node = profiler.registry()._billing_node()
    base = node.host
    entry = profiler._ENTRY_BYTES
    for i in range(10):
        profiler.profile("hashagg", f"bill-{i}")
    assert node.host == base + 10 * entry
    profiler.registry().clear()
    assert node.host == base
    old = config.get_var("tidb_tpu_kernel_profile_cap")
    config.set_var("tidb_tpu_kernel_profile_cap", 16)
    try:
        for i in range(40):
            profiler.profile("hashagg", f"ev-{i}")
        assert node.host == base + 16 * entry
    finally:
        config.set_var("tidb_tpu_kernel_profile_cap", old)


def test_shed_chain_drains_the_port_registry():
    """The SERVER root's shed chain (the admission and /shed path of the
    reference) drops the profile history and its billed bytes."""
    pprofiler.reset_for_tests()
    for i in range(8):
        pprofiler.profile("fragment", f"shed-{i}")
    assert len(pprofiler.registry()) == 8
    pmemtrack.SERVER.run_spill_actions(0, recurse=True)
    assert len(pprofiler.registry()) == 0
    assert pprofiler.registry()._billing_node().host == 0


def test_profile_of_reregisters_after_a_clear(pkg):
    profiler, _cfg = pkg

    class Kernel:
        pass
    k = Kernel()
    k._profile = profiler.profile("hashagg", "orphan")
    profiler.registry().clear()
    prof = profiler.profile_of(k)
    assert prof is not None and prof is k._profile
    assert len(profiler.registry()) == 1


def test_roofline_math_equals_the_references(pkg):
    profiler, _cfg = pkg
    peak, src = profiler.platform_peak_gbps()
    assert peak > 0 and (peak, src) == profiler.platform_peak_gbps()
    assert src.startswith(("datasheet(", "measured-memcpy("))
    nbytes = int(peak * 1e9)
    assert profiler.achieved_gbps(nbytes, int(1e9)) == pytest.approx(peak)
    assert profiler.roofline_fraction(nbytes, int(1e9)) == \
        pytest.approx(1.0)
    assert profiler.achieved_gbps(0, 100) is None
    assert profiler.roofline_fraction(100, 0) is None


@pytest.mark.parametrize("name, want", [
    ("NVIDIA H100 80GB HBM3", (3350.0, "datasheet(NVIDIA H100 80GB HBM3)")),
    ("NVIDIA H100 PCIe", None), ("NVIDIA H100 NVL", None)])
def test_peak_by_full_card_name(monkeypatch, name, want):
    """Only the SXM card's full name takes its datasheet peak: the PCIe
    and NVL parts fall to a measured rate, not the SXM figure."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: name)
    monkeypatch.setattr(pprofiler, "_peak", None)
    got = pprofiler._measure_peak()
    if want is None:
        assert got[1] == f"measured-memcpy({name})" and got[0] > 0
    else:
        assert got == want


def test_store_q1_dispatches_land_on_one_hashagg_row():
    from tidb_tpu_torch import runtime_stats
    from tidb_tpu_torch.benchmarks import tpch
    from tidb_tpu_torch.executor.agg import run_q1_store
    pprofiler.reset_for_tests()
    with pconfig.session_overlay({"tidb_tpu_device_min_rows": 1}):
        res = run_q1_store(sf=0.002, seed=7, device="cpu")
        try:
            coll = runtime_stats.StatsCollector()
            cop = tpch.q1_cop_plan(tpch.table_infos()["lineitem"])
            from tidb_tpu_torch.executor import ExecContext
            from tidb_tpu_torch.executor.reader import TableReader
            ctx = ExecContext(res.storage.device, storage=res.storage,
                              read_ts=res.storage.current_ts())
            with runtime_stats.collecting(coll):
                parts = list(TableReader(cop).partials(ctx))
        finally:
            res.storage.close()
    rows = [r for r in pprofiler.snapshot() if r["family"] == "hashagg"]
    assert len(rows) == 1
    row = rows[0]
    assert row["dispatches"] >= 2 * len(parts) > 0
    assert row["bytes_in"] > 0 and row["busy_ns"] > 0
    assert row["roofline_fraction"] is not None
    st = coll.get(cop)
    assert st.kernel_family == "hashagg" and st.kernel_dispatches > 0
    assert st.kernel_bytes > 0
    pprofiler.reset_for_tests()
