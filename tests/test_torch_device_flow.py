"""The port's device-plane dataflow pass (tidb_tpu_torch/lint/flow/
device.py), case for case beside the reference's
tests/test_device_flow.py: discovery of every kernel construction site
across its four forms (the three `FingerprintCache.get_or_create`
callers, the five `devplane.plane_jit` wraps, the executor/mesh dict
cache and the segsum build), program bodies resolved through their
owner classes, dispatch resolution, the static construction model the
lintcheck leg cross-checks against the profiler, and two runtime pins in
place of the reference's donation pins: the HBM patch writes clones and
leaves the resident lanes a reader holds untouched (the contract
inplace-safety enforces), and a kernel cache keys on the plane (the
fault the cache-key rule found: the port's keys had dropped
`devplane.mesh_fingerprint`). The segsum build's reuse key (the other
cache-key fault) is pinned last.
"""

import numpy as np
import pytest
import torch

from tidb_tpu_torch.lint.engine import Forest
from tidb_tpu_torch.lint.flow.device import DeviceFlow, device_flow_of

OPS = "tidb_tpu_torch/ops/"


@pytest.fixture(scope="module")
def df():
    return device_flow_of(Forest.load())


# -- discovery --------------------------------------------------------------

def test_discovers_all_construction_forms(df):
    assert {s.form for s in df.sites} == {"factory", "plane_jit", "dict",
                                          "build"}
    # kernel caches, instance attrs, the executor's dict cache, the
    # build's library file
    assert {s.store[0] for s in df.sites} == {"cache", "attr", "dict",
                                              "file"}


def test_discovers_the_known_kernel_sites(df):
    found = sorted((s.form, s.rel, s.store[1]) for s in df.sites)
    assert found == [
        ("build", OPS + "segsum.py", None),
        ("dict", "tidb_tpu_torch/executor/mesh.py", "_KERNELS"),
        ("factory", OPS + "fragment.py", "_FRAGMENTS"),
        ("factory", OPS + "hashagg.py", "_KERNELS"),
        ("factory", OPS + "streamagg.py", "_SEG_KERNELS"),
        ("plane_jit", OPS + "meshagg.py", "_jit"),
        ("plane_jit", OPS + "meshjoin.py", "_stage1"),
        ("plane_jit", OPS + "meshjoin.py", "_stage2"),
        ("plane_jit", OPS + "meshjoin.py", "_stage3"),
        ("plane_jit", OPS + "meshshuffle.py", "_prog"),
    ]
    hashagg = next(s for s in df.sites if s.rel == OPS + "hashagg.py")
    assert sorted(c for _r, c in hashagg.kernel_classes) == \
        ["HashAggKernel", "ScalarAggKernel"]


def test_build_site_is_the_segsum_compile(df):
    """The reference's donating sites were its _jitd twins; the port's
    one site that leaves the Python process is the kernel's build."""
    (build,) = [s for s in df.sites if s.form == "build"]
    assert build.owner.qualname == "build"
    assert "build_command" in ast_text(build.call)


def test_traced_bodies_resolve_through_owner_classes(df):
    names = set()
    for s in df.sites:
        names |= {f.qualname for f in s.fns}
    for body in ("HashAggKernel._kernel", "ScalarAggKernel._kernel",
                 "SegmentAggKernel._kernel", "ProbeAggKernel._kernel",
                 "MeshAggKernel._program", "MeshShuffleJoinKernel._program",
                 "MeshLookupAggKernel._stage1_fn",
                 "MeshLookupAggKernel._stage2_fn",
                 "MeshLookupAggKernel._stage3_fn"):
        assert body in names
    # a program body's closure: the hash-agg kernel reaches the group
    # table and the segment-sum batch through the call graph
    (site,) = [s for s in df.sites if s.rel == OPS + "hashagg.py"]
    reach = {f.qualname for f in df.traced_bodies(site)}
    assert {"group_partial", "_group_table", "_hash_keys"} <= reach


def test_dispatches_resolve_to_sites(df):
    assert len(df.dispatches) >= 10
    by_func = {(d.rel, d.func.qualname) for d in df.dispatches}
    for cls in ("HashAggKernel", "ScalarAggKernel"):
        assert (OPS + "hashagg.py", f"{cls}.dispatch") in by_func
    assert (OPS + "meshagg.py", "MeshAggKernel.launch") in by_func
    assert (OPS + "meshshuffle.py", "MeshShuffleJoinKernel.__call__") in \
        by_func


def test_memoized_on_forest(df):
    forest = Forest.load()
    a = device_flow_of(forest)
    assert device_flow_of(forest) is a
    assert isinstance(a, DeviceFlow)


# -- construction predictions -----------------------------------------------

def test_compile_predictions_cover_every_profiler_family(df):
    from tidb_tpu_torch import profiler
    preds = df.compile_predictions()
    assert set(preds) == set(profiler.FAMILIES)
    for fam, p in preds.items():
        assert p["warm_growth"] == 0
        assert p["per_row_bound"] == (None if fam == "plane" else 1)
        assert p["sites"] >= 1, fam
    assert preds["plane"]["sites"] == 5


# -- runtime pins -----------------------------------------------------------

def test_hbm_patch_clones_and_leaves_the_resident_lanes(df):
    """store/device_cache.scatter_block, the shape inplace-safety
    sanctions: the patched block is new tensors; the resident lanes a
    concurrent reader captured keep their values."""
    from tidb_tpu_torch.store.device_cache import scatter_block
    data = torch.arange(8, dtype=torch.int64)
    valid = torch.ones(8, dtype=torch.bool)
    cols = [(data, valid)]
    before = data.clone()
    new = scatter_block(cols, np.array([6], dtype=np.int64),
                        np.array([1], dtype=np.int64),
                        np.array([2], dtype=np.int64),
                        [np.array([99], dtype=np.int64)],
                        [np.array([False])], torch.device("cpu"))
    assert torch.equal(data, before) and bool(valid.all())
    assert new[0][0].tolist() == [0, 6, 99, 3, 4, 5, 6, 7]
    assert new[0][1].tolist() == [True, True, False] + [True] * 5
    assert new[0][0].data_ptr() != data.data_ptr()


def test_kernel_cache_keys_on_the_plane():
    """The same plan under another plane gets a kernel object of its
    own, constructed once under that plane's profile row (before the
    fix the cache served the old object, and the new row showed a reuse
    with no construction)."""
    from tidb_tpu_torch import devplane, profiler, sqltypes as st
    from tidb_tpu_torch.expression import AggDesc, AggFunc, col
    from tidb_tpu_torch.ops.hashagg import kernel_for
    INT = st.new_int_field()
    args = (None, [col(0, INT)], [AggDesc(AggFunc.SUM, col(1, INT))])
    plane = devplane.active_mesh()
    try:
        devplane.configure_mesh(None)
        profiler.reset_for_tests()
        a = kernel_for(*args, device="cpu")
        assert kernel_for(*args, device="cpu") is a
        devplane.enable_mesh(1, device="cpu")
        b = kernel_for(*args, device="cpu")
        assert b is not a
        assert kernel_for(*args, device="cpu") is b
        assert profiler.profile_of(b).compiles == 1
        assert profiler.profile_of(b).reuses == 1
    finally:
        devplane.configure_mesh(plane)
        profiler.reset_for_tests()


def test_segsum_build_reuses_only_under_its_key(monkeypatch, tmp_path):
    """The build's reuse key covers the kernel's source and nvcc's flags
    (it used to compare mtimes with the source alone): a library built
    with other flags is rebuilt, one built with these is reused."""
    from tidb_tpu_torch.ops import segsum
    src = tmp_path / "segsum.cu"
    src.write_text("// kernel\n")
    monkeypatch.setattr(segsum, "SOURCE", src)
    monkeypatch.setattr(segsum, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(segsum, "LIBRARY", tmp_path / "_build" / "lib.so")
    monkeypatch.setattr(segsum, "STAMP", tmp_path / "_build" / "lib.key")
    monkeypatch.setattr(segsum, "_nvcc", lambda: "nvcc")
    runs = []

    class Done:
        returncode, stdout, stderr = 0, "", ""

    def fake_run(cmd, **kw):
        runs.append(list(cmd))
        out = cmd[cmd.index("-o") + 1]
        with open(out, "w") as f:
            f.write("lib")
        return Done()

    monkeypatch.setattr(segsum.subprocess, "run", fake_run)
    segsum.build()
    segsum.build()
    assert len(runs) == 1                       # same key: reused
    monkeypatch.setattr(segsum, "NVCC_FLAGS", segsum.NVCC_FLAGS + ["-G"])
    segsum.build()
    assert len(runs) == 2 and "-G" in runs[-1]  # new flags: rebuilt
    src.write_text("// kernel, edited\n")
    segsum.build()
    segsum.build()
    assert len(runs) == 3                       # new source: rebuilt once
    segsum.build(force=True)
    assert len(runs) == 4


def ast_text(node) -> str:
    import ast
    return ast.unparse(node)
