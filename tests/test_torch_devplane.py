"""The port's device plane (devplane.py) against the JAX package's.

* construction: n shards spread round-robin over the given devices, the
  ("batch", n, platform) fingerprint the reference's mesh gives, the
  generation and its listeners, `chip_device`, `shard_map`'s per-shard
  bodies and `plane_jit`'s `plane`-family profile row;
* without a card the plane, like every entry point, refuses to build on
  CUDA unless the caller asks for the CPU;
* the plan cache: a plan made at ndev = 1 is not reused under a plane of
  4 shards (the routed plan has a MeshAgg), and after `disable_mesh()` a
  plan is made anew and then reused;
* the HBM block cache on a plane: the reference bills nbytes x 8 on its
  8-device mesh (one copy per chip); the port holds one copy per
  distinct device (one on an 8-shard CPU plane) and bills exactly that;
  in both the hbm-cache ledger equals the resident bytes;
* `python -m tidb_tpu_torch --device cpu --mesh 4` installs a plane of
  four shards, whose routed Q1-shaped statement answers as the host path
  does (without `--mesh` the plane has one shard and routes nothing:
  test_torch_server.py's CLI test).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.mysql_client import MiniClient
from tidb_tpu import devplane as jplane
from tidb_tpu_torch import devplane, memtrack, profiler
from tidb_tpu_torch.store.storage import new_mock_storage

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_planes():
    yield
    devplane.disable_mesh()
    jplane.disable_mesh()


def test_plane_construction_and_fingerprint(restore_planes):
    p = devplane.build_mesh(8, device="cpu")
    assert p.shape == {"batch": 8} and p.devices.size == 8
    assert p.distinct() == [torch.device("cpu")]
    two = devplane.build_mesh(5, devices=["cpu", "meta"])
    assert [d.type for d in two.devices.flat] == \
        ["cpu", "meta", "cpu", "meta", "cpu"]
    assert devplane.build_mesh(devices=["cpu"]).devices.size == 1
    j = jplane.build_mesh(8)
    assert devplane.mesh_fingerprint(p) == jplane.mesh_fingerprint(j) == \
        ("batch", 8, "cpu")
    assert devplane.ndev() == 1
    gen = devplane.mesh_generation()
    seen = []
    devplane.on_topology_change(lambda: seen.append(devplane.ndev()))
    devplane.enable_mesh(4, device="cpu")
    assert devplane.mesh_generation() == gen + 1 and seen[-1] == 4
    assert devplane.mesh_fingerprint(process=True) == ("batch", 4, "cpu")
    assert devplane.chip_device(6) == torch.device("cpu")
    devplane.disable_mesh()
    assert seen[-1] == 1 and devplane.chip_device(0) is None
    assert devplane.mesh_fingerprint(process=True)[:2] == ("host", 1)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_plane_refuses_cuda_without_a_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        devplane.build_mesh(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        devplane.enable_mesh(2, device="cuda")


def test_shard_map_and_plane_jit():
    p = devplane.build_mesh(3, device="cpu")
    rows = [torch.arange(4) + 10 * i for i in range(3)]
    rep = devplane.replicate(lambda d: torch.ones(1, device=d), p)
    assert rep[0] is rep[1] is rep[2]
    body = devplane.shard_map(
        lambda r, w, k: (devplane.axis_index(), int(r.sum() * w.sum()) + k),
        p, in_specs=(devplane.batch_spec(), devplane.replicated_spec(),
                     devplane.replicated_spec()))
    assert body(rows, rep, 1) == [(0, 7), (1, 47), (2, 87)]
    profiler.reset_for_tests()

    def stage():
        return None
    assert devplane.plane_jit(stage) is stage
    rows = [r for r in profiler.snapshot() if r["family"] == "plane"]
    assert rows and rows[0]["compiles"] == 1


def test_plan_cache_follows_the_plane(restore_planes):
    from tidb_tpu_torch.plan.mesh_route import PhysMeshAgg
    from tidb_tpu_torch.session import Session
    st = new_mock_storage(device="cpu")
    s = Session(st)
    s.execute("CREATE DATABASE d")
    s.execute("USE d")
    s.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, g BIGINT, v BIGINT)")
    s.execute("INSERT INTO t VALUES " + ",".join(
        f"({i}, {i % 5}, {i * 3})" for i in range(200)))
    sql = "SELECT g, COUNT(*), SUM(v) FROM t GROUP BY g"
    made = []
    planner = s._plan

    def plan(stmt):
        made.append(planner(stmt))
        return made[-1]
    s._plan = plan

    def routed(p):
        return isinstance(p, PhysMeshAgg) or any(routed(c)
                                                 for c in p.children)

    def run():
        """-> (rows, the plan made by this run or None on a hit)."""
        n = len(made)
        rows = sorted(s.query(sql).rows)
        return rows, (made[-1] if len(made) > n else None)

    want, p1 = run()
    assert p1 is not None and not routed(p1)
    assert run() == (want, None)               # cached at ndev = 1
    devplane.enable_mesh(4, device="cpu")
    rows, p4 = run()                           # not the ndev = 1 plan
    assert routed(p4) and rows == want
    assert run() == (want, None)
    devplane.disable_mesh()
    rows, p1b = run()
    assert p1b is not None and not routed(p1b)
    assert rows == want
    assert run() == (want, None)               # reused again
    s.close()
    st.close()


def test_hbm_block_billing_on_a_plane(restore_planes):
    from tidb_tpu.chunk import Chunk as JChunk
    from tidb_tpu.chunk import Column as JColumn
    from tidb_tpu.sqltypes import new_int_field
    from tidb_tpu.store import device_cache as jdc
    from tidb_tpu_torch.store import device_cache as pdc
    from tests.test_torch_hashagg import port_chunk
    n = 3000
    ch = JChunk([JColumn(new_int_field(), np.arange(n, dtype=np.int64)),
                 JColumn(new_int_field(), np.arange(n, dtype=np.int64) % 7)])
    one = memtrack.device_put_bytes(port_chunk(ch))
    jplane.enable_mesh(8)
    devplane.enable_mesh(8, device="cpu")
    assert jdc.block_replicas() == 8
    assert pdc.block_replicas(torch.device("cpu")) == 1
    j0, p0 = jdc.tracker().device, pdc.tracker().device
    jc, pc = jdc.DeviceCache(), pdc.DeviceCache(device="cpu")
    jb = jc.fill(("k",), 1, 1, ch)
    pb = pc.fill(("k",), 1, 1, port_chunk(ch))
    assert jb.nbytes == 8 * one and pb.nbytes == one
    assert jdc.tracker().device - j0 == jc.resident_bytes() == 8 * one
    assert pdc.tracker().device - p0 == pc.resident_bytes() == one
    assert pb.replicas == {}
    jc.shed()
    pc.shed()
    assert jdc.tracker().device == j0 and pdc.tracker().device == p0


def _spawn(args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.Popen(
        [sys.executable, "-m", "tidb_tpu_torch", *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT, env=env)


def _serve(args):
    """Start the server; -> (process, its port, its plane log line)."""
    proc = _spawn(["--device", "cpu", "--port", "0", "--no-status",
                   "--set", "tidb_tpu_device_min_rows=1", *args])
    port = mesh = None
    for _ in range(200):
        line = proc.stdout.readline()
        if not line:
            break
        if "device mesh:" in line:
            mesh = line.split("device mesh:", 1)[1].strip()
        if "MySQL protocol on" in line:
            port = int(line.rsplit(":", 1)[1])
            break
    assert port, "server did not report its port"
    return proc, port, mesh


def test_server_installs_the_plane():
    """`--mesh 4`; the default (one shard per device, so ndev = 1 on one
    card or on the CPU) is test_torch_server.py's CLI test."""
    shards = 4
    proc, port, mesh = _serve(["--mesh", str(shards)])
    try:
        assert mesh == repr({"batch": shards})
        c = MiniClient("127.0.0.1", port)
        c.query("CREATE DATABASE d")
        c.query("CREATE TABLE d.t (id BIGINT PRIMARY KEY, g INT)")
        c.query("INSERT INTO d.t VALUES " +
                ",".join(f"({i}, {i % 3})" for i in range(64)))
        plan = "\n".join(r[0] for r in c.query(
            "EXPLAIN SELECT g, COUNT(*) FROM d.t GROUP BY g")[1])
        assert ("MeshAgg" in plan) == (shards > 1)
        assert c.query("SELECT g, SUM(id), COUNT(*) FROM d.t GROUP BY g "
                       "ORDER BY g")[1] == \
            [("0", "693", "22"), ("1", "651", "21"), ("2", "672", "21")]
        c.close()
    finally:
        proc.terminate()
        assert proc.wait(timeout=20) == 0
