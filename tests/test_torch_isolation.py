"""The port stands alone: tidb_tpu_torch imports neither jax nor
tidb_tpu (by AST scan of every module, the storage path's, the device
plane's, the SQL stack's and the server's included, and by sys.modules
after CPU runs of Q1, Q18's inner block, Q1, Q3 and Q5 through the store
under the device plane, Q1 as SQL through the port's Session, and Q1
over the wire through the port's Server, in a fresh process), and its
entry points run on CUDA unless told otherwise, raising where there is
none instead of quietly running on the CPU (the fleet's store plane,
`connect`, `Fleet` and the benchmark tools too); `python -m
tidb_tpu_torch` without `--device cpu` exits non-zero there instead of
serving on the CPU."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

# one intra-op thread: these tests share the CPU with parallel test workers
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "tidb_tpu_torch"
# `tests` too: the JAX package's test helpers import it (the port keeps
# its own MySQL client, util/mysqlclient.py)
FORBIDDEN = ("jax", "jaxlib", "tidb_tpu", "tests")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in FORBIDDEN


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix()
                                        for p in PKG.rglob("*.py")))
def test_no_forbidden_import(path):
    bad = [m for m in _imports(ROOT / path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


# the subpackages of the SQL stack, each scanned by the test above
SQL_STACK = ("parser", "plan", "ddl", "meta", "structure", "session",
             "ranger", "schema", "statistics", "expression", "executor")


# the server slice's modules, each scanned by the test above
SERVER_SLICE = ("server/__init__.py", "server/packet.py", "server/status.py",
                "__main__.py", "privilege.py", "bootstrap.py", "owner.py",
                "perfschema.py", "metrics_history.py", "errcode.py")


# the fleet slice's modules and the bench entry, each scanned by the test
# above (host-only copies included: the port keeps its own)
FLEET_SLICE = ("store/wire.py", "store/remote.py", "store/fleetcop.py",
               "member.py", "fleet.py", "util/statusclient.py",
               "store/rawkv.py", "benchmarks/benchkv.py",
               "benchmarks/benchraw.py", "benchmarks/benchdb.py",
               "benchmarks/benchfilesort.py", "util/testleak.py",
               "server/xserver.py", "bench.py", "util/mysqlclient.py")


# bench.py's other legs and their shared helpers, each scanned by the
# test above; neither the JAX package's `bench.py` (a top-level `bench`)
# nor `__graft_entry__.py` may be imported: the port keeps its own copies
LEGS_SLICE = ("benchmarks/common.py", "benchmarks/kernelmicro.py",
              "benchmarks/skewjoin.py", "benchmarks/encoded.py",
              "benchmarks/tracing.py", "benchmarks/profiling.py",
              "benchmarks/serve.py", "benchmarks/chaos.py",
              "benchmarks/fleetbench.py", "benchmarks/multichip.py",
              "benchmarks/contracts.py", "benchmarks/htap.py", "bench.py")


@pytest.mark.parametrize("mod", LEGS_SLICE)
def test_legs_slice_module_is_scanned(mod):
    path = PKG / mod
    assert path in set(PKG.rglob("*.py"))
    names = list(_imports(path))
    assert not [n for n in names if _forbidden(n)], mod
    assert not [n for n in names
                if n.split(".")[0] in ("__graft_entry__", "bench")], mod


def test_bench_legs_without_a_card_refuse():
    _no_cuda()
    from tidb_tpu_torch.benchmarks import (chaos, encoded, fleetbench,
                                           htap, kernelmicro, multichip,
                                           profiling, serve, tracing)
    for mod in (encoded, tracing, profiling, serve, chaos, multichip, htap,
                fleetbench):
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.run()
    with pytest.raises(RuntimeError, match="CUDA"):
        kernelmicro.run(rows=16)


@pytest.mark.parametrize("mod", FLEET_SLICE)
def test_fleet_slice_module_is_scanned(mod):
    path = PKG / mod
    assert path in set(PKG.rglob("*.py"))
    assert not [n for n in _imports(path) if _forbidden(n)], mod


def test_fleet_entry_points_default_to_cuda():
    _no_cuda()
    from tidb_tpu_torch.benchmarks import benchdb, benchkv, benchraw
    from tidb_tpu_torch.fleet import Fleet
    from tidb_tpu_torch.store.remote import (RemoteStorage, StorageServer,
                                             connect)
    calls = [
        lambda: StorageServer(),
        lambda: connect("127.0.0.1", 1),
        lambda: connect("127.0.0.1", 1, local_cache=True),
        lambda: RemoteStorage(("127.0.0.1", 1)),
        lambda: Fleet(n_sql=2),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    for tool in (benchkv, benchraw, benchdb):
        with pytest.raises(RuntimeError, match="CUDA"):
            tool.main([])


@pytest.mark.parametrize("mod", SERVER_SLICE)
def test_server_slice_module_is_scanned(mod):
    path = PKG / mod
    assert path in set(PKG.rglob("*.py"))
    assert not [n for n in _imports(path) if _forbidden(n)], mod


@pytest.mark.parametrize("sub", SQL_STACK)
def test_sql_stack_subpackage_is_scanned(sub):
    mods = sorted((PKG / sub).rglob("*.py"))
    assert (PKG / sub / "__init__.py") in mods
    for m in mods:
        assert not [n for n in _imports(m) if _forbidden(n)], m


def test_chip_smoke_imports_no_jax():
    bad = [m for m in _imports(ROOT / "chip_smoke.py") if _forbidden(m)]
    assert not bad


_PROBE = """
import json, sys
from tidb_tpu_torch.executor.agg import run_q1
from tidb_tpu_torch.benchmarks import tpch
d = tpch.ScaledTpch(0.002, 7)
res = run_q1(device="cpu", chunks=tpch.lineitem_chunks(d, 4096),
             superchunk_rows=4096)
assert res.rows == tpch.q1_truth(d), res.rows
from tidb_tpu_torch.executor.agg import run_q18_inner
q18 = run_q18_inner(device="cpu", sf=0.002, seed=7, superchunk_rows=4096)
assert [r[0] for r in q18.rows] == tpch.q18_inner_truth(d).tolist()
from tidb_tpu_torch.executor.agg import run_q1_store
from tidb_tpu_torch import config
config.set_var("tidb_tpu_device_min_rows", 1)
st = run_q1_store(device="cpu", sf=0.002, seed=7)
assert st.rows == tpch.q1_truth(d), st.rows
assert run_q1_store(device="cpu", storage=st.storage).rows == st.rows
from tidb_tpu_torch.executor.agg import run_q3_store, run_q5_store
q3 = run_q3_store(device="cpu", storage=st.storage)
assert q3.rows == tpch.q3_truth(d), q3.rows
assert run_q5_store(device="cpu", storage=st.storage).rows == \
    tpch.q5_truth(d)
from tidb_tpu_torch import devplane, meter, profiler, sched
from tidb_tpu_torch.util import supervisor
assert supervisor.run_once("probe", lambda: None)
assert sched.stats()["scheduler"]["grants"] > 0
assert meter.server_snapshot()["device_ns"] > 0
assert profiler.snapshot() and devplane.ndev() == 1
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.store.storage import new_mock_storage
sst = new_mock_storage(device="cpu")
sess = Session(sst)
sess.execute("CREATE DATABASE tpch")
sess.execute("USE tpch")
tpch.load(sess, sst, d)
assert sess.query(tpch.Q1).rows == \
    tpch.as_session_rows("q1", tpch.q1_truth(d))
assert sess.last_stats.segsum_launches == 0 and sess.last_mem.total() == 0
import socket, struct, hashlib
from tidb_tpu_torch.server import Server
from tidb_tpu_torch.server.packet import PacketIO, read_lenenc_int
srv = Server(sst, port=0)
srv.start()
pk = PacketIO(socket.create_connection(("127.0.0.1", srv.port), timeout=30))
pk.read_packet()
pk.write_packet(struct.pack("<II", 0x200 | 0x8000 | 0x80000, 1 << 24)
                + bytes([33]) + b"\\0" * 23 + b"root\\0" + b"\\0"
                + b"mysql_native_password\\0")
assert pk.read_packet()[0] == 0
pk.reset_seq()
pk.write_packet(b"\\x02tpch")
assert pk.read_packet()[0] == 0
pk.reset_seq()
pk.write_packet(b"\\x03" + tpch.Q1.encode())
ncols, _ = read_lenenc_int(pk.read_packet(), 0)
for _ in range(ncols + 1):
    pk.read_packet()
nrows = 0
while True:
    p = pk.read_packet()
    if p[0] == 0xFE and len(p) < 9:
        break
    nrows += 1
assert ncols == 10 and nrows == len(tpch.q1_truth(d)), (ncols, nrows)
srv.close()
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "tidb_tpu"))))
"""


# every module of the port imported, then a query through Fleet.client
# (the client it hands a fleet's user) to the port's Server on the CPU
_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import tidb_tpu_torch
for m in pkgutil.walk_packages(tidb_tpu_torch.__path__, "tidb_tpu_torch."):
    importlib.import_module(m.name)
from tidb_tpu_torch.fleet import Fleet, SQLMember
from tidb_tpu_torch.server import Server
from tidb_tpu_torch.store.storage import new_mock_storage
srv = Server(new_mock_storage(device="cpu"), port=0)
srv.start()
f = Fleet(n_sql=1, device="cpu")
f.members = [SQLMember(0, None, srv.port, 0)]
c = f.client(0)
assert c.query("SELECT 1 + 1")[1] == [("2",)]
c.close()
srv.close()
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] in
                        ("jax", "jaxlib", "tidb_tpu", "tests"))))
"""


def test_every_module_and_the_fleet_client_load_no_reference_module():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_cpu_q1_loads_no_jax_module():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")


def test_entry_points_default_to_cuda():
    _no_cuda()
    import numpy as np
    from tidb_tpu_torch import statistics
    from tidb_tpu_torch.benchmarks import tpch
    from tidb_tpu_torch.chunk import Chunk
    from tidb_tpu_torch.executor import ExecContext
    from tidb_tpu_torch.executor.agg import (run_agg, run_q1, run_q1_store,
                                             run_q3, run_q3_store, run_q5,
                                             run_q5_store, run_q18_inner)
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.store import copr
    from tidb_tpu_torch.store.device_cache import DeviceCache
    from tidb_tpu_torch.store.storage import new_mock_storage
    from tidb_tpu_torch.ops import (fragment, hashagg, hybrid, join, runtime,
                                    stats, streamagg)
    flt, group_exprs, aggs = tpch.q1_plan()
    ch = tpch.lineitem_chunks(tpch.ScaledTpch(0.002, 1), 4096)[0]
    q18, _having = tpch.q18_inner_plan()
    big = tpch.table_column([ch] * 40, "lineitem", "l_orderkey")
    calls = [
        lambda: run_q1(sf=0.002),
        lambda: run_q3(sf=0.002),
        lambda: run_q5(sf=0.002),
        lambda: run_q18_inner(sf=0.002),
        lambda: stats.device_sort(np.arange(10)),
        lambda: statistics.build_column_stats(big),
        lambda: tpch.analyze_columns(None, ["l_orderkey"], chunks=[ch]),
        lambda: list(q18.chunks(ExecContext(None, {"lineitem": [ch]}))),
        lambda: streamagg.segment_kernel_for(q18.group_exprs, q18.aggs),
        lambda: streamagg.SegmentAggKernel(q18.group_exprs, q18.aggs),
        lambda: join.JoinKernel(1),
        lambda: fragment.fragment_kernel_for(1, 5, 10, group_exprs, aggs),
        lambda: hybrid.partitioned_agg(ch, flt, group_exprs, aggs),
        lambda: run_agg([ch], flt, group_exprs, aggs),
        lambda: hashagg.kernel_for(flt, group_exprs, aggs),
        lambda: hashagg.HashAggKernel(flt, group_exprs, aggs),
        lambda: hashagg.ScalarAggKernel(flt, aggs),
        lambda: runtime.device_put_chunk(ch),
        lambda: runtime.device_put_chunk(Chunk(ch.columns), device="cuda"),
        lambda: run_q1_store(sf=0.002),
        lambda: run_q3_store(sf=0.002),
        lambda: run_q5_store(sf=0.002),
        lambda: new_mock_storage(),
        lambda: Session(new_mock_storage()),
        lambda: DeviceCache(),
        lambda: copr.exec_cop_plan(tpch.q1_cop_plan(
            tpch.table_infos()["lineitem"]), ch),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_main_without_a_card_exits_non_zero():
    _no_cuda()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, "-m", "tidb_tpu_torch", "--port",
                          "0", "--no-status"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "CUDA" in out.stderr and "MySQL protocol on" not in out.stderr
