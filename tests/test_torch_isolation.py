"""The port stands alone: tidb_tpu_torch imports neither jax nor
tidb_tpu (by AST scan of every module, the storage path's, the device
plane's and the SQL stack's included, and by sys.modules after CPU runs
of Q1, Q18's inner block, Q1, Q3 and Q5 through the store under the
device plane, and Q1 as SQL through the port's Session, in a fresh
process), and its entry points run on CUDA unless told otherwise,
raising where there is none instead of quietly running on the CPU."""

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
FORBIDDEN = ("jax", "jaxlib", "tidb_tpu")


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
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "tidb_tpu"))))
"""


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
