"""The port's bench entry (`python -m tidb_tpu_torch.bench`) on the CPU.

At SF 0.002 with `--device cpu`: Q1/Q3/Q5 run through the port's
`Session` with `tidb_tpu_device` = 1 and = 0 on one store; the two modes
agree (else the run fails), the line's keys are the ones the JAX
package's `bench.py: main` prints (read from its syntax tree), the
per-query detail carries rows/s, scan GB/s and the roofline fraction,
the detail the coprocessor mode it ran on,
and each query's rows equal the JAX package's Session on the same
seeded data. Without a card and without `--device cpu` it exits
non-zero instead of falling back.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from tidb_tpu.benchmarks import tpch as jtpch
from tidb_tpu.session import Session as JSession
from tidb_tpu.store.storage import new_mock_storage as jnew_storage
from tidb_tpu_torch import bench, config
from tidb_tpu_torch.benchmarks import tpch as ptpch
from tidb_tpu_torch.session import Session as PSession
from tidb_tpu_torch.store.storage import new_mock_storage as pnew_storage

ROOT = Path(__file__).resolve().parent.parent
SF, SEED = 0.002, 42


def _reference_keys():
    """The keys of the dict bench.py's main() prints."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    for node in ast.walk(main):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "metric"
                for k in node.keys):
            return tuple(k.value for k in node.keys)
    raise AssertionError("bench.py main prints no metric line")


@pytest.fixture(scope="module")
def loaded():
    d = ptpch.ScaledTpch(SF, SEED)
    st = pnew_storage(device="cpu")
    s = PSession(st)
    s.execute("CREATE DATABASE tpch")
    s.execute("USE tpch")
    ptpch.load(s, st, d)
    yield s, st, d
    s.close()
    st.close()


def test_line_has_bench_py_keys_and_modes_agree(loaded):
    s, st, d = loaded
    prev = config.get_var("tidb_tpu_device_min_rows")
    config.set_var("tidb_tpu_device_min_rows", 1)
    try:
        line = bench.run(s, st, d, iters=1, host_iters=1)
    finally:
        config.set_var("tidb_tpu_device_min_rows", prev)
    assert tuple(line) == bench.KEYS == _reference_keys()
    assert line["metric"] == "tpch_q1_q3_q5_e2e_rows_per_sec_per_chip"
    assert line["unit"] == "rows/s" and line["value"] > 0
    assert line["vs_baseline"] > 0
    json.dumps(line)
    for q in ("q1", "q3", "q5"):
        det = line["detail"][q]
        assert det["device_rows_per_sec"] > 0
        assert det["host_rows_per_sec"] > 0
        assert det["device_scan_gbps"] > 0
        assert 0 < det["roofline_fraction"]
    assert line["detail"]["q1"]["segsum_launches"] == 0   # CPU: no kernel
    assert config.get_var("tidb_tpu_device") == 1


def test_line_records_the_coprocessor_mode(loaded):
    """Streamed (the default) and materialized runs read a selection
    region differently: the line says which one it timed."""
    s, st, d = loaded
    assert bench.run(s, st, d, iters=1, host_iters=1)[
        "detail"]["copr_stream"] == 1
    s.execute("SET @@tidb_tpu_copr_stream = 0")
    try:
        line = bench.run(s, st, d, iters=1, host_iters=1)
    finally:
        s.execute("SET @@tidb_tpu_copr_stream = 1")
    assert line["detail"]["copr_stream"] == 0


def test_query_rows_equal_the_reference(loaded):
    s, _st, _d = loaded
    js = jnew_storage()
    jsess = JSession(js)
    jsess.execute("CREATE DATABASE tpch")
    jsess.execute("USE tpch")
    jtpch.load(jsess, js, jtpch.ScaledTpch(SF, SEED))
    for sql in (ptpch.Q1, ptpch.Q3, ptpch.Q5):
        assert bench.rows_equal(s.query(sql).rows, jsess.query(sql).rows)
    jsess.close()
    js.close()


def test_disagreeing_modes_fail_the_run(loaded, monkeypatch):
    s, st, d = loaded
    real = s.query

    def skewed(sql):
        res = real(sql)
        if config.get_var("tidb_tpu_device") == 0 and res.rows:
            res.rows = res.rows[1:]
        return res

    monkeypatch.setattr(s, "query", skewed)
    with pytest.raises(RuntimeError, match="disagree"):
        bench.run(s, st, d, iters=1, host_iters=1)


def test_cli_on_the_cpu_prints_the_line():
    out = subprocess.run(
        [sys.executable, "-m", "tidb_tpu_torch.bench", "--sf", "0.002",
         "--iters", "1", "--host-iters", "1", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert tuple(line) == _reference_keys()
    assert line["detail"]["rows_loaded"] > 0


def test_cli_without_a_card_exits_non_zero():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    out = subprocess.run(
        [sys.executable, "-m", "tidb_tpu_torch.bench", "--sf", "0.002"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "CUDA" in out.stderr
    assert not out.stdout.strip()
