"""A CPU rehearsal of every cell at a tiny scale drives the whole run:
set-up, the server, the load process, the window and the judgement; its last line has the result's keys, with the checks last."""

import json
import subprocess
import sys

import pytest

from benchmark import catalog, harness

CELLS = [w["name"] for w in catalog.spec()["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(cell, trace=False):
    return harness.Run(cell, 2**31 + 4321, 2, trace, device="cpu",
                       scale=0.002).execute()


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_line(cell):
    line = _run(cell)
    assert list(line) == KEYS + ["checks"]
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    spec = {m["name"] for m in catalog.Cell(cell).end_to_end}
    assert set(line["metrics"]) == spec
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    json.dumps(line)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_rehearsal_reads_the_program_side_metrics(cell):
    line = _run(cell, trace=True)
    assert list(line) == KEYS + ["checks"]   # no card: no breakdown
    # the device-trace metrics read nothing without a card
    assert set(line["metrics"]) == {"stmt_p95_ms", "front_ms",
                                    "sched_wait_ms", "hbm_hit_ratio",
                                    "h2d_bytes_per_row"}


def test_cli_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, str(catalog.HERE / "run.py"), "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=catalog.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_cli_refuses_outside_a_checkout(tmp_path):
    import shutil
    shutil.copy(catalog.SPEC, tmp_path / "BENCHMARK.json")
    shutil.copytree(catalog.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.chip
def test_cell_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", str(2**31 + 9), "--seconds", "5", "--trace", "1"],
        capture_output=True, text=True, timeout=600, cwd=catalog.ROOT)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line) == KEYS + ["breakdown", "checks"]
    assert line["correct"] is True
    assert line["device"]["busy_s"] > 0
