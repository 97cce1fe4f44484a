"""The bench legs' contracts and their command line, on the CPU.

`benchmarks/contracts.check_<leg>` is the port of the assertions of the
JAX package's `scripts/<leg>_bench.sh`: it passes on the line each leg
prints here at a tiny size and fails on the same line doctored to show
what the script catches (a wrong result, a coverage of 0.5, an
encoding fallback, a reason="mesh" fallback, a ledger left above zero,
...). The encoded, trace and profile lines carry every key of the line
that `python bench.py <leg>` prints (run as a subprocess on the CPU, so
its compile-cache setting never reaches this process). `python -m
tidb_tpu_torch.bench LEG --device cpu` prints the line; without a card
and without `--device cpu` it exits non-zero and prints nothing; a leg
whose contract fails, and a north-star run whose block raised, print
their line and exit 1.
"""

import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tests.torch_legs_ref import (SF, HTAP_ROWS, key_tree, missing_keys,
                                  small_registries)
from tidb_tpu_torch import bench
from tidb_tpu_torch.benchmarks import contracts

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TINY = {
    "encoded": dict(sf=SF, iters=2),
    "trace": dict(sf=SF, iters=2, lookups=4),
    "profile": dict(sf=SF, iters=2),
    "serve": dict(clients=2, rounds=1, lookups=2, sf=SF),
    # 100 writes/s: the seeded schedule arms delta/merge first, and the
    # writer reaches the 64-row merge well inside the window
    "chaos": dict(clients=2, secs=3.0, sf=SF, writes_per_sec=100.0),
    "multichip": dict(devs=(1, 2), sf=SF, iters=1, serve_rounds=4),
    "htap": dict(rows=HTAP_ROWS, secs=1.0, rates=(0, 20)),
}
# the reference's knobs for the same sizes, and the same small device
# thresholds (the JAX package seeds its variables from TIDB_TPU_*)
REF_ENV = {"encoded": {"BENCH_ENCODED_SF": str(SF), "BENCH_ENCODED_ITERS": "2"},
           "trace": {"BENCH_TRACE_SF": str(SF), "BENCH_TRACE_ITERS": "2",
                     "BENCH_TRACE_LOOKUPS": "4"},
           "profile": {"BENCH_PROFILE_SF": str(SF),
                       "BENCH_PROFILE_ITERS": "2"}}
REF_VARS = {"TIDB_TPU_DEVICE_MIN_ROWS": "1",
            "TIDB_TPU_SUPERCHUNK_ROWS": "4096"}


@pytest.fixture(scope="module")
def lines():
    """Each leg's line and its contract's failures at a tiny size."""
    out = {}
    with small_registries():
        for leg, knobs in TINY.items():
            out[leg] = bench.run_leg(leg, None, "cpu", **knobs)
    return out


def _doctor(line, path, value):
    line = copy.deepcopy(line)
    node = line
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = value
    return line


def _mesh(line):
    line = copy.deepcopy(line)
    line["detail"]["legs"][-1]["mesh_fallbacks"] = 1
    line["detail"]["checks"]["no_mesh_fallbacks"] = False
    return line


def _htap_recold(line):
    line = copy.deepcopy(line)
    line["detail"]["rates"]["20"]["delta"]["hbm_misses"] = 1
    return line


# (leg, how the line is doctored, what the failure names)
DOCTORED = [
    ("serve", lambda l: _doctor(l, ("detail", "utilization",
                                    "attribution_coverage"), 0.5),
     "attribution coverage 0.5"),
    ("serve", lambda l: _doctor(l, ("detail", "pinched", "oom_cancels"), 2),
     "OOM cancels"),
    ("serve", lambda l: _doctor(l, ("detail", "pinched", "completed"), False),
     "pinched leg failed"),
    ("chaos", lambda l: _doctor(l, ("detail", "wrong_results"),
                                ["q1: [('A', 'F')]"]), "WRONG RESULTS"),
    ("chaos", lambda l: _doctor(l, ("detail", "server_ledger_device_end"),
                                4096), "ledgers leaked"),
    ("chaos", lambda l: _doctor(l, ("detail", "sched_inflight_end"), 1),
     "slots leaked"),
    ("chaos", lambda l: _doctor(l, ("detail", "non_retryable_errors"),
                                ["q3: (8175) oom"]), "non-retryable"),
    ("encoded", lambda l: _doctor(l, ("detail", "queries", "q1",
                                      "encoding_fallbacks"), 1),
     "encoding fallback"),
    ("multichip", _mesh, 'reason="mesh"'),
    ("trace", lambda l: _doctor(l, ("detail", "passed"), False),
     "did not pass"),
    ("profile", lambda l: _doctor(l, ("detail", "statement_profile_rows"), 0),
     "memo empty"),
    ("htap", _htap_recold, "re-colded"),
]


@pytest.mark.parametrize("leg", sorted(TINY))
def test_contract_holds_on_the_cpu_line(leg, lines):
    line, failures = lines[leg]
    assert contracts.invariants(failures) == [], failures


@pytest.mark.parametrize("leg,doctor,named", DOCTORED,
                         ids=[f"{leg}-{named.split()[0]}"
                              for leg, _d, named in DOCTORED])
def test_contract_fails_on_a_doctored_line(leg, doctor, named, lines):
    bad = contracts.invariants(contracts.check(leg, doctor(lines[leg][0])))
    assert any(named in f for f in bad), bad


def test_floors_are_told_apart_from_invariants(lines):
    line = _doctor(lines["multichip"][0],
                   ("detail", "per_chip_ratio_1_to_n"), {"q1": 0.5})
    failures = contracts.check("multichip", line)
    assert contracts.floors(failures) and not contracts.invariants(failures)
    fleet = {"value": 1.0, "detail": {
        "legs": [{"servers": n, "stmts_per_sec": 10.0, "latency": {
            "q1": {"p99_ms": 1.0}},
            "per_server": {str(i): {"stmts": 1} for i in range(n)}}
            for n in (1, 2, 4)],
        "scaling_max_vs_1": 1.2, "coherence": {"0": {"journal_pulls": 3}},
        "fleet_attribution": {"live_members": {"a": "sql"},
                              "members": {"a": {"statements": 2}},
                              "trace_id": 1 << 40, "stitched_store": True}}}
    failures = contracts.check_fleet(fleet, cores=8)
    assert len(failures) == 1 and contracts.floors(failures)
    assert contracts.check_fleet(fleet, cores=2) == []


def test_a_line_missing_a_block_fails_by_name(lines):
    line = copy.deepcopy(lines["serve"][0])
    del line["detail"]["pinched"]
    assert "pinched" in contracts.check("serve", line)[0]


@pytest.mark.parametrize("leg", sorted(REF_ENV))
def test_line_has_the_reference_legs_keys(leg, lines):
    # one host device, as `python bench.py` finds without the tests'
    # 8-device XLA_FLAGS (an 8-device mesh leaves the profile memo empty)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", TIDB_TPU_COMPILE_CACHE="0", **REF_VARS,
               **REF_ENV[leg])
    out = subprocess.run([sys.executable, "bench.py", leg], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    assert not missing_keys(key_tree(ref), key_tree(lines[leg][0]))
    if leg == "encoded":
        # the encoded dispatches' bytes, Q3's fused fragment included,
        # are the reference's to the byte
        for q, got in lines[leg][0]["detail"]["queries"].items():
            want = ref["detail"]["queries"][q]["bytes_touched"]
            for k in ("decoded_equivalent_bytes", "encoded_bytes"):
                assert got["bytes_touched"][k] == want[k] > 0, (q, k)


def test_cli_prints_the_leg_line_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "tidb_tpu_torch.bench", "trace", "--sf",
         str(SF), "--iters", "2", "--lookups", "4", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metric"] == "trace_bench_traces_retained"
    assert line["detail"]["passed"] and line["value"] > 0


def test_cli_without_a_card_exits_non_zero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    out = subprocess.run([sys.executable, "-m", "tidb_tpu_torch.bench",
                          "serve"], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and "CUDA" in out.stderr
    assert not out.stdout.strip()


@pytest.mark.parametrize("leg", sorted(bench.LEGS))
def test_leg_without_a_card_exits_non_zero(leg, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    assert bench.main([leg]) == 2
    out = capsys.readouterr()
    assert "CUDA" in out.err and not out.out.strip()


def test_leg_exits_1_after_its_line_when_its_contract_fails(monkeypatch,
                                                            capsys):
    line = {"metric": "m", "value": 0, "unit": "u", "vs_baseline": 0.0,
            "detail": {}}
    monkeypatch.setattr(bench, "run_leg",
                        lambda *a, **k: (line, ["it broke"]))
    assert bench.main(["encoded", "--device", "cpu"]) == 1
    out = capsys.readouterr()
    assert json.loads(out.out.strip()) == line
    assert "it broke" in out.err
    monkeypatch.setattr(bench, "run_leg", lambda *a, **k: (line, []))
    assert bench.main(["encoded", "--device", "cpu"]) == 0


def test_flags_replace_the_reference_knobs():
    flags = {leg: [f[0] for f in spec[1]] for leg, spec in bench.LEGS.items()}
    assert flags["chaos"] == ["seed", "clients", "secs", "sf",
                              "writes_per_sec", "timeout_ms", "stuck_secs"]
    assert flags["multichip"] == ["devs", "sf", "iters", "serve_rounds"]
    assert flags["fleet"] == ["servers", "clients", "rounds", "lookups", "sf"]
    defaults = {leg: {f[0]: f[2] for f in spec[1]}
                for leg, spec in bench.LEGS.items()}
    assert defaults["serve"] == {"clients": 8, "rounds": 2, "lookups": 8,
                                 "sf": 0.02}
    assert defaults["htap"] == {"rows": 60000, "secs": 5.0,
                                "rates": "0,20,100"}


def test_north_star_records_a_raising_block_and_exits_1(monkeypatch,
                                                        capsys):
    from tidb_tpu_torch.benchmarks import kernelmicro, skewjoin

    def broken(*a, **k):
        raise RuntimeError("skew broke")

    monkeypatch.setattr(skewjoin, "run", broken)
    real_micro = kernelmicro.run
    monkeypatch.setattr(kernelmicro, "run",
                        lambda device: real_micro(rows=1 << 12, iters=1,
                                                  device=device))
    with small_registries():
        rc = bench.main(["--sf", str(SF), "--iters", "1", "--host-iters",
                         "1", "--device", "cpu", "--no-serve", "--no-htap",
                         "--no-chaos"])
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert rc == 1 and "skew broke" in line["detail"]["skew_join_error"]
    assert line["detail"]["kernel_only_q1_rows_per_sec"] > 0
    assert "serve" not in line["detail"] and "chaos" not in line["detail"]
    assert line["metric"] == "tpch_q1_q3_q5_e2e_rows_per_sec_per_chip"
