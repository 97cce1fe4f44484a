"""The static-vs-runtime cross-check leg: the port's counterpart of the
JAX package's `python bench.py lintcheck` (`_lintcheck_bench`,
`lintcheck_main`).

The device dataflow pass (`tidb_tpu_torch/lint/flow/device.py`)
predicts each kernel family's constructions from source alone; this leg
runs warm TPC-H Q1 and Q3 under the kernel profiler, with a plane of one
shard per visible device (`devplane.enable_mesh()`; the reference's
`parallel.config.enable_mesh()`), and records a failure on drift in
either direction: a family the static model does not know (the analysis
fell behind the runtime), a fingerprinted row constructed more often
than the predicted bound or any family constructing on the warm
iterations (the runtime fell behind the contract the lint rules
enforce), or a non-clean `python -m tidb_tpu_torch.lint --json` run (a
child process, as the reference runs it). In the port a "compile" is a
kernel object constructed (`profiler.note_construct`).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

__all__ = ["METRIC", "run", "line"]

METRIC = "lintcheck_families_verified"
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_lint() -> tuple[dict | None, int, str, float]:
    """`python -m tidb_tpu_torch.lint --json` as a child process.
    -> (its report or None, exit code, the end of its stderr, seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tidb_tpu_torch.lint", "--json"],
        capture_output=True, text=True, cwd=_REPO, timeout=600)
    secs = time.perf_counter() - t0
    try:
        report = json.loads(proc.stdout)
    except json.JSONDecodeError:
        report = None
    return report, proc.returncode, proc.stderr[-500:], secs


def run(progress=None, sf: float = 0.02, iters: int = 2, seed: int = 42,
        device="cuda") -> dict:
    """-> the line's detail: `failures` (a list of messages) and
    `passed`. Restores `tidb_tpu_device` and the process's plane."""
    from tidb_tpu_torch import config, devplane, profiler
    from tidb_tpu_torch.benchmarks import tpch
    from tidb_tpu_torch.lint.engine import Forest
    from tidb_tpu_torch.lint.flow.device import device_flow_of
    from tidb_tpu_torch.ops import segsum
    from tidb_tpu_torch.ops.runtime import resolve_device
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.store.storage import new_mock_storage
    device = resolve_device(device)     # no card: refuse before the lint
    progress = progress or (lambda msg: None)
    out: dict = {"sf": sf, "iters": iters}
    failures: list[str] = []

    progress("lintcheck: python -m tidb_tpu_torch.lint --json")
    lint, rc, err, secs = run_lint()
    out["lint_seconds"] = secs
    if lint is None or rc not in (0, 1):
        failures.append(f"lint --json did not produce a report "
                        f"(rc={rc}): {err}")
        lint = {"clean": False, "rules": [], "findings": [],
                "timing": {}}
    out["lint_clean"] = lint["clean"]
    out["lint_rules"] = len(lint["rules"])
    out["lint_rule_ms"] = lint.get("timing", {}).get("rule_ms", {})
    if not lint["clean"]:
        failures.append(
            f"lint is not clean: {len(lint['findings'])} finding(s), "
            f"first: {lint['findings'][:3]}")

    progress("lintcheck: static construction predictions")
    df = device_flow_of(Forest.load())
    preds = df.compile_predictions()
    out["predictions"] = preds
    out["traced_sites"] = len(df.sites)
    missing_model = sorted(set(profiler.FAMILIES) - set(preds))
    if missing_model:
        failures.append(
            f"static model predicts nothing for profiler families "
            f"{missing_model} — the device pass fell behind the "
            f"profiler plane")

    data = tpch.ScaledTpch(sf, seed)
    storage = new_mock_storage(device=device)
    session = Session(storage)
    saved = config.get_var("tidb_tpu_device")
    plane = devplane.active_mesh()
    launches0 = segsum.launches
    try:
        session.execute("CREATE DATABASE tpch_lintcheck")
        session.execute("USE tpch_lintcheck")
        progress(f"lintcheck: loading sf={sf}")
        tpch.load(session, storage, data, regions_per_table=2)
        queries = {q: tpch.QUERIES[q] for q in ("q1", "q3")}
        config.set_var("tidb_tpu_device", 1)
        devplane.enable_mesh(device=device)
        profiler.reset_for_tests()
        progress("lintcheck: cold runs (kernel construction + cache fill)")
        for sql in queries.values():
            session.query(sql)

        def fam_compiles() -> dict:
            fams: dict = {}
            for p in profiler.snapshot():
                fams[p["family"]] = fams.get(p["family"], 0) + \
                    p["compiles"]
            return fams

        cold = fam_compiles()
        progress(f"lintcheck: {iters} warm iterations per query")
        for _i in range(iters):
            for sql in queries.values():
                session.query(sql)
        warm = fam_compiles()
        out["compiles_after_cold"] = cold
        out["compiles_after_warm"] = warm

        checked = 0
        for fam, n in sorted(warm.items()):
            pred = preds.get(fam)
            if pred is None:
                failures.append(
                    f"family {fam!r} constructed {n} kernel(s) but the "
                    f"static model has no prediction for it")
                continue
            checked += 1
            growth = n - cold.get(fam, 0)
            if growth > pred["warm_growth"]:
                failures.append(
                    f"family {fam!r} constructed {growth} kernel(s) "
                    f"during warm iterations (predicted "
                    f"{pred['warm_growth']})")
        out["families_checked"] = checked
        if not checked:
            failures.append("no family constructed anything — the "
                            "cross-check exercised nothing")

        # per-fingerprint bound: a fingerprint-cached family builds at
        # most one kernel object per profile row ("~" rows are
        # explicitly unfingerprinted and exempt from the bound)
        over = []
        for p in profiler.snapshot():
            bound = (preds.get(p["family"]) or {}).get("per_row_bound")
            if bound is None or p["fingerprint"].startswith("~"):
                continue
            if p["compiles"] > bound:
                over.append((p["family"], p["fingerprint"][:16],
                             p["compiles"]))
        out["rows_over_bound"] = over
        if over:
            failures.append(
                f"fingerprinted rows constructed past the static "
                f"per-row bound: {over}")
    finally:
        out["segsum_launches"] = segsum.launches - launches0
        config.set_var("tidb_tpu_device", saved)
        devplane.configure_mesh(plane)
        session.close()
        storage.close()
    out["failures"] = failures
    out["passed"] = not failures
    return out


def line(detail: dict) -> dict:
    """bench.py's line around the detail (bench.py:1925-1930)."""
    return {"metric": METRIC, "value": detail.get("families_checked", 0),
            "unit": "families", "detail": detail}


if __name__ == "__main__":
    from tidb_tpu_torch.bench import leg_main
    raise SystemExit(leg_main("lintcheck", sys.argv[1:]))
