"""The kernel-profiling leg: the port's counterpart of the JAX package's
`python bench.py profile` (`_profile_bench`, `profile_main`).

Warm TPC-H Q1, Q3 and Q5 under the continuous kernel profiler, with a
plane of one shard per visible device (`devplane.enable_mesh()`; the
reference's `parallel.config.enable_mesh()`). The leg records failures
unless the profiler saw the run: `information_schema.kernel_profile`
populated with dispatches, `roofline_fraction` on every row that moved
bytes, the compile counts flat across the warm iterations (in the port a
compile is a kernel object constructed, `profiler.py`'s `compiles`), and
every `statement_profile` memo row carrying the mode that ran.
"""

from __future__ import annotations

__all__ = ["METRIC", "run", "line"]

METRIC = "profile_bench_kernel_profiles"


def run(progress=None, sf: float = 0.02, iters: int = 3, seed: int = 42,
        device="cuda") -> dict:
    """-> the line's detail: `failures` (a list of messages) and
    `passed`. Restores `tidb_tpu_device` and the process's plane."""
    from tidb_tpu_torch import config, devplane, profiler
    from tidb_tpu_torch.benchmarks import tpch
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.store.storage import new_mock_storage
    progress = progress or (lambda msg: None)
    data = tpch.ScaledTpch(sf, seed)
    storage = new_mock_storage(device=device)
    session = Session(storage)
    saved = config.get_var("tidb_tpu_device")
    plane = devplane.active_mesh()
    out: dict = {"sf": sf, "iters": iters}
    failures: list[str] = []
    try:
        session.execute("CREATE DATABASE tpch_profile")
        session.execute("USE tpch_profile")
        progress(f"profile: loading sf={sf}")
        tpch.load(session, storage, data, regions_per_table=2)
        queries = [tpch.QUERIES[q] for q in ("q1", "q3", "q5")]
        config.set_var("tidb_tpu_device", 1)
        devplane.enable_mesh(device=device)
        profiler.reset_for_tests()
        progress("profile: cold runs (kernel construction + cache fill)")
        for sql in queries:
            session.query(sql)

        def total_compiles() -> int:
            return sum(p["compiles"] for p in profiler.snapshot())

        compiles_after_cold = total_compiles()
        progress(f"profile: {iters} warm iterations per query")
        compile_track = []
        for _ in range(iters):
            for sql in queries:
                session.query(sql)
            compile_track.append(total_compiles())
        out["compiles_after_cold"] = compiles_after_cold
        out["compiles_per_warm_iter"] = compile_track
        if compile_track and compile_track[-1] > compile_track[0]:
            failures.append(f"compile counts grew across warm iterations: "
                            f"{compile_track} (warm runs must ride the "
                            f"caches)")

        rows = session.query(
            "SELECT family, compiles, dispatches, busy_ns, bytes_in, "
            "roofline_fraction FROM information_schema.kernel_profile").rows
        out["kernel_profile_rows"] = len(rows)
        out["kernel_profile_families"] = sorted({r[0] for r in rows})
        if not rows or not any(r[2] for r in rows):
            failures.append(f"kernel_profile unpopulated after {iters} "
                            f"warm iterations: {rows!r}")
        missing_roof = [r[0] for r in rows if r[2] and r[4] and r[5] is None]
        if missing_roof:
            failures.append(f"rows with dispatches+bytes but no "
                            f"roofline_fraction: {missing_roof}")

        memo = session.query(
            "SELECT digest, op, mode, runs, device_ns FROM "
            "information_schema.statement_profile").rows
        out["statement_profile_rows"] = len(memo)
        out["statement_profile_modes"] = sorted({m[2] for m in memo})
        if not memo:
            failures.append("statement_profile memo is empty after a warm "
                            "TPC-H sweep")
        bad_mode = [(m[0][:8], m[1]) for m in memo if not m[2]]
        if bad_mode:
            failures.append(f"memo rows missing mode: {bad_mode}")

        gbps, src = profiler.platform_peak_gbps()
        out["roofline"] = {"peak_gbps": gbps, "source": src}
        out["profiler_stats"] = profiler.stats()
    finally:
        config.set_var("tidb_tpu_device", saved)
        devplane.configure_mesh(plane)
        session.close()
        storage.close()
    out["failures"] = failures
    out["passed"] = not failures
    return out


def line(detail: dict) -> dict:
    """bench.py's line around the detail (bench.py:1760-1766)."""
    return {"metric": METRIC, "value": detail.get("kernel_profile_rows", 0),
            "unit": "profiles", "detail": detail}


if __name__ == "__main__":
    import sys
    from tidb_tpu_torch.bench import leg_main
    raise SystemExit(leg_main("profile", sys.argv[1:]))
