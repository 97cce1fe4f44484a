"""SQL workload runner — the benchdb equivalent.

Reference: TiDB's cmd/benchdb/main.go — a job string
("create|truncate|insert:0_10000|update-random:0_10000:100000|
select:0_10000:10|gc") run against a live store, each job timed.
Here jobs run through a Session over the in-process mock storage by
default, or over the out-of-process storage with --addr host:port
(store/remote.py), mirroring the reference's mocktikv-vs-tikv split.

Usage: python -m tidb_tpu_torch.benchmarks.benchdb \
    [--run JOBS] [--table NAME] [--batch N] [--blob N] [--addr H:P]
"""

from __future__ import annotations

import argparse
import random
import time

__all__ = ["run_jobs", "main"]

DEFAULT_JOBS = ("create|truncate|insert:0_10000|"
                "update-random:0_10000:30000|select:0_10000:10|"
                "update-range:5000_5100:1000|select:0_10000:10|gc|"
                "select:0_10000:10")


def _span(spec: str):
    a, _, b = spec.partition("_")
    return int(a), int(b)


class _BenchDB:
    def __init__(self, session, table: str, batch: int, blob: int):
        self.s = session
        self.table = table
        self.batch = batch
        self.blob = blob
        self.rng = random.Random(42)

    def create(self, _spec):
        self.s.execute(
            f"CREATE TABLE IF NOT EXISTS {self.table} "
            "(id BIGINT PRIMARY KEY, k BIGINT, data VARCHAR(4096))")

    def truncate(self, _spec):
        self.s.execute(f"TRUNCATE TABLE {self.table}")

    def _blob(self) -> str:
        return "A" * self.blob

    def insert(self, spec):
        lo, hi = _span(spec)
        ids = list(range(lo, hi))
        for i in range(0, len(ids), self.batch):
            chunk = ids[i:i + self.batch]
            vals = ",".join(f"({j},{j},'{self._blob()}')" for j in chunk)
            self.s.execute(f"INSERT INTO {self.table} VALUES {vals}")

    def update_random(self, spec):
        span, _, count = spec.partition(":")
        lo, hi = _span(span)
        n = int(count)
        for i in range(0, n, self.batch):
            self.s.execute("BEGIN")
            for _ in range(min(self.batch, n - i)):
                j = self.rng.randrange(lo, hi)
                self.s.execute(
                    f"UPDATE {self.table} SET k = k + 1 WHERE id = {j}")
            self.s.execute("COMMIT")

    def update_range(self, spec):
        span, _, count = spec.partition(":")
        lo, hi = _span(span)
        for _ in range(int(count) // max(hi - lo, 1) or 1):
            self.s.execute(f"UPDATE {self.table} SET k = k + 1 "
                           f"WHERE id >= {lo} AND id < {hi}")

    def select(self, spec):
        span, _, count = spec.partition(":")
        lo, hi = _span(span)
        for _ in range(int(count or 1)):
            self.s.query(f"SELECT id, k FROM {self.table} "
                         f"WHERE id >= {lo} AND id < {hi}")

    def query(self, spec):
        sql, _, count = spec.rpartition(":")
        for _ in range(int(count or 1)):
            self.s.query(sql)

    def gc(self, _spec):
        from tidb_tpu_torch.store.gcworker import GCWorker
        w = GCWorker(self.s.storage, gc_life_time_ms=0)
        w.run_once()


_JOBS = {"create": _BenchDB.create, "truncate": _BenchDB.truncate,
         "insert": _BenchDB.insert, "update-random": _BenchDB.update_random,
         "update_random": _BenchDB.update_random,
         "update-range": _BenchDB.update_range,
         "update_range": _BenchDB.update_range,
         "select": _BenchDB.select, "query": _BenchDB.query,
         "gc": _BenchDB.gc}


def run_jobs(session, jobs: str, table: str = "benchdb",
             batch: int = 100, blob: int = 1000) -> list[tuple]:
    """-> [(job, seconds)]; each job timed like the reference's runJobs."""
    db = _BenchDB(session, table, batch, blob)
    out = []
    for work in jobs.split("|"):
        work = work.strip()
        name, _, spec = work.partition(":")
        name = name.lower()      # job names only: query: SQL keeps case
        fn = _JOBS.get(name)
        if fn is None:
            raise ValueError(f"unknown job {name!r}")
        t0 = time.perf_counter()
        fn(db, spec)
        dt = time.perf_counter() - t0
        out.append((work, dt))
        print(f"{work}: {dt:.3f}s", flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tidb_tpu_torch.benchmarks.benchdb")
    p.add_argument("--run", default=DEFAULT_JOBS)
    p.add_argument("--table", default="benchdb")
    p.add_argument("--batch", type=int, default=100)
    p.add_argument("--blob", type=int, default=1000)
    p.add_argument("--addr", default=None,
                   help="host:port of an out-of-process storage node")
    p.add_argument("--device", default="cuda",
                   help="torch device of the storage and its kernels "
                        "(default cuda; cpu runs the host path)")
    args = p.parse_args(argv)
    from tidb_tpu_torch.session import Session
    if args.addr:
        from tidb_tpu_torch.store.remote import connect
        host, _, port = args.addr.rpartition(":")
        storage = connect(host or "127.0.0.1", int(port), device=args.device)
    else:
        from tidb_tpu_torch.store.storage import new_mock_storage
        storage = new_mock_storage(device=args.device)
    s = Session(storage)
    s.execute("CREATE DATABASE IF NOT EXISTS bench")
    s.execute("USE bench")
    run_jobs(s, args.run, args.table, args.batch, args.blob)
    s.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
