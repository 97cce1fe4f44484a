"""External-sort throughput — the benchfilesort equivalent.

Reference: TiDB's cmd/benchfilesort — times util/filesort
building sorted on-disk runs and merging them. Here the subject is
executor/extsort.SpillSorter (the same role: spill-to-disk sort with
bounded memory), timed end-to-end: feed N random rows in chunks, force
runs of `run_rows`, drain the globally sorted stream.

Usage: python -m tidb_tpu_torch.benchmarks.benchfilesort \
    [--rows N] [--run-rows N] [--chunk-rows N] [--key-cols N]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

__all__ = ["run", "main"]


def run(rows: int = 200_000, run_rows: int = 50_000,
        chunk_rows: int = 8192, key_cols: int = 1) -> dict:
    from tidb_tpu_torch.chunk import Chunk, Column
    from tidb_tpu_torch.executor.extsort import SpillSorter
    from tidb_tpu_torch.expression import col
    from tidb_tpu_torch.sqltypes import new_int_field, new_string_field

    rng = np.random.default_rng(42)
    fts = [new_int_field() for _ in range(key_cols)] + [new_string_field()]
    by = [(col(i, fts[i]), i % 2 == 1) for i in range(key_cols)]

    t0 = time.perf_counter()
    sorter = SpillSorter(by, run_rows=run_rows)
    fed = 0
    payload = np.array([f"row-payload-{i % 97}" for i in range(chunk_rows)],
                       dtype=object)
    while fed < rows:
        n = min(chunk_rows, rows - fed)
        cols = [Column(fts[i], rng.integers(0, rows, n),
                       np.ones(n, dtype=bool))
                for i in range(key_cols)]
        cols.append(Column(fts[-1], payload[:n], np.ones(n, dtype=bool)))
        sorter.add(Chunk(cols))
        fed += n
    build_secs = time.perf_counter() - t0

    t0 = time.perf_counter()
    out_rows = 0
    prev = None
    for ch in sorter.sorted_chunks():
        out_rows += ch.num_rows
        first = int(ch.columns[0].data[0])
        if prev is not None and key_cols == 1:
            assert first >= prev, "sort order violated"
        prev = int(ch.columns[0].data[-1])
    drain_secs = time.perf_counter() - t0
    sorter.close()
    assert out_rows == rows

    total = build_secs + drain_secs
    print(f"rows={rows} runs_of={run_rows} build={build_secs:.3f}s "
          f"drain={drain_secs:.3f}s total={total:.3f}s "
          f"({rows / total:.0f} rows/s)", flush=True)
    return {"rows": rows, "build_secs": build_secs,
            "drain_secs": drain_secs, "rows_per_sec": rows / total}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tidb_tpu_torch.benchmarks.benchfilesort")
    p.add_argument("--rows", type=int, default=200_000)
    p.add_argument("--run-rows", type=int, default=50_000)
    p.add_argument("--chunk-rows", type=int, default=8192)
    p.add_argument("--key-cols", type=int, default=1)
    args = p.parse_args(argv)
    run(args.rows, args.run_rows, args.chunk_rows, args.key_cols)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
