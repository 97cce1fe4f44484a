"""Raw KV throughput — the benchraw equivalent.

Reference: TiDB's cmd/benchraw/main.go — parallel batch puts/
gets/deletes against the raw KV API, reporting elapsed time. Runs
against the in-process mock storage by default or an out-of-process
node with --addr (the reference's live-TiKV mode).

Usage: python -m tidb_tpu_torch.benchmarks.benchraw \
    [--num N] [--batch N] [--value-size N] [--workers N] [--addr H:P]
"""

from __future__ import annotations

import argparse
import time
from concurrent.futures import ThreadPoolExecutor

__all__ = ["run", "main"]


def run(storage, num: int = 10000, batch: int = 128,
        value_size: int = 64, workers: int = 4) -> dict:
    from tidb_tpu_torch.store.rawkv import RawKVClient
    client = RawKVClient(storage)
    val = b"v" * value_size
    keys = [b"raw_%010d" % i for i in range(num)]
    batches = [keys[i:i + batch] for i in range(0, num, batch)]

    def timed(name, fn):
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=workers) as ex:
            list(ex.map(fn, batches))
        dt = time.perf_counter() - t0
        print(f"{name}: {num} keys in {dt:.3f}s "
              f"({num / dt:.0f} ops/s)", flush=True)
        return dt

    out = {
        "put_secs": timed("batch_put", lambda ks: client.batch_put(
            [(k, val) for k in ks])),
        "get_secs": timed("batch_get", client.batch_get),
        "delete_secs": timed(
            "delete", lambda ks: [client.delete(k) for k in ks]),
    }
    out["num"] = num
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tidb_tpu_torch.benchmarks.benchraw")
    p.add_argument("--num", type=int, default=10000)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--value-size", type=int, default=64)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--addr", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device of the storage and its kernels "
                        "(default cuda; cpu runs the host path)")
    args = p.parse_args(argv)
    if args.addr:
        from tidb_tpu_torch.store.remote import connect
        host, _, port = args.addr.rpartition(":")
        storage = connect(host or "127.0.0.1", int(port), device=args.device)
    else:
        from tidb_tpu_torch.store.storage import new_mock_storage
        storage = new_mock_storage(device=args.device)
    run(storage, args.num, args.batch, args.value_size, args.workers)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
