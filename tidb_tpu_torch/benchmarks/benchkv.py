"""Txn / raw KV throughput tool.

Reference: TiDB's cmd/benchkv/main.go:122-140 (batchRW
measuring transactional set+get round trips against a live cluster) and
cmd/benchraw (the raw-KV variant). Drives the same code paths a SQL
workload uses — 2PC with region batching for txn mode, region-routed
raw ops for raw mode — against the in-process store or an
out-of-process storage server (--addr host:port).

    python -m tidb_tpu_torch.benchmarks.benchkv --keys 20000 --batch 200
    python -m tidb_tpu_torch.benchmarks.benchkv --mode raw --workers 8
"""

from __future__ import annotations

import argparse
import json
import threading
import time


def _run_txn(storage, keys: int, batch: int, worker_id: int) -> None:
    for lo in range(0, keys, batch):
        txn = storage.begin()
        for i in range(lo, min(lo + batch, keys)):
            txn.set(b"bench_w%d_k%08d" % (worker_id, i), b"v%d" % i)
        txn.commit()
    for lo in range(0, keys, batch):
        txn = storage.begin()
        for i in range(lo, min(lo + batch, keys)):
            assert txn.get(b"bench_w%d_k%08d" % (worker_id, i)) is not None
        txn.rollback()


def _run_raw(storage, keys: int, batch: int, worker_id: int) -> None:
    from tidb_tpu_torch.store.rawkv import RawKVClient
    c = RawKVClient(storage)
    for lo in range(0, keys, batch):
        c.batch_put([(b"bench_w%d_k%08d" % (worker_id, i), b"v%d" % i)
                     for i in range(lo, min(lo + batch, keys))])
    for lo in range(0, keys, batch):
        got = c.batch_get([b"bench_w%d_k%08d" % (worker_id, i)
                           for i in range(lo, min(lo + batch, keys))])
        assert len(got) == min(lo + batch, keys) - lo


def run(storage, mode: str = "txn", keys: int = 10000, batch: int = 100,
        workers: int = 1) -> dict:
    fn = _run_txn if mode == "txn" else _run_raw
    t0 = time.perf_counter()
    if workers == 1:
        fn(storage, keys, batch, 0)
    else:
        errors: list[BaseException] = []

        def guarded(w: int) -> None:
            try:
                fn(storage, keys, batch, w)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors.append(e)

        ts = [threading.Thread(target=guarded, args=(w,))
              for w in range(workers)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        if errors:       # a failed worker must fail the benchmark
            raise errors[0]
    dt = time.perf_counter() - t0
    total_ops = keys * workers * 2          # one write + one read per key
    return {"metric": f"benchkv_{mode}_ops_per_sec",
            "value": round(total_ops / dt, 1), "unit": "ops/s",
            "keys": keys, "batch": batch, "workers": workers,
            "elapsed_s": round(dt, 3)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mode", choices=("txn", "raw"), default="txn")
    p.add_argument("--keys", type=int, default=10000)
    p.add_argument("--batch", type=int, default=100)
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--addr", help="host:port of an out-of-process "
                                  "storage server (default: in-process)")
    p.add_argument("--regions", type=int, default=4,
                   help="pre-split the keyspace (in-process only)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the storage and its kernels "
                        "(default cuda; cpu runs the host path)")
    args = p.parse_args(argv)
    if args.addr:
        from tidb_tpu_torch.store.remote import connect
        host, port = args.addr.rsplit(":", 1)
        storage = connect(host, int(port), device=args.device)
    else:
        from tidb_tpu_torch.store.storage import new_mock_storage
        storage = new_mock_storage(device=args.device)
        for w in range(args.workers):
            for i in range(1, args.regions):
                try:
                    storage.cluster.split(
                        b"bench_w%d_k%08d" %
                        (w, i * args.keys // args.regions))
                except ValueError:
                    pass
    print(json.dumps(run(storage, args.mode, args.keys, args.batch,
                         args.workers)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
