"""Cold TPC-H Q1 from the mock TiKV store, with and without the native
decoder's string kind.

    python -m tidb_tpu_torch.benchmarks.store_decode_bench [--sf 1]
        [--seed 42] [--device cuda]

The port's native/codec.cc decodes CHAR/VARCHAR columns (its byte-string
kind); the JAX package's declines any row set with a string column, so
there every lineitem scan takes the per-datum Python decoder. This bench
loads ScaledTpch(--sf, --seed) into one store (lineitem in 4 regions)
and runs run_q1_store cold three times, in turns: native, Python,
native. "Python" makes the port's native decoder decline string columns
as the JAX package's does; each cold run starts from empty chunk and HBM
caches. Every run's rows must equal tpch.q1_truth. Each line of output
is one JSON object: the card's name and power limit as nvidia-smi gives
them, the load's seconds, then per run its decoder, seconds and rows/s.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time

import torch


@contextlib.contextmanager
def strings_in_python():
    """The JAX package's decoder rule: any string column sends the whole
    row set to the Python decoder."""
    from tidb_tpu_torch import native
    real = native.decode_rows_native

    def declining(kvrows, col_specs):
        if any(s[1] == native.NATIVE_KIND_BYTES for s in col_specs):
            return None
        return real(kvrows, col_specs)

    native.decode_rows_native = declining
    try:
        yield
    finally:
        native.decode_rows_native = real


def nvidia_smi() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not available"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("store_decode_bench: no CUDA device available",
              file=sys.stderr)
        return 1
    from tidb_tpu_torch.benchmarks import tpch
    from tidb_tpu_torch.executor.agg import run_q1_store
    from tidb_tpu_torch.store.storage import new_mock_storage
    print(json.dumps({"card": nvidia_smi()}), flush=True)
    d = tpch.ScaledTpch(args.sf, args.seed)
    truth = tpch.q1_truth(d)
    storage = new_mock_storage(device=args.device)
    t0 = time.perf_counter()
    tpch.load_store(storage, d)
    print(json.dumps({"sf": args.sf, "lineitem_rows": d.counts["lineitem"],
                      "load_s": time.perf_counter() - t0}), flush=True)
    try:
        for decoder in ("native", "python", "native"):
            storage.chunk_cache.clear()
            storage.device_cache.shed()
            with (strings_in_python() if decoder == "python"
                  else contextlib.nullcontext()):
                res = run_q1_store(device=args.device, storage=storage)
            if res.rows != truth:
                raise AssertionError(f"{decoder}: rows differ from the "
                                     "truth")
            print(json.dumps({"decoder": decoder, "cold_s": res.seconds,
                              "rows_per_s": d.counts["lineitem"] /
                              res.seconds}), flush=True)
    finally:
        storage.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
