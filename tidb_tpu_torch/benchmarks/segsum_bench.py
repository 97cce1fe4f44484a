"""Device times of the segment-sum kernel at the main path's shapes.

    python -m tidb_tpu_torch.benchmarks.segsum_bench [--baseline DIR]

Two shapes, both Q1's stacked call (2^18 rows x 12 int64 lanes, a
per-lane mask, C = 4096):
  q1      the inputs of Q1's own segment_sum calls, captured from the
          port's Q1 kernel over generated lineitem superchunks: six live
          slots and about 1.4 % of rows at slot C-1 (the filtered rows)
  spread  the same values and masks with ids uniform over [0, C), a
          stand-in for a hashed group table
`record_calls` captures the calls of any run the same way; chip_smoke.py
uses it to hold and time the kernel at each shape the Q1, Q3 and Q5
paths give it.
Inputs rotate over four superchunks, so the working set exceeds the
50 MB L2 (a superchunk arrives cold). Device time per call comes from
torch.profiler's device events (the kernel's own, and all device work of
a call for the plain version and index_add_), or from CUDA events around
each call where the profiler delivers no device record; host time per
call is the host clock around the same calls, with no synchronisation
inside.

`--baseline DIR` loads tidb_tpu_torch/ops/segsum.py of another checkout
of the repository (for example the parent commit, unpacked with `git
archive`) as a module of its own, which builds that checkout's kernel
into its own _build/, and times its segment_sum against this tree's in
turns (baseline, kernel, kernel, baseline) in one process. Each line of
output is one JSON object. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12        # HBM3, NVIDIA H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12       # non-tensor-core fp32; no int64 peak given
Q1_SUPERCHUNK = 1 << 18
ROUNDS = 2                        # turns of (baseline, kernel, kernel, baseline)


class record_calls:
    """While active, records the calls of ops/segsum.segment_sum by shape:
    shapes[(rows, lanes, C, dtype, mask mode)] = {"calls": count,
    "inputs": clones of the (values, ids, valid, C) of the first `keep`
    calls}, the inputs time_shape takes. The clones are enqueued on the
    inputs' stream and add no host sync. Calls may come from several
    threads (the coprocessor's pool)."""

    def __init__(self, keep: int = 4):
        self.keep = keep
        self.shapes: dict = {}
        self._real = None
        self._mu = threading.Lock()

    def __enter__(self):
        from tidb_tpu_torch.ops import segsum
        self._real = real = segsum.segment_sum

        def spy(values, ids, num_segments, valid=None):
            mode = "none" if valid is None else \
                "lane" if valid.shape == values.shape else "row"
            key = (*values.shape, num_segments,
                   str(values.dtype).removeprefix("torch."), mode)
            with self._mu:
                ent = self.shapes.setdefault(key, {"calls": 0, "inputs": []})
                ent["calls"] += 1
                if len(ent["inputs"]) < self.keep:
                    ent["inputs"].append((
                        values.clone(), ids.clone(),
                        None if valid is None else valid.clone(),
                        num_segments))
            return real(values, ids, num_segments, valid)
        segsum.segment_sum = spy
        return self

    def __exit__(self, *exc):
        from tidb_tpu_torch.ops import segsum
        segsum.segment_sum = self._real
        return False

    def calls(self) -> int:
        return sum(ent["calls"] for ent in self.shapes.values())


def q1_inputs(dev, count: int = 4, seed: int = 42):
    """Captures the (values, ids, valid, C) of Q1's segment_sum call on
    `count` generated lineitem superchunks of 2^18 rows."""
    from tidb_tpu_torch.benchmarks import tpch
    from tidb_tpu_torch.ops.hashagg import kernel_for
    d = tpch.ScaledTpch(0.05 * count, seed)
    chunks = tpch.lineitem_chunks(d, Q1_SUPERCHUNK)[:count]
    kernel = kernel_for(*tpch.q1_plan(), device=dev)
    with record_calls(keep=count) as rec:
        for c in chunks:
            kernel.finalize(c, kernel.dispatch(c))
    if len(rec.shapes) != 1 or rec.calls() != count:
        raise AssertionError(f"expected one segment_sum call per superchunk "
                             f"at one shape, saw {list(rec.shapes)}")
    (ent,) = rec.shapes.values()
    return ent["inputs"]


def spread_inputs(inputs, seed: int = 7):
    """The same calls with ids uniform over [0, C)."""
    rng = np.random.default_rng(seed)
    out = []
    for v, ids, m, c in inputs:
        u = torch.from_numpy(rng.integers(0, c, ids.shape[0])
                             .astype(np.int32)).to(ids.device)
        out.append((v, u, m, c))
    return out


def id_profile(inputs) -> dict:
    """Live slots and the share of rows at slot C-1 over the inputs."""
    # lint: exempt[device-sync] bench harness, off the pipeline: the recorded ids are profiled on the host once, before any timing
    ids = torch.cat([i for _v, i, _m, _c in inputs]).cpu().numpy()
    c = inputs[0][3]
    return {"live_slots": int(np.unique(ids).size),
            "share_at_c_minus_1": float(np.mean(ids == c - 1))}


def _device_us(event) -> float:
    us = getattr(event, "self_device_time_total", None)
    if us is None:
        us = getattr(event, "self_cuda_time_total", 0)
    return us


def event_ms(fn, inputs, iters: int = 40) -> float:
    """Device time per call of fn(*x), rotating over `inputs`, from a pair
    of CUDA events around each call: the whole call, with no idle time
    between calls in it."""
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for i, (start, end) in enumerate(pairs):
        start.record()
        fn(*inputs[i % len(inputs)])
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in pairs) / iters


def device_ms(fn, inputs, iters: int = 40, warmup: int = 4,
              match: str | None = None) -> float:
    """Device time per call of fn(*x), rotating over `inputs`, from
    torch.profiler: the device events whose name holds `match`, or every
    device event when `match` is None. A window in which the profiler
    delivered no device record at all (it happens: CUPTI's buffer request
    shows, the kernels' records do not) is profiled again, at most twice;
    after that the call is timed with CUDA events (event_ms), which for a
    `match` is the whole call's time, an upper bound, and says so on
    stderr."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(warmup):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    for _attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(*inputs[i % len(inputs)])
            torch.cuda.synchronize()
        # per call: each device event's mean time times its launches per
        # call, so a record the profiler dropped does not shrink the mean
        total, seen = 0.0, []
        for e in prof.key_averages():
            on_device = getattr(e, "device_type", None) is not None and \
                "CUDA" in str(e.device_type)
            seen.append(e.key[:60])
            if on_device and e.count and (match is None or match in e.key):
                total += _device_us(e) / e.count * max(1, round(
                    e.count / iters))
        if total > 0:
            return total / 1e3
    print(f"segsum_bench: the profiler saw no device time"
          f"{'' if match is None else ' for ' + match} ({seen}); "
          "timed with CUDA events instead", file=sys.stderr, flush=True)
    return event_ms(fn, inputs, iters)


def host_ms(fn, inputs, iters: int = 40, warmup: int = 4) -> float:
    """Host time per call of fn(*x): wrapper plus launch, no sync."""
    for i in range(warmup):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


def bound(n: int, k: int, c: int, elem: int, mask_bytes: int) -> dict:
    """Least time of the call on an H100 SXM: each input byte read once,
    each output byte written once, one add per (row, lane)."""
    nbytes = n * (4 + k * elem + mask_bytes) + c * k * elem
    by_bytes = nbytes / H100_BYTES_PER_S * 1e3
    by_ops = n * k / H100_FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes}


def parity_error(got, v, i, c, m) -> tuple[float, bool]:
    """`got` against segment_sum_plain on the same inputs -> (max abs
    error, within tolerance): int64 exactly (two's-complement wrap
    included); float64 within 1e-12 and float32 within 1e-5 of each
    segment's sum of |v| (atomic order varies from run to run)."""
    from tidb_tpu_torch.ops import segsum
    want = segsum.segment_sum_plain(v, i, c, valid=m)
    if not v.dtype.is_floating_point:
        return (0 if torch.equal(got, want) else
                (got - want).abs().max().item()), torch.equal(got, want)
    if not torch.isfinite(got).all():
        return float("inf"), False
    scale = segsum.segment_sum_plain(torch.nan_to_num(v).abs(), i, c,
                                     valid=m)
    rtol = 1e-5 if v.dtype == torch.float32 else 1e-12
    err = (got - want).abs()
    return err.max().item(), not bool((err > rtol * scale + 1e-30).any())


def time_kernel(mod, inputs) -> dict:
    """`mod.segment_sum` (this tree's ops/segsum or a baseline's) at one
    shape: the kernel's own device time, the device time of the whole
    call with its zeroed output, and host time per call. The call is
    first held against the plain version (parity_error)."""

    def kern(v, i, m, c):
        return mod.segment_sum(v, i, c, valid=m)
    v, i, m, c = inputs[0]
    if not parity_error(kern(v, i, m, c), v, i, c, m)[1]:
        raise AssertionError(f"{mod.__name__}.segment_sum disagrees with "
                             "the plain version")
    return {"kernel_ms": device_ms(kern, inputs, match="segsum_kernel"),
            "call_device_ms": device_ms(kern, inputs),
            "host_ms_per_call": host_ms(kern, inputs)}


def time_shape(inputs) -> dict:
    """This tree's kernel (time_kernel), plain version and index_add_ at
    one shape, with the launch plan and the bound."""
    from tidb_tpu_torch.ops import segsum
    v0, _i, m0, c = inputs[0]
    n, k = v0.shape
    mode = 0 if m0 is None else (2 if m0.shape == v0.shape else 1)
    plan = segsum.plan_for(v0.dtype, c, k, mode, v0.device)

    def plain(v, i, m, c):
        return segsum.segment_sum_plain(v, i, c, valid=m)
    lib_inputs = [(torch.where(m, v, 0) if m is not None else v, i.long(),
                   torch.zeros((c, k), dtype=v.dtype, device=v.device))
                  for v, i, m, c in inputs]

    def library(v, i, out):
        return out.index_add_(0, i, v)
    mask_bytes = 0 if m0 is None else m0[0].numel()
    return {"shape": [n, k, c], "dtype": str(v0.dtype).removeprefix(
                "torch."), "mask": ["none", "row", "lane"][mode],
            "plan": {"variant": plan.variant, "window": plan.window,
                     "tile": plan.tile, "threads": plan.threads,
                     "blocks_per_sm": plan.blocks_per_sm,
                     "smem": plan.smem, "grid": plan.grid(n)},
            **time_kernel(segsum, inputs),
            "plain_ms": device_ms(plain, inputs),
            "library_ms": device_ms(library, lib_inputs),
            **bound(n, k, c, v0.element_size(), mask_bytes),
            **id_profile(inputs)}


def sass_atomics(lib: Path) -> dict | None:
    """Atomic instructions per kernel variant in a built library's SASS
    (cuobjdump -sass), or None where the toolkit has no cuobjdump."""
    import os
    import re
    import subprocess
    from tidb_tpu_torch.ops import segsum
    cuobjdump = os.path.join(os.path.dirname(segsum._nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        return None
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    counts: dict = {}
    fn = None
    for line in sass.splitlines():
        if "Function :" in line:
            e = re.search(r"segsum_kernelI([fdx])Li(\d)E", line)
            fn = None if e is None else (
                f"{segsum._DTYPE_OF[e.group(1)]}/mask{e.group(2)}")
            continue
        for word in line.replace(";", " ").split():
            if fn and word.startswith(("ATOMS.", "ATOM.", "ATOMG.", "RED.",
                                       "REDG.")):
                per = counts.setdefault(fn, {})
                per[word] = per.get(word, 0) + 1
    return counts


def load_baseline(root: Path):
    """tidb_tpu_torch/ops/segsum.py of the checkout at `root`, loaded as a
    module of its own; it builds its kernel into that checkout's
    _build/ and keeps its own launch count."""
    path = root / "tidb_tpu_torch" / "ops" / "segsum.py"
    spec = importlib.util.spec_from_file_location("baseline_segsum", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path,
                    help="another checkout whose segment_sum is timed in "
                    "turns with this one")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("segsum_bench: no CUDA device available", file=sys.stderr)
        return 1
    from tidb_tpu_torch.ops import segsum
    dev = torch.device("cuda", 0)
    segsum.build()
    q1 = q1_inputs(dev)
    shapes = {"q1": q1, "spread": spread_inputs(q1)}
    base = None
    if args.baseline:
        base = load_baseline(args.baseline)
        print(json.dumps({"baseline": str(args.baseline), "sass_atomics":
                          sass_atomics(base.build())}), flush=True)
    for r in range(ROUNDS):
        for name, inputs in shapes.items():
            order = ["baseline", "kernel", "kernel", "baseline"]
            for who in order:
                if who == "baseline":
                    if base is None:
                        continue
                    res = time_kernel(base, inputs)
                else:
                    res = time_shape(inputs)
                print(json.dumps({"round": r, "cell": name, "kernel": who,
                                  **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
