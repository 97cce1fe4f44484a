"""Device times of the torch programs on the Q3/Q5 path, at the shapes
that path gives them.

The sort-join matcher (`JoinKernel._program`), the fused probe -> partial
agg fragment (`ProbeAggKernel._kernel`) and the hash aggregation over
joined rows (`HashAggKernel._kernel`, whose hashed group ids reach the
segment-sum kernel spread over the table) are torch ops, not hand
kernels. `capture` records, while a query runs, how often each program
is called at each input shape and the arguments of the first call;
`time_program` then replays those arguments: device time per call and
device kernels per call from torch.profiler, the wall time on the
device's stream per call from CUDA events, and the least time the call
could take on an H100 SXM (each input byte read once, each output byte
written once, at 3.35 TB/s). Used by chip_smoke.py; needs a CUDA card.
"""

from __future__ import annotations

import torch

from tidb_tpu_torch.benchmarks.segsum_bench import H100_BYTES_PER_S, _device_us

__all__ = ["capture", "time_program", "PROGRAMS"]


def _lane_shape(lanes) -> int:
    return next(d.shape[0] for lane in lanes if lane is not None
                for d in lane[:1])


# program -> (class path, method, shape of a call's arguments)
PROGRAMS = {
    "JoinKernel._program (sort-join matcher)":
        ("tidb_tpu_torch.ops.join", "JoinKernel", "_program",
         lambda bkeys, pkeys, nb, np_, out_cap:
         (_lane_shape(bkeys), _lane_shape(pkeys), out_cap)),
    "ProbeAggKernel._kernel (fused probe -> partial agg)":
        ("tidb_tpu_torch.ops.fragment", "ProbeAggKernel", "_kernel",
         lambda bkeys, pkeys, pcols, bcols, nb, np_, out_cap:
         (_lane_shape(bkeys), _lane_shape(pkeys), out_cap)),
    "HashAggKernel._kernel (hash agg over joined rows)":
        ("tidb_tpu_torch.ops.hashagg", "HashAggKernel", "_kernel",
         lambda cols, nrows: (_lane_shape(cols),)),
}


class capture:
    """While active, records per program and per argument shape the number
    of calls and the (kernel object, arguments) of the first call."""

    def __init__(self):
        self.calls: dict = {}     # (program, shape) -> [obj, args, count]
        self._saved = []

    def __enter__(self):
        import importlib
        for name, (mod, cls_name, meth, shape_of) in PROGRAMS.items():
            cls = getattr(importlib.import_module(mod), cls_name)
            orig = getattr(cls, meth)

            def spy(obj, *args, _orig=orig, _name=name, _shape=shape_of):
                ent = self.calls.setdefault((_name, _shape(*args)),
                                            [obj, args, 0])
                ent[2] += 1
                return _orig(obj, *args)
            self._saved.append((cls, meth, orig))
            setattr(cls, meth, spy)
        return self

    def __exit__(self, *exc):
        for cls, meth, orig in self._saved:
            setattr(cls, meth, orig)
        return False

    def most_called(self, per_program: int = 2):
        """-> [(program, shape, obj, args, calls)], the `per_program` most
        called shapes of each program."""
        out = []
        for name in PROGRAMS:
            ents = sorted(((shape, *ent) for (n, shape), ent
                           in self.calls.items() if n == name),
                          key=lambda e: -e[3])
            out += [(name, shape, obj, args, count)
                    for shape, obj, args, count in ents[:per_program]]
        return out


def _tensor_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(t) for t in tree if t is not None)
    return 0


def time_program(program: str, obj, args, iters: int = 10) -> dict:
    """Replays one captured call: profiler device time and device kernels
    per call, CUDA-event time per call, bytes moved and the bound."""
    from torch.profiler import ProfilerActivity, profile
    _mod, _cls, meth, _shape = PROGRAMS[program]
    fn = getattr(type(obj), meth)
    out = fn(obj, *args)
    in_bytes = _tensor_bytes(args)
    nbytes = in_bytes + _tensor_bytes(out)
    for _ in range(2):
        fn(obj, *args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(obj, *args)
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn(obj, *args)
        torch.cuda.synchronize()
    busy_us, kernels = 0.0, 0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) is not None and \
                "CUDA" in str(e.device_type) and e.count:
            busy_us += _device_us(e)
            kernels += e.count
    return {"device_ms": busy_us / 1e3 / iters,
            "device_kernels_per_call": kernels / iters,
            "event_ms": event_ms, "bytes": nbytes,
            "bound_ms": nbytes / H100_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}
