"""Device synchronization discipline: the torch spellings of the
block_until_ready ban (a stream or device wait on the hot path) and of
its generalization to every other way of forcing a device value onto
the host."""

from __future__ import annotations

import ast

from tidb_tpu_torch.lint.engine import Finding, Rule, register_rule
from tidb_tpu_torch.lint.flow.device import (device_flow_of,
                                             is_host_method_call)

_PROFILER = "tidb_tpu_torch/runtime_stats.py"
# the sanctioned timing helpers: the gated profiler, and the kernel
# benches that time launches between CUDA events on purpose
_TIMING = (_PROFILER, "tidb_tpu_torch/benchmarks/segsum_bench.py",
           "tidb_tpu_torch/benchmarks/programs_bench.py")
# the sanctioned output boundaries besides functions named finalize:
# the one packed readback each kernel's finalize goes through
BOUNDARY_HELPERS = frozenset({"_readback"})


@register_rule("hot-path-sync")
class HotPathSyncRule(Rule):
    """torch.cuda.synchronize / Stream.synchronize / Event.synchronize
    appear nowhere in the package except the sanctioned timing helpers
    (runtime_stats.py's gated profiling path and the kernel benches).

    The dispatch-ahead pipeline's whole win is that superchunk k+1
    transfers while k executes; ONE stray synchronize on the hot path
    drains the stream and silently erases the overlap. Syncs at
    operator output boundaries copy the result (`.cpu()` in a
    finalize), which is visible in review precisely because it returns
    the data. Matched as Name, Attribute, or string constant, so
    aliased imports and getattr(torch.cuda, "synchronize") are all
    caught.
    """

    min_sites = 1       # the sanctioned profiling site must still exist
    fixture = (
        "import torch\n"
        "def f(out):\n"
        "    torch.cuda.synchronize()\n"
        "    return out\n"
    )

    def check(self, forest):
        for pf in forest:
            for node in pf.nodes:
                hit = (isinstance(node, ast.Attribute) and
                       node.attr == "synchronize") or \
                      (isinstance(node, ast.Name) and
                       node.id == "synchronize") or \
                      (isinstance(node, ast.Constant) and
                       node.value == "synchronize")
                if not hit:
                    continue
                if pf.rel in _TIMING:
                    self.sites += 1     # sanctioned: timing owns it
                    continue
                yield Finding(
                    pf.rel, node.lineno, self.name,
                    "synchronize on the hot path (copy the result at an "
                    "output boundary, or time through "
                    "runtime_stats.device_call for gated profiling)")


@register_rule("device-sync")
class DeviceSyncRule(Rule):
    """Tensors are materialized on the host only in finalize() helpers
    (or the gated profiler): no stray .item() / .cpu() / .tolist() /
    .numpy() / .to("cpu") / np.asarray on a tensor mid-pipeline.

    Every kernel is split into async dispatch() and blocking finalize()
    so transfers overlap execution; a device->host copy anywhere else
    reintroduces a serialization point invisible to the pipeline.
    Matched: those calls where the receiver (np.asarray's argument) is
    provably a tensor — bound from a torch call, a tensor method, or
    arithmetic over one (numpy arrays and Python scalars never match).
    Sanctioned: functions named finalize, the packed readback helper
    they share (`_readback`), and runtime_stats.py.
    """

    min_sites = 1       # the finalize() readbacks must still exist
    fixture = (
        "import torch\n"
        "def step(cols):\n"
        "    total = torch.sum(cols)\n"
        "    return total.item()\n"
    )

    def check(self, forest):
        df = device_flow_of(forest)
        for pf in forest:
            if pf.rel == _PROFILER:
                continue
            for node in pf.nodes:
                if not isinstance(node, ast.Call):
                    continue
                kind = self._sync_kind(df, pf.rel, node)
                if kind is None:
                    continue
                self.sites += 1
                fi = df.enclosing_function(pf.rel, node)
                name = fi.node.name if fi is not None else ""
                if name == "finalize" or name in BOUNDARY_HELPERS:
                    continue            # sanctioned output boundary
                yield Finding(
                    pf.rel, node.lineno, self.name,
                    f"{kind} on a tensor outside a finalize() helper "
                    f"forces a device->host sync mid-pipeline — move it "
                    f"to the kernel's finalize() output boundary")

    @staticmethod
    def _sync_kind(df, rel, call) -> str | None:
        kind = is_host_method_call(call)
        fn = call.func
        if kind is not None:
            recv = fn.value
        elif isinstance(fn, ast.Attribute) and \
                fn.attr in ("asarray", "array") and \
                isinstance(fn.value, ast.Name) and \
                fn.value.id in ("np", "numpy") and call.args:
            kind, recv = f"{fn.value.id}.{fn.attr}", call.args[0]
        else:
            return None
        fi = df.enclosing_function(rel, call)
        if fi is None or not df.tensors(fi).is_tensor(recv):
            return None
        return kind
