"""Per-operator runtime statistics: the RuntimeStatsColl analogue.

The port's copy of the JAX package's runtime_stats.py, the parts the
coprocessor and the streaming handler call: a `StatsCollector` lives for
one statement, `collecting()` installs it on a thread (the coprocessor
re-installs it in every pool worker, like the sysvar overlay), and the
`note_*` call sites record cop tasks, superchunks, fallbacks (also
counted on `tidb_tpu_device_fallback_total{op,reason}`), encoding and
execution modes, bytes touched (also the tenant meter's bytes ledger)
and the kernel-profile feed (`note_kernel`, called from
profiler.note_dispatch) against the issuing plan node.

Device time is recorded only for a collector made with `device=True`
(the reference builds it so under `tidb_tpu_runtime_stats_device`, a
sysvar the port's session does not have: EXPLAIN ANALYZE, which reads
it, is not ported):
`device_section` records a CUDA event pair around the region and waits
for the second (where the reference calls `jax.block_until_ready`), so
timing serializes the reader with the card. `device_watermark` reads
`torch.cuda.memory_stats`.

Left out, with the executor tree, the session and the profiler that need
them: `instrument` (wrapping an executor's methods) with the rows, loops
and host time it records, `link`/`seal`/`suspended`, the pipeline-stall
notes and the rendering helpers.
"""

from __future__ import annotations

import contextlib
import threading
import time

__all__ = ["OpStats", "StatsCollector", "collecting", "current",
           "device_section", "note_superchunk", "note_cop_tasks",
           "note_fallback", "note_encoding", "note_bytes_touched",
           "note_mode", "note_kernel", "device_watermark"]

_tl = threading.local()


_mem_stats_available: bool | None = None   # None = not yet probed


def device_watermark() -> int:
    """The CUDA allocator's peak bytes in use, 0 without a card.
    PROCESS-WIDE: concurrent statements' allocations inflate it for each
    other, so it feeds only server-scope gauges — per-operator memory
    comes from memtrack's per-statement trackers."""
    global _mem_stats_available
    if _mem_stats_available is False:
        return 0
    try:
        import torch
        if not torch.cuda.is_available():
            _mem_stats_available = False
            return 0
        ms = torch.cuda.memory_stats()
        _mem_stats_available = True
        return int(ms.get("allocated_bytes.all.peak", 0) or 0)
    except Exception:  # noqa: BLE001 - stats must never break execution
        _mem_stats_available = False
    return 0


class OpStats:
    """One physical operator's actuals for one statement execution (the
    counters the coprocessor path records; the reference's OpStats also
    carries the executor wrappers' rows/loops/time, which the port does
    not have yet)."""

    __slots__ = ("name", "device_time_ns", "cop_tasks", "superchunks",
                 "coalesced_chunks", "superchunk_fill_rows",
                 "superchunk_bucket_rows", "fallbacks", "fallback_reasons",
                 "encoding", "mode", "kernel_family", "kernel_compile",
                 "kernel_bytes", "kernel_busy_ns", "kernel_dispatches")

    def __init__(self, name: str):
        self.name = name
        self.device_time_ns = 0    # sum of CUDA event pairs
        self.cop_tasks = 0
        # superchunk accounting: how the operator's device work was
        # batched
        self.superchunks = 0            # coalesced device dispatches
        self.coalesced_chunks = 0       # source chunks folded into them
        self.superchunk_fill_rows = 0   # live rows across superchunks
        self.superchunk_bucket_rows = 0  # padded bucket rows (>= fill)
        # device->host fallbacks: batches this operator planned for the
        # device but executed on the host (capacity/collision miss that
        # survived the partition retry, or a non-device-safe plan)
        self.fallbacks = 0
        self.fallback_reasons: dict = {}    # reason -> count
        # encoded-execution mode this operator last ran in: "" = nothing
        # noted, else one of encoded | decoded | direct-agg
        self.encoding = ""
        # execution mode that actually ran: "" = nothing noted, else one
        # of direct | hash | hybrid | host
        self.mode = ""
        # kernel-profile feed (profiler.py): which kernel family served
        # this operator, its first-dispatch attribution, and the bytes,
        # busy time and dispatches its profile rows recorded here
        self.kernel_family = ""
        self.kernel_compile = ""
        self.kernel_bytes = 0
        self.kernel_busy_ns = 0
        self.kernel_dispatches = 0

    def fill_ratio(self) -> float:
        """Live rows over padded bucket rows (0.0 when no superchunks)."""
        if not self.superchunk_bucket_rows:
            return 0.0
        return self.superchunk_fill_rows / self.superchunk_bucket_rows


class StatsCollector:
    """Stats for one statement: OpStats keyed by plan-node identity.

    The entry pins the plan node, so ids cannot be recycled while the
    collector lives. Notes arrive from cop pool workers, so they go
    through a lock."""

    def __init__(self, device: bool = False):
        self.device = device
        # guarded-by: _lock
        self._nodes: dict[int, tuple[object, OpStats]] = {}
        self._lock = threading.Lock()

    def node(self, plan, name: str | None = None) -> OpStats:
        ent = self._nodes.get(id(plan))
        if ent is not None:
            return ent[1]
        if name is None:
            name = type(plan).__name__.removeprefix("Phys")
        st = OpStats(name)
        with self._lock:
            self._nodes.setdefault(id(plan), (plan, st))
        return self._nodes[id(plan)][1]

    def get(self, plan) -> OpStats | None:
        ent = self._nodes.get(id(plan))
        return ent[1] if ent is not None else None

    def ops(self) -> list[OpStats]:
        """The OpStats of every plan node noted, insertion order."""
        with self._lock:
            return [st for _plan, st in self._nodes.values()]

    def note_device(self, plan, elapsed_ns: int) -> None:
        st = self.node(plan)
        with self._lock:
            st.device_time_ns += elapsed_ns

    def note_cop_tasks(self, plan, n: int) -> None:
        st = self.node(plan)
        with self._lock:
            st.cop_tasks += n

    def note_superchunk(self, plan, rows: int, bucket: int,
                        sources: int) -> None:
        """One coalesced device dispatch: `sources` chunks folded into
        `rows` live rows padded to a `bucket`-row shape."""
        st = self.node(plan)
        with self._lock:
            st.superchunks += 1
            st.coalesced_chunks += sources
            st.superchunk_fill_rows += rows
            st.superchunk_bucket_rows += bucket

    def note_fallback(self, plan, reason: str = "") -> "OpStats":
        """One device->host fallback on this operator, counted by reason
        too. Returns the OpStats so the caller can label the metric with
        the operator name."""
        st = self.node(plan)
        with self._lock:
            st.fallbacks += 1
            st.fallback_reasons[reason] = \
                st.fallback_reasons.get(reason, 0) + 1
        return st

    def note_encoding(self, plan, mode: str) -> None:
        """Record the operator's encoded-execution mode (encoded /
        decoded / direct-agg)."""
        st = self.node(plan)
        with self._lock:
            st.encoding = mode

    def note_mode(self, plan, mode: str) -> None:
        """Record the execution mode that actually ran (direct / hash /
        hybrid / host)."""
        st = self.node(plan)
        with self._lock:
            st.mode = mode

    def note_kernel(self, plan, family: str, compile_src: str,
                    nbytes: int, busy_ns: int) -> None:
        """Fold one kernel dispatch's profile slice onto the operator.
        May arrive from cop pool workers, hence the lock."""
        st = self.node(plan)
        with self._lock:
            st.kernel_family = family
            if compile_src:
                st.kernel_compile = compile_src
            st.kernel_bytes += nbytes
            st.kernel_busy_ns += busy_ns
            st.kernel_dispatches += 1


@contextlib.contextmanager
def collecting(coll: StatsCollector | None):
    """Install `coll` as this thread's active collector. Passing the
    already-active collector (or None) nests transparently."""
    prev = getattr(_tl, "coll", None)
    _tl.coll = coll if coll is not None else prev
    try:
        yield _tl.coll
    finally:
        _tl.coll = prev


def current() -> StatsCollector | None:
    return getattr(_tl, "coll", None)


def note_cop_tasks(plan, n: int) -> None:
    """Record a coprocessor fan-out's task count against the active
    collector (no-op without one)."""
    coll = getattr(_tl, "coll", None)
    if coll is not None and plan is not None:
        coll.note_cop_tasks(plan, n)


def note_superchunk(plan, rows: int, bucket: int, sources: int) -> None:
    """Record a coalesced dispatch against the active collector (no-op
    without one) — the call-site form for executors and the cop handler."""
    coll = getattr(_tl, "coll", None)
    if coll is not None:
        coll.note_superchunk(plan, rows, bucket, sources)


def note_encoding(plan, mode: str) -> None:
    """Record the operator's encoded-execution mode against the active
    collector (no-op without one): EXPLAIN ANALYZE's enc= note."""
    coll = getattr(_tl, "coll", None)
    if coll is not None and plan is not None:
        coll.note_encoding(plan, mode)


def note_mode(plan, mode: str) -> None:
    """Record the operator's actually-run execution mode against the
    active collector (no-op without one): the memo's vocabulary
    (direct | hash | sort | fused | hybrid | host)."""
    coll = getattr(_tl, "coll", None)
    if coll is not None and plan is not None:
        coll.note_mode(plan, mode)


def note_bytes_touched(decoded_equiv: int, encoded: int) -> None:
    """Account one device dispatch's input bytes on the two
    bytes-touched counter families: `encoded` is what the dispatch
    actually staged/read (dict codes + validity at the padded bucket),
    `decoded_equiv` is what the same input would occupy decoded into
    wide host vectors — the auditable compression win, the per-query
    bytes_touched figure. Also the per-tenant bytes ledger's single
    chokepoint (meter.py)."""
    from tidb_tpu_torch import meter, metrics
    metrics.counter(metrics.BYTES_DECODED_EQUIV, inc=decoded_equiv)
    metrics.counter(metrics.BYTES_ENCODED, inc=encoded)
    meter.note_bytes(encoded, decoded_equiv)


def note_kernel(plan, family: str, compile_src: str, nbytes: int,
                busy_ns: int) -> None:
    """Record a kernel dispatch's profile slice against the active
    collector (no-op without one): called from profiler.note_dispatch,
    so every instrumented seam feeds both the process-wide registry row
    and the statement's per-operator view with one call."""
    coll = getattr(_tl, "coll", None)
    if coll is not None and plan is not None:
        coll.note_kernel(plan, family, compile_src, nbytes, busy_ns)


def note_fallback(plan, reason: str) -> None:
    """Record one device->host fallback: counted on the operator's
    OpStats (EXPLAIN ANALYZE `pipeline` column) and on the
    tidb_tpu_device_fallback_total{op,reason} metric family. `reason`
    is one of capacity|collision|unsupported|encoding (single-chip),
    mesh (a mesh stream batch served by the host), or the device-fault
    recovery pair fault|quarantine (tidb_tpu/sched.py DeviceHealth) —
    the designed fallback causes; anything else should RAISE, not
    fall back."""
    from tidb_tpu_torch import metrics
    coll = getattr(_tl, "coll", None)
    name = None
    if coll is not None and plan is not None:
        name = coll.note_fallback(plan, reason).name
    if name is None:
        name = type(plan).__name__.removeprefix("Phys") \
            if plan is not None else "?"
    metrics.counter(metrics.DEVICE_FALLBACKS,
                    {"op": name, "reason": reason})


# -- device timing (gated: the event wait serializes the reader) ----------


def _cuda(device) -> bool:
    return device is not None and getattr(device, "type", None) == "cuda"


def _device_ns(t0: int, ev) -> int:
    """Elapsed ns of a region: its CUDA event pair (waiting for the
    second) where it ran on the card, else the host clock from t0."""
    if ev is None:
        return time.perf_counter_ns() - t0
    ev[1].record()
    ev[1].synchronize()
    return int(ev[0].elapsed_time(ev[1]) * 1e6)


def _events():
    import torch
    ev = (torch.cuda.Event(enable_timing=True),
          torch.cuda.Event(enable_timing=True))
    ev[0].record()
    return ev


@contextlib.contextmanager
def device_section(plan, errors: bool = True, device=None):
    """Time a whole device region, ending on its blocking readback, by a
    CUDA event pair on `device` (the host clock for a CPU device). With
    errors=False the section records only on SUCCESS, for call sites
    whose failures retry through an escalated kernel (the failed
    attempt's time would double against the retry's). A no-op unless
    the thread's collector was made with device=True."""
    coll = getattr(_tl, "coll", None)
    if coll is None or not coll.device:
        yield
        return
    t0 = time.perf_counter_ns()
    ev = _events() if _cuda(device) else None
    try:
        yield
    except BaseException:
        if errors:
            coll.note_device(plan, _device_ns(t0, ev))
        raise
    coll.note_device(plan, _device_ns(t0, ev))
