"""Device scheduler, device health and the dispatch watchdog: the port
of the JAX package's sched.py for one device.

**Scheduling** (`DeviceScheduler`): the pipeline-depth in-flight window
is a GLOBAL resource. Every device dispatch — pipelined superchunks
(ops/runtime.pipeline_map) and one-shot sync kernels alike
(`device_slot`) — takes a slot before it enqueues work, and slots are
granted round-robin across statements. Two gates bound the grant:
`tidb_tpu_sched_inflight` concurrent slots (0 = scheduler off) and
`tidb_tpu_sched_inflight_bytes` against the memtrack SERVER root's
DEVICE ledger (0 = no bytes gate). The scheduler is a throttle, not a
correctness gate: a waiter past the bypass valve proceeds WITHOUT a
slot (counted in `tidb_tpu_sched_bypass_total`), so no lost wakeup or
crashed holder can hang a statement. One deviation: a thread that holds
slots and finds the window full does not wait — its slots belong to its
own suspended pipelines (a join tree's nested probe pipelines run as
generators on one thread), which cannot release them while it waits —
so it drains or bypasses at once where the reference waits out the 2 s
valve per dispatch. On CUDA a slot is held from the
dispatch to the finalize's readback, so its hold interval covers the
device time only because the readback blocks.

**Device health** (`DeviceHealth`, `degrade_statement`): a device fault
at the coprocessor retries once, then latches the statement onto the
host path; at three consecutive faults the device is quarantined and
every HBM-resident block is shed (store/device_cache.shed_all) until
one probe dispatch past the quarantine window readmits it.

**Watchdog** (`DispatchWatchdog`, `finalize_watch`): a dispatch/finalize
section past `tidb_tpu_dispatch_timeout_ms` cancels its statement with
the retryable DispatchTimeoutError (0 = off, the default).

**Admission** (`AdmissionController`, `admission`): a statement that
builds executors projects its footprint (its digest's recorded peak,
perfschema.digest_max_mem) against `tidb_tpu_server_mem_quota` before it
runs; past the quota it sheds the server's caches (`shed_server`), then
queues, then is refused with the retryable AdmissionRejectedError (9008
on the wire) instead of an OOM cancel in the middle of the statement.

Lock discipline: each class owns ONE Condition/Lock guarding its own
counters; the scheduler's bytes gate reads the ledger integer lock-free
(a stale read is one dispatch of slack, and every release re-evaluates).
"""

from __future__ import annotations

import contextlib
import threading
import time

from tidb_tpu_torch import config, devplane, memtrack, meter, metrics, trace
from tidb_tpu_torch.util import failpoint

__all__ = ["DeviceScheduler", "AdmissionController",
           "AdmissionRejectedError", "DispatchWatchdog", "DeviceHealth",
           "device_scheduler", "admission", "dispatch_watchdog",
           "device_health", "device_slot", "finalize_watch",
           "degrade_statement", "statement_degraded",
           "shed_server", "stats", "reset_for_tests"]


class AdmissionRejectedError(Exception):
    """Statement refused at admission: the server is over
    `tidb_tpu_server_mem_quota`, shedding freed too little, and the
    bounded queue wait expired. RETRYABLE — surfaced to clients as
    ER_SERVER_BUSY_ADMISSION (9008) with a retry-later message; the
    session and its transaction state are untouched."""

# scheduler wait granularity: contended acquires re-check (and
# pipeline_map gets a chance to drain its own window) on this period
_SLICE_S = 0.02
# bypass valve: a dispatch that cannot get a slot for this long stops
# waiting and proceeds unscheduled (counted, never hung)
_BYPASS_S = 2.0
# admission projection floor for digests never seen before: small enough
# to admit cold workloads, large enough that a flood of unknowns still
# queues once the ledger fills
_MIN_PROJECTION = 1 << 20


class _Slot:
    """One granted (or bypassed) dispatch slot. `chip` is the plane
    chip index the grant placed this dispatch on (0 when the plane has
    one device, or for bypass/no-op slots); `t_grant` is the grant
    timestamp, so the release can attribute the slot's hold interval —
    dispatch through finalize — to the chip's busy ledger."""

    __slots__ = ("stream", "granted", "chip", "t_grant", "thread",
                 "_event")

    def __init__(self, stream, thread=None):
        self.stream = stream
        self.thread = thread          # the acquiring thread's ident
        self.granted = False          # guarded-by the scheduler's _cv
        self.chip = 0                 # guarded-by the scheduler's _cv
        self.t_grant = 0              # guarded-by the scheduler's _cv
        self._event = threading.Event()


class DeviceScheduler:
    """Round-robin dispatch-slot allocator over the device plane.

    Streams are statements (keyed by their memtrack statement root, so
    every operator and pool worker of one statement shares one fairness
    bucket; library use without a tracker falls back to the thread id).
    Grants hand off: a release picks the next stream in rotation with a
    waiting head and wakes exactly that waiter, so a statement that
    just ran yields to every other waiting statement before it runs
    again.

    Per-chip slot streams: on an N-chip ``("batch",)`` plane
    (devplane.ndev() > 1) `tidb_tpu_sched_inflight` is a PER-CHIP
    depth — total capacity scales to inflight × ndev — and every grant
    places its dispatch on the least-loaded chip (fewest slots held,
    then least RECENT busy time: a half-life-decayed EWMA of the
    attributed hold intervals, so a chip that absorbed a heavy scan an
    hour ago competes as an equal once the work drains instead of
    being penalized by its cumulative ledger forever). Releases
    attribute the slot's hold interval to both the cumulative busy
    ledger (the metrics-history sampler and serve bench derive
    utilization from its deltas — those must stay monotone) and the
    decayed one (the placement signal). On a 1-device plane every
    counter collapses to chip 0 and behavior is exactly the
    single-device scheduler."""

    # placement half-life: busy time stops mattering once it is a few
    # multiples of this old. 30s spans many statements (so placement
    # is not noise-driven) while forgetting last-minute history fast
    # enough that a drained chip rejoins the rotation promptly.
    EWMA_HALFLIFE_S = 30.0

    def __init__(self):
        self._cv = threading.Condition()
        self._granted = 0                  # guarded-by: _cv
        self._waiters: dict = {}           # guarded-by: _cv  stream -> [slot]
        self._rr: list = []                # guarded-by: _cv  rotation order
        self._stall_ns = 0                 # guarded-by: _cv
        self._bypasses = 0                 # guarded-by: _cv
        self._grants = 0                   # guarded-by: _cv
        self._chip_granted: dict = {}      # guarded-by: _cv  chip -> held
        self._chip_grants: dict = {}       # guarded-by: _cv  chip -> total
        self._chip_busy_ns: dict = {}      # guarded-by: _cv  chip -> ns
        # chip -> decayed busy ns (the placement signal); decayed in
        # place against _ewma_t whenever placement or release reads it
        self._chip_busy_ewma: dict = {}    # guarded-by: _cv
        self._ewma_t = time.monotonic()    # guarded-by: _cv
        # thread ident -> slots granted to it and not yet released
        self._thread_held: dict = {}       # guarded-by: _cv

    # -- capacity ------------------------------------------------------------

    @staticmethod
    def enabled() -> bool:
        return config.sched_inflight() > 0

    def _capacity_free(self) -> bool:
        """Both gates, called under _cv. The bytes gate reads the SERVER
        device ledger without its lock (an int load; one dispatch of
        staleness, re-checked on every release). Min-progress: with
        nothing granted, one dispatch always fits — resident HBM (cache
        blocks, pinned builds) above the cap must throttle, not
        starve."""
        if self._granted >= config.sched_inflight() * devplane.ndev():
            return False
        if self._granted == 0:
            return True
        cap = config.sched_inflight_bytes()
        return cap <= 0 or memtrack.SERVER.device < cap

    def _decay_ewma_locked(self, now: float | None = None) -> None:
        """Fold elapsed time into the decayed busy ledgers (under _cv).
        Exponential decay is time-composable, so decaying lazily at
        read/update points is exact — no background timer needed."""
        if now is None:
            now = time.monotonic()
        dt = now - self._ewma_t
        if dt <= 0:
            return
        self._ewma_t = now
        f = 0.5 ** (dt / self.EWMA_HALFLIFE_S)
        for c in self._chip_busy_ewma:
            self._chip_busy_ewma[c] *= f

    def _pick_chip_locked(self) -> int:
        """Least-loaded chip of the plane: fewest held slots, then
        least RECENT busy time — the decayed EWMA, not the cumulative
        ledger (ties break to the lowest index). Called under _cv at
        grant time."""
        n = devplane.ndev()
        if n <= 1:
            return 0
        self._decay_ewma_locked()
        return min(range(n),
                   key=lambda c: (self._chip_granted.get(c, 0),
                                  self._chip_busy_ewma.get(c, 0.0), c))

    # -- acquire / release ---------------------------------------------------

    @staticmethod
    def _stream_key():
        root = memtrack.current()
        return id(root) if root is not None else threading.get_ident()

    def acquire(self, timeout: float | None = None) -> "_Slot | None":
        """A dispatch slot, or None when `timeout` expires first.
        timeout=None waits a single grant slice. Returns a no-op slot
        immediately when the scheduler is off."""
        if not self.enabled():
            return _NOOP_SLOT
        stream = self._stream_key()
        tid = threading.get_ident()
        slot = _Slot(stream, tid)
        t0 = time.perf_counter_ns()
        with self._cv:
            q = self._waiters.get(stream)
            if q is None:
                q = self._waiters[stream] = []
                if stream not in self._rr:   # may linger after a timeout
                    self._rr.append(stream)
            q.append(slot)
            self._grant_locked()
            # a thread that holds slots and gets none at once is a nested
            # pipeline (a join's probe side is the pipelined output of
            # the join below it, generators on one thread): the slots it
            # would wait for are held by its own suspended frames, so it
            # does not wait (the JAX package waits out the bypass valve)
            nested = not slot.granted and self._thread_held.get(tid, 0)
            if nested:
                self._forget_locked(slot)
        if nested:
            self._note_stall(t0, stalled=False)
            return None
        wait_s = timeout if timeout is not None else _SLICE_S
        deadline = time.monotonic() + wait_s
        stalled = False
        granted = slot._event.wait(timeout=_SLICE_S)
        while not granted:
            stalled = True
            expired = False
            with self._cv:
                if not slot.granted:
                    self._grant_locked()   # capacity may have freed
                if not slot.granted and \
                        time.monotonic() >= deadline:
                    self._forget_locked(slot)
                    expired = True
                granted = slot.granted
            if expired:
                self._note_stall(t0, stalled=True)
                return None
            if not granted:
                granted = slot._event.wait(timeout=_SLICE_S)
        self._note_stall(t0, stalled=stalled)
        return slot

    def acquire_or_bypass(self) -> "_Slot":
        """A slot, waiting at most the bypass valve; past it, an
        ungranted slot is returned so the dispatch proceeds unscheduled
        rather than hang (`tidb_tpu_sched_bypass_total`)."""
        slot = self.acquire(timeout=_BYPASS_S)
        if slot is not None:
            return slot
        with self._cv:
            self._bypasses += 1
        metrics.counter(metrics.SCHED_BYPASSES)
        return _Slot(self._stream_key())    # never granted: release no-ops

    def release(self, slot: "_Slot | None") -> None:
        now = time.perf_counter_ns()
        if slot is None or slot is _NOOP_SLOT:
            return
        with self._cv:
            if not slot.granted:     # bypass slots / double release:
                return               # checked under _cv, so two racing
            slot.granted = False     # releasers cannot both decrement
            self._granted -= 1
            n = self._thread_held.get(slot.thread, 0) - 1
            if n > 0:
                self._thread_held[slot.thread] = n
            else:
                self._thread_held.pop(slot.thread, None)
            held = self._chip_granted.get(slot.chip, 0)
            self._chip_granted[slot.chip] = max(held - 1, 0)
            # the hold interval (dispatch through finalize) IS the
            # chip's attributed busy time — cumulative for the sampler
            # and serve bench (monotone deltas), decayed for placement
            held_ns = max(now - slot.t_grant, 0)
            self._chip_busy_ns[slot.chip] = \
                self._chip_busy_ns.get(slot.chip, 0) + held_ns
            self._decay_ewma_locked()
            self._chip_busy_ewma[slot.chip] = \
                self._chip_busy_ewma.get(slot.chip, 0.0) + held_ns
            self._grant_locked()

    # -- grant machinery (all under _cv) -------------------------------------

    def _grant_locked(self) -> None:
        """Hand free capacity to waiting streams, one slot per stream
        per rotation pass."""
        while self._rr and self._capacity_free():
            progressed = False
            for _ in range(len(self._rr)):
                stream = self._rr.pop(0)
                q = self._waiters.get(stream)
                if not q:
                    self._waiters.pop(stream, None)
                    continue
                slot = q.pop(0)
                if not q:
                    self._waiters.pop(stream, None)
                else:
                    self._rr.append(stream)   # stays in rotation, at back
                slot.granted = True
                slot.chip = self._pick_chip_locked()
                slot.t_grant = time.perf_counter_ns()
                self._granted += 1
                self._thread_held[slot.thread] = \
                    self._thread_held.get(slot.thread, 0) + 1
                self._grants += 1
                self._chip_granted[slot.chip] = \
                    self._chip_granted.get(slot.chip, 0) + 1
                self._chip_grants[slot.chip] = \
                    self._chip_grants.get(slot.chip, 0) + 1
                slot._event.set()
                progressed = True
                break
            if not progressed:
                break
            if not self._capacity_free():
                break

    def _forget_locked(self, slot: "_Slot") -> None:
        q = self._waiters.get(slot.stream)
        if q is not None:
            try:
                q.remove(slot)
            except ValueError:
                pass
            if not q:
                self._waiters.pop(slot.stream, None)

    def _note_stall(self, t0: int, stalled: bool) -> None:
        waited = time.perf_counter_ns() - t0
        with self._cv:
            self._stall_ns += waited
        if stalled:
            metrics.histogram(metrics.SCHED_STALLS, waited / 1e9)

    # -- introspection -------------------------------------------------------

    def snapshot(self) -> dict:
        with self._cv:
            return {"inflight": self._granted,
                    "waiting": sum(len(q) for q in self._waiters.values()),
                    "grants": self._grants,
                    "bypasses": self._bypasses,
                    "stall_seconds": round(self._stall_ns / 1e9, 6),
                    "chips": self._chip_snapshot_locked()}

    def _chip_snapshot_locked(self) -> dict:
        self._decay_ewma_locked()

        def one(c: int) -> dict:
            return {"inflight": self._chip_granted.get(c, 0),
                    "grants": self._chip_grants.get(c, 0),
                    "busy_seconds": round(
                        self._chip_busy_ns.get(c, 0) / 1e9, 6),
                    "busy_ewma_seconds": round(
                        self._chip_busy_ewma.get(c, 0.0) / 1e9, 6)}

        chips = {c: one(c) for c in range(devplane.ndev())}
        # chips that held slots under a since-shrunk plane keep their
        # history visible (the busy figures still explain past samples)
        for c in self._chip_grants:
            if c not in chips:
                chips[c] = one(c)
        return chips

    def chip_busy_ns(self) -> dict:
        """{chip: cumulative attributed busy ns} — the metrics-history
        sampler derives per-chip utilization ratios from deltas of
        this, and the serve bench reads it for the mesh-balance
        aggregate (total rows over the busiest chip's time)."""
        with self._cv:
            out = {c: self._chip_busy_ns.get(c, 0)
                   for c in range(devplane.ndev())}
            for c, ns in self._chip_busy_ns.items():
                out.setdefault(c, ns)
            return out


_NOOP_SLOT = _Slot(None)


class DispatchWatchdog:
    """Bounded finalize: a dispatch/finalize section that runs past
    `tidb_tpu_dispatch_timeout_ms` cancels its statement with the
    RETRYABLE device-fault error (DispatchTimeoutError) instead of
    wedging the scheduler.

    Two halves cooperate. A monitor thread (started lazily on the first
    watched section, exits when idle) scans registered sections; one
    past its deadline is marked expired, counted in
    `tidb_tpu_dispatch_timeout_total`, and its statement's memtrack
    root is cancel()-latched with the watchdog's message (its
    on_cancel hook fires; a later quota check of the statement re-raises
    the message). The watched section itself re-checks on
    exit: when the blocking call eventually returns past the deadline,
    DeviceFaultError raises THERE, so the existing finally chains
    (pipeline_map's slot/ledger releases, memtrack.device_scope)
    drain every scheduler slot and device-ledger byte exactly as on
    any other error path. 0 = off (the default)."""

    _SLICE_S = 0.05         # monitor scan period while sections exist
    _IDLE_S = 5.0           # idle monitor lingers this long, then dies

    def __init__(self):
        self._cv = threading.Condition()
        self._entries: dict = {}    # guarded-by: _cv  tok -> entry
        self._seq = 0               # guarded-by: _cv
        self._thread = None         # guarded-by: _cv
        self._fired = 0             # guarded-by: _cv

    def begin(self, label: str):
        """-> opaque token (None when the watchdog is off)."""
        timeout_ms = config.dispatch_timeout_ms()
        if timeout_ms <= 0:
            return None
        # [deadline, label, statement root, expired]
        ent = [time.monotonic() + timeout_ms / 1e3, label,
               memtrack.current(), False]
        with self._cv:
            self._seq += 1
            tok = self._seq
            self._entries[tok] = ent
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._monitor, name="dispatch-watchdog",
                    daemon=True)
                self._thread.start()
            self._cv.notify()
        return (tok, ent)

    def end(self, token) -> bool:
        """Unregister; -> True when the section expired (the caller
        raises DeviceFaultError unless an error is already unwinding)."""
        if token is None:
            return False
        tok, ent = token
        with self._cv:
            self._entries.pop(tok, None)
            return ent[3]

    @contextlib.contextmanager
    def watch(self, label: str = "dispatch"):
        token = self.begin(label)
        try:
            yield
        except BaseException:
            self.end(token)     # the in-flight error wins
            raise
        if self.end(token):
            trace.event("watchdog.fired", label=label)
            raise _timeout_error(label)

    def _monitor(self) -> None:
        while True:
            fire = []
            with self._cv:
                if not self._entries:
                    self._cv.wait(timeout=self._IDLE_S)
                    if not self._entries:
                        # idle: exit. The slot clears UNDER _cv before
                        # the return, so a begin() racing our unwind
                        # cannot see a still-alive thread that will
                        # never scan its entry — it spawns a fresh one
                        self._thread = None
                        return
                now = time.monotonic()
                for ent in self._entries.values():
                    if not ent[3] and now >= ent[0]:
                        ent[3] = True
                        self._fired += 1
                        fire.append(ent)
                if not fire:
                    self._cv.wait(timeout=self._SLICE_S)
            for ent in fire:    # cancels run with _cv dropped
                metrics.counter(metrics.DISPATCH_TIMEOUTS)
                root = ent[2]
                if root is not None:
                    root.cancel(_timeout_msg(ent[1]))

    def snapshot(self) -> dict:
        with self._cv:
            return {"watching": len(self._entries),
                    "fired": self._fired}


def _timeout_msg(label: str) -> str:
    return (f"device fault: dispatch watchdog — {label} exceeded "
            f"tidb_tpu_dispatch_timeout_ms="
            f"{config.dispatch_timeout_ms()}ms; statement cancelled "
            f"(retryable)")


def _timeout_error(label: str):
    return failpoint.DispatchTimeoutError(_timeout_msg(label))


# device-fault recovery policy: consecutive faults before the device is
# quarantined, and how long quarantine lasts before ONE probe dispatch
# is let through to re-test it
_FAULT_QUARANTINE_AFTER = 3
_QUARANTINE_S = 1.0


class DeviceHealth:
    """Device-plane fault accounting + quarantine. Fault reporters:
    the copr agg dispatch sites (store/copr.py — which also run the
    full retry-once/degrade chain and gate on available()) and
    pipeline_map's dispatch wrapper (ops/runtime.py — faults feed the
    counter and propagate retryable; executor paths do not consult
    available(), so a quarantine routes the storage-side agg volume to
    the host while executor-plane dispatches surface the retryable
    fault to their caller). At `_FAULT_QUARANTINE_AFTER` consecutive faults the
    device is quarantined — HBM residency is invalidated (blocks
    uploaded through a faulting plane are not trustworthy, and nothing
    could consume them anyway) — until the quarantine window passes,
    after which exactly ONE probe dispatch is admitted: success
    readmits the device, another fault re-arms the window. Transitions
    count in `tidb_tpu_device_quarantine_total{event}`."""

    def __init__(self):
        self._mu = threading.Lock()
        self._consecutive = 0       # guarded-by: _mu
        self._quarantined = False   # guarded-by: _mu
        self._probe_at = 0.0        # guarded-by: _mu
        self._probing = False       # guarded-by: _mu
        self._probe_deadline = 0.0  # guarded-by: _mu
        self._faults = 0            # guarded-by: _mu
        self._quarantines = 0       # guarded-by: _mu

    def available(self) -> bool:
        """May this dispatch try the device? While quarantined, only
        the single re-probe past the window is admitted. A probe that
        never reports back — its dispatch exited via a designed
        rejection (capacity, unsupported) rather than success or fault
        — would otherwise pin `_probing` forever; past the probe's own
        deadline it counts as abandoned and the next caller probes."""
        with self._mu:
            if not self._quarantined:
                return True
            now = time.monotonic()
            if self._probing and now < self._probe_deadline:
                return False
            if not self._probing and now < self._probe_at:
                return False
            self._probing = True    # this caller IS the probe
            self._probe_deadline = now + _QUARANTINE_S
            return True

    def note_ok(self) -> None:
        with self._mu:
            self._consecutive = 0
            readmit = self._quarantined
            self._quarantined = False
            self._probing = False
        if readmit:
            metrics.counter(metrics.DEVICE_QUARANTINES,
                            {"event": "readmit"})
            trace.event("device.readmit")

    def note_fault(self) -> None:
        trace.event("device.fault")
        quarantined = False
        with self._mu:
            self._consecutive += 1
            self._faults += 1
            if self._quarantined:
                if self._probing:   # the probe failed: re-arm
                    self._probing = False
                    self._probe_at = time.monotonic() + _QUARANTINE_S
            elif self._consecutive >= _FAULT_QUARANTINE_AFTER:
                self._quarantined = True
                self._probing = False
                self._probe_at = time.monotonic() + _QUARANTINE_S
                self._quarantines += 1
                quarantined = True
        if quarantined:
            metrics.counter(metrics.DEVICE_QUARANTINES,
                            {"event": "quarantine"})
            trace.event("device.quarantine")
            # invalidate HBM residency with every lock dropped: the
            # shed walks the cache locks, and a re-probe refills from
            # a (possibly recovered) clean slate
            from tidb_tpu_torch.store import device_cache
            device_cache.shed_all()

    def snapshot(self) -> dict:
        with self._mu:
            return {"quarantined": self._quarantined,
                    "consecutive_faults": self._consecutive,
                    "faults": self._faults,
                    "quarantines": self._quarantines}


def degrade_statement() -> None:
    """Latch THIS statement onto the host path after a retried device
    fault (the flag lives on the statement's memtrack root and dies
    with it): one faulting statement stops paying fault+retry per
    dispatch, while the next statement — and the quarantine re-probe —
    still exercises the device."""
    root = memtrack.current()
    if root is not None:
        root.fault_degraded = True
        trace.event("device.degrade")


def statement_degraded() -> bool:
    root = memtrack.current()
    return root is not None and root.fault_degraded


class AdmissionController:
    """Statement admission against `tidb_tpu_server_mem_quota`.

    admit() outcomes (the `tidb_tpu_admission_total{outcome}` label):
      * admitted — fit on the first check;
      * shed     — fit only after driving the SERVER shed chain;
      * queued   — fit after waiting for running statements to finish;
      * rejected — still over quota at `tidb_tpu_admission_timeout_ms`:
        AdmissionRejectedError (retryable 9008).

    Projections reserve their bytes for the statement's lifetime, so N
    racing admissions cannot all clear one remaining gap. The reserve
    double-counts once the statement's REAL consumption lands on the
    SERVER ledgers — deliberately conservative: admission exists to
    keep mid-query OOM cancels at zero, and the min-progress rule (an
    empty controller always admits its head) caps the cost at
    serialized execution, never a stuck server."""

    def __init__(self):
        self._cv = threading.Condition()
        self._reserved = 0           # guarded-by: _cv  projected bytes
        self._admitted = 0           # guarded-by: _cv  running statements
        self._waiting = 0            # guarded-by: _cv  queue depth
        self._counts = {"admitted": 0, "queued": 0, "shed": 0,
                        "rejected": 0}   # guarded-by: _cv
        self._shed_bytes = 0         # guarded-by: _cv

    @staticmethod
    def enabled() -> bool:
        return config.server_mem_quota() > 0

    def _fits_locked(self, projected: int, quota: int) -> bool:
        if self._admitted == 0:
            # min-progress: with nothing admitted, the next statement
            # runs whatever the projection says (checks serialize under
            # _cv, so exactly one waiter takes this door) — the quota
            # throttles concurrency, it must not brick the server
            return True
        return memtrack.SERVER.total() + self._reserved + projected \
            <= quota

    def admit(self, projected: int = 0, label: str = "stmt"):
        """-> ticket (pass to finish()), or None when admission is off.
        Raises AdmissionRejectedError past the bounded queue wait."""
        quota = config.server_mem_quota()
        if quota <= 0:
            return None
        projected = max(int(projected), _MIN_PROJECTION)
        t0 = time.perf_counter_ns()
        deadline = time.monotonic() + \
            max(config.admission_timeout_ms(), 1) / 1e3
        outcome = "admitted"
        shed_tried = False
        with self._cv:
            self._waiting += 1
            # published under _cv so racing enter/leave cannot publish
            # counts out of order (metrics._lock is a leaf lock)
            metrics.gauge(metrics.ADMISSION_QUEUE_DEPTH, self._waiting)
        try:
            while True:
                with self._cv:
                    if self._fits_locked(projected, quota):
                        self._reserved += projected
                        self._admitted += 1
                        self._counts[outcome] += 1
                        break
                if not shed_tried:
                    shed_tried = True
                    # drive the registered shed chain (HBM cache blocks,
                    # hybrid-join cold partitions on running statements)
                    # down to the headroom this statement needs
                    target = max(quota - projected - self._reserved, 0)
                    freed = shed_server(target)
                    if freed > 0:
                        outcome = "shed"
                        with self._cv:
                            self._shed_bytes += freed
                        continue      # re-check immediately
                if time.monotonic() >= deadline:
                    with self._cv:
                        self._counts["rejected"] += 1
                    metrics.counter(metrics.ADMISSIONS,
                                    {"outcome": "rejected"})
                    raise AdmissionRejectedError(
                        f"server is busy: admission of {label} would "
                        f"exceed tidb_tpu_server_mem_quota ({quota} "
                        f"bytes); retry later")
                if outcome == "admitted":
                    outcome = "queued"
                with self._cv:
                    # woken by finish() / shed; slices double as the
                    # re-check for ledger drains that notify nobody
                    self._cv.wait(timeout=min(
                        _SLICE_S, max(deadline - time.monotonic(), 0.001)))
        finally:
            with self._cv:
                self._waiting -= 1
                metrics.gauge(metrics.ADMISSION_QUEUE_DEPTH,
                              self._waiting)
            waited_ns = time.perf_counter_ns() - t0
            metrics.histogram(metrics.ADMISSION_WAITS, waited_ns / 1e9)
            # the per-tenant admission-wait ledger (meter.py): the
            # session thread runs admit() with its statement meter
            # installed, so the wait attributes to the right tenant
            meter.note_admission_wait(waited_ns)
        metrics.counter(metrics.ADMISSIONS, {"outcome": outcome})
        return projected

    def finish(self, ticket) -> None:
        """Release an admit() ticket (None-safe)."""
        if ticket is None:
            return
        with self._cv:
            self._reserved -= ticket
            self._admitted -= 1
            self._cv.notify_all()

    def snapshot(self) -> dict:
        with self._cv:
            out = dict(self._counts)
            out["queue_depth"] = self._waiting
            out["running"] = self._admitted
            out["reserved_bytes"] = self._reserved
            out["shed_bytes"] = self._shed_bytes
            return out


# -- process singletons ------------------------------------------------------

_SCHEDULER = DeviceScheduler()
_ADMISSION = AdmissionController()
_WATCHDOG = DispatchWatchdog()
_HEALTH = DeviceHealth()


def device_scheduler() -> DeviceScheduler:
    return _SCHEDULER


def admission() -> AdmissionController:
    return _ADMISSION


def dispatch_watchdog() -> DispatchWatchdog:
    return _WATCHDOG


def device_health() -> DeviceHealth:
    return _HEALTH


def reset_for_tests() -> None:
    """Fresh singletons (test isolation: counters and rotation state)."""
    global _SCHEDULER, _ADMISSION, _WATCHDOG, _HEALTH
    _SCHEDULER = DeviceScheduler()
    _ADMISSION = AdmissionController()
    _WATCHDOG = DispatchWatchdog()
    _HEALTH = DeviceHealth()


def finalize_watch(label: str = "finalize"):
    """Watchdog guard for a blocking finalize (ops/runtime.pipeline_map
    uses it around each pop_finalize): past
    `tidb_tpu_dispatch_timeout_ms` the statement is cancelled with the
    retryable device-fault error — see DispatchWatchdog."""
    return _WATCHDOG.watch(label)


class device_slot:
    """Hold one scheduler slot for the duration of a synchronous kernel
    call — the one-shot dispatch sites' (copr scalar aggs, escalated
    retries, mesh collectives) counterpart of pipeline_map's slot per
    in-flight token. Uses the bypass valve: a sync dispatch inside
    another statement's finalize path must throttle, never deadlock.
    The whole guarded section runs under the dispatch watchdog: a sync
    kernel call past `tidb_tpu_dispatch_timeout_ms` surfaces the
    retryable device-fault error AFTER the slot (and, one context
    inward, the memtrack.device_scope ledger bytes) released.

    With `profile` set (a profiler.KernelProfile), the guarded hold
    interval records as one dispatch on that profile row on SUCCESS —
    the device_slot seam of the kernel profiling plane, for sync sites
    that are not already inside a profiler.dispatch_section."""

    __slots__ = ("_slot", "_wtok", "_busy", "_prof", "_t0")

    def __init__(self, profile=None):
        self._slot = None
        self._wtok = None
        self._busy = None
        self._prof = profile
        self._t0 = 0

    @property
    def chip(self) -> int:
        """The plane chip the grant placed this dispatch on (0 for
        bypass slots or a 1-device plane) — dispatch sites pass it to
        devplane.chip_scope and tag their trace spans with it."""
        return self._slot.chip if self._slot is not None else 0

    def __enter__(self):
        self._wtok = _WATCHDOG.begin("sync-dispatch")
        try:
            failpoint.eval("sched/slot")
            # the slot WAIT is a statement-trace phase of its own: the
            # span covers only the acquire, not the guarded dispatch
            t0 = time.perf_counter_ns()
            with trace.span("sched.slot", sync=1):
                self._slot = _SCHEDULER.acquire_or_bypass()
            # per-tenant attribution (meter.py): the acquire is slot
            # wait; everything from here to __exit__ is the dispatch/
            # finalize interval this slot guards — device busy-time,
            # billed as a section so a nested retry's own device_slot
            # cannot double-count the same wall time
            meter.note_slot_wait(time.perf_counter_ns() - t0)
            self._busy = meter.busy_section().__enter__()
            self._t0 = time.perf_counter_ns()
        except BaseException:
            # anything that raises after a successful acquire (the
            # meter bookkeeping above is new code in this window) must
            # hand the slot back — __exit__ will never run
            _SCHEDULER.release(self._slot)
            self._slot = None
            _WATCHDOG.end(self._wtok)
            self._wtok = None
            raise
        return self

    def __exit__(self, exc_type, exc, tb):
        _SCHEDULER.release(self._slot)
        self._slot = None
        if self._prof is not None and exc_type is None:
            from tidb_tpu_torch import profiler
            profiler.note_dispatch(
                self._prof, time.perf_counter_ns() - self._t0)
        if self._busy is not None:
            # busy even on an error path: the device (attempt) really
            # occupied this interval
            self._busy.__exit__(exc_type, exc, tb)
            self._busy = None
        expired = _WATCHDOG.end(self._wtok)
        self._wtok = None
        if expired and exc_type is None:
            # the watchdog fired while the kernel call blocked; now
            # that it returned (slot + ledger already released by the
            # finally chain), surface the cancel to the statement
            trace.event("watchdog.fired", label="sync-dispatch")
            raise _timeout_error("sync-dispatch")
        return False


def shed_server(target: int = 0) -> int:
    """Drive the SERVER root's registered shed chain (recursing into
    session/statement subtrees, so running statements' spill actions —
    hybrid-join cold partitions, sort spills — fire too) until the
    SERVER total is at/below `target` bytes. -> bytes freed. The admin
    hook behind the status port's /shed endpoint and the admission
    controller's overflow path. Registered server-scope actions: the HBM
    region-block cache (store/device_cache.py), the MVCC delta stores
    (store/delta.py), the kernel-profile registry and the
    metrics-history ring."""
    failpoint.eval("admission/shed")
    return memtrack.SERVER.run_spill_actions(target, recurse=True)


def stats() -> dict:
    """Scheduler, admission, watchdog and device-health snapshot."""
    return {"scheduler": _SCHEDULER.snapshot(),
            "admission": _ADMISSION.snapshot(),
            "watchdog": _WATCHDOG.snapshot(),
            "device_health": _HEALTH.snapshot()}
