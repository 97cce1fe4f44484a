"""Continuous per-tenant resource metering: who is consuming the device.

A copy of the JAX package's meter module (which imports nothing of that
package): the ledger of work done, as memtrack is the ledger of bytes
held. Device busy-time, host-fallback time, scheduler slot-wait,
admission-wait, encoded/decoded bytes dispatched, rows and statements
are charged per statement and rolled up memtrack-style:

    statement meter -> session meter -> user meter -> SERVER

Charges walk the parent chain one per-node lock at a time, never
nested, so the SERVER node is the total and each level is a consistent
slice of it. Work metered on a thread with no meter installed charges
the SERVER node alone.

The port's instrumentation sites are the chokepoints every device
dispatch passes through: `sched.device_slot` (the coprocessor's sync
kernel sites, escalated retries, the delta merge's HBM refill),
`ops/runtime.pipeline_map` (dispatch and finalize of every pipelined
superchunk) and the coprocessor's `host.fallback` region. The
coprocessor fan-out captures `current()` and re-installs it in every
pool and stream worker with `metering()`, as it does the memtrack
tracker and the runtime-stats collector. The disarmed cost is one
thread-local read per note.

Session meters are kept (bounded, LRU) after the session closes;
statement totals fold into a bounded per-digest table at statement end.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict

__all__ = ["Meter", "SERVER", "session_meter", "session_closed",
           "statement_meter",
           "metering", "suspended", "current", "note", "note_device",
           "note_host_fallback", "note_slot_wait", "note_admission_wait",
           "note_bytes", "busy_section", "finish_statement",
           "roll_interval",
           "server_snapshot", "sessions_snapshot", "users_snapshot",
           "digests_snapshot", "top_sessions", "top_digests",
           "attributed_device_ns", "reset_for_tests"]

# the metered quantities, in snapshot/rollup order. All monotone
# cumulative counters — the meter has no release() because work done is
# never handed back.
FIELDS = ("device_ns", "host_fallback_ns", "slot_wait_ns",
          "admission_wait_ns", "bytes_encoded", "bytes_decoded_equiv",
          "rows_sent", "statements")

# retention bounds: closed sessions and digest rollups kept (LRU past
# the cap). Small fixed-size counter structs — ~200 bytes each, so the
# worst case is a few hundred KB, not worth a memtrack node.
_SESSIONS_CAP = 1024
_DIGESTS_CAP = 512


class Meter:
    """One node of the metering tree. Counters are monotone cumulative;
    `last_interval` is the delta the history sampler computed at its
    most recent roll (the "current interval" resource_usage reports)."""

    __slots__ = ("label", "parent", "user", "session_id", "closed",
                 "_mu",
                 "device_ns", "host_fallback_ns", "slot_wait_ns",
                 "admission_wait_ns", "bytes_encoded",
                 "bytes_decoded_equiv", "rows_sent", "statements",
                 "_last", "last_interval")

    def __init__(self, label: str, parent: "Meter | None" = None,
                 user: str = "", session_id: int = 0):
        self.label = label
        self.parent = parent
        self.user = user
        self.session_id = session_id
        self.closed = False     # session meters: the owner went away
        self._mu = threading.Lock()
        self.device_ns = 0              # guarded-by: _mu
        self.host_fallback_ns = 0       # guarded-by: _mu
        self.slot_wait_ns = 0           # guarded-by: _mu
        self.admission_wait_ns = 0      # guarded-by: _mu
        self.bytes_encoded = 0          # guarded-by: _mu
        self.bytes_decoded_equiv = 0    # guarded-by: _mu
        self.rows_sent = 0              # guarded-by: _mu
        self.statements = 0             # guarded-by: _mu
        self._last: dict | None = None        # guarded-by: _mu
        self.last_interval: dict | None = None  # guarded-by: _mu

    def add(self, device_ns: int = 0, host_fallback_ns: int = 0,
            slot_wait_ns: int = 0, admission_wait_ns: int = 0,
            bytes_encoded: int = 0, bytes_decoded_equiv: int = 0,
            rows_sent: int = 0, statements: int = 0) -> None:
        """Charge work to this node and every ancestor (one per-node
        lock at a time while walking up, never nested — the memtrack
        consume() discipline, so the walk can join no lock cycle)."""
        node = self
        while node is not None:
            with node._mu:
                node.device_ns += device_ns
                node.host_fallback_ns += host_fallback_ns
                node.slot_wait_ns += slot_wait_ns
                node.admission_wait_ns += admission_wait_ns
                node.bytes_encoded += bytes_encoded
                node.bytes_decoded_equiv += bytes_decoded_equiv
                node.rows_sent += rows_sent
                node.statements += statements
                nxt = node.parent
            node = nxt

    def totals(self) -> dict:
        with self._mu:
            return {f: getattr(self, f) for f in FIELDS}

    def roll(self) -> dict:
        """Compute this node's delta since the previous roll, store it
        as `last_interval`, and advance the baseline (the history
        sampler drives this once per cadence tick)."""
        with self._mu:
            cur = {f: getattr(self, f) for f in FIELDS}
            prev = self._last
            self.last_interval = cur if prev is None else \
                {f: cur[f] - prev[f] for f in FIELDS}
            self._last = cur
            return self.last_interval

    def snapshot(self) -> dict:
        with self._mu:
            out = {"label": self.label, "user": self.user,
                   "session_id": self.session_id}
            out.update((f, getattr(self, f)) for f in FIELDS)
            iv = self.last_interval
            out["interval"] = dict(iv) if iv else {f: 0 for f in FIELDS}
            return out


# process root: the total of all metered work, attributed or not —
# the denominator of the attribution coverage
SERVER = Meter("server")

_reg_mu = threading.Lock()
_users: dict[str, Meter] = {}                       # guarded-by: _reg_mu
_sessions: "OrderedDict[int, Meter]" = OrderedDict()  # guarded-by: _reg_mu
_digests: "OrderedDict[str, dict]" = OrderedDict()    # guarded-by: _reg_mu


def _user_meter(user: str) -> Meter:
    key = user or "<anonymous>"
    with _reg_mu:
        m = _users.get(key)
        if m is None:
            m = _users[key] = Meter(f"user-{key}", parent=SERVER,
                                    user=key)
        return m


def session_meter(session_id: int, user: str) -> Meter:
    """Register (and return) the meter for one client session. Kept
    after the session closes (bounded past _SESSIONS_CAP) — a closed
    session's device-seconds still reconcile against the SERVER total.
    Eviction prefers CLOSED meters in registration order: a long-lived
    live session must never drop off resource_usage/attribution while
    idle closed ones are retained."""
    m = Meter(f"session-{session_id}", parent=_user_meter(user),
              user=user or "<anonymous>", session_id=session_id)
    with _reg_mu:
        _sessions[session_id] = m
        while len(_sessions) > _SESSIONS_CAP:
            victim = next((sid for sid, old in _sessions.items()
                           if old.closed), None)
            if victim is None:      # backstop: everything claims live
                _sessions.popitem(last=False)
            else:
                _sessions.pop(victim)
    return m


def session_closed(session_id: int) -> None:
    """Mark a session's meter evictable (driven by the Session's
    finalizer — the meter itself, and its rolled-up work, stay)."""
    with _reg_mu:
        m = _sessions.get(session_id)
    if m is not None:
        m.closed = True


def statement_meter(session: Meter | None) -> Meter:
    """A statement-scoped meter under `session` (or under SERVER when
    the session has none — library use). Unregistered: its numbers roll
    up live, and finish_statement() folds its totals into the digest
    table; the object itself just gets dropped."""
    return Meter("stmt", parent=session if session is not None else SERVER)


def finish_statement(stmt: Meter, digest: str,
                     digest_text: str = "") -> None:
    """Fold one finished statement's metered totals into the bounded
    per-digest rollup (the `GET /top` digest ranking)."""
    if not digest:
        return
    tot = stmt.totals()
    with _reg_mu:
        rec = _digests.get(digest)
        if rec is None:
            rec = _digests[digest] = {
                "digest": digest,
                "digest_text": digest_text[:256],
                **{f: 0 for f in FIELDS}}
        _digests.move_to_end(digest)
        for f in FIELDS:
            rec[f] += tot[f]
        while len(_digests) > _DIGESTS_CAP:
            _digests.popitem(last=False)


# -- thread-local installation (mirrors memtrack.tracking) -------------------

_tl = threading.local()


@contextlib.contextmanager
def metering(m: Meter | None):
    """Install `m` as this thread's active meter. Passing None nests
    transparently (keeps the outer meter) — the coprocessor fan-out
    re-installs the captured meter inside pool/stream workers with
    exactly this, like the memtrack tracker and the stats collector."""
    prev = getattr(_tl, "meter", None)
    _tl.meter = m if m is not None else prev
    try:
        yield _tl.meter
    finally:
        _tl.meter = prev


@contextlib.contextmanager
def suspended():
    """Hide the active meter (internal bookkeeping sessions run inside
    a client statement but must not bill the client's tenant — their
    work lands on the SERVER node as unattributed, which is the honest
    place for it)."""
    prev = getattr(_tl, "meter", None)
    _tl.meter = None
    try:
        yield
    finally:
        _tl.meter = prev


def current() -> Meter | None:
    return getattr(_tl, "meter", None)


def note(**fields) -> None:
    """Charge work against this thread's meter, falling back to the
    SERVER node so the process total never loses a nanosecond."""
    m = getattr(_tl, "meter", None)
    (m if m is not None else SERVER).add(**fields)


def _cover(ns: int) -> None:
    """Tell the enclosing busy_section (same thread) that `ns` of its
    interval is already billed, so it charges only the remainder."""
    frames = getattr(_tl, "frames", None)
    if frames:
        frames[-1][0] += ns


def note_device(ns: int) -> None:
    """Device busy-time: one dispatch/finalize interval at a
    sched.device_slot or pipeline_map site."""
    if ns > 0:
        note(device_ns=ns)
        _cover(ns)


def note_host_fallback(ns: int) -> None:
    if ns > 0:
        note(host_fallback_ns=ns)
        _cover(ns)


def note_slot_wait(ns: int) -> None:
    """Slot-wait time also covers any enclosing busy_section: a nested
    device_slot's acquire wait is idle time for this statement, and the
    outer finalize section must not re-bill it as device busy-time."""
    if ns > 0:
        note(slot_wait_ns=ns)
        _cover(ns)


def note_admission_wait(ns: int) -> None:
    if ns > 0:
        note(admission_wait_ns=ns)
        _cover(ns)


def note_bytes(encoded: int, decoded_equiv: int) -> None:
    if encoded or decoded_equiv:
        note(bytes_encoded=encoded, bytes_decoded_equiv=decoded_equiv)


class busy_section:
    """Bill one wall interval as device busy-time (or host-fallback
    time), MINUS whatever nested metered busy intervals already billed
    on this thread — a finalize whose escalation path re-enters
    sched.device_slot (or degrades a partition to host_hash_agg,
    which notes host-fallback) must not count the same nanoseconds
    twice, and the inner, finer-grained classification wins. `kind`
    ("device" | "host") may be reassigned before exit — pipeline_map
    only learns a token's path from dispatch()'s return value."""

    __slots__ = ("kind", "_t0")

    def __init__(self, kind: str = "device"):
        self.kind = kind
        self._t0 = 0

    def __enter__(self):
        frames = getattr(_tl, "frames", None)
        if frames is None:
            frames = _tl.frames = []
        frames.append([0])      # covered-ns accumulator for this frame
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter_ns() - self._t0
        covered = _tl.frames.pop()[0]
        own = dur - covered
        if own > 0:
            if self.kind == "host":
                note(host_fallback_ns=own)
            else:
                note(device_ns=own)
        # the parent frame sees this whole interval as billed
        _cover(max(dur, covered))
        return False


# -- interval roll + snapshots (history sampler / surfaces) ------------------


def roll_interval() -> None:
    """Advance every node's interval baseline — one call per history
    sampler tick, so `last_interval` across the tree describes the SAME
    wall window."""
    SERVER.roll()
    with _reg_mu:
        nodes = list(_users.values()) + list(_sessions.values())
    for m in nodes:
        m.roll()


def server_snapshot() -> dict:
    return SERVER.snapshot()


def sessions_snapshot() -> list[dict]:
    """Per-session meter snapshots (live AND retained-closed), session
    creation order."""
    with _reg_mu:
        nodes = list(_sessions.values())
    return [m.snapshot() for m in nodes]


def users_snapshot() -> list[dict]:
    with _reg_mu:
        nodes = list(_users.values())
    return [m.snapshot() for m in nodes]


def digests_snapshot() -> list[dict]:
    with _reg_mu:
        return [dict(rec) for rec in _digests.values()]


def top_sessions(n: int = 10) -> list[dict]:
    """Sessions ranked by device busy-time over the last sampler
    interval, cumulative device-time as the tiebreak (and the ranking
    itself when the sampler has not rolled yet)."""
    snaps = sessions_snapshot()
    snaps.sort(key=lambda s: (s["interval"].get("device_ns", 0),
                              s["device_ns"]), reverse=True)
    return snaps[:n]


def top_digests(n: int = 10) -> list[dict]:
    recs = digests_snapshot()
    recs.sort(key=lambda r: r["device_ns"], reverse=True)
    return recs[:n]


def attributed_device_ns() -> int:
    """Sum of per-session device busy-time — the attribution coverage's numerator
    (the SERVER node's device_ns is the denominator)."""
    with _reg_mu:
        nodes = list(_sessions.values())
    return sum(m.device_ns for m in nodes)


def reset_for_tests() -> None:
    """Fresh tree (test isolation)."""
    global SERVER
    SERVER = Meter("server")
    with _reg_mu:
        _users.clear()
        _sessions.clear()
        _digests.clear()
