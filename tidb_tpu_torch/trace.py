"""Statement tracing: lifecycle span trees, sampling, slow-trace
capture, the retention ring and the Chrome trace-event export.

The port's copy of the JAX package's trace.py. `begin`/`end` open and
close a root, `span()` hangs a timed child under the thread's current
span (a no-op, still timed, with none), `event()` marks a point on it,
and `propagate()`/`attached()` carry the current span into the
coprocessor's pool workers, so storage-side spans (cop tasks and
streams, HBM fill and patch, delta fold and merge, the hybrid agg's
partitions) hang off the reader that issued them. `tree`, `validate`
and `phases_of` export a finished tree.

Retention: every statement gets a tree (perfschema's phase breakdown
reads it), and some are retained into the bounded ring (`_Ring`) that
the TRACE statement, `information_schema.statement_traces`, the status
port's `/trace` and the Chrome export (`to_chrome`) serve: 1-in-N
deterministic sampling (`tidb_tpu_trace_sample`), threshold capture
(`tidb_tpu_slow_trace_ms`; the digest summary carries the trace id) and
the TRACE statement, which forces retention (`finish_statement`). The
ring is billed to a `trace-ring` memtrack server node with a registered
shed action, so admission shedding and `/shed` reclaim it.

Across processes (the fleet, store/remote.py): `origin()` is the
forward context a traced store RPC carries, `attach_remote` grafts the
store plane's returned span tree under the calling span, and a trace id
folds the member start nonce (member.py) into its high bits, so ids are
unique across the fleet.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time

__all__ = ["Span", "SPAN_NAMES", "begin", "end", "span", "event",
           "annotate", "current_root", "active", "detach", "restore",
           "attached", "propagate", "attach_remote", "origin",
           "phase_ns", "log_tree", "ensure_id", "finish_statement",
           "tree", "validate", "phases_of", "ring_snapshot",
           "ring_records", "ring_get", "ring_stats", "to_chrome",
           "reset_for_tests"]

log = logging.getLogger("tidb_tpu_torch.trace")

_tl = threading.local()

# declared span vocabulary, the JAX package's table as it is: every
# trace.begin / trace.span call site names one of these, as a string
# literal, so both packages' trees read the same names.
SPAN_NAMES = {
    # statement lifecycle (session/__init__.py)
    "statement": "root of one non-internal statement execution",
    "parse": "this statement's share of the batch parse",
    "plan": "logical+physical planning (plan-cache miss)",
    "execute": "executor tree drive, operator output boundary to rows",
    "commit": "2PC commit incl. optimistic replay retries",
    "admission": "wait in the server admission controller",
    # device plane (sched.py, ops/runtime.py, store/copr.py)
    "sched.slot": "wait for a global device dispatch slot",
    "dispatch": "kernel dispatch: pad/transfer/async enqueue",
    "finalize": "blocking device readback at the output boundary",
    "host.fallback": "host-path aggregation of device-planned work",
    # coprocessor fan-out (store/copr.py)
    "copr.task": "one region task on a coprocessor pool worker",
    "copr.stream": "one streaming fan-out worker's frame production",
    # storage-side caches and deltas (store/device_cache.py, delta.py)
    "hbm.fill": "HBM region-block cache upload",
    "hbm.patch": "in-place delta patch of a resident HBM block",
    "delta.fold": "base-chunk ⋈ delta-journal merge on the read path",
    "delta.merge": "delta-store merge into new base blocks",
    # hybrid join/agg partition phases (ops/hybrid.py)
    "join.partition": "one radix partition's device chain",
    # cross-process storage roots (store/remote.py)
    "storage:coprocessor_stream": "storage-side root of one COP stream",
    # cluster observability fan-out (util/statusclient.fetch_all): one
    # bounded-timeout sweep over live members' status ports serving a
    # cluster_* memtable or a /fleet/* endpoint
    "cluster.fetch": "fan-out fetch over live members' status ports",
}

# retention bounds of the server-scope trace ring: records and an
# estimated-bytes budget, billed to the trace-ring memtrack node
_RING_CAP = 256
_RING_BYTES_CAP = 16 << 20
_SPAN_EST_BYTES = 256          # rough per-span record cost estimate


class Span:
    # the last three slots are ROOT-ONLY retention state (sampling
    # decided at begin(), TRACE forces, ids assigned on first need):
    # begin() writes them; child spans leave them unset — the hot
    # constructor must not pay three dead writes per span
    __slots__ = ("name", "tags", "start_ns", "end_ns", "children",
                 "events", "tid", "sampled", "forced", "trace_id")

    def __init__(self, name: str, tags: dict | None = None):
        self.name = name
        self.tags = tags or {}
        self.start_ns = time.perf_counter_ns()
        self.end_ns = 0
        self.children: list[Span] = []
        self.events: list | None = None   # (name, t_ns, tags), lazy
        self.tid = threading.get_ident()

    @property
    def duration_ns(self) -> int:
        return (self.end_ns or time.perf_counter_ns()) - self.start_ns

    def event(self, name: str, **tags) -> None:
        """Point event on THIS span (fault retries, degrade/quarantine
        transitions, watchdog fires — the device-plane state machine on
        the statement timeline)."""
        ev = (name, time.perf_counter_ns(), tags or None)
        if self.events is None:
            self.events = [ev]
        else:
            self.events.append(ev)

    def to_dict(self) -> dict:
        d = {"name": self.name, "duration_ns": self.duration_ns}
        if self.tags:
            d["tags"] = dict(self.tags)
        if self.events:
            d["events"] = [{"name": n, "tags": t} if t else {"name": n}
                           for n, _t_ns, t in self.events]
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d


def begin(name: str, **tags) -> Span:
    """Open a root span for the current thread's statement. Statement
    roots (`name == "statement"`) take the deterministic 1-in-N
    sampling decision here — `tidb_tpu_trace_sample` — so the whole
    tree below either records for retention or is a pure phase-
    breakdown skeleton."""
    root = Span(name, tags)
    root.sampled = _sample_next() if name == "statement" else False
    root.forced = False
    root.trace_id = None
    _tl.cur = root
    # the ROOT is tracked separately from the current span: origin()
    # must name the enclosing statement from arbitrarily deep inside
    # its tree (spans carry no parent pointers), and the store-RPC
    # client fires from exactly there
    _tl.root = root
    return root


def end(root: Span) -> Span:
    root.end_ns = time.perf_counter_ns()
    if getattr(_tl, "cur", None) is root:
        _tl.cur = None
    if getattr(_tl, "root", None) is root:
        _tl.root = None
    return root


def current_root():
    return getattr(_tl, "cur", None)


def detach():
    """Suspend the thread's trace (internal bookkeeping sessions run
    inside a client statement but must not pollute its phase breakdown).
    -> opaque token for restore()."""
    token = (getattr(_tl, "cur", None), getattr(_tl, "root", None))
    _tl.cur = None
    _tl.root = None
    return token


def restore(token) -> None:
    _tl.cur, _tl.root = token


def propagate():
    """Opaque token naming the current span AND its statement root, for
    re-installation inside worker threads with `attached()` — the trace
    twin of runtime_stats.current() / memtrack.current() riding into
    the coprocessor fan-out. The root rides along so store RPCs issued
    from pool/stream workers still know which statement they originate
    from (origin())."""
    return (getattr(_tl, "cur", None), getattr(_tl, "root", None))


@contextlib.contextmanager
def attached(token):
    """Install a propagate() token (possibly None) as this thread's
    current span + root: spans the worker opens hang off the
    dispatching statement's tree. Child appends are GIL-atomic list
    ops, so concurrent workers may attach under one parent."""
    prev_cur = getattr(_tl, "cur", None)
    prev_root = getattr(_tl, "root", None)
    cur, root = token if token is not None else (None, None)
    _tl.cur = cur if cur is not None else prev_cur
    _tl.root = root if root is not None else prev_root
    try:
        yield
    finally:
        _tl.cur = prev_cur
        _tl.root = prev_root


class span:
    """Child span under the thread's current span; a no-op (still timed,
    but unattached) when no trace is active — internal sessions and
    worker threads pay one thread-local read. A plain slotted context
    manager, not @contextmanager: this sits on the per-statement and
    per-dispatch hot paths, and the generator machinery would double
    the disarmed cost (pinned <5us/statement by TestOverhead). The
    span opens in __init__ — legal because a `with` statement calls
    __enter__ immediately after evaluating the expression, with no
    user code in between; use only as `with trace.span(...)`."""

    __slots__ = ("_span", "_parent")

    def __init__(self, name: str, **tags):
        parent = getattr(_tl, "cur", None)
        s = Span(name, tags)
        self._span = s
        self._parent = parent
        if parent is not None:
            parent.children.append(s)
            _tl.cur = s

    def __enter__(self) -> Span:
        return self._span

    def __exit__(self, exc_type, exc, tb):
        self._span.end_ns = time.perf_counter_ns()
        if self._parent is not None:
            _tl.cur = self._parent
        return False


def active() -> bool:
    """True when the calling thread is inside a traced statement."""
    return getattr(_tl, "cur", None) is not None


def annotate(**tags) -> None:
    """Merge tags into the thread's CURRENT span without opening a child
    — safe from inside generators (a `with span(...)` wrapped around a
    `yield` would interleave restores with the consumer's own spans).
    Used by the streaming coprocessor to stamp per-stream frame/byte/
    stall counts onto the dispatching span. No-op untraced."""
    cur = getattr(_tl, "cur", None)
    if cur is not None:
        cur.tags.update(tags)


def event(name: str, **tags) -> None:
    """Point event on the thread's current span (no-op untraced): the
    call-site form for the device-plane recovery transitions."""
    cur = getattr(_tl, "cur", None)
    if cur is not None:
        cur.event(name, **tags)


def origin() -> dict | None:
    """Forward propagation context of the statement enclosing this
    thread: the fleet-unique trace id of its ROOT plus the retention
    flags, shipped inside traced store RPCs (store/remote.py request
    flags) so anything the store plane retains on its own — slow
    handler roots, forced traces — carries the originating statement's
    id and member instead of being unjoinable. None when untraced."""
    root = getattr(_tl, "root", None)
    if root is None:
        return None
    return {"trace_id": ensure_id(root),
            "sampled": bool(root.sampled),
            "forced": bool(root.forced),
            "member": _member().member_id()}


def attach_remote(d: dict) -> None:
    """Graft a span tree returned by another PROCESS (the storage node's
    side of an RPC — store/remote.py) under the current span. Remote
    clocks don't align, so only names/tags/durations carry over; the
    child is pinned at the current moment with its reported duration.
    Ref: the reference's cross-process span propagation
    (session.go:692 opentracing context over gRPC)."""
    parent = getattr(_tl, "cur", None)
    if parent is None:
        return

    def build(node: dict) -> Span:
        s = Span(node.get("name", "remote"), node.get("tags"))
        dur = int(node.get("duration_ns", 0))
        # end at "now" (the Span's birth instant), duration preserved
        s.end_ns, s.start_ns = s.start_ns, s.start_ns - dur
        for c in node.get("children", ()):
            s.children.append(build(c))
        return s

    parent.children.append(build(d))


def phase_ns(root: Span | None, name: str) -> int:
    """Sum of top-level child spans with `name` (a statement's parse /
    plan / execute / commit phase totals)."""
    if root is None:
        return 0
    return sum(c.duration_ns for c in root.children if c.name == name)


def log_tree(root: Span, sql: str) -> None:
    parts: list[str] = []

    def walk(s: Span, depth: int) -> None:
        parts.append("%s%s %.3fms %s" % (
            "  " * depth, s.name, s.duration_ns / 1e6,
            s.tags if s.tags else ""))
        for c in s.children:
            walk(c, depth + 1)

    walk(root, 0)
    log.info("trace for %r:\n%s", sql[:256], "\n".join(parts))


# -- sampling ----------------------------------------------------------------

_seq_lock = threading.Lock()
_stmt_seq = 0
_id_seq = 0

# lazy config binding: trace.py keeps zero package imports at module
# level (it loads before most of the package), and a per-statement
# `from tidb_tpu_torch import config` would dominate the disarmed cost
_config = None


def _cfg():
    global _config
    if _config is None:
        from tidb_tpu_torch import config
        _config = config
    return _config


def _sample_next() -> bool:
    """Deterministic 1-in-N: the N-th, 2N-th, ... statement since
    process start (or reset) is sampled. One lock'd int increment per
    statement — the whole disarmed cost besides the skeleton spans the
    phase breakdown needs anyway."""
    n = _cfg().trace_sample()
    if n <= 0:
        return False
    global _stmt_seq
    with _seq_lock:
        _stmt_seq += 1
        return _stmt_seq % n == 0


_member_mod = None


def _member():
    global _member_mod
    if _member_mod is None:
        from tidb_tpu_torch import member
        _member_mod = member
    return _member_mod


def ensure_id(root: Span) -> int:
    """The root's fleet-unique trace id, assigned on first need (the
    TRACE statement reads it before retention runs). The process's
    32-bit member start nonce (member.py) occupies the high bits over a
    24-bit per-process sequence: two members minting concurrently never
    collide, a restarted member never reuses its predecessor's id space,
    and ids stay monotonic within one process, so min_id filtering
    (ring_records) works."""
    if root.trace_id is None:
        global _id_seq
        with _seq_lock:
            _id_seq += 1
            seq = _id_seq
        root.trace_id = (_member().nonce() << 24) | (seq & 0xFFFFFF)
    return root.trace_id


# -- the bounded, memtrack-billed trace ring ---------------------------------


class _Ring:
    """Finished trace records, newest last, bounded by count AND an
    estimated-bytes budget billed to a `trace-ring` memtrack SERVER
    node. The registered shed action clears the ring, so admission
    shedding / GET /shed reclaim retained trees."""

    def __init__(self):
        self._mu = threading.Lock()
        self._records: list[dict] = []    # guarded-by: _mu
        self._bytes = 0                   # guarded-by: _mu
        self._node = None                 # guarded-by: _mu (memtrack)

    def _tracker(self):
        """Lazy node creation (imports memtrack on first retention)."""
        from tidb_tpu_torch import memtrack
        with self._mu:
            if self._node is None:
                self._node = memtrack.server_node("trace-ring")
                self._node.add_spill_action(self.shed)
            return self._node

    def append(self, rec: dict) -> None:
        node = self._tracker()
        # lint: exempt[paired-resource] ownership transfer: ring bytes release on evict (below) / shed / reset
        node.consume(host=rec["cost"])
        evicted = 0
        with self._mu:
            self._records.append(rec)
            self._bytes += rec["cost"]
            while len(self._records) > _RING_CAP or \
                    self._bytes > _RING_BYTES_CAP:
                old = self._records.pop(0)
                self._bytes -= old["cost"]
                evicted += old["cost"]
        if evicted:
            node.release(host=evicted)

    def shed(self) -> int:
        """Drop every retained record (the memtrack shed action).
        -> bytes freed."""
        with self._mu:
            freed = self._bytes
            self._records.clear()
            self._bytes = 0
            node = self._node
        if node is not None and freed:
            node.release(host=freed)
        return freed

    def get(self, trace_id: int) -> dict | None:
        with self._mu:
            for rec in self._records:
                if rec["trace_id"] == trace_id:
                    return rec
        return None

    def records(self, min_id: int = 0) -> list[dict]:
        with self._mu:
            return [r for r in self._records if r["trace_id"] > min_id]

    def snapshot(self) -> dict:
        with self._mu:
            return {"records": len(self._records), "bytes": self._bytes}


_RING = _Ring()


def _span_count(root: Span) -> int:
    n = 1
    for c in root.children:
        n += _span_count(c)
    return n


def finish_statement(root: Span, sql: str, error: str | None = None,
                     slow_ms: int | None = None,
                     origin: dict | None = None) -> int | None:
    """Retention decision for one ENDED statement root: keep the full
    tree in the ring when the statement was sampled, forced (TRACE), or
    ran past `tidb_tpu_slow_trace_ms`. -> trace id when retained, else
    None. The untraced path is one flag test + one sysvar read.
    `slow_ms` overrides the registry read — the session passes its
    shadowed (session-SET) value, captured while its overlay was still
    installed. `origin` is the forward-propagated context of a
    cross-process caller (trace.origin() shipped in store-RPC flags):
    the record's origin_trace_id/origin_member then name the SQL
    statement that caused this store-plane root instead of the local
    identity, the join key cluster_statement_traces and /fleet/trace
    search on."""
    if root.forced:
        reason = "forced"
    elif root.sampled:
        reason = "sampled"
    else:
        if slow_ms is None:
            slow_ms = _cfg().slow_trace_ms()
        if slow_ms <= 0 or root.duration_ns < slow_ms * 1_000_000:
            return None
        reason = "slow"
    dur_ns = root.duration_ns
    from tidb_tpu_torch import metrics, perfschema
    tid = ensure_id(root)
    rec = {
        "trace_id": tid,
        "sql": sql[:512],
        "digest": perfschema.sql_digest(sql)[0],
        "start_unix": time.time() - dur_ns / 1e9,
        "duration_ns": dur_ns,
        "reason": reason,
        "error": error and error[:256],
        "span_count": _span_count(root),
        "origin_trace_id": int(origin["trace_id"]) if origin else tid,
        "origin_member": (origin.get("member") or "") if origin
        else _member().member_id(),
        "root": root,
    }
    rec["cost"] = rec["span_count"] * _SPAN_EST_BYTES + len(rec["sql"])
    _RING.append(rec)
    metrics.counter(metrics.TRACES, {"reason": reason})
    return tid


def ring_snapshot() -> list[dict]:
    """Summaries of retained traces, oldest first (the
    information_schema.statement_traces rows and GET /trace list)."""
    out = []
    for rec in _RING.records():
        out.append({k: rec[k] for k in
                    ("trace_id", "digest", "sql", "start_unix",
                     "duration_ns", "span_count", "reason", "error",
                     "origin_trace_id", "origin_member")})
    return out


def ring_records(min_id: int = 0) -> list[dict]:
    """Full retained records (bench attribution walks their trees)."""
    return _RING.records(min_id)


def ring_get(trace_id: int) -> dict | None:
    return _RING.get(trace_id)


def ring_stats() -> dict:
    return _RING.snapshot()


def reset_for_tests() -> None:
    """Clear the ring and the sampling counters (test isolation)."""
    global _stmt_seq, _id_seq
    _RING.shed()
    with _seq_lock:
        _stmt_seq = 0
        _id_seq = 0


# -- exports -----------------------------------------------------------------


def tree(root: Span, base_ns: int | None = None) -> dict:
    """Nested export of one span tree with start offsets: start_us is
    relative to the ROOT's start, so the JSON is self-contained and a
    still-open span (the TRACE statement snapshots its own live root)
    reads as closed at "now"."""
    base = root.start_ns if base_ns is None else base_ns

    def walk(s: Span) -> dict:
        d = {"name": s.name,
             "start_us": round((s.start_ns - base) / 1e3, 3),
             "duration_us": round(s.duration_ns / 1e3, 3)}
        if s.tags:
            d["tags"] = {k: v for k, v in s.tags.items()}
        if s.events:
            d["events"] = [
                {"name": n, "at_us": round((t - base) / 1e3, 3),
                 **({"tags": tg} if tg else {})}
                for n, t, tg in s.events]
        if s.children:
            d["children"] = [walk(c) for c in s.children]
        return d

    return walk(root)


def validate(root: Span) -> list[str]:
    """Structural problems of a FINISHED tree: begin-without-end spans
    and negative durations (the balance check the trace bench and the
    TRACE tests assert empty)."""
    problems: list[str] = []

    def walk(s: Span) -> None:
        if not s.end_ns:
            problems.append(f"span {s.name!r} has no end (begin "
                            f"without end)")
        elif s.end_ns < s.start_ns:
            problems.append(f"span {s.name!r} ends before it starts")
        for c in s.children:
            walk(c)

    walk(root)
    return problems


# the bench attribution's phase buckets: span names summed per trace.
# "other" is the statement remainder — with no cross-thread overlap the
# per-trace phase sum equals the statement duration exactly.
_PHASE_SPANS = {
    "parse": ("parse",),
    "plan": ("plan",),
    "admission_wait": ("admission",),
    "sched_stall": ("sched.slot",),
    "device_dispatch": ("dispatch",),
    "finalize": ("finalize",),
    "host_fallback": ("host.fallback",),
    "commit": ("commit",),
}


def phases_of(root: Span) -> dict:
    """Per-phase nanosecond sums for one finished statement tree — the
    latency-attribution input (bench serve/chaos blocks, ROADMAP item
    2's p99 breakdown). Spans sum BY NAME across the whole tree (pool
    workers included), so concurrent workers can push a phase past the
    wall-clock statement time; "other" floors at zero."""
    sums: dict[str, int] = {}

    def walk(s: Span) -> None:
        sums[s.name] = sums.get(s.name, 0) + s.duration_ns
        for c in s.children:
            walk(c)

    for c in root.children:
        walk(c)
    out = {phase: sum(sums.get(n, 0) for n in names)
           for phase, names in _PHASE_SPANS.items()}
    total = root.duration_ns
    out["total"] = total
    out["other"] = max(0, total - sum(
        v for k, v in out.items() if k != "total"))
    return out


def to_chrome(rec: dict) -> dict:
    """Chrome trace-event JSON for one retained record: complete ("X")
    events per span in µs relative to the root, instant ("i") events
    for the recovery transitions, one lane per OS thread — load it in
    Perfetto / chrome://tracing to SEE dispatch-ahead depth, slot waits
    and finalize serialization across the statement's threads."""
    root: Span = rec["root"]
    base = root.start_ns
    events = [{"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
               "args": {"name": f"tidb-tpu trace {rec['trace_id']}"}}]

    def walk(s: Span) -> None:
        ev = {"ph": "X", "pid": 1, "tid": s.tid, "name": s.name,
              "cat": "statement",
              "ts": round((s.start_ns - base) / 1e3, 3),
              "dur": round(s.duration_ns / 1e3, 3)}
        if s.tags:
            ev["args"] = {k: str(v) for k, v in s.tags.items()}
        events.append(ev)
        for n, t, tg in s.events or ():
            ie = {"ph": "i", "pid": 1, "tid": s.tid, "name": n,
                  "cat": "fault", "s": "t",
                  "ts": round((t - base) / 1e3, 3)}
            if tg:
                ie["args"] = {k: str(v) for k, v in tg.items()}
            events.append(ie)
        for c in s.children:
            walk(c)

    walk(root)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"trace_id": rec["trace_id"],
                          "sql": rec["sql"],
                          "digest": rec["digest"],
                          "reason": rec["reason"]}}
