"""Hierarchical per-statement memory tracking: the port of the JAX
package's memtrack module.

Every byte a statement holds is attributed to a tree of trackers rooted
at the statement, and `tidb_tpu_mem_quota_query` bounds the statement's
total. Each tracker keeps TWO ledgers, host bytes (chunk buffers, hash
builds, agg state, sort runs, superchunk staging) and device bytes
(padded superchunk uploads, device-resident join builds, kernel scratch),
because device memory is the scarcer resource and the two must not
launder into one number. Consumption rolls up the parent chain:

    operator node  ->  statement root  ->  session root  ->  SERVER

The statement root carries the quota and the ordered OOM-action chain:
spill actions registered by operators that can shed memory
(executor/extsort.SpillSorter, ops/hybrid.HybridJoinBuild) fire first;
when none remain, or none helped, the statement cancels with
QuotaExceededError.

Lock discipline: consume/release take one per-node lock at a time while
walking up (never nested), and OOM actions fire AFTER every lock is
dropped, so a spill action may itself consume/release re-entrantly.

The thread-local `tracking()` context installs a statement root; the
call-site helpers (`consume`, `release`, `track_to`, `op_node`,
`register_spill`) are no-ops without one, which is how the port's
operators run when a caller opens no statement.

`MemTracker.cancel` is the dispatch watchdog's latch (sched.py), and a
statement root's `fault_degraded` flag is sched.degrade_statement's.
Left out of the port: `link` (the coprocessor's alias plans, which the
port does not have yet).
"""

from __future__ import annotations

import contextlib
import threading

from tidb_tpu_torch import metrics

__all__ = ["MemTracker", "QuotaExceededError", "SERVER", "tracking",
           "suspended", "current", "check_interrupted",
           "session_root",
           "statement_root",
           "server_node", "op_node", "consume", "release", "device_scope",
           "track_to", "register_spill", "chunk_bytes", "result_bytes",
           "device_put_bytes",
           "sessions_snapshot"]


class QuotaExceededError(Exception):
    """Statement memory over tidb_tpu_mem_quota_query with no spill
    action left (ER_MEM_EXCEED_QUOTA in the JAX package's server)."""


class MemTracker:
    """One node of the tracking tree. host/device are the two ledgers;
    peaks are monotone high-water marks. quota (statement roots only,
    0 = unlimited) bounds host+device. Beside the JAX package's per-ledger
    peaks, `total_peak` is the high-water mark of host+device together
    (the sum the quota compares) and `device_at_peak` the device bytes
    at that moment."""

    __slots__ = ("label", "parent", "quota", "on_cancel", "_mu",
                 "host", "device", "host_peak", "device_peak",
                 "total_peak", "device_at_peak",
                 "_actions", "_firing", "_cancel_msg", "_nodes",
                 "children", "fault_degraded", "interrupted")

    def __init__(self, label: str, parent: "MemTracker | None" = None,
                 quota: int = 0, on_cancel=None):
        self.label = label
        self.parent = parent            # guarded-by: _mu
        self.quota = quota
        self.on_cancel = on_cancel
        self._mu = threading.Lock()
        self.host = 0                   # guarded-by: _mu
        self.device = 0                 # guarded-by: _mu
        self.host_peak = 0              # guarded-by: _mu
        self.device_peak = 0            # guarded-by: _mu
        self.total_peak = 0             # guarded-by: _mu
        self.device_at_peak = 0         # guarded-by: _mu
        self._actions: list = []        # guarded-by: _mu  (OOM spills)
        self._firing = False            # guarded-by: _mu
        self._cancel_msg: str | None = None   # guarded-by: _mu
        # id(plan) -> (plan, tracker)
        self._nodes: dict[int, tuple] = {}    # guarded-by: _mu
        self.children: dict[int, "MemTracker"] = {}   # guarded-by: _mu
        # statement roots only: sched.degrade_statement latched this
        # statement onto the host path after a retried device fault
        self.fault_degraded = False
        # statement roots only: the session's KILL QUERY probe
        # (`check_interrupted` below), read by the workers the root
        # rides to
        self.interrupted = None

    # -- the two ledgers -----------------------------------------------------

    def consume(self, host: int = 0, device: int = 0) -> None:
        """Charge bytes to this node and every ancestor; fires the
        OOM-action chain of the nearest quota-carrying ancestor AFTER all
        locks are released (actions may consume/release re-entrantly).
        The next-parent pointer is read under the node's lock, so a walk
        racing detach() keeps the ancestor ledgers exact."""
        node = self
        fire = None
        while node is not None:
            with node._mu:
                node.host += host
                node.device += device
                if node.host > node.host_peak:
                    node.host_peak = node.host
                if node.device > node.device_peak:
                    node.device_peak = node.device
                if node.host + node.device > node.total_peak:
                    node.total_peak = node.host + node.device
                    node.device_at_peak = node.device
                if fire is None and node.quota and \
                        node.host + node.device > node.quota:
                    fire = node
                nxt = node.parent
            node = nxt
        if fire is not None:
            fire._over_quota()

    def release(self, host: int = 0, device: int = 0) -> None:
        node = self
        while node is not None:
            with node._mu:
                node.host -= host
                node.device -= device
                nxt = node.parent
            node = nxt

    def total(self) -> int:
        return self.host + self.device

    def peak_total(self) -> int:
        return self.host_peak + self.device_peak

    # -- OOM action chain ----------------------------------------------------

    def add_spill_action(self, fn) -> None:
        """Register a memory-shedding callback (fires in quota order,
        re-armed: a spiller that frees bytes may fire again on a later
        episode). The callback must be safe to invoke from any thread
        that consumes into this tree."""
        with self._mu:
            self._actions.append(fn)

    def remove_spill_action(self, fn) -> None:
        with self._mu:
            try:
                self._actions.remove(fn)
            except ValueError:
                pass

    def _over_quota(self) -> None:
        with self._mu:
            if self._cancel_msg is not None:
                # cancel already latched: stragglers re-raise without
                # re-counting the event or re-running the spill chain
                msg = self._cancel_msg
            elif self._firing:     # an action on another frame is already
                return             # shedding; let it finish
            else:
                msg = None
                self._firing = True
                actions = list(self._actions)
        if msg is not None:
            raise QuotaExceededError(msg)
        try:
            for act in actions:
                with self._mu:
                    before = self.host + self.device
                    if before <= self.quota:
                        return
                try:
                    act()
                except Exception:  # noqa: BLE001 - a broken spiller must
                    pass           # not mask the cancel below
                with self._mu:
                    freed = before - (self.host + self.device)
                if freed > 0:
                    # count only spills that actually shed bytes
                    metrics.counter(metrics.MEM_QUOTA_EXCEEDED,
                                    {"action": "spill"})
            with self._mu:
                total = self.host + self.device
                if total <= self.quota:
                    return
                msg = (f"Out Of Memory Quota! query tracked {total} "
                       f"bytes > tidb_tpu_mem_quota_query {self.quota}")
                self._cancel_msg = msg
            metrics.counter(metrics.MEM_QUOTA_EXCEEDED,
                            {"action": "cancel"})
            if self.on_cancel is not None:
                try:
                    self.on_cancel(msg)
                except Exception:  # noqa: BLE001
                    pass
            raise QuotaExceededError(msg)
        finally:
            with self._mu:
                self._firing = False

    def cancel(self, msg: str) -> bool:
        """Latch a statement cancel from OUTSIDE the quota chain — the
        dispatch watchdog's door (sched.py): the message latches exactly
        like a quota cancel (stragglers that later trip the quota
        re-raise it, never re-count), and the on_cancel hook fires.
        Never raises — the caller is a monitor thread, not the consuming
        thread. -> False when a cancel was already latched."""
        with self._mu:
            if self._cancel_msg is not None:
                return False
            self._cancel_msg = msg
        if self.on_cancel is not None:
            try:
                self.on_cancel(msg)
            except Exception:  # noqa: BLE001 - monitor must survive
                pass
        return True

    def run_spill_actions(self, target: int = 0,
                          recurse: bool = False) -> int:
        """Drive registered spill actions until this node's total() is
        at or below `target` bytes; -> bytes freed. Unlike the quota
        chain this never cancels and needs no quota armed. Actions fire
        with every tracker lock dropped, as in the quota chain."""
        with self._mu:
            before = self.host + self.device
        if before <= target:
            return 0
        actions: list = []
        nodes = [self]
        seen: set[int] = set()
        while nodes:
            node = nodes.pop()
            if id(node) in seen:
                continue
            seen.add(id(node))
            with node._mu:
                actions.extend(node._actions)
                if recurse:
                    nodes.extend(node.children.values())
        for act in actions:
            with self._mu:
                cur = self.host + self.device
            if cur <= target:
                break
            try:
                act()
            except Exception:  # noqa: BLE001 - one broken spiller must
                pass           # not stop the rest of the chain
        with self._mu:
            after = self.host + self.device
        return max(before - after, 0)

    # -- per-plan-node children (statement roots) ----------------------------

    def node(self, plan, name: str | None = None) -> "MemTracker":
        """Child tracker for one plan node (in the port: one operator);
        the entry pins the plan so ids cannot recycle while this root
        lives (cleared on detach)."""
        with self._mu:
            ent = self._nodes.get(id(plan))
        if ent is not None:
            return ent[1]
        if name is None:
            name = type(plan).__name__.removeprefix("Phys")
        child = MemTracker(name, parent=self)
        with self._mu:
            ent = self._nodes.setdefault(id(plan), (plan, child))
        return ent[1]

    # -- lifecycle -----------------------------------------------------------

    def detach(self) -> None:
        """Unhook from the parent, crediting back everything still held.
        Peaks (and residual current counters) survive for readers."""
        with self._mu:
            p = self.parent
            if p is None:
                return
            h, d = self.host, self.device
            self.parent = None
            self._nodes = {}       # drop plan pins
            self._actions = []
        with p._mu:
            p.children.pop(id(self), None)
        if h or d:
            p.release(host=h, device=d)

    def snapshot(self) -> dict:
        with self._mu:
            return {"label": self.label, "host": self.host,
                    "device": self.device, "host_peak": self.host_peak,
                    "device_peak": self.device_peak}


# process root: every session tracker hangs off it
SERVER = MemTracker("server")


def session_root(session_id: int) -> MemTracker:
    t = MemTracker(f"session-{session_id}", parent=SERVER)
    with SERVER._mu:
        SERVER.children[id(t)] = t
    return t


def server_node(label: str) -> MemTracker:
    """A long-lived server-scope tracker (shared caches, pools): a child
    of SERVER that belongs to no session or statement."""
    t = MemTracker(label, parent=SERVER)
    with SERVER._mu:
        SERVER.children[id(t)] = t
    return t


def statement_root(parent: MemTracker | None, quota: int = 0,
                   on_cancel=None, label: str = "stmt") -> MemTracker:
    t = MemTracker(label, parent=parent, quota=quota, on_cancel=on_cancel)
    if parent is not None:
        with parent._mu:
            parent.children[id(t)] = t
    return t


def sessions_snapshot() -> list[dict]:
    """Per-session tracker snapshots, session creation order."""
    with SERVER._mu:
        kids = list(SERVER.children.values())
    return [t.snapshot() for t in kids]


# -- thread-local installation ----------------------------------------------

_tl = threading.local()


@contextlib.contextmanager
def tracking(root: MemTracker | None):
    """Install `root` as this thread's active statement tracker. Passing
    None nests transparently (keeps the outer tracker)."""
    prev = getattr(_tl, "root", None)
    _tl.root = root if root is not None else prev
    try:
        yield _tl.root
    finally:
        _tl.root = prev


@contextlib.contextmanager
def suspended():
    """Hide the active tracker (internal work that runs inside a
    statement but must not bill it)."""
    prev = getattr(_tl, "root", None)
    _tl.root = None
    try:
        yield
    finally:
        _tl.root = prev


def current() -> MemTracker | None:
    return getattr(_tl, "root", None)


def check_interrupted() -> None:
    """Raise the statement's interrupt (ExecError, ER_QUERY_INTERRUPTED
    on the wire) when the statement whose root this thread carries was
    killed (KILL QUERY / CONNECTION): the coprocessor's pool workers and
    the device pipeline stop at their next task or batch on it, not
    only the statement's own thread."""
    root = getattr(_tl, "root", None)
    probe = root.interrupted if root is not None else None
    if probe is not None and probe():
        from tidb_tpu_torch.executor import ExecError
        raise ExecError("Query execution was interrupted")


def op_node(plan) -> MemTracker | None:
    """The active statement's tracker node for `plan` (None when no
    tracker is installed)."""
    root = getattr(_tl, "root", None)
    if root is None:
        return None
    return root.node(plan)


def consume(plan, host: int = 0, device: int = 0) -> None:
    """Charge bytes against the active statement's node for `plan`
    (no-op without a tracker)."""
    root = getattr(_tl, "root", None)
    if root is not None and (host or device):
        root.node(plan).consume(host=host, device=device)


def release(plan, host: int = 0, device: int = 0) -> None:
    root = getattr(_tl, "root", None)
    if root is not None and (host or device):
        root.node(plan).release(host=host, device=device)


@contextlib.contextmanager
def device_scope(plan, nbytes: int):
    """Hold `nbytes` on `plan`'s device ledger for the duration of a
    synchronous kernel call. Split dispatch/finalize pairs (pipelines)
    pair consume and release by hand."""
    consume(plan, device=nbytes)
    try:
        yield
    finally:
        release(plan, device=nbytes)


def track_to(plan, nbytes: int, prev: int = 0, kind: str = "host") -> int:
    """Move `plan`'s tracked bytes (one ledger) to an absolute value:
    the pattern for accumulators that grow or shrink (hash builds, agg
    state). Returns nbytes for the caller to carry."""
    delta = nbytes - prev
    if delta > 0:
        consume(plan, **{kind: delta})
    elif delta < 0:
        release(plan, **{kind: -delta})
    return nbytes


def register_spill(fn):
    """Hook a spill action onto the active statement root; returns an
    unregister callable (a no-op pair when no tracker is active)."""
    root = getattr(_tl, "root", None)
    if root is None:
        return lambda: None
    root.add_spill_action(fn)
    return lambda: root.remove_spill_action(fn)


# -- size estimators --------------------------------------------------------

_STR_TYPES = {str, bytes}


def chunk_bytes(chunk) -> int:
    """Host footprint of a chunk: numpy buffers at their real size,
    object (string) columns at pointer + payload length. Memoized on the
    (immutable) chunk."""
    hit = getattr(chunk, "_bytes_memo", None)
    if hit is not None:
        return hit
    total = 0
    for c in chunk.columns:
        data = c.data
        if getattr(data, "dtype", None) is not None and \
                data.dtype != object:
            total += data.nbytes
        else:
            total += 8 * len(data)
            if set(map(type, data)) <= _STR_TYPES:
                # the same sum with the per-element work in C: a column
                # of plain strings takes ~1/10 of the generator's time
                total += sum(map(len, data))
            else:
                total += sum(len(x) for x in data
                             if isinstance(x, (str, bytes)))
        total += len(c.valid)          # bool mask
    try:
        chunk._bytes_memo = total
    except AttributeError:
        pass        # duck-typed chunk without the memo slot
    return total


def result_bytes(res) -> int:
    """Host footprint of a coprocessor response payload: a decoded
    Chunk (chunk_bytes), or an agg partial shaped like
    ops.hashagg.GroupResult (keys / per-agg lane arrays / counts).
    Anything else — scalar partials are a handful of lanes — rounds to
    its lane arrays alone."""
    if getattr(res, "columns", None) is not None:
        return chunk_bytes(res)
    total = 0
    for lanes in getattr(res, "partials", None) or []:
        for arr in lanes:
            nb = getattr(arr, "nbytes", None)
            total += nb if nb is not None else 8 * len(arr)
    counts = getattr(res, "counts", None)
    if counts is not None:
        total += counts.nbytes
    for key in getattr(res, "keys", None) or []:
        total += 8 * max(len(key), 1)
        total += sum(len(x) for x in key if isinstance(x, (str, bytes)))
    return total


_MIN_BUCKET = 1024     # ops/runtime.MIN_BUCKET (this module imports no torch)


def _bucket(n: int) -> int:
    b = _MIN_BUCKET
    while b < n:
        b <<= 1
    return b


def device_put_bytes(chunk, size: int | None = None) -> int:
    """Device bytes one transfer of every column of `chunk` stages, from
    shapes alone: ops/runtime.put_lanes pads each column to the bucket
    size as an 8-byte data lane (varlen columns ship as int64 dictionary
    codes) plus a bool validity lane. The JAX package's count for the
    same chunk is the same number."""
    n = size or _bucket(max(chunk.num_rows, 1))
    total = 0
    for c in chunk.columns:
        itemsize = 8 if c.data.dtype == object else c.data.dtype.itemsize
        total += n * (itemsize + 1)
    return total
