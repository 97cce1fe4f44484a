"""PERFORMANCE_SCHEMA statement events + the statement digest summary.

Reference: TiDB's perfschema/const.go:120-298 — the
events_statements_current / events_statements_history virtual tables.
Process-wide: a per-session current-event slot plus a bounded history
ring; every non-internal statement records its SQL, wall time, phase
breakdown (parse/plan/execute/commit, from the trace span tree), row
count and error state. Served as memtables by the planner, exactly like
INFORMATION_SCHEMA.

The digest summary (`events_statements_summary_by_digest`) aggregates
repeated statements under one normalized-SQL digest — literals stripped
via the real lexer, so `SELECT * FROM t WHERE id = 7` and `... = 8`
share a row — with exec counts, sum/max latency, the phase breakdown,
and per-digest operator hot spots from the runtime-stats collector
(ref: the reference's statement summary tables,
util/stmtsummary/statement_summary.go)."""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict, deque

__all__ = ["stmt_begin", "stmt_end", "current_events", "history_events",
           "normalize_sql", "sql_digest", "digest_record",
           "digest_summary", "memo_record", "memo_snapshot", "memo_reset",
           "HISTORY_CAP", "SUMMARY_CAP"]

HISTORY_CAP = 1024
SUMMARY_CAP = 512          # distinct digests kept (LRU beyond)

_lock = threading.Lock()
_history: deque = deque(maxlen=HISTORY_CAP)          # guarded-by: _lock
_current: dict[int, dict] = {}       # guarded-by: _lock  (sid -> event)
_event_seq = 0                       # guarded-by: _lock
# digest -> record
_summary: "OrderedDict[str, dict]" = OrderedDict()   # guarded-by: _lock


def stmt_begin(session_id: int, sql: str) -> dict:
    global _event_seq
    with _lock:
        _event_seq += 1
        ev = {
            "thread_id": session_id,
            "event_id": _event_seq,
            "sql_text": sql[:1024],
            "state": "running",
            "timer_start_us": int(time.time() * 1e6),
            "timer_wait_ns": 0,
            "parse_ns": 0, "plan_ns": 0, "exec_ns": 0, "commit_ns": 0,
            "rows": 0,
            "error": None,
        }
        _current[session_id] = ev
        return ev


def stmt_end(ev: dict, root=None, rows: int = 0,
             error: str | None = None) -> None:
    from tidb_tpu_torch import trace
    with _lock:
        ev["state"] = "error" if error else "completed"
        ev["error"] = error and error[:256]
        ev["rows"] = rows
        if root is not None:
            ev["timer_wait_ns"] = root.duration_ns
            for phase in ("parse", "plan", "execute", "commit"):
                key = ("exec" if phase == "execute" else phase) + "_ns"
                ev[key] = trace.phase_ns(root, phase)
        _history.append(dict(ev))


def session_closed(session_id: int) -> None:
    with _lock:
        _current.pop(session_id, None)


def current_events() -> list[dict]:
    with _lock:
        return [dict(ev) for _sid, ev in sorted(_current.items())]


def history_events() -> list[dict]:
    with _lock:
        return [dict(ev) for ev in _history]


# -- statement digest summary ----------------------------------------------


def normalize_sql(sql: str) -> str:
    """Literal-stripped canonical form: numeric/string literals become
    `?`, keywords uppercase, identifiers lowercase, one space between
    tokens. Tokenized by the real lexer so quoting/comments can't fool
    it; unlexable text falls back to whitespace collapse."""
    from tidb_tpu_torch.parser.lexer import Lexer, TokenType
    try:
        toks = Lexer(sql).tokens()
    except Exception:  # noqa: BLE001 - redacted/garbled text must still
        return " ".join(sql.split())   # produce a stable digest
    out = []
    for t in toks:
        if t.tp == TokenType.EOF:
            break
        if t.tp in (TokenType.INT, TokenType.DECIMAL, TokenType.FLOAT,
                    TokenType.STRING):
            out.append("?")
        elif t.tp == TokenType.KEYWORD:
            out.append(str(t.val).upper())
        elif t.tp == TokenType.IDENT:
            out.append(str(t.val).lower())
        else:
            out.append(str(t.val))
    return " ".join(out)


# repeated identical SQL is the digest table's whole point: memoize the
# (re-)lex. Only short statements are cached — a multi-MB bulk INSERT
# would pin its whole text as a cache key.
_digest_lock = threading.Lock()
# guarded-by: _digest_lock
_digest_cache: "OrderedDict[str, tuple[str, str]]" = OrderedDict()
_DIGEST_CACHE_CAP = 256
_DIGEST_CACHE_MAX_SQL = 8192


def sql_digest(sql: str) -> tuple[str, str]:
    """-> (digest hex, normalized text). LRU-memoized for short SQL."""
    cacheable = len(sql) <= _DIGEST_CACHE_MAX_SQL
    if cacheable:
        with _digest_lock:
            hit = _digest_cache.get(sql)
            if hit is not None:
                _digest_cache.move_to_end(sql)
                return hit
    norm = normalize_sql(sql)
    out = (hashlib.sha256(norm.encode()).hexdigest()[:32], norm)
    if cacheable:
        with _digest_lock:
            _digest_cache[sql] = out
            while len(_digest_cache) > _DIGEST_CACHE_CAP:
                _digest_cache.popitem(last=False)
    return out


def digest_record(sql: str, dur_ns: int, phases: dict | None = None,
                  rows: int = 0, error: str | None = None,
                  op_stats: list[dict] | None = None,
                  mem_bytes: int = 0,
                  tag: str | None = None,
                  trace_id: int | None = None) -> tuple[str, str]:
    """Fold one finished statement into its digest's summary row.
    -> (digest, normalized text) so callers (slow log) can reuse them.
    `tag` disambiguates statements inside a multi-statement batch (the
    parser keeps no per-statement offsets, so all of them share the
    batch text): without it, an INSERT and a SELECT in one batch would
    merge their phases and op stats under a single digest row."""
    dg, norm = sql_digest(sql)
    if tag:
        norm = f"{norm} [{tag}]"
        dg = hashlib.sha256(norm.encode()).hexdigest()[:32]
    now = time.time()
    with _lock:
        rec = _summary.get(dg)
        if rec is None:
            rec = _summary[dg] = {
                "digest": dg, "digest_text": norm[:1024],
                "exec_count": 0, "sum_latency_ns": 0,
                "max_latency_ns": 0, "min_latency_ns": None,
                "sum_parse_ns": 0, "sum_plan_ns": 0, "sum_exec_ns": 0,
                "sum_commit_ns": 0, "sum_rows": 0, "sum_errors": 0,
                "max_mem_bytes": 0,   # peak tracked bytes (memtrack)
                "last_trace_id": 0,   # latest retained trace (trace.py)
                "first_seen": now, "last_seen": now,
                "ops": {},      # op name -> {time_ns, act_rows, device}
            }
        _summary.move_to_end(dg)
        rec["exec_count"] += 1
        rec["sum_latency_ns"] += dur_ns
        rec["max_latency_ns"] = max(rec["max_latency_ns"], dur_ns)
        rec["min_latency_ns"] = dur_ns if rec["min_latency_ns"] is None \
            else min(rec["min_latency_ns"], dur_ns)
        for phase, ns in (phases or {}).items():
            rec["sum_" + phase + "_ns"] = \
                rec.get("sum_" + phase + "_ns", 0) + ns
        rec["sum_rows"] += rows
        if error:
            rec["sum_errors"] += 1
        if mem_bytes > rec.get("max_mem_bytes", 0):
            rec["max_mem_bytes"] = mem_bytes
        if trace_id is not None:
            # a digest hot spot links to its latest concrete timeline
            # (sampled or slow-captured — trace.py retention)
            rec["last_trace_id"] = trace_id
        rec["last_seen"] = now
        for op in op_stats or ():
            agg = rec["ops"].setdefault(
                op["name"], {"time_ns": 0, "act_rows": 0,
                             "device_time_ns": 0})
            agg["time_ns"] += op.get("time_ns", 0)
            agg["act_rows"] += op.get("act_rows", 0)
            agg["device_time_ns"] += op.get("device_time_ns", 0)
        while len(_summary) > SUMMARY_CAP:
            _summary.popitem(last=False)
    return dg, norm


def digest_max_mem(sql: str) -> int:
    """The digest's historical peak tracked bytes (0 when unseen): the
    admission controller's footprint projection — a statement shaped
    like one that peaked at N bytes is assumed to need N again."""
    dg, _norm = sql_digest(sql)
    with _lock:
        rec = _summary.get(dg)
        return rec.get("max_mem_bytes", 0) if rec is not None else 0


def _hot_ops(rec: dict, top: int = 3) -> str:
    """Per-digest operator hot spots, worst first."""
    items = sorted(rec["ops"].items(), key=lambda kv: -kv[1]["time_ns"])
    parts = []
    for name, a in items[:top]:
        s = f"{name} time={a['time_ns'] / 1e6:.2f}ms rows={a['act_rows']}"
        if a["device_time_ns"]:
            s += f" device={a['device_time_ns'] / 1e6:.2f}ms"
        parts.append(s)
    return "; ".join(parts)


def digest_summary() -> list[dict]:
    """Snapshot rows for events_statements_summary_by_digest, hottest
    (by cumulative latency) first."""
    with _lock:
        # per-record deep copy of the ops map: digest_record mutates the
        # live dicts under this same lock, and _hot_ops iterates them
        # after release
        recs = []
        for r in _summary.values():
            c = dict(r)
            c["ops"] = {k: dict(v) for k, v in r["ops"].items()}
            recs.append(c)
    recs.sort(key=lambda r: -r["sum_latency_ns"])
    out = []
    for r in recs:
        out.append({
            "digest": r["digest"], "digest_text": r["digest_text"],
            "exec_count": r["exec_count"],
            "sum_latency_ns": r["sum_latency_ns"],
            "max_latency_ns": r["max_latency_ns"],
            "min_latency_ns": r["min_latency_ns"] or 0,
            "avg_latency_ns": r["sum_latency_ns"] // r["exec_count"],
            "sum_parse_ns": r["sum_parse_ns"],
            "sum_plan_ns": r["sum_plan_ns"],
            "sum_exec_ns": r["sum_exec_ns"],
            "sum_commit_ns": r["sum_commit_ns"],
            "sum_rows": r["sum_rows"], "sum_errors": r["sum_errors"],
            "max_mem_bytes": r.get("max_mem_bytes", 0),
            "last_trace_id": r.get("last_trace_id", 0),
            "first_seen": r["first_seen"], "last_seen": r["last_seen"],
            "top_operators": _hot_ops(r),
        })
    return out


# -- per-digest mode-history memo ------------------------------------------
#
# The optimizer's mode choices (direct vs hash group table, fused vs
# unfused, hybrid engaged, host fallback) are made from *estimates*; this
# memo records what actually ran, per digest and per operator, with the
# observed group cardinality and per-mode device time. It is the read
# side for feedback-driven mode selection (ROADMAP item 3): a planner
# that consults `memo_lookup`-style reads can learn "this digest's
# hashagg always escalates — start at the bigger capacity" without
# re-discovering it per statement. Same LRU discipline as _summary.

_memo_lock = threading.Lock()
# (digest, op name) -> record                    guarded-by: _memo_lock
_memo: "OrderedDict[tuple[str, str], dict]" = OrderedDict()


def memo_record(digest: str, op_stats: list[dict] | None) -> None:
    """Fold one statement's per-operator runtime stats into the memo.
    Only operators that reported a `mode` (i.e. actually chose between
    execution strategies) take a row — scans/sorts without a mode field
    stay out so the table holds decisions, not the whole plan."""
    if not op_stats:
        return
    from tidb_tpu_torch import config
    cap = config.stmt_profile_cap()
    now = time.time()
    with _memo_lock:
        for op in op_stats:
            mode = op.get("mode")
            if not mode:
                continue
            key = (digest, op.get("name", "?"))
            rec = _memo.get(key)
            if rec is None:
                rec = _memo[key] = {
                    "digest": digest, "op": key[1],
                    "runs": 0, "last_mode": "", "last_groups": 0,
                    "max_groups": 0, "first_seen": now, "last_seen": now,
                    "modes": {},   # mode -> {runs, device_ns, rows}
                }
            _memo.move_to_end(key)
            groups = op.get("act_rows", 0)
            rec["runs"] += 1
            rec["last_mode"] = mode
            rec["last_groups"] = groups
            rec["max_groups"] = max(rec["max_groups"], groups)
            rec["last_seen"] = now
            m = rec["modes"].setdefault(
                mode, {"runs": 0, "device_ns": 0, "rows": 0})
            m["runs"] += 1
            m["device_ns"] += op.get("device_time_ns", 0)
            m["rows"] += groups
        while len(_memo) > cap:
            _memo.popitem(last=False)


def memo_snapshot() -> list[dict]:
    """Rows for information_schema.statement_profile, one per
    (digest, operator, mode) — flattened so SQL can filter on mode."""
    with _memo_lock:
        recs = []
        for r in _memo.values():
            recs.append((dict(r), {k: dict(v) for k, v in
                                   r["modes"].items()}))
    out = []
    for rec, modes in recs:
        for mode, m in modes.items():
            out.append({
                "digest": rec["digest"], "op": rec["op"], "mode": mode,
                "runs": m["runs"], "device_ns": m["device_ns"],
                "rows": m["rows"],
                "last_mode": rec["last_mode"],
                "last_groups": rec["last_groups"],
                "max_groups": rec["max_groups"],
                "last_seen": rec["last_seen"],
            })
    out.sort(key=lambda r: (-r["device_ns"], r["digest"], r["op"]))
    return out


def memo_reset() -> None:
    with _memo_lock:
        _memo.clear()


def reset() -> None:
    """Test hook."""
    global _event_seq
    with _lock:
        _history.clear()
        _current.clear()
        _summary.clear()
        _event_seq = 0
    memo_reset()
