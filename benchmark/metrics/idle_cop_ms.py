"""idle_cop_ms: milliseconds a statement in which the card is idle while
a coprocessor span (`copr.task`, `copr.stream`) of a statement is open:
the reader and coprocessor layer (store/copr.py, executor/reader.py).

This file holds the split that the five idle_*_ms metrics read. Its
interval runs from the first to the last end of the traced window's
retained statement roots that ended by the window's last answer. Each
instant in it at which the card runs no operation goes to the first
layer with a span open then: cop (`copr.task`, `copr.stream`), exec
(`execute`), write (`wire.write`), session (the `statement` root), else
between (no root open). Spans go onto the device trace's clock by each
record's `wall_offset_ns`. The five sum to the card's idle time over the
interval; each is divided by the number of roots it covers. None
without a device trace, and where the records carry no offset."""

from benchmark.devtrace import busy_intervals

LAYERS = ("cop", "exec", "write", "session", "between")
# span name -> its layer's index in LAYERS; the root is "session"
_SPAN_LAYER = {"copr.task": 0, "copr.stream": 0, "execute": 1,
               "wire.write": 2}


def _clip(u: list, a: int, b: int) -> list:
    return [[max(s, a), min(e, b)] for s, e in u if e > a and s < b]


def _overlap(u: list, v: list) -> int:
    """Length of the intersection of two sorted disjoint unions."""
    i = j = n = 0
    while i < len(u) and j < len(v):
        s, e = max(u[i][0], v[j][0]), min(u[i][1], v[j][1])
        if e > s:
            n += e - s
        if u[i][1] < v[j][1]:
            i += 1
        else:
            j += 1
    return n


def spans_by_layer(recs: list) -> list:
    """(name, start, end) on the device clock, per layer but between:
    [cop, exec, write, session]."""
    out = [[], [], [], []]
    for rec in recs:
        off = rec["wall_offset_ns"]
        root = rec["root"]
        out[3].append(("statement", root.start_ns + off, root.end_ns + off))
        stack = list(root.children)
        while stack:
            s = stack.pop()
            layer = _SPAN_LAYER.get(s.name)
            if layer is not None:
                out[layer].append((s.name, s.start_ns + off, s.end_ns + off))
            stack.extend(s.children)
    return out


def covered(r) -> list:
    """The retained records the split covers: those with an offset whose
    root ended by the last answer the load process received in the
    window (perf_counter on both sides: CLOCK_MONOTONIC)."""
    if not r.analytic:
        return []
    last_ns = max(rec[2] for rec in r.analytic) * 1e9
    return [rec for rec in r.ring if "wall_offset_ns" in rec
            and rec["root"].end_ns <= last_ns]


def split(r) -> dict | None:
    """-> {layer: ms of card idle time a covered statement}, or None."""
    if r.device_ops is None:
        return None
    recs = covered(r)
    if not recs:
        return None
    layers = spans_by_layer(recs)
    a = min(s for _n, s, _e in layers[3])
    b = max(e for _n, _s, e in layers[3])
    busy = _clip(busy_intervals(r.device_ops), a, b)
    idle = (b - a) - sum(e - s for s, e in busy)
    out, upto, idle_upto = {}, [], 0
    for name, spans in zip(LAYERS, layers):
        upto += spans
        cover = _clip(busy_intervals(upto), a, b)
        now = sum(e - s for s, e in cover) - _overlap(cover, busy)
        out[name] = now - idle_upto
        idle_upto = now
    out["between"] = idle - idle_upto
    return {k: v / 1e6 / len(recs) for k, v in out.items()}


def read(r):
    got = split(r)
    return None if got is None else got["cop"]
