"""front_ms: median parse + plan milliseconds of an analytic statement,
from the span trees of the program's trace ring (every statement is
retained in a traced run). The SQL front end: session/, parser/, plan/."""

import statistics

_FRONT = ("parse", "plan")


def _ns(span) -> int:
    own = span.end_ns - span.start_ns if span.name in _FRONT else 0
    return own + sum(_ns(c) for c in span.children)


def read(r):
    xs = [_ns(rec["root"]) / 1e6 for rec in r.ring]
    return statistics.median(xs) if xs else None
