"""The five idle_*_ms metrics on synthetic readings: retained records
whose span trees sit on known monotonic times and offsets, and device
ops on the profiler's Unix clock. Each idle instant goes to the first
layer of cop, exec, write, session and between with a span open; the
five sum to the card's idle time over the covered interval."""

import random

import pytest

from benchmark import catalog
from benchmark.harness import Readings
from tidb_tpu_torch.trace import Span

NAMES = ["idle_cop_ms", "idle_exec_ms", "idle_write_ms", "idle_session_ms",
         "idle_between_ms"]
MS = 1_000_000
OFFSET = 1_790_000_000_000_000_000     # Unix ns minus monotonic ns


def _span(name, start, end, *children):
    s = Span(name)
    s.start_ns, s.end_ns = start, end
    s.children = list(children)
    return s


def _record(root, offset=OFFSET):
    return {"sql": "q", "root": root, "wall_offset_ns": offset,
            "start_unix": (root.start_ns + offset) / 1e9}


def _statement(t, execute, cop, write, end):
    """A root at t ms: execute and, under it, cop spans; wire.write."""
    cops = [_span(name, t + s, t + e) for name, s, e in cop]
    ex = _span("execute", t + execute[0], t + execute[1], *cops)
    kids = [_span("parse", t + 1, t + 2), ex]
    if write is not None:
        kids.append(_span("wire.write", t + write[0], t + write[1]))
    return _span("statement", t, t + end, *kids)


def _readings(records, ops_ms, last_answer_ms, offset=OFFSET):
    r = Readings()
    r.ring = records
    r.device_ops = [("k", s * MS + offset, e * MS + offset)
                    for s, e in ops_ms]
    r.analytic = [("q1", 0.0, last_answer_ms * MS / 1e9, [], None)]
    r.traced_s = 1.0
    return r


def _read(r):
    return {n: catalog.metric_reader(n)(r) for n in NAMES}


def _scaled(root):
    root.start_ns *= MS
    root.end_ns *= MS
    for c in root.children:
        _scaled(c)
    return root


def test_each_idle_interval_goes_to_the_layer_the_priority_names():
    # statement 1 at 0-100 ms, statement 2 at 120-200 ms; a third one
    # ends after the last answer, so the split leaves it out
    one = _scaled(_statement(0, (10, 80), [("copr.task", 20, 50)],
                             (85, 95), 100))
    two = _scaled(_statement(120, (10, 60), [("copr.stream", 20, 40)],
                             (65, 75), 80))
    late = _scaled(_statement(210, (10, 60), [], (65, 75), 80))
    r = _readings([_record(one), _record(two), _record(late)],
                  [(30, 40), (60, 70), (150, 155)], last_answer_ms=201)
    got = _read(r)
    # per statement: cop (30-10 + 20-5) / 2, exec (10+30-10 + 10+20) / 2,
    # write 20 / 2, session (10+5+5 + 10+5+5) / 2, between 20 / 2
    assert got == pytest.approx({"idle_cop_ms": 17.5, "idle_exec_ms": 30.0,
                                 "idle_write_ms": 10.0,
                                 "idle_session_ms": 20.0,
                                 "idle_between_ms": 10.0})
    assert sum(got.values()) * 2 == pytest.approx(200 - 25)


def test_spans_go_onto_the_device_clock_by_each_records_offset():
    one = _scaled(_statement(0, (10, 80), [("copr.task", 20, 50)],
                             (85, 95), 100))
    two = _scaled(_statement(120, (10, 60), [("copr.stream", 20, 40)],
                             (65, 75), 80))
    shift = 3 * MS     # the second record's offset reads 3 ms later
    two_rec = _record(_scaled(_statement(117, (10, 60),
                                         [("copr.stream", 20, 40)],
                                         (65, 75), 80)), OFFSET + shift)
    ops = [(30, 40), (60, 70), (150, 155)]
    same = _read(_readings([_record(one), _record(two)], ops, 201))
    shifted = _read(_readings([_record(one), two_rec], ops, 201))
    assert shifted == pytest.approx(same)


def _oracle(records, ops, last):
    """Layer of each 1-ns step, by the priority, over the covered
    interval: the reference the split is held to."""
    roots = [rec["root"] for rec in records if rec["root"].end_ns <= last]
    a = min(x.start_ns for x in roots)
    b = max(x.end_ns for x in roots)
    layer = {"copr.task": 0, "copr.stream": 0, "execute": 1,
             "wire.write": 2, "statement": 3}
    best = [4] * (b - a)
    busy = [False] * (b - a)

    def walk(s):
        k = layer.get(s.name)
        if k is not None:
            for t in range(max(s.start_ns, a), min(s.end_ns, b)):
                best[t - a] = min(best[t - a], k)
        for c in s.children:
            walk(c)
    for x in roots:
        walk(x)
    for s, e in ops:
        for t in range(max(s, a), min(e, b)):
            busy[t - a] = True
    out = [0] * 5
    for k, on in zip(best, busy):
        if not on:
            out[k] += 1
    return [v / 1e6 / len(roots) for v in out], (b - a) - sum(busy)


@pytest.mark.parametrize("seed", range(8))
def test_the_five_sum_to_the_idle_time_and_match_a_stepwise_count(seed):
    rng = random.Random(seed)
    records, t = [], 0
    for _ in range(rng.randint(1, 6)):
        t += rng.randint(0, 15)
        end = rng.randint(40, 90)
        ex0 = rng.randint(1, 10)
        ex1 = rng.randint(ex0 + 5, end - 15)
        cops = []
        for _ in range(rng.randint(0, 3)):
            c0 = rng.randint(ex0, ex1 - 1)
            cops.append((rng.choice(["copr.task", "copr.stream"]), c0,
                         rng.randint(c0 + 1, ex1 + 3)))
        w0 = rng.randint(ex1, end - 5)
        write = (w0, rng.randint(w0 + 1, end)) if rng.random() < 0.8 \
            else None
        records.append(_record(_statement(t, (ex0, ex1), cops, write, end),
                               0))
        t += end
    ops = []
    for _ in range(rng.randint(0, 30)):
        s = rng.randint(-10, t + 10)
        ops.append((s, s + rng.randint(0, 12)))
    last = rng.choice([rec["root"].end_ns for rec in records] + [t + 50])
    r = Readings()
    r.ring, r.traced_s = records, 1.0
    r.device_ops = [("k", s, e) for s, e in ops]
    r.analytic = [("q1", 0.0, last / 1e9, [], None)]
    want, idle = _oracle(records, ops, last)
    got = _read(r)
    assert [got[n] for n in NAMES] == pytest.approx(want, abs=1e-12)
    n = sum(1 for rec in records if rec["root"].end_ns <= last)
    assert sum(got.values()) * n * 1e6 == pytest.approx(idle)


def test_each_reads_none_without_device_ops_or_offsets():
    root = _scaled(_statement(0, (10, 80), [], (85, 95), 100))
    r = _readings([_record(root)], [(30, 40)], 200)
    assert all(v is not None for v in _read(r).values())
    r.device_ops = None
    assert _read(r) == dict.fromkeys(NAMES)
    # the parent's records carry no offset
    r = _readings([{"sql": "q", "root": root, "start_unix": 0.0}],
                  [(30, 40)], 200)
    assert _read(r) == dict.fromkeys(NAMES)
    r = _readings([], [(30, 40)], 200)
    assert _read(r) == dict.fromkeys(NAMES)
