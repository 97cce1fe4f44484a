"""sched_wait_ms: milliseconds an analytic statement waited for the
device scheduler's slots (sched.py), from the program's meter: the slot
wait it bills per statement digest over the window, over the digests'
statements."""


def read(r):
    n = r.slot_wait.get("statements", 0)
    return r.slot_wait["slot_wait_ns"] / n / 1e6 if n else None
