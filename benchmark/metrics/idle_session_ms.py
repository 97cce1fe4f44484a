"""idle_session_ms: milliseconds a statement in which the card is idle
while a `statement` root is open and no cop, execute or wire.write span
is: the SQL front end and the session (session/, parser/, plan/):
parse, plan, admission and the bookkeeping around execute.
The split is idle_cop_ms.py's."""

from benchmark.metrics.idle_cop_ms import split


def read(r):
    got = split(r)
    return None if got is None else got["session"]
