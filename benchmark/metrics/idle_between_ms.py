"""idle_between_ms: milliseconds a statement in which the card is idle
while no statement root is open: the wire server between one
command's last packet and the read of the next (the socket and the
client).
The split is idle_cop_ms.py's."""

from benchmark.metrics.idle_cop_ms import split


def read(r):
    got = split(r)
    return None if got is None else got["between"]
