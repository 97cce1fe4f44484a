"""idle_write_ms: milliseconds a statement in which the card is idle
while the wire server writes a response (`wire.write`, from its first
packet to its last sendall): the wire server (server/).
The split is idle_cop_ms.py's."""

from benchmark.metrics.idle_cop_ms import split


def read(r):
    got = split(r)
    return None if got is None else got["write"]
