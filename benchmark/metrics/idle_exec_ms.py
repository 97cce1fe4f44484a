"""idle_exec_ms: milliseconds a statement in which the card is idle
while an `execute` span is open and no coprocessor span is: the executor
and the host above the reader (executor/, the final merge of
ops/hashagg.py, executor/extsort.py).
The split is idle_cop_ms.py's."""

from benchmark.metrics.idle_cop_ms import split


def read(r):
    got = split(r)
    return None if got is None else got["exec"]
