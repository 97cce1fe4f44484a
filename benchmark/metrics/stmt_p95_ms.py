"""stmt_p95_ms: nearest-rank 95th percentile of the latency, send to last
row on the load process's clock, of every analytic statement sent in the
window: the statement as the wire server delivers it."""

from benchmark.yardstick import percentile


def read(r):
    return percentile(r.latencies, 95) * 1e3 if r.latencies else None
