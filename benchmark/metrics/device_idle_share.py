"""device_idle_share: the share of the traced window in which no
operation ran on the card, in percent: one less the union of the device
ops' intervals in the torch.profiler trace over the window."""

from benchmark.devtrace import busy_intervals


def read(r):
    if r.device_ops is None or not r.traced_s:
        return None
    busy = sum(e - s for s, e in busy_intervals(r.device_ops)) / 1e9
    return 100.0 * (1.0 - busy / r.traced_s)
