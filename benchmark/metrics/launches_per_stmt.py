"""launches_per_stmt: kernels the card ran in the traced window (the
torch.profiler trace; copies and sets not counted) per analytic
statement completed in it."""

from benchmark.devtrace import is_kernel


def read(r):
    if r.device_ops is None or not r.analytic:
        return None
    return sum(1 for n, _s, _e in r.device_ops if is_kernel(n)) / \
        len(r.analytic)
