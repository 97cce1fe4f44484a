"""The benchmark's own arithmetic: the nearest-rank percentile, the
table of the cards' peaks, and the bytes a segment sum needs, computed
from its shapes so the count is the same whatever implements the sum.

The percentile and the peak are copies of the program's
(benchmarks/common.percentile, profiler.HBM_PEAK_GBPS), kept here so
that no change to the program moves the yardstick.
"""

from __future__ import annotations

import math

# HBM bandwidth in bytes/s by the name torch.cuda.get_device_name()
# gives, from NVIDIA's data sheet (SXM part, full 700 W power limit)
HBM_PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

_ELEM = {"float32": 4, "float64": 8, "int64": 8}


def percentile(xs, p: float) -> float:
    """Nearest rank: the ceil(p/100 * n)-th smallest of a non-empty
    list."""
    ys = sorted(xs)
    i = min(math.ceil(p / 100.0 * len(ys)) - 1, len(ys) - 1)
    return ys[max(i, 0)]


def segsum_bytes(shape: tuple) -> int:
    """Bytes one segment-sum launch needs: each input read once (values
    [rows, lanes], int32 group ids [rows], the bool mask: none, one per
    row or one per value) and the [groups, lanes] output written once.
    `shape` is (rows, [lanes,] groups, dtype, mask), the key under which
    the program counts its launches by shape."""
    if len(shape) == 5:
        rows, lanes, groups, dtype, mask = shape
    else:
        rows, groups, dtype, mask = shape
        lanes = 1
    elem = _ELEM[dtype]
    mask_bytes = {"none": 0, "row": rows, "lane": rows * lanes}[mask]
    return rows * lanes * elem + rows * 4 + mask_bytes + \
        groups * lanes * elem
