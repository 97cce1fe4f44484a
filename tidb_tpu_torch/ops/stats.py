"""ANALYZE's whole-column sort on the device.

The port of the JAX package's ops/stats.py, where the sort is one
jit-traced XLA program (no Pallas kernel); here it is one `torch.sort`
on the card. The histogram build (statistics.build_column_stats) sorts
each numeric column of 2^17 rows or more this way and reads the sorted
column back once.

Inputs pad to the power-of-two bucket (runtime.bucket_size) as in the
JAX package, with values that sort AFTER every real element (NaN for
floats, the dtype's maximum for integers), so the first n values of the
sorted bucket are exactly the sorted input.
"""

from __future__ import annotations

import numpy as np
import torch

from tidb_tpu_torch.ops import runtime

__all__ = ["device_sort", "pad_for_sort"]


def pad_for_sort(data: np.ndarray) -> np.ndarray:
    """`data` padded to its bucket with values that sort last."""
    n = data.shape[0]
    cap = runtime.bucket_size(n)
    if cap == n:
        return data
    if np.issubdtype(data.dtype, np.inexact):
        fill = np.array(np.nan, dtype=data.dtype)
    else:
        fill = np.array(np.iinfo(data.dtype).max, dtype=data.dtype)
    padded = np.empty(cap, dtype=data.dtype)
    padded[:n] = data
    padded[n:] = fill
    return padded


def device_sort(data: np.ndarray, device=None) -> np.ndarray:
    """Sort a numeric column on `device` (CUDA unless the caller asks for
    another); returns numpy."""
    device = runtime.resolve_device(device)
    n = data.shape[0]
    x = torch.from_numpy(pad_for_sort(np.ascontiguousarray(data)))
    if device.type == "cuda":
        x = x.pin_memory().to(device, non_blocking=True)
    s, _idx = torch.sort(x)
    return s.cpu().numpy()[:n]
