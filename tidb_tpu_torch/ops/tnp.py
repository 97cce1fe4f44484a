"""A small numpy-style namespace over torch, bound to one device.

The counterpart of `jax.numpy` in the JAX package: `Expression.eval_xp(xp,
cols, n)` and the kernel bodies are written once against an array
namespace, and this module lets the port pass torch tensors through the
same bodies line for line. It supplies only what the slice needs, and
papers over the three places where torch's defaults differ from numpy's:

* dtypes may be given as numpy dtypes (`np.int64`, `np.dtype(bool)`);
* a python float constant is float64 (`torch.full((n,), 1.5)` and
  `torch.asarray(1.5)` would give float32);
* `where` with a python float against an integer tensor promotes to
  float64, as numpy does (torch would pick float32).

Every array it creates lies on the namespace's device; nothing here
synchronises with the device.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["on", "Namespace", "torch_dtype", "astype"]

_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(dt) -> torch.dtype:
    """numpy dtype (or python type, or torch dtype) -> torch dtype."""
    if dt is None or isinstance(dt, torch.dtype):
        return dt
    return _DTYPES[np.dtype(dt)]


def astype(x: torch.Tensor, dt) -> torch.Tensor:
    """`x.astype(dt)` for a tensor: a cast, integer casts wrapping."""
    return x.to(torch_dtype(dt))


def _scalar(v):
    """numpy scalars -> python scalars (torch treats those as weakly typed)."""
    return v.item() if isinstance(v, np.generic) else v


class Namespace:
    """The array functions the ported eval_xp bodies call, on one device."""

    def __init__(self, device):
        self.device = torch.device(device)

    def __repr__(self):
        return f"tnp.on({str(self.device)!r})"

    # -- construction -------------------------------------------------------

    def asarray(self, x, dtype=None):
        dt = torch_dtype(dtype)
        if isinstance(x, torch.Tensor):
            return x if dt is None or x.dtype == dt else x.to(dt)
        if isinstance(x, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
            return t if dt is None else t.to(dt)
        return self._const(_scalar(x), dt)

    def _const(self, v, dt=None):
        """A 0-d tensor made on the device by a fill (as_tensor would copy
        from the host and synchronise)."""
        if dt is None:
            dt = torch.float64 if isinstance(v, float) else \
                torch.bool if isinstance(v, bool) else torch.int64
        return torch.full((), v, dtype=dt, device=self.device)

    def full(self, n, v, dtype=None):
        v = _scalar(v)
        dt = torch_dtype(dtype)
        if dt is None:
            dt = torch.float64 if isinstance(v, float) else \
                torch.bool if isinstance(v, bool) else torch.int64
        return torch.full((n,) if isinstance(n, int) else tuple(n), v,
                          dtype=dt, device=self.device)

    def zeros(self, n, dtype=None):
        return self.full(n, 0, dtype=dtype or np.float64)

    def ones(self, n, dtype=None):
        return self.full(n, 1, dtype=dtype or np.float64)

    def arange(self, n, dtype=np.int64):
        return torch.arange(n, dtype=torch_dtype(dtype), device=self.device)

    @staticmethod
    def zeros_like(x):
        return torch.zeros_like(x)

    @staticmethod
    def ones_like(x):
        return torch.ones_like(x)

    # -- elementwise --------------------------------------------------------

    def where(self, cond, a, b):
        a, b = _scalar(a), _scalar(b)
        ta, tb = isinstance(a, torch.Tensor), isinstance(b, torch.Tensor)
        if not ta and not tb:
            dt = torch.float64 if isinstance(a, float) or \
                isinstance(b, float) else torch.int64
            a, b = self._const(a, dt), self._const(b, dt)
        elif ta != tb:
            t, s = (a, b) if ta else (b, a)
            if isinstance(s, float) and not t.dtype.is_floating_point:
                t = t.to(torch.float64)
                a, b = (t, s) if ta else (s, t)
        return torch.where(cond, a, b)

    @staticmethod
    def minimum(a, b):
        if not isinstance(b, torch.Tensor):
            return torch.clamp(a, max=_scalar(b))
        return torch.minimum(a, b)

    @staticmethod
    def clip(x, lo, hi):
        return torch.clamp(x, _scalar(lo), _scalar(hi))

    abs = staticmethod(torch.abs)
    sign = staticmethod(torch.sign)
    round = staticmethod(torch.round)     # half to even, as numpy
    trunc = staticmethod(torch.trunc)
    ceil = staticmethod(torch.ceil)
    floor = staticmethod(torch.floor)
    sqrt = staticmethod(torch.sqrt)
    exp = staticmethod(torch.exp)
    log = staticmethod(torch.log)
    log2 = staticmethod(torch.log2)
    power = staticmethod(torch.pow)


_NS: dict = {}


def on(device) -> Namespace:
    """The (cached) namespace for `device`."""
    key = str(torch.device(device))
    ns = _NS.get(key)
    if ns is None:
        ns = _NS[key] = Namespace(device)
    return ns
