"""Masked segment-sum: the port's counterpart of ops/pallas_agg.py.

    out[C, K] = sum_r onehot(ids[r]) * where(valid, values[r, :], 0)

On a CUDA tensor `segment_sum` launches the hand-written Hopper kernel of
csrc/segsum.cu (which names the TPU kernel it replaces, its bound and its
design); on a CPU tensor it runs `segment_sum_plain`, the same function in
plain torch, which the tests and chip_smoke.py hold the kernel against.
There is no other fallback: a CUDA tensor the kernel cannot take raises.

Deviation from the JAX package: there the Pallas kernel engages only on
float32 lanes on a TPU, and int64 lanes (Q1's decimal sums and counts) go
to XLA's scatter. Here every float32, float64 and int64 sum lane on the
card goes through the kernel, so the kernel lies on Q1's path.

The kernel is built at first use with nvcc into tidb_tpu_torch/_build/
and loaded with ctypes; importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["segment_sum", "segment_sum_plain", "build", "launches",
           "lane_tile"]

# kernel launches by segment_sum since the last reset (a plain int: the
# caller sets it to 0 and reads it back around the run it attributes)
launches = 0

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "segsum.cu"
BUILD_DIR = _PKG / "_build"
LIBRARY = BUILD_DIR / "libsegsum.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.int64: 2}
_lib = None
_lib_mu = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           "the segment-sum kernel")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_command(out: Path = LIBRARY) -> list[str]:
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(SOURCE)]


def build(force: bool = False) -> Path:
    """Compile csrc/segsum.cu into _build/libsegsum.so unless a build
    newer than the source is there. Writes to a temporary name first, so
    a concurrent reader never loads a half-written library."""
    if not force and LIBRARY.exists() and \
            LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime:
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".libsegsum.{os.getpid()}.so"
    res = subprocess.run(build_command(tmp), capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, LIBRARY)
    return LIBRARY


def _library():
    global _lib
    with _lib_mu:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.tidb_segsum.argtypes = [i, p, p, p, i, p, ll, i, i, p]
            lib.tidb_segsum.restype = i
            lib.tidb_segsum_lane_tile.argtypes = [i, i, i]
            lib.tidb_segsum_lane_tile.restype = i
            lib.tidb_cuda_error_string.argtypes = [i]
            lib.tidb_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def lane_tile(dtype: torch.dtype, num_segments: int, k: int) -> int:
    """Lanes per shared-memory table the kernel uses for this shape on
    the current card (0: it adds straight into device memory)."""
    elem = torch.empty((), dtype=dtype).element_size()
    return _library().tidb_segsum_lane_tile(elem, num_segments, k)


def segment_sum_plain(values: torch.Tensor, ids: torch.Tensor,
                      num_segments: int, valid: torch.Tensor | None = None):
    """Plain torch: where(valid, v, 0), then index_add_ over ids, with
    rows whose id lies outside [0, num_segments) dropped (JAX's segment
    sum drops them; index_add_ would raise). 1-D in -> 1-D out."""
    v = values
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    if valid is not None:
        mask = valid if valid.dim() == v.dim() else valid[:, None]
        v = torch.where(mask, v, zero)
    ids = ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    v = torch.where(keep if v.dim() == 1 else keep[:, None], v, zero)
    out = torch.zeros((num_segments,) + tuple(v.shape[1:]), dtype=v.dtype,
                      device=v.device)
    out.index_add_(0, torch.where(keep, ids, 0), v)
    return out


def segment_sum(values: torch.Tensor, ids: torch.Tensor, num_segments: int,
                valid: torch.Tensor | None = None):
    """values [n] or [n, K] (float32, float64 or int64), ids [n] int32,
    valid None, [n] or [n, K] bool -> [num_segments] or
    [num_segments, K] sums of the live values per segment. A CPU tensor
    takes segment_sum_plain; a CUDA tensor launches the kernel."""
    global launches
    if values.device.type == "cpu":
        return segment_sum_plain(values, ids, num_segments, valid)
    if values.device.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {values.device}")
    one_d = values.dim() == 1
    v = values[:, None] if one_d else values
    if v.dim() != 2:
        raise ValueError(f"segment_sum: values must be 1-D or 2-D, got "
                         f"shape {tuple(values.shape)}")
    n, k = v.shape
    code = _DTYPE_CODES.get(v.dtype)
    if code is None:
        raise TypeError(f"segment_sum: unsupported dtype {v.dtype}")
    if ids.dtype != torch.int32 or ids.shape != (n,):
        raise TypeError(f"segment_sum: ids must be int32 of shape ({n},), "
                        f"got {ids.dtype} {tuple(ids.shape)}")
    if not (1 <= num_segments < (1 << 31)):
        raise ValueError(f"segment_sum: num_segments={num_segments}")
    mode = 0
    if valid is not None:
        if valid.dtype != torch.bool:
            raise TypeError(f"segment_sum: valid must be bool, got "
                            f"{valid.dtype}")
        if valid.shape == (n,):
            mode = 1
        elif valid.shape == (n, k):
            mode = 2
        else:
            raise ValueError(f"segment_sum: valid shape {tuple(valid.shape)}"
                             f" fits neither ({n},) nor ({n}, {k})")
    for name, t in (("values", v), ("ids", ids), ("valid", valid)):
        if t is None:
            continue
        if t.device != v.device:
            raise ValueError(f"segment_sum: {name} on {t.device}, values "
                             f"on {v.device}")
        if not t.is_contiguous():
            raise ValueError(f"segment_sum: {name} is not contiguous")
    out = torch.zeros((num_segments, k), dtype=v.dtype, device=v.device)
    if n:
        lib = _library()
        with torch.cuda.device(v.device):
            stream = torch.cuda.current_stream(v.device).cuda_stream
            rc = lib.tidb_segsum(
                code, v.data_ptr(), ids.data_ptr(),
                valid.data_ptr() if valid is not None else None, mode,
                out.data_ptr(), n, k, num_segments, stream)
        if rc != 0:
            raise RuntimeError(
                f"segment_sum kernel launch failed: "
                f"{lib.tidb_cuda_error_string(rc).decode()} ({rc})")
        launches += 1
    return out[:, 0] if one_d else out
