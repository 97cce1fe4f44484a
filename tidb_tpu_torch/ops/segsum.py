"""Masked segment-sum: the port's counterpart of ops/pallas_agg.py.

    out[C, K] = sum_r onehot(ids[r]) * where(valid, values[r, :], 0)

On a CUDA tensor `segment_sum` launches the hand-written Hopper kernel of
csrc/segsum.cu (which names the TPU kernel it replaces, its bound and its
design); on a CPU tensor it runs `segment_sum_plain`, the same function in
plain torch, which the tests and chip_smoke.py hold the kernel against.
There is no other fallback: a CUDA tensor the kernel cannot take raises.

The launch plan (the window of slots each warp's table keeps, rows per
staged tile, threads, blocks per SM, shared bytes) is
computed here, once per (dtype, C, K, mask mode, device), from device
limits read once per device; `launch_plan` is pure, so the CPU tests
reach it.

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
import re
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path

import torch

__all__ = ["segment_sum", "segment_sum_plain", "build", "launches",
           "launch_plan", "plan_for", "DeviceLimits", "LaunchPlan", "H100"]

# kernel launches by segment_sum since the last reset (a plain int: the
# caller sets it to 0 and reads it back around the run it attributes;
# the coprocessor's pool threads add under _count_mu)
launches = 0
_count_mu = threading.Lock()

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "segsum.cu"
BUILD_DIR = _PKG / "_build"
LIBRARY = BUILD_DIR / "libsegsum.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.int64: 2}
_lib = None
_lib_mu = threading.Lock()
# what ptxas printed (-Xptxas -v) for the last build in this process
build_log = ""

# The launch plan's constants. On the H100 the kernel runs faster the more
# warps an SM holds: one staged tile a block and 4 blocks of 256 threads
# an SM (32 warps) beat double buffering, which fits only with fewer
# warps, at Q1's shape and at spread ids alike (PERF.md).
STAGE_TARGET = 32 * 1024      # bytes of one staged tile: ids, values, mask
MAX_TILE = 1024               # rows per staged tile
MAX_THREADS = 256             # the kernel's __launch_bounds__
MIN_BLOCKS_PER_SM = 4
REGS_PER_THREAD = 64          # what __launch_bounds__(256, 4) allows


@dataclass(frozen=True)
class DeviceLimits:
    sms: int
    smem_per_block: int       # opt-in maximum of dynamic shared memory
    smem_per_sm: int
    threads_per_sm: int
    smem_reserved: int        # the system's shared bytes per resident block
    regs_per_sm: int


# NVIDIA H100 SXM (sm_90): what cudaDeviceGetAttribute reports for it
H100 = DeviceLimits(sms=132, smem_per_block=232448, smem_per_sm=233472,
                    threads_per_sm=2048, smem_reserved=1024,
                    regs_per_sm=65536)


@dataclass(frozen=True)
class LaunchPlan:
    segments: int
    window: int               # W: slots 0..W-2 and slot C-1 in each table
    tile: int                 # rows per staged tile
    threads: int              # one [W, K] table per warp
    blocks_per_sm: int
    smem: int                 # dynamic shared bytes per block
    sms: int

    @property
    def variant(self) -> str:
        return "table" if self.window == self.segments else "window"

    def grid(self, n: int) -> int:
        """Persistent grid: one block per (SM, resident slot), never more
        blocks than tiles."""
        return max(1, min(self.sms * self.blocks_per_sm,
                          -(-n // self.tile)))


def _round16(x: int) -> int:
    return (x + 15) & ~15


def _mask_bytes_per_row(mask_mode: int, k: int) -> int:
    return k if mask_mode == 2 else mask_mode


def stage_bytes(elem: int, k: int, mask_mode: int, tile: int) -> int:
    """Shared bytes of one staged tile (csrc/segsum.cu: stage_bytes)."""
    return (_round16(tile * k * elem) + tile * 4 +
            _round16(tile * _mask_bytes_per_row(mask_mode, k)))


def launch_plan(elem: int, num_segments: int, k: int, mask_mode: int,
                limits: DeviceLimits) -> LaunchPlan:
    """The kernel's launch plan for lanes of `elem` bytes.

    A block keeps one staged tile of about STAGE_TARGET bytes and one
    [W, K] table per warp, all within a budget that leaves
    MIN_BLOCKS_PER_SM blocks resident per SM. W = C when the whole table
    fits; otherwise W fills the budget, and slots outside the window go
    to global atomics."""
    row_bytes = k * elem + 4 + _mask_bytes_per_row(mask_mode, k)
    slot_bytes = k * elem
    tile = 32
    while tile * 2 <= min(MAX_TILE, STAGE_TARGET // row_bytes):
        tile *= 2
    # lanes so wide that not even 32-row tiles fit MIN_BLOCKS_PER_SM blocks
    # per SM take the whole opt-in of one block
    budgets = [min(limits.smem_per_block, limits.smem_per_sm //
                   MIN_BLOCKS_PER_SM - limits.smem_reserved),
               limits.smem_per_block]
    budget = budgets.pop(0)
    while True:
        threads = min(MAX_THREADS, tile)
        tables = threads // 32
        staging = stage_bytes(elem, k, mask_mode, tile)
        room = budget - staging
        if room >= tables * slot_bytes:
            break
        if tile > 32:
            tile //= 2
        elif budgets:
            budget = budgets.pop(0)
        else:
            raise ValueError(f"segment_sum: {k} lanes of {elem} bytes are "
                             "too wide for the kernel's shared memory")
    window = min(num_segments, room // (tables * slot_bytes))
    smem = staging + tables * window * slot_bytes
    blocks = min(limits.threads_per_sm // threads,
                 limits.regs_per_sm // (REGS_PER_THREAD * threads),
                 limits.smem_per_sm // (smem + limits.smem_reserved), 32)
    return LaunchPlan(segments=num_segments, window=window, tile=tile,
                      threads=threads, blocks_per_sm=blocks, smem=smem,
                      sms=limits.sms)


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
    newer than the source is there; keeps ptxas's report in `build_log`.
    Writes to a temporary name first, so a concurrent reader never loads
    a half-written library."""
    global build_log
    if not force and LIBRARY.exists() and \
            LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime:
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".libsegsum.{os.getpid()}.so"
    res = subprocess.run(build_command(tmp), capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, LIBRARY)
    build_log = res.stdout + res.stderr
    return LIBRARY


_ENTRY = re.compile(r"segsum_kernelI([fdx])Li(\d)EE")
_DTYPE_OF = {"f": "float32", "d": "float64", "x": "int64"}


def ptxas_report(log: str) -> list[dict]:
    """Registers, spills and static shared bytes per kernel variant from
    ptxas's -v report (the kernel's table and tiles are dynamic shared
    memory, sized by the launch plan)."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\S+?)'?(?: for|$)", line)
        if m:
            e = _ENTRY.search(m.group(1))
            if e is None:
                cur = None
                continue
            key = {"dtype": _DTYPE_OF[e.group(1)], "mask": int(e.group(2))}
            cur = next((r for r in rows if all(r[a] == b for a, b in
                                               key.items())), None)
            if cur is None:
                cur = dict(key)
                rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"] = int(m.group(1))
            cur["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            cur["static_smem"] = int(m.group(1))
    return rows


def _library():
    global _lib
    with _lib_mu:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.tidb_segsum.argtypes = [i, p, p, p, i, p, ll, i, i, p,
                                        i, i, i, i, i]
            lib.tidb_segsum.restype = i
            lib.tidb_segsum_device_limits.argtypes = [i, ctypes.POINTER(i)]
            lib.tidb_segsum_device_limits.restype = i
            lib.tidb_segsum_init.argtypes = [i]
            lib.tidb_segsum_init.restype = i
            lib.tidb_cuda_error_string.argtypes = [i]
            lib.tidb_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"segment_sum {what} failed: "
                           f"{lib.tidb_cuda_error_string(rc).decode()} "
                           f"({rc})")


def _query_device_limits(index: int) -> DeviceLimits:
    """Reads the card's limits and sets every variant's shared-memory
    opt-in on it: the only device queries, made once per device."""
    lib = _library()
    vals = (ctypes.c_int * 6)()
    with torch.cuda.device(index):
        _check(lib, lib.tidb_segsum_device_limits(index, vals),
               "device query")
        limits = DeviceLimits(*vals)
        _check(lib, lib.tidb_segsum_init(limits.smem_per_block), "init")
    return limits


_limits: dict = {}
_plans: dict = {}
_plans_mu = threading.Lock()


def plan_for(dtype: torch.dtype, num_segments: int, k: int, mask_mode: int,
             device: torch.device) -> LaunchPlan:
    """launch_plan for this shape class on `device`, cached per (dtype, C,
    K, mask mode, device); a device without an index is the current one."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    key = (dtype, num_segments, k, mask_mode, index)
    plan = _plans.get(key)
    if plan is None:
        with _plans_mu:
            limits = _limits.get(key[-1])
            if limits is None:
                limits = _limits[key[-1]] = _query_device_limits(key[-1])
            elem = torch.empty((), dtype=dtype).element_size()
            plan = _plans[key] = launch_plan(elem, num_segments, k,
                                             mask_mode, limits)
    return plan


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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """The kernel stages with 16-byte copies: a view that starts off a
    16-byte boundary is copied once into fresh storage."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


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
    if v.dtype not in _DTYPE_CODES:
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
    plan = plan_for(v.dtype, num_segments, k, mode, v.device)
    out = torch.zeros((num_segments, k), dtype=v.dtype, device=v.device)
    if n:
        lib = _library()
        v, ids = _aligned(v), _aligned(ids)
        if valid is not None:
            valid = _aligned(valid)
        with torch.cuda.device(v.device):
            stream = torch.cuda.current_stream(v.device).cuda_stream
            rc = lib.tidb_segsum(
                _DTYPE_CODES[v.dtype], v.data_ptr(), ids.data_ptr(),
                valid.data_ptr() if valid is not None else None, mode,
                out.data_ptr(), n, k, num_segments, stream, plan.window,
                plan.tile, plan.threads, plan.grid(n), plan.smem)
        _check(lib, rc, "kernel launch")
        with _count_mu:
            launches += 1
    return out[:, 0] if one_d else out
