"""The device plane: the process-wide 1-D ``("batch",)`` plane of shards.

The port of the JAX package's devplane.py. A plane is an ordered list of
torch devices on the one axis ``"batch"``; shards may share a device, so
a plane of n shards runs on one card (or on the CPU, as the tests do),
the port's counterpart of XLA's virtual host devices. Rows are sharded
(each shard holds a contiguous row shard of the padded superchunk) and
small or broadcast state is replicated: one copy per DISTINCT device,
shared by the shards on it.

One process drives the whole plane (a single controller, as in the
reference). `shard_map(fn, plane, in_specs)` runs a per-shard body on
each shard's tensors, on that shard's device, one shard after another;
`axis_index()` inside the body is the shard's index. The collectives
are plain functions over per-shard lists, called between the stages a
body is split into: `all_gather` (stacked, or tiled), `pmax` and
`all_to_all`. Between distinct cards they copy with
``.to(device, non_blocking=True)`` (a peer copy); shards that share a
device copy nothing. NCCL and torch.distributed are not used: they need
one process per rank, cannot put two ranks on one card, and the system
has one controller.

`enable_mesh(None)` installs one shard per visible CUDA device (so one
card keeps ndev = 1 and `route_mesh` leaves every plan alone, as the
reference does on one chip); `enable_mesh(n)` installs n shards spread
round-robin over the visible devices. `device="cpu"` builds the plane on
the host. The planner consults `active_mesh()` to route plans and folds
`mesh_generation()` into the plan-cache key; `mesh_fingerprint()` is the
identity folded into kernel-cache and profile keys, so a 1-shard and an
8-shard kernel for the same plan never collide.

Concurrency: configuration happens at process start or test setup, on
one thread; readers see one attribute load each, so no lock is needed —
the generation counter is the coherence protocol.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np

__all__ = [
    "AXIS", "Plane", "Replicas", "build_mesh", "configure_mesh",
    "enable_mesh", "disable_mesh", "active_mesh", "mesh_generation",
    "on_topology_change", "ndev", "batch_spec", "replicated_spec",
    "replicate", "chip_device",
    "chip_scope", "mesh_fingerprint", "shard_map", "plane_jit",
    "axis_index", "device_scope", "all_gather", "pmax", "all_to_all",
    "per_device",
]

#: the one data-parallel axis name of the device plane
AXIS = "batch"

_mesh = None
_generation = 0
_listeners: list = []
_tl = threading.local()


class Plane:
    """An ordered list of torch devices on the axis ``"batch"``.
    `devices` is a numpy object array (`.size`, `.flat`, as a jax Mesh's
    device array); two shards may name the same device."""

    def __init__(self, devices):
        import torch
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("a plane needs at least one device")
        self.devices = np.empty(len(devs), dtype=object)
        for i, d in enumerate(devs):
            self.devices[i] = d
        self.axis_names = (AXIS,)

    @property
    def shape(self) -> dict:
        return {AXIS: int(self.devices.size)}

    def distinct(self) -> list:
        """The plane's devices, each once, in shard order."""
        out: list = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out

    def __repr__(self):
        return f"Plane({[str(d) for d in self.devices.flat]})"


class Replicas(list):
    """A replicated value: one entry per shard, the entries of shards
    that share a device being the same object. `shard_map` hands entry i
    to shard i wherever a replicated spec stands."""


# -- construction ----------------------------------------------------------

def _visible(device=None) -> list:
    """The devices a plane spreads over: every visible CUDA device, or
    the one device the caller names (``"cpu"``). Never falls back to the
    CPU by itself."""
    import torch
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            if device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("no CUDA device available; pass "
                                   "device='cpu' to build the plane on "
                                   "the host")
            return [device]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' "
                           "to build the plane on the host")
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def build_mesh(n_devices: int | None = None, devices=None,
               device=None) -> Plane:
    """A ``("batch",)`` plane of n_devices shards spread round-robin over
    `devices` (default: the visible devices, see `_visible`); None gives
    one shard per device."""
    if devices is None:
        devices = _visible(device)
    devices = list(devices)
    n = len(devices) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a plane needs at least one shard, got {n}")
    return Plane([devices[i % len(devices)] for i in range(n)])


# -- process configuration -------------------------------------------------

def on_topology_change(fn) -> None:
    """Register fn() to run after every plane (re)configuration: kernel
    caches keyed on the generation release entries that can never be hit
    again (e.g. after disable_mesh)."""
    _listeners.append(fn)


def configure_mesh(mesh) -> None:
    """Install `mesh` (a Plane or None) as the process plane."""
    global _mesh, _generation
    _mesh = mesh
    _generation += 1
    for fn in _listeners:
        fn()


def enable_mesh(n_devices: int | None = None, device=None) -> None:
    """Build a ``("batch",)`` plane of n shards and install it."""
    configure_mesh(build_mesh(n_devices, device=device))


def disable_mesh() -> None:
    configure_mesh(None)


def active_mesh() -> Plane | None:
    return _mesh


def mesh_generation() -> int:
    return _generation


def ndev(mesh: Plane | None = None) -> int:
    """Shard count of `mesh` (default: the process plane; 1 if none)."""
    if mesh is None:
        mesh = _mesh
    return 1 if mesh is None else int(mesh.devices.size)


# -- layout language -------------------------------------------------------

def batch_spec() -> str:
    """Rows sharded over the ``"batch"`` axis."""
    return AXIS


def replicated_spec():
    """Replicated state: every shard sees the same value."""
    return None


def replicate(fn, mesh: Plane) -> Replicas:
    """Replicas of fn(device) over the plane's distinct devices: fn runs
    once per device, and shards on one device share its result."""
    made: dict = {}
    out = Replicas()
    for d in mesh.devices.flat:
        if d not in made:
            made[d] = fn(d)
        out.append(made[d])
    return out


def chip_device(chip: int, mesh: Plane | None = None):
    """The torch device backing plane chip index `chip` (modulo the shard
    count); None when no plane is installed — callers then use the
    default device."""
    if mesh is None:
        mesh = _mesh
    if mesh is None:
        return None
    return mesh.devices.flat[chip % int(mesh.devices.size)]


def chip_scope(chip: int, device=None, mesh: Plane | None = None):
    """Make plane chip `chip`'s device the current CUDA device for a
    slot-guarded dispatch section. Without a plane, chip `chip` of the
    visible CUDA devices; a null context when `device` (or the chip's
    device) is not a CUDA device, or torch has no CUDA."""
    import torch
    if device is not None and getattr(device, "type", str(device)) \
            != "cuda":
        return contextlib.nullcontext()
    if not torch.cuda.is_available():
        return contextlib.nullcontext()
    dev = chip_device(chip, mesh)
    if dev is None:
        return torch.cuda.device(chip % max(torch.cuda.device_count(), 1))
    if dev.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def mesh_fingerprint(mesh: Plane | None = None, *,
                     process: bool = False) -> tuple:
    """Structural identity of the plane for cache and profile keys:
    (axis, shard count, platform) as in the reference; with no plane,
    ("host", 1) plus the CUDA device's name where there is one, so
    profiles taken on two kinds of card never merge. With
    ``process=True``, fingerprint the installed process plane."""
    global _fingerprint
    if mesh is None and process:
        mesh = _mesh
    if mesh is not None:
        return (AXIS, int(mesh.devices.size), mesh.devices.flat[0].type)
    if _fingerprint is None:
        import torch
        _fingerprint = ("host", 1, torch.cuda.get_device_name(0)) \
            if torch.cuda.is_available() else ("host", 1)
    return _fingerprint


_fingerprint: tuple | None = None


# -- per-shard programs ----------------------------------------------------

def axis_index() -> int:
    """Inside a `shard_map` body: the running shard's index."""
    return _tl.index


def device_scope(device):
    """The CUDA current-device context for a shard's work (so launches
    and allocations without an explicit device go to it); a null
    context on the CPU."""
    if device.type == "cuda":
        import torch
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def shard_map(fn, mesh: Plane, in_specs):
    """The per-shard program of `fn`: called with per-shard lists where
    `in_specs` says ``"batch"`` (and Replicas where it says None), it runs
    fn(*shard i's arguments) on each shard's device and returns the list
    of per-shard results (the reference's out_specs: always per shard).
    A None-spec argument that is not a Replicas goes to every shard as
    it is (python scalars, host objects)."""
    specs = tuple(in_specs)

    def run(*args):
        if len(args) != len(specs):
            raise TypeError(f"shard_map: {len(args)} arguments for "
                            f"{len(specs)} specs")
        outs = []
        prev = getattr(_tl, "index", None)
        try:
            for i, dev in enumerate(mesh.devices.flat):
                shard_args = [a[i] if s == AXIS or isinstance(a, Replicas)
                              else a for a, s in zip(args, specs)]
                _tl.index = i
                with device_scope(dev):
                    outs.append(fn(*shard_args))
        finally:
            _tl.index = prev
        return outs
    return run


def plane_jit(fn, **kwargs):
    """The seam where the reference compiles a plane program. Torch runs
    eagerly, so this returns fn; each wrap registers one `plane`-family
    construction with the kernel-profile registry (keyed by the staged
    function's name and the process plane), as the reference's does."""
    from tidb_tpu_torch import profiler
    prof = profiler.profile("plane", getattr(fn, "__name__", "shard"))
    profiler.note_construct(prof, reuse=False)
    return fn


def per_device(fn, mesh: Plane, *reps) -> Replicas:
    """Run a replicated stage: fn(*values on device d) once per distinct
    device d of the plane (every shard of the reference computes the
    same replicated result; shards on one device share one), -> Replicas.
    Each of `reps` is a Replicas (or a per-shard list whose entries on
    one device are interchangeable)."""
    made: dict = {}
    out = Replicas()
    for i, d in enumerate(mesh.devices.flat):
        if d not in made:
            with device_scope(d):
                made[d] = fn(*(r[i] for r in reps))
        out.append(made[d])
    return out


# -- collectives over per-shard lists --------------------------------------

def _to(x, device):
    return x if x.device == device else x.to(device, non_blocking=True)


def all_gather(xs, mesh: Plane, tiled: bool = False) -> Replicas:
    """Every shard's `xs[i]` on every device: stacked to [ndev, ...], or
    concatenated along axis 0 with `tiled`. One result per distinct
    device (the copies between distinct cards are peer copies)."""
    import torch

    def gather(d):
        parts = [_to(x, d) for x in xs]
        return torch.cat(parts, 0) if tiled else torch.stack(parts, 0)
    return replicate(gather, mesh)


def pmax(xs, mesh: Plane) -> Replicas:
    """The elementwise max of the shards' `xs[i]`, replicated."""
    import torch

    def red(d):
        return torch.amax(torch.stack([_to(x, d) for x in xs], 0), 0)
    return replicate(red, mesh)


def all_to_all(xs, mesh: Plane) -> list:
    """`xs[i]` is [ndev, ...] on shard i: shard j receives row j of every
    shard's block, stacked in shard order -> per-shard [ndev, ...]
    (lax.all_to_all with split and concat axis 0)."""
    import torch
    out = []
    for j, d in enumerate(mesh.devices.flat):
        out.append(torch.stack([_to(x[j], d) for x in xs], 0))
    return out
