"""The device plane for one device: the port of the JAX package's
devplane.py, single-device part.

The JAX package installs one process-wide 1-D ``("batch",)`` mesh that
every kernel addresses; on one device the mesh is absent and every
kernel lowers to its single-chip form. The port has one CUDA device per
process, so the plane here is that case only: `active_mesh()` is None,
`ndev()` is 1, and `chip_scope(chip)` makes the scheduler's chip the
current CUDA device for a slot-guarded dispatch (a null context on the
CPU). `mesh_fingerprint` is the identity folded into kernel-profile
keys, and `on_topology_change` keeps the listener seam kernel caches
register with.

Left out, with the multi-GPU plane: building and installing a mesh,
the row/replicated layout specs, `shard_map` and `plane_jit`.
"""

from __future__ import annotations

import contextlib

__all__ = ["active_mesh", "mesh_generation", "on_topology_change", "ndev",
           "chip_scope", "mesh_fingerprint"]

_listeners: list = []


def on_topology_change(fn) -> None:
    """Register fn() to run after every plane reconfiguration. The
    single-device plane never changes, so none runs yet; kernel caches
    keyed on the generation register here, as in the reference."""
    _listeners.append(fn)


def active_mesh():
    """The process mesh: None, one device."""
    return None


def mesh_generation() -> int:
    """The plane's configuration count: 0, the one plane there is."""
    return 0


def ndev(mesh=None) -> int:
    """Device count of the plane: 1."""
    return 1


def chip_scope(chip: int, device=None):
    """Make plane chip `chip` the current CUDA device for a slot-guarded
    dispatch section; a null context when `device` is not a CUDA device
    (the CPU) or torch has no CUDA."""
    import torch
    if device is not None and getattr(device, "type", str(device)) \
            != "cuda":
        return contextlib.nullcontext()
    if not torch.cuda.is_available():
        return contextlib.nullcontext()
    return torch.cuda.device(chip % max(torch.cuda.device_count(), 1))


def mesh_fingerprint(mesh=None, *, process: bool = False) -> tuple:
    """Structural identity of the plane for kernel-profile keys: with no
    mesh, ("host", 1) as in the reference, plus the CUDA device's name
    where there is one, so profiles taken on two kinds of card never
    merge."""
    global _fingerprint
    if _fingerprint is None:
        import torch
        _fingerprint = ("host", 1, torch.cuda.get_device_name(0)) \
            if torch.cuda.is_available() else ("host", 1)
    return _fingerprint


_fingerprint: tuple | None = None
