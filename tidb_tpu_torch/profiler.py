"""Kernel profiling plane: continuous dispatch/busy/roofline accounting.

The port of the JAX package's profiler.py. One `KernelProfileRegistry`
keyed ``(family, plan fingerprint, plane fingerprint)`` — the key
discipline of the kernel caches it shadows (ops/hashagg.kernel_for,
ops/streamagg.segment_kernel_for, ops/fragment.fragment_kernel_for) —
so a cache-key regression shows up as construction churn on exactly
one registry row.

Feeds:
  * construction sites call `note_construct(prof, reuse=...)` — a fresh
    kernel object is one construction, a kernel-cache hit a reuse;
  * dispatch seams (`dispatch_section` at the coprocessor's sync sites,
    `sched.device_slot(profile=...)`, `pipeline_map(profile=...)`)
    record dispatch count, busy-ns and bytes. The FIRST dispatch of a
    freshly constructed kernel lands its wall time in `compile_ns`
    (torch has no compile step of its own; on the card that dispatch
    also pays the lazy CUDA and kernel-build costs).

Roofline: `roofline_fraction` is computed online per kernel family
(bytes / busy-ns against `platform_peak_gbps()`): the card's datasheet
peak looked up by its full name, or a measured host memcpy rate on the
CPU.

Cost discipline: entries bill a fixed per-entry cost to a
`kernel-profile` memtrack SERVER node with a registered shed action,
the registry is a bounded true-LRU (`tidb_tpu_kernel_profile_cap`), and
with `tidb_tpu_kernel_profile=0` every entry point is one config read.

Left out: the persistent compile-cache probes (`cc_probe`, the
compile-cache counters around a first dispatch). Torch has no compile
cache, so a first dispatch's source always reads `cached`, as the
reference's does when it takes no probe.
"""

from __future__ import annotations

import threading
import time

from tidb_tpu_torch import config

__all__ = ["KernelProfile", "KernelProfileRegistry", "enabled",
           "profile", "profile_of", "note_construct", "note_dispatch",
           "note_busy", "note_bytes", "note_escalation",
           "note_kernel_fallback", "dispatch_section",
           "snapshot", "stats", "registry", "platform_peak_gbps",
           "achieved_gbps", "roofline_fraction", "FAMILIES",
           "reset_for_tests"]

# the closed family vocabulary (also the {family} metric label set):
# every kernel-cache construction site declares exactly one of these,
# the reference's set (the mesh and plane families come with the
# multi-device plane)
FAMILIES = ("hashagg", "scalaragg", "streamagg", "fragment", "mesh",
            "plane")

# fixed per-entry billing against the kernel-profile SERVER node: a
# KernelProfile is ~15 ints + 3 short strings + a small fallback dict;
# billing a round figure keeps the ledger arithmetic auditable
_ENTRY_BYTES = 1024


class KernelProfile:
    """One (family, fingerprint, mesh) row. All mutation happens under
    the owning registry's lock; readers take snapshots there too."""

    __slots__ = ("family", "fingerprint", "mesh", "generation",
                 "compiles", "compile_ns", "compile_src",
                 "pcache_hits", "pcache_misses", "reuses",
                 "dispatches", "busy_ns", "bytes_in", "bytes_out",
                 "bytes_encoded", "bytes_decoded_equiv",
                 "escalations", "fallbacks", "last_used", "_fresh",
                 "epoch")

    def __init__(self, family: str, fingerprint: str, mesh: tuple,
                 generation: int):
        self.family = family
        self.fingerprint = fingerprint
        self.mesh = mesh
        self.generation = generation
        self.compiles = 0        # kernel objects constructed (LRU misses)
        self.compile_ns = 0      # first-dispatch wall (trace+compile+load)
        self.compile_src = ""    # attribution: hit | miss | cached | reuse
        self.pcache_hits = 0     # persistent-cache loads observed
        self.pcache_misses = 0   # persistent-cache compiles observed
        self.reuses = 0          # executable-LRU hits
        self.dispatches = 0
        self.busy_ns = 0         # dispatch+finalize wall attributed here
        self.bytes_in = 0        # dispatch_nbytes: padded upload + scratch
        self.bytes_out = 0       # result bytes where cheaply known
        self.bytes_encoded = 0   # actually staged (dict codes + validity)
        self.bytes_decoded_equiv = 0
        self.escalations = 0     # capacity re-plans inherited by the key
        self.fallbacks: dict[str, int] = {}   # reason -> count
        self.last_used = time.time()
        self._fresh = False      # next dispatch is the compile dispatch
        self.epoch = 0           # registry epoch at creation (staleness)

    def to_dict(self) -> dict:
        d = {"family": self.family, "fingerprint": self.fingerprint,
             "mesh": "-".join(str(p) for p in self.mesh),
             "generation": self.generation,
             "compiles": self.compiles, "compile_ns": self.compile_ns,
             "compile_cache": self.compile_src,
             "pcache_hits": self.pcache_hits,
             "pcache_misses": self.pcache_misses,
             "reuses": self.reuses, "dispatches": self.dispatches,
             "busy_ns": self.busy_ns, "bytes_in": self.bytes_in,
             "bytes_out": self.bytes_out,
             "bytes_encoded": self.bytes_encoded,
             "bytes_decoded_equiv": self.bytes_decoded_equiv,
             "escalations": self.escalations,
             "fallbacks": sum(self.fallbacks.values()),
             "fallback_reasons": dict(self.fallbacks),
             "last_used": self.last_used}
        gbps = achieved_gbps(self.bytes_in, self.busy_ns)
        d["achieved_gbps"] = None if gbps is None else round(gbps, 3)
        frac = roofline_fraction(self.bytes_in, self.busy_ns)
        d["roofline_fraction"] = None if frac is None else round(frac, 4)
        return d


class KernelProfileRegistry:
    """Bounded true-LRU of KernelProfile entries, billed to a
    `kernel-profile` memtrack SERVER node whose registered shed action
    drops the whole history (observability data: always safe to shed).
    Keys carry `devplane.mesh_fingerprint(process=True)`, so a topology
    change starts fresh rows instead of folding 8-chip dispatches into
    1-chip compile history."""

    def __init__(self):
        self._mu = threading.Lock()
        from collections import OrderedDict
        # key -> KernelProfile, true LRU order
        self._d: "OrderedDict[tuple, KernelProfile]" = OrderedDict()  # guarded-by: _mu
        self._node = None           # lazy memtrack server node
        self._evictions = 0         # guarded-by: _mu
        # bumped by clear(): kernels cache their profile object on
        # themselves (plan._kernel outlives any one statement), so after
        # a shed the seams must detect the orphan and re-register
        # instead of recording into an invisible row forever
        self._epoch = 0             # guarded-by: _mu (racy reads ok)

    # -- memtrack billing ----------------------------------------------------

    def _billing_node(self):
        """The kernel-profile SERVER ledger node, created on first use
        (import-time creation would bill an empty registry into every
        test's hygiene sweep). The shed action clears the registry —
        profile history is the cheapest thing a loaded server owns."""
        if self._node is None:
            from tidb_tpu_torch import memtrack
            node = memtrack.server_node("kernel-profile")
            node.add_spill_action(self._shed)
            self._node = node
        return self._node

    def _shed(self) -> None:
        self.clear()

    def clear(self) -> None:
        with self._mu:
            n = len(self._d)
            self._d.clear()
            self._epoch += 1
        if n and self._node is not None:
            self._node.release(host=n * _ENTRY_BYTES)

    # -- entry resolution ----------------------------------------------------

    def get_or_create(self, family: str, fingerprint: str | None) \
            -> KernelProfile:
        from tidb_tpu_torch import devplane
        fp = fingerprint if fingerprint is not None else "~"
        mesh = devplane.mesh_fingerprint(process=True)
        key = (family, fp, mesh)
        with self._mu:
            hit = self._d.get(key)
            if hit is not None:
                self._d.move_to_end(key)
                hit.last_used = time.time()
                return hit
        prof = KernelProfile(family, _short_fp(fp), mesh,
                             devplane.mesh_generation())
        node = self._billing_node()
        cap = config.kernel_profile_cap()
        evicted = 0
        with self._mu:
            prof.epoch = self._epoch
            cur = self._d.setdefault(key, prof)
            if cur is prof:             # we inserted: bill + bound
                self._d.move_to_end(key)
                while len(self._d) > cap:
                    old = next(iter(self._d))
                    if old == key:
                        break
                    self._d.pop(old)
                    evicted += 1
                    self._evictions += 1
        if cur is prof:
            # lint: exempt[paired-resource] ownership transfer: entry bytes release on LRU eviction (below) / shed / clear()
            node.consume(host=_ENTRY_BYTES)
        if evicted:
            node.release(host=evicted * _ENTRY_BYTES)
        return cur

    # -- recording (all under _mu; sites hold no other locks here) -----------

    def note_construct(self, prof: KernelProfile, reuse: bool) -> None:
        with self._mu:
            if reuse:
                prof.reuses += 1
            else:
                prof.compiles += 1
                prof._fresh = True
            prof.last_used = time.time()

    def record_dispatch(self, prof: KernelProfile, busy_ns: int,
                        nbytes: int, out_nbytes: int, encoded: int,
                        decoded: int) -> bool:
        """Fold one completed dispatch; -> True when it was the entry's
        compile dispatch (the caller emits the compile histogram)."""
        from tidb_tpu_torch.util import failpoint
        failpoint.eval("profiler/record", prof.family)
        compiled = False
        with self._mu:
            prof.dispatches += 1
            prof.busy_ns += busy_ns
            prof.bytes_in += nbytes
            prof.bytes_out += out_nbytes
            prof.bytes_encoded += encoded
            prof.bytes_decoded_equiv += decoded
            prof.last_used = time.time()
            if prof._fresh:
                prof._fresh = False
                compiled = True
                prof.compile_ns += busy_ns
                # no compile cache to probe: the reference's label for a
                # first dispatch taken without a probe
                prof.compile_src = "cached"
            elif not prof.compile_src:
                # executable predates this profile row (built before the
                # registry entry existed, e.g. re-registered after a shed)
                prof.compile_src = "reuse"
        return compiled

    def note_busy(self, prof: KernelProfile, ns: int) -> None:
        with self._mu:
            prof.busy_ns += ns

    def note_bytes(self, prof: KernelProfile, nbytes: int = 0,
                   out_nbytes: int = 0, encoded: int = 0,
                   decoded: int = 0) -> None:
        with self._mu:
            prof.bytes_in += nbytes
            prof.bytes_out += out_nbytes
            prof.bytes_encoded += encoded
            prof.bytes_decoded_equiv += decoded

    def note_escalation(self, prof: KernelProfile) -> None:
        with self._mu:
            prof.escalations += 1

    def note_fallback(self, prof: KernelProfile, reason: str) -> None:
        with self._mu:
            prof.fallbacks[reason] = prof.fallbacks.get(reason, 0) + 1

    # -- introspection -------------------------------------------------------

    def snapshot(self) -> list[dict]:
        with self._mu:
            profs = list(self._d.values())
        return [p.to_dict() for p in profs]

    def stats(self) -> dict:
        with self._mu:
            return {"entries": len(self._d),
                    "cap": config.kernel_profile_cap(),
                    "evictions": self._evictions,
                    "compiles": sum(p.compiles for p in self._d.values()),
                    "dispatches": sum(p.dispatches
                                      for p in self._d.values()),
                    "busy_ns": sum(p.busy_ns for p in self._d.values())}

    def __len__(self) -> int:
        with self._mu:
            return len(self._d)


def _short_fp(fp: str) -> str:
    """Registry rows carry a bounded fingerprint: plan fingerprints are
    structural reprs that can run long; 16 hex chars is identity enough
    for a profile surface (collisions merge rows, never crash)."""
    if len(fp) <= 16:
        return fp
    import hashlib
    return hashlib.sha256(fp.encode()).hexdigest()[:16]


_REGISTRY = KernelProfileRegistry()


def registry() -> KernelProfileRegistry:
    return _REGISTRY


def enabled() -> bool:
    return config.kernel_profile()


def profile(family: str, fingerprint: str | None) \
        -> KernelProfile | None:
    """The profile entry for a kernel being constructed or dispatched,
    None when profiling is off — every note_* below is None-tolerant,
    so call sites stay one-liners with no gating of their own."""
    if not config.kernel_profile():
        return None
    return _REGISTRY.get_or_create(family, fingerprint)


def note_construct(prof: KernelProfile | None, reuse: bool) -> None:
    if prof is not None:
        _REGISTRY.note_construct(prof, reuse)


def note_dispatch(prof: KernelProfile | None, busy_ns: int,
                  nbytes: int = 0, out_nbytes: int = 0,
                  encoded: int = 0, decoded: int = 0,
                  plan=None) -> None:
    """Fold one completed dispatch interval (the pipeline_map /
    device_slot seam form — dispatch_section below packages the timing
    for the sync sites)."""
    if prof is None:
        return
    from tidb_tpu_torch import metrics
    compiled = _REGISTRY.record_dispatch(prof, busy_ns, nbytes,
                                         out_nbytes, encoded, decoded)
    metrics.counter(metrics.KERNEL_DISPATCHES, {"family": prof.family})
    if compiled:
        metrics.histogram(metrics.KERNEL_COMPILE_SECONDS, busy_ns / 1e9,
                          {"family": prof.family})
    if plan is not None:
        from tidb_tpu_torch import runtime_stats
        runtime_stats.note_kernel(plan, prof.family, prof.compile_src,
                                  nbytes, busy_ns)


def note_busy(prof: KernelProfile | None, ns: int) -> None:
    if prof is not None:
        _REGISTRY.note_busy(prof, ns)


def note_bytes(prof: KernelProfile | None, nbytes: int = 0,
               out_nbytes: int = 0, encoded: int = 0,
               decoded: int = 0) -> None:
    if prof is not None:
        _REGISTRY.note_bytes(prof, nbytes, out_nbytes, encoded, decoded)


def note_escalation(prof: KernelProfile | None) -> None:
    if prof is not None:
        _REGISTRY.note_escalation(prof)


def note_kernel_fallback(prof: KernelProfile | None,
                         reason: str) -> None:
    if prof is not None:
        _REGISTRY.note_fallback(prof, reason)


def profile_of(kernel) -> KernelProfile | None:
    """The profile a construction site attached to a kernel object
    (dispatch seams resolve through this so they need no key math).
    Kernels outlive statements (plan-attached, executable LRUs), so a
    registry clear — shed, test reset — orphans attached profiles; an
    epoch mismatch here re-registers under the same identity and
    reattaches, so history rebuilds instead of recording into an
    invisible row forever."""
    if not config.kernel_profile():
        return None
    prof = getattr(kernel, "_profile", None)
    if prof is None:
        return None
    if prof.epoch != _REGISTRY._epoch:
        prof = _REGISTRY.get_or_create(prof.family, prof.fingerprint)
        try:
            kernel._profile = prof
        except AttributeError:   # slotted/frozen kernel: resolve anew
            pass                 # next dispatch, same merged row
    return prof


class dispatch_section:
    """Time one synchronous dispatch+finalize interval against `prof`
    (None = disarmed no-op). SUCCESS-ONLY, matching
    runtime_stats.device_section(errors=False) at the same sites: a
    capacity/collision attempt re-runs through an escalated kernel
    whose own section records — double-billing the failed wall time
    would poison exactly the per-mode cost the memo exists to compare.
    Set `.out_nbytes` inside the block once the result size is known."""

    __slots__ = ("prof", "nbytes", "encoded", "decoded", "plan",
                 "out_nbytes", "_t0")

    def __init__(self, prof: KernelProfile | None, nbytes: int = 0,
                 encoded: int = 0, decoded: int = 0, plan=None):
        self.prof = prof
        self.nbytes = nbytes
        self.encoded = encoded
        self.decoded = decoded
        self.plan = plan
        self.out_nbytes = 0
        self._t0 = 0

    def __enter__(self):
        if self.prof is not None:
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.prof is not None and exc_type is None:
            note_dispatch(self.prof, time.perf_counter_ns() - self._t0,
                          nbytes=self.nbytes,
                          out_nbytes=self.out_nbytes,
                          encoded=self.encoded, decoded=self.decoded,
                          plan=self.plan)
        return False


# -- roofline ----------------------------------------------------------------

# HBM peak per card, by the full name torch.cuda.get_device_name gives
# (NVIDIA's data sheet, GB/s). The PCIe and NVL parts of a card differ,
# so a name matches only in full; the CPU measures its own memcpy rate
HBM_PEAK_GBPS = {"NVIDIA H100 80GB HBM3": 3350.0}

_peak_lock = threading.Lock()
_peak: tuple[float, str] | None = None      # guarded-by: _peak_lock


def platform_peak_gbps() -> tuple[float, str]:
    """-> (peak memory GB/s, how it was obtained). On a card: datasheet
    lookup by its full name. Otherwise: measured big-buffer memcpy
    bandwidth, once per process (~100ms), cached."""
    global _peak
    with _peak_lock:
        if _peak is not None:
            return _peak
        _peak = _measure_peak()
        return _peak


def _measure_peak() -> tuple[float, str]:
    import torch
    kind = torch.cuda.get_device_name(0) if torch.cuda.is_available() \
        else "cpu"
    if kind in HBM_PEAK_GBPS:
        return HBM_PEAK_GBPS[kind], f"datasheet({kind})"
    import numpy as np
    buf = np.empty(1 << 27, dtype=np.uint8)   # 128 MB
    t0 = time.perf_counter()
    for _ in range(3):
        buf2 = buf.copy()
    dt = time.perf_counter() - t0
    del buf2
    # copy reads + writes: 2 bytes moved per byte copied
    return (3 * 2 * buf.nbytes / dt) / 1e9, f"measured-memcpy({kind})"


def achieved_gbps(nbytes: int, busy_ns: int) -> float | None:
    """Bytes the device touched over the wall it was busy, in GB/s;
    None when either side is zero (no dispatch yet / timing off)."""
    if nbytes <= 0 or busy_ns <= 0:
        return None
    return (nbytes / (busy_ns / 1e9)) / 1e9


def roofline_fraction(nbytes: int, busy_ns: int) -> float | None:
    g = achieved_gbps(nbytes, busy_ns)
    if g is None:
        return None
    peak, _src = platform_peak_gbps()
    if peak <= 0:
        return None
    return g / peak


def snapshot() -> list[dict]:
    """Registry rows, one dict per (family, fingerprint, plane)."""
    return _REGISTRY.snapshot()


def stats() -> dict:
    """Summary block: entries, cap, evictions, totals, on/off."""
    out = _REGISTRY.stats()
    out["enabled"] = config.kernel_profile()
    return out


def reset_for_tests() -> None:
    """Drop all profile entries (and their billed bytes). The memtrack
    node and its shed registration survive — they are process-scoped,
    like the HBM cache's."""
    _REGISTRY.clear()
    global _peak
    with _peak_lock:
        _peak = None
