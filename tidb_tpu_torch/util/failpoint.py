"""Central gofail-style failpoint registry: every injectable fault in
one table, armed by name, free when disarmed.

Reference: the reference system's gofail sites (mocktikv rpc.go:465-521
`rpcServerBusy`/`rpcCommitResult`/..., armed via the failpoint HTTP
endpoint) — the pattern this module ports. Before it, the only fault
machinery in-tree was the store-level Backoffer and one ad-hoc `inject`
hook on the mockstore RPC shim; the entire device plane (kernel
dispatch/finalize, HBM fill/patch, the delta-merge worker, scheduler
slots, the admission shed chain, wire teardown) had no injectable
faults and therefore no proof of recovery. Now each seam declares one
named point in `REGISTRY` below and calls

    failpoint.eval("name", *args)

which costs ONE dict lookup while the point is disarmed — production
paths stay free. Armed points run an action:

  * ``raise`` / ``raise(ExcName)`` / ``raise(ExcName:message)`` — raise
    an exception from the safe class table (`_EXC_TABLE`);
  * ``delay(ms)``       — sleep, then continue (slow-path injection);
  * ``return(value)``   — eval returns the parsed int/str value;
  * a Python callable   — called with eval's args (test hooks; the
    successor of the deleted `RPCShim.inject`).

Action prefixes compose: ``3*raise(DeviceFaultError)`` fires three
times then self-disarms (fire-count budget); ``1-in-4:delay(20)``
fires on every 4th evaluation (deterministic, so chaos schedules
replay). Arming surfaces:

  * environment: ``TIDB_TPU_FAILPOINTS="hbm/fill=raise;..."`` at
    import (CI / chaos harness);
  * Python: `enable()` / `disable()` / `disable_all()` (tests).

The `failpoint-discipline` lint rule keeps the table honest: every
in-tree eval site must use a declared name, and a declared name no
eval site fires is a finding. See docs/ROBUSTNESS.md for the catalog
and the recovery machinery (watchdog / quarantine / supervisor) the
faults prove out.
"""

from __future__ import annotations

import os
import threading
import time

from tidb_tpu_torch import metrics

__all__ = ["REGISTRY", "eval", "enable", "disable", "disable_all",
           "armed", "parse_spec", "arm_from_string",
           "FailpointError", "DeviceFaultError", "DispatchTimeoutError",
           "UnknownFailpointError", "BadFailpointSpecError"]


# -- the declared points (the failpoint-discipline lint table) ---------------
# name -> where it fires / what arming it simulates. Declaring here is
# the ONLY way to add a failpoint: eval() of an undeclared name is a
# lint finding, enable() of one raises.
REGISTRY: dict[str, str] = {
    # mockstore RPC shim, before every command's region check (the
    # migrated `inject` hook): args (cmd, ctx). Streaming re-checks per
    # frame, so arming it mid-stream drives the client resume path.
    "rpc/request": "mockstore/rpc.py _check — every RPC command, "
                   "including the per-frame CopStream re-check",
    # storage-side streaming producer, before each frame is yielded:
    # args (region_id,). Distinct from rpc/request: fires on the remote
    # transport too.
    "copr/stream-frame": "store/stream.py region_stream — before each "
                         "framed partial response is emitted",
    # device kernel dispatch: sync sites (store/copr.py) and the
    # pipelined dispatch wrapper (ops/runtime.pipeline_map)
    "device/dispatch": "kernel dispatch (copr sync sites + "
                       "pipeline_map) — a raise here is a device fault "
                       "the retry/degrade/quarantine chain handles",
    # device kernel finalize (the blocking readback): pipeline_map's
    # pop_finalize and the device_slot-guarded sync calls
    "device/finalize": "kernel finalize / readback — delay(ms) here "
                       "exercises the dispatch watchdog",
    "hbm/fill": "store/device_cache.py fill — the HBM region-block "
                "upload path",
    "hbm/patch": "store/device_cache.py _patch_locked — the in-place "
                 "delta patch of a resident block",
    "delta/merge": "store/delta.py _merge_table — the background "
                   "delta-merge worker loop (supervisor restarts it)",
    "sched/slot": "sched.device_slot acquire — the global dispatch-"
                  "slot grant",
    "admission/shed": "sched.shed_server — the admission/operator shed "
                      "chain drive",
    "wire/resultset": "server _write_resultset — between result rows "
                      "(connection teardown mid-resultset)",
    "worker/tick": "util/supervisor.py — each supervised background-"
                   "worker beat (schema worker, delta merge); args "
                   "(worker_name,)",
    # cluster observability fan-out, before each per-member status-port
    # fetch: args (member_id, path). Arming it simulates a wedged or
    # partitioned member — cluster_* queries must degrade to partial
    # rows + a warning, never hang or error.
    "cluster/fetch": "util/statusclient.py _fetch_one — before each "
                     "per-member fetch of the cluster_* / /fleet/* "
                     "fan-out",
    # kernel-profile registry record fold, before each completed
    # dispatch is folded into its profile row: args (family,). Lets
    # tests fault/delay exactly the profiler's own bookkeeping without
    # touching the kernel dispatch it shadows.
    "profiler/record": "profiler.KernelProfileRegistry.record_dispatch "
                       "— before a completed dispatch folds into its "
                       "profile row",
}


class FailpointError(RuntimeError):
    """Generic injected failure (the default `raise` action)."""


class DeviceFaultError(Exception):
    """A device-plane operation (kernel dispatch/finalize, HBM
    fill/patch) failed or timed out. RETRYABLE: surfaced to clients as
    ER_DEVICE_FAULT (9009) — nothing partial is visible, the statement
    may be re-run verbatim; in-process the recovery chain (retry once,
    degrade the statement to the host path, quarantine the device on
    repeated faults) usually absorbs it first. Raised by armed
    failpoints, by the dispatch watchdog (sched.py), and available to
    real device backends for transport-level failures."""


class DispatchTimeoutError(DeviceFaultError):
    """The dispatch watchdog's flavor of DeviceFaultError: the
    statement is already cancel-latched, so the per-dispatch recovery
    chain must NOT retry it — it propagates straight out (still
    retryable at the client)."""


class UnknownFailpointError(KeyError):
    """enable()/POST of a name not declared in REGISTRY."""


class BadFailpointSpecError(ValueError):
    """Unparseable action spec."""


# exceptions `raise(Name)` may construct: message-only / no-arg classes
# (region errors need ids — inject those through a callable action)
def _exc_table() -> dict:
    from tidb_tpu_torch import kv
    return {
        "FailpointError": FailpointError,
        "DeviceFaultError": DeviceFaultError,
        "DispatchTimeoutError": DispatchTimeoutError,
        "KVError": kv.KVError,
        "ServerBusyError": kv.ServerBusyError,
        "RetryableError": kv.RetryableError,
        "StreamInterruptedError": kv.StreamInterruptedError,
        "RuntimeError": RuntimeError,
        "IOError": IOError,
        "TimeoutError": TimeoutError,
    }


class _Armed:
    """One armed point. Counters are guarded by the module _mu; the
    action fields are immutable after construction."""

    __slots__ = ("spec", "action", "arg", "budget", "period", "hits",
                 "fired")

    def __init__(self, spec, action, arg, budget, period):
        self.spec = spec            # original string (None for callables)
        self.action = action        # "raise"|"delay"|"return"|"call"
        self.arg = arg
        self.budget = budget        # guarded-by: _mu  remaining fires
        self.period = period        # fire every Nth eval (None = every)
        self.hits = 0               # guarded-by: _mu
        self.fired = 0              # guarded-by: _mu


_mu = threading.Lock()
_ARMED: dict[str, _Armed] = {}      # guarded-by: _mu (reads lock-free)


def parse_spec(spec: str) -> _Armed:
    """``[N*][1-in-M:]action[(arg)]`` -> an _Armed (unbound).
    Raises BadFailpointSpecError on anything else."""
    raw = spec
    spec = spec.strip()
    budget = None
    period = None
    if "*" in spec:
        head, spec = spec.split("*", 1)
        try:
            budget = int(head)
        except ValueError:
            raise BadFailpointSpecError(raw) from None
        if budget <= 0:
            raise BadFailpointSpecError(raw)
    if spec.startswith("1-in-"):
        head, _, spec = spec.partition(":")
        try:
            period = int(head[len("1-in-"):])
        except ValueError:
            raise BadFailpointSpecError(raw) from None
        if period <= 0 or not spec:
            raise BadFailpointSpecError(raw)
    arg = None
    if "(" in spec:
        if not spec.endswith(")"):
            raise BadFailpointSpecError(raw)
        spec, arg = spec[:-1].split("(", 1)
    action = spec.strip()
    if action == "raise":
        exc_name, _, msg = (arg or "FailpointError").partition(":")
        cls = _exc_table().get(exc_name.strip())
        if cls is None:
            raise BadFailpointSpecError(
                f"{raw}: unknown exception {exc_name!r} (see "
                f"failpoint._exc_table)")
        arg = (cls, msg or f"failpoint {exc_name.strip()}")
    elif action == "delay":
        try:
            arg = float(arg)
        except (TypeError, ValueError):
            raise BadFailpointSpecError(raw) from None
    elif action == "return":
        if not arg:
            raise BadFailpointSpecError(raw)
        try:
            arg = int(arg)
        except ValueError:
            pass                    # strings pass through verbatim
    else:
        raise BadFailpointSpecError(raw)
    return _Armed(raw, action, arg, budget, period)


def enable(name: str, spec) -> None:
    """Arm `name` with a spec string or a callable (called with eval's
    args; its return value is eval's). Re-arming replaces."""
    if name not in REGISTRY:
        raise UnknownFailpointError(name)
    if callable(spec):
        ap = _Armed(None, "call", spec, None, None)
    else:
        ap = parse_spec(spec)
    with _mu:
        _ARMED[name] = ap


def disable(name: str) -> None:
    with _mu:
        _ARMED.pop(name, None)


def disable_all() -> None:
    with _mu:
        _ARMED.clear()
        _SYSVAR_ARMED.clear()


def armed() -> dict[str, dict]:
    """Snapshot of armed points (status endpoint / tests)."""
    with _mu:
        return {name: {"spec": ap.spec or "<callable>",
                       "hits": ap.hits, "fired": ap.fired,
                       "budget": ap.budget}
                for name, ap in _ARMED.items()}


def eval(name: str, *args):  # noqa: A001 - gofail's verb, deliberately
    """The instrumented-seam hook: one dict lookup when `name` is
    disarmed (returns None); otherwise runs the armed action — which
    may raise, sleep, or hand back a value."""
    ap = _ARMED.get(name)       # lock-free read: benign race with
    if ap is None:              # enable/disable, re-checked under _mu
        return None
    return _fire(name, ap, args)


def _fire(name: str, ap: _Armed, args):
    with _mu:
        if _ARMED.get(name) is not ap:
            return None         # disarmed/re-armed since the fast read
        ap.hits += 1
        if ap.period is not None and ap.hits % ap.period != 0:
            return None
        if ap.budget is not None:
            if ap.budget <= 0:
                _ARMED.pop(name, None)
                return None
            ap.budget -= 1
            if ap.budget == 0:
                _ARMED.pop(name, None)   # last fire: self-disarm
        ap.fired += 1
        action, arg = ap.action, ap.arg
    # the action itself runs with _mu dropped: callables may re-enter
    # the registry, raises unwind arbitrary stacks, delays sleep
    metrics.counter(metrics.FAILPOINT_FIRES, {"name": name})
    if action == "raise":
        cls, msg = arg
        raise cls(msg)
    if action == "delay":
        time.sleep(arg / 1e3)
        return None
    if action == "return":
        return arg
    return arg(*args)           # "call"


# -- bulk arming (env / sysvar) ----------------------------------------------

_SYSVAR_ARMED: set = set()     # names the sysvar armed; guarded-by: _mu


def arm_from_string(specs: str, owner_sysvar: bool = False) -> list[str]:
    """Parse ``name=spec;name=spec`` and arm each point; with
    owner_sysvar=True the listed set REPLACES whatever a previous sysvar
    write armed (the sysvar's value is declarative). Returns the armed
    names. Raises on unknown names / bad specs — arming must fail
    loudly, a typo'd chaos schedule that silently arms nothing would
    fake a green run."""
    pairs = []
    for part in specs.split(";"):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise BadFailpointSpecError(part)
        name, spec = part.split("=", 1)
        pairs.append((name.strip(), spec.strip()))
    # validate EVERYTHING before arming ANYTHING: a bad entry halfway
    # through must not leave earlier points armed (and, on the sysvar
    # surface, un-owned)
    parsed = []
    for name, spec in pairs:
        if name not in REGISTRY:
            raise UnknownFailpointError(name)
        parsed.append((name, parse_spec(spec)))
    names = [name for name, _ap in parsed]
    with _mu:
        for name, ap in parsed:
            _ARMED[name] = ap
        if owner_sysvar:
            for old in _SYSVAR_ARMED - set(names):
                _ARMED.pop(old, None)
            _SYSVAR_ARMED.clear()
            _SYSVAR_ARMED.update(names)
    return names


def _sysvar_changed(value) -> None:
    """config.on_change hook for `tidb_tpu_failpoints`: the sysvar's
    string IS the SET-armed set."""
    arm_from_string(str(value or ""), owner_sysvar=True)


def _install() -> None:
    from tidb_tpu_torch import config
    config.on_change("tidb_tpu_failpoints", _sysvar_changed)
    env = os.environ.get("TIDB_TPU_FAILPOINTS")
    if env:
        arm_from_string(env)


_install()
