"""Fleet member identity + the ephemeral membership registry.

Every server process of a fleet — the N stateless SQL servers AND the
store plane itself — mints one stable identity at startup: the host and
status port it serves on plus a random 32-bit start nonce. The nonce
does double duty:

  * it makes the member id unique across restarts (a member that
    SIGKILLs and comes back on the same ports is a NEW member — its
    caches are cold, its meters are zero, and joining its old rows to
    its new ones would be wrong), and
  * it is folded into every trace id this process mints
    (trace.ensure_id), so trace ids are fleet-unique and a store-plane
    ring record's `origin_trace_id` joins unambiguously back to the SQL
    member that issued the statement.

Membership is advertised through the store plane the same way the
schema-sync heartbeats are (session Domain.publish_schema_version):
a lease-stamped JSON record under an EPHEMERAL key prefix
(mockstore/mvcc.py EPHEMERAL_PREFIXES — heartbeats never bump
data_version, so a 1/s membership beat cannot re-cold the fleet's
chunk/HBM caches), republished every `tidb_tpu_member_heartbeat_ms` by
a supervised worker and expiring `tidb_tpu_member_ttl_ms` after the
last beat. Any member enumerates live peers with one snapshot range
scan (`live_members`); a SIGKILLed member simply stops beating and
ages out within one TTL — there is no deregistration path to miss.

Ref: the reference's infosync.InfoSyncer (domain/infosync/info.go) —
every tidb-server publishes a TTL'd ServerInfo record to etcd and the
CLUSTER_INFO/CLUSTER_PROCESSLIST memtables enumerate it."""

from __future__ import annotations

import json
import logging
import os
import threading
import time

from tidb_tpu_torch import codec, kv

__all__ = ["MEMBER_PREFIX", "nonce", "set_identity", "identity",
           "member_id", "start_unix", "publish_once", "live_members",
           "local_state", "start_heartbeat", "stop_heartbeat",
           "reset_for_tests"]

log = logging.getLogger("tidb_tpu_torch.member")

# ephemeral membership namespace (declared in EPHEMERAL_PREFIXES):
# key = MEMBER_PREFIX + member_id, value = the JSON identity record
# with an `expiry` wall-clock stamp
MEMBER_PREFIX = b"m_member_"

_mu = threading.Lock()
_nonce: int | None = None           # guarded-by: _mu
_identity: dict | None = None       # guarded-by: _mu
_start_unix = time.time()
_hb_stop: threading.Event | None = None   # guarded-by: _mu


def nonce() -> int:
    """This process's 32-bit start nonce (minted once, first use).
    Folded into trace ids by trace.ensure_id — two members minting
    trace ids concurrently never collide, and a restarted member never
    reuses its dead predecessor's id space."""
    global _nonce
    with _mu:
        if _nonce is None:
            _nonce = int.from_bytes(os.urandom(4), "big") or 1
        return _nonce


def set_identity(host: str, status_port: int, role: str) -> str:
    """Record this process's fleet identity (called once at server
    startup, before the heartbeat starts). role is "sql" or "store".
    -> the member id."""
    global _identity
    ident = {
        "id": f"{host}:{status_port}:{nonce():08x}",
        "host": host,
        "status_port": int(status_port),
        "role": role,
        "nonce": nonce(),
        "start_unix": _start_unix,
    }
    with _mu:
        _identity = ident
    return ident["id"]


def identity() -> dict:
    """The recorded identity — or a local-process placeholder when no
    server ever registered one (in-process sessions, unit tests): the
    cluster surfaces still render, scoped to this process."""
    with _mu:
        if _identity is not None:
            return dict(_identity)
    return {"id": f"local:0:{nonce():08x}", "host": "local",
            "status_port": 0, "role": "local", "nonce": nonce(),
            "start_unix": _start_unix}


def member_id() -> str:
    return identity()["id"]


def start_unix() -> float:
    return _start_unix


def publish_once(storage) -> None:
    """One membership beat: write this member's lease-stamped record
    under its ephemeral key (same txn path as the schema-sync
    heartbeat — Domain.publish_schema_version). A failed beat logs and
    returns: the record expires within one TTL, so peers treat a
    member that cannot reach the store plane as dead, which it
    operationally is."""
    from tidb_tpu_torch import config
    ident = identity()
    ident["expiry"] = int(time.time() * 1000) + config.member_ttl_ms()
    key = MEMBER_PREFIX + ident["id"].encode()
    txn = storage.begin()
    try:
        txn.set(key, json.dumps(ident).encode())
        txn.commit()
    except kv.KVError as e:
        log.warning("membership heartbeat failed: %s", e)
        if getattr(txn, "valid", False):
            txn.rollback()


def live_members(storage) -> list[dict]:
    """Unexpired membership records, sorted by member id — the fan-out
    list for the cluster_* tables and the /fleet/* endpoints. One
    snapshot range scan over the ephemeral prefix."""
    now = int(time.time() * 1000)
    out: list[dict] = []
    snap = storage.snapshot(storage.current_ts())
    end = codec.prefix_next(MEMBER_PREFIX)
    for _k, v in snap.iter_range(MEMBER_PREFIX, end):
        try:
            rec = json.loads(v)
            if int(rec["expiry"]) > now:
                out.append(rec)
        except (ValueError, KeyError, TypeError):
            continue
    out.sort(key=lambda r: r.get("id", ""))
    return out


def local_state() -> dict:
    """This member's cluster-state document — the payload GET
    /cluster/state serves and the cluster_* memtables consume, one
    fetch per member: identity, live sessions, per-tenant resource
    meters, and retained trace summaries (origin-stamped, so a
    store-plane member's records join back to SQL statements). Also
    the degraded local-only document when no registry exists
    (in-process sessions, unit tests)."""
    from tidb_tpu_torch import meter, profiler, trace
    from tidb_tpu_torch.session import processlist_snapshot
    return {
        "member": identity(),
        "processlist": processlist_snapshot(),
        "resource_usage": {
            "server": meter.server_snapshot(),
            "users": meter.users_snapshot(),
            "sessions": meter.sessions_snapshot(),
        },
        "traces": trace.ring_snapshot(),
        "kernel_profile": profiler.snapshot(),
    }


def start_heartbeat(storage) -> None:
    """Start the supervised membership heartbeat (idempotent). The
    worker republishes every `tidb_tpu_member_heartbeat_ms`; a crashing
    beat is counted in tidb_tpu_worker_restarts_total and backed off
    by the supervisor, never silently swallowed."""
    global _hb_stop
    from tidb_tpu_torch import config
    from tidb_tpu_torch.util import supervisor
    with _mu:
        if _hb_stop is not None:
            return
        _hb_stop = threading.Event()
        stop = _hb_stop
    publish_once(storage)       # registered before the first tick
    supervisor.supervise("member-heartbeat",
                         lambda: publish_once(storage), stop,
                         config.member_heartbeat_ms() / 1000.0)


def stop_heartbeat() -> None:
    global _hb_stop
    with _mu:
        stop = _hb_stop
        _hb_stop = None
    if stop is not None:
        stop.set()


def reset_for_tests() -> None:
    """Drop the recorded identity and heartbeat (test isolation). The
    nonce stays — trace ids minted earlier in the process must not
    collide with ones minted after."""
    global _identity
    stop_heartbeat()
    with _mu:
        _identity = None
