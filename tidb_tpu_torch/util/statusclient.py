"""Status-port HTTP client: one bounded-timeout JSON fetch helper.

Before this module, every consumer of the status API hand-rolled its
own `urllib.request.urlopen` — fleet.py's health probe, bench.py's
fleet scrapes, and half a dozen test files, each with its own timeout
(or none). One shared client keeps the contract in one place:

  * every request carries an explicit bounded timeout — a dead or
    wedged member costs at most the budget, never a hang;
  * JSON decoding and error classification live here, so callers see
    `(doc, None)` or `(None, "timeout"|"error: ...")`, not six
    flavors of URLError.

`fetch_all` is the cluster fan-out built on top: one concurrent sweep
over live members' status ports (member.live_members), used by the
`information_schema.cluster_*` memtables and the `/fleet/*` endpoints.
Per-member outcomes count `tidb_tpu_cluster_scrape_total{outcome=...}`
and an unreachable member degrades to a partial result plus its error
— the caller renders rows for who answered and a warning for who
didn't, never a statement error."""

from __future__ import annotations

import json
import socket
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

__all__ = ["get_json", "get_text", "post_json", "fetch_all"]

DEFAULT_TIMEOUT = 10.0


def _url(host: str, port: int, path: str) -> str:
    if not path.startswith("/"):
        path = "/" + path
    return f"http://{host}:{int(port)}{path}"


def get_text(host: str, port: int, path: str,
             timeout: float = DEFAULT_TIMEOUT) -> str:
    """GET -> decoded body text (the /metrics Prometheus exposition)."""
    with urllib.request.urlopen(_url(host, port, path),
                                timeout=timeout) as r:
        return r.read().decode()


def get_json(host: str, port: int, path: str,
             timeout: float = DEFAULT_TIMEOUT):
    """GET -> decoded JSON document. Raises like urlopen (OSError
    family) or ValueError on a non-JSON body — callers that must not
    fail use fetch_all's classified form."""
    return json.loads(get_text(host, port, path, timeout=timeout))


def post_json(host: str, port: int, path: str, obj,
              timeout: float = DEFAULT_TIMEOUT):
    """POST a JSON document -> decoded JSON reply (the /failpoint
    arming surface)."""
    req = urllib.request.Request(
        _url(host, port, path), data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read().decode())


def _classify(e: BaseException) -> str:
    if isinstance(e, (socket.timeout, TimeoutError)):
        return "timeout"
    if isinstance(e, urllib.error.URLError) and \
            isinstance(getattr(e, "reason", None),
                       (socket.timeout, TimeoutError)):
        return "timeout"
    return "error"


def _fetch_one(member: dict, path: str, timeout: float):
    from tidb_tpu_torch import metrics
    from tidb_tpu_torch.util import failpoint
    mid = member.get("id", "?")
    try:
        # chaos hook: tests arm this to simulate a wedged/partitioned
        # member without killing the process; args (member_id, path)
        failpoint.eval("cluster/fetch", mid, path)
        doc = get_json(member["host"], member["status_port"], path,
                       timeout=timeout)
    except Exception as e:  # noqa: BLE001 — degrade, never propagate:
        # a dead member yields partial fleet results plus a warning
        outcome = _classify(e)
        if outcome == "timeout":
            metrics.counter(metrics.CLUSTER_SCRAPES,
                            {"outcome": "timeout"})
        else:
            metrics.counter(metrics.CLUSTER_SCRAPES,
                            {"outcome": "error"})
        return mid, None, f"{outcome}: {type(e).__name__}: {e}"
    metrics.counter(metrics.CLUSTER_SCRAPES, {"outcome": "ok"})
    return mid, doc, None


def fetch_all(members: list[dict], path: str,
              timeout: float | None = None):
    """Concurrent bounded sweep: GET `path` from every member's status
    port. -> (docs, errors): docs maps member id -> decoded JSON for
    members that answered inside the budget, errors maps member id ->
    classification string for those that didn't. The sweep's wall time
    is ~one timeout, not members x timeout."""
    from tidb_tpu_torch import config, trace
    if timeout is None:
        timeout = config.cluster_fetch_timeout_ms() / 1000.0
    docs: dict[str, dict] = {}
    errors: dict[str, str] = {}
    if not members:
        return docs, errors
    with trace.span("cluster.fetch", members=len(members), path=path):
        with ThreadPoolExecutor(
                max_workers=min(8, len(members)),
                thread_name_prefix="cluster-fetch") as pool:
            for mid, doc, err in pool.map(
                    lambda m: _fetch_one(m, path, timeout), members):
                if err is None:
                    docs[mid] = doc
                else:
                    errors[mid] = err
    return docs, errors
