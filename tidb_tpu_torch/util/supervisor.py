"""Background-worker supervisor: crashed workers restart with backoff
and a counted metric instead of dying silently.

A copy of the JAX package's util/supervisor.py:

* `supervise(name, beat, stop, interval)` — a daemon loop calling
  `beat()` every `interval` seconds until `stop` is set. A beat that
  raises counts `tidb_tpu_worker_restarts_total{worker=name}` and the
  NEXT beat waits an exponential backoff (capped) instead of the plain
  interval, so a deterministically-failing beat cannot busy-spin; a
  beat that succeeds resets the backoff.

* `run_once(name, fn, retries)` — one-shot background jobs (the
  delta-merge trigger, store/delta.py): run `fn`, retrying a crash up
  to `retries` times with the same counted backoff, then give up
  loudly (logged) rather than silently.

Each supervised beat first evaluates the `worker/tick` failpoint
(util/failpoint.py) with the worker's name, so tests can crash any
worker by name and watch it come back.
"""

from __future__ import annotations

import logging
import threading
import time

from tidb_tpu_torch import metrics
from tidb_tpu_torch.util import failpoint

__all__ = ["supervise", "run_once", "BACKOFF_BASE_S", "BACKOFF_CAP_S"]

log = logging.getLogger("tidb_tpu_torch.supervisor")

BACKOFF_BASE_S = 0.05
BACKOFF_CAP_S = 5.0


def _backoff_s(crashes: int) -> float:
    return min(BACKOFF_BASE_S * (2 ** max(crashes - 1, 0)),
               BACKOFF_CAP_S)


def supervise(name: str, beat, stop: threading.Event,
              interval: float) -> threading.Thread:
    """Start (and return) a daemon thread running `beat()` every
    `interval` seconds until `stop` is set, restarting crashed beats
    with counted exponential backoff. The thread is named `name` so
    thread dumps identify it."""

    def loop() -> None:
        crashes = 0
        # backoff SLOWS a crashing beat, never accelerates it: a 30s
        # worker that starts failing must not retry every 5s
        while not stop.wait(interval if crashes == 0
                            else max(interval, _backoff_s(crashes))):
            try:
                failpoint.eval("worker/tick", name)
                beat()
                crashes = 0
            except Exception as e:  # noqa: BLE001 - the supervisor IS
                # the crash handler: count + back off + keep the worker
                # alive (the pre-supervisor blanket nets did the same,
                # silently and without backoff)
                crashes += 1
                metrics.counter(metrics.WORKER_RESTARTS,
                                {"worker": name})
                log.warning("worker %s crashed (restart %d, backoff "
                            "%.2fs): %s", name, crashes,
                            _backoff_s(crashes), e)

    t = threading.Thread(target=loop, daemon=True, name=name)
    t.start()
    return t


def run_once(name: str, fn, retries: int = 2) -> bool:
    """Run a one-shot background job with crash-restart semantics:
    `fn()` retried up to `retries` times after a crash, each retry
    counted in tidb_tpu_worker_restarts_total{worker=name} and backed
    off. -> True when an attempt completed. Called on the job's own
    (already background) thread."""
    for attempt in range(retries + 1):
        try:
            failpoint.eval("worker/tick", name)
            fn()
            return True
        except Exception as e:  # noqa: BLE001 - counted crash-restart
            metrics.counter(metrics.WORKER_RESTARTS, {"worker": name})
            if attempt >= retries:
                log.error("worker %s gave up after %d attempts: %s",
                          name, attempt + 1, e)
                return False
            time.sleep(_backoff_s(attempt + 1))
    return False
