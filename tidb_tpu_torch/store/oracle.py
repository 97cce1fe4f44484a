"""Timestamp oracle (TSO).

Reference: TiDB's store/tikv/oracle/oracle.go:23-35 — Oracle
{GetTimestamp(Async), IsExpired}; hybrid ts = physical_ms << 18 | logical;
impls oracles/pd.go (batched from PD) and oracles/local.go (tests).
Here the Cluster plays PD; async prefetch uses a single worker thread
(the reference prefetches the commit/start ts while parsing, session.go:1198).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

__all__ = ["Oracle", "PDOracle", "LocalOracle", "physical_ms", "compose_ts",
           "retention_ts"]


def physical_ms(ts: int) -> int:
    """Physical milliseconds of a hybrid timestamp."""
    return ts >> 18


def compose_ts(ms: int, logical: int = 0) -> int:
    return (ms << 18) | logical


def retention_ts(retain_ms: int) -> int:
    """Hybrid timestamp `retain_ms` behind the wall clock. The TSO is
    wall-clock-ms based, so a store-plane merge clamping its journal
    floor to this keeps a pull window open for remote fleet caches
    whose fill snapshots are at most `retain_ms` old."""
    return compose_ts(max(0, int(time.time() * 1000) - retain_ms))


class Oracle:
    def get_timestamp(self) -> int:
        raise NotImplementedError

    def get_timestamp_async(self) -> Future:
        raise NotImplementedError

    def is_expired(self, lock_ts: int, ttl_ms: int) -> bool:
        phys = self.get_timestamp() >> 18
        return phys >= (lock_ts >> 18) + ttl_ms

    def close(self) -> None:
        pass


class PDOracle(Oracle):
    """TSO from the (mock) PD = Cluster."""

    def __init__(self, pd):
        self.pd = pd
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="tso")

    def get_timestamp(self) -> int:
        return self.pd.tso()

    def get_timestamp_async(self) -> Future:
        return self._pool.submit(self.pd.tso)

    def close(self) -> None:
        self._pool.shutdown(wait=False)


class LocalOracle(Oracle):
    """Process-local clock oracle for unit tests (oracles/local.go)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._last_phys = 0
        self._logical = 0

    def get_timestamp(self) -> int:
        with self._mu:
            ms = int(time.time() * 1000)
            if ms > self._last_phys:
                self._last_phys = ms
                self._logical = 0
            self._logical += 1
            return (self._last_phys << 18) | self._logical

    def get_timestamp_async(self) -> Future:
        f: Future = Future()
        f.set_result(self.get_timestamp())
        return f
