"""Typed exponential backoff with jitter and per-request sleep budgets.

Reference: TiDB's store/tikv/backoff.go:80-126 — per-cause configs
{tikvRPC, TxnLock, RegionMiss, PDRPC, ServerBusy}, total-sleep caps per
request type, forkable contexts for parallel batches (2pc.go:267-289).
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass

__all__ = ["BackoffConfig", "Backoffer", "BackoffExhausted",
           "BO_RPC", "BO_TXN_LOCK", "BO_REGION_MISS", "BO_SERVER_BUSY",
           "GET_MAX_BACKOFF", "SCAN_MAX_BACKOFF", "COP_MAX_BACKOFF",
           "PREWRITE_MAX_BACKOFF", "COMMIT_MAX_BACKOFF"]


class BackoffExhausted(Exception):
    def __init__(self, cause: str, total_ms: int, errors: list):
        super().__init__(f"backoff budget exhausted after {total_ms}ms "
                         f"(last cause: {cause}); errors: {errors[-3:]}")
        self.errors = errors


@dataclass(frozen=True)
class BackoffConfig:
    name: str
    base_ms: int
    cap_ms: int
    # jitter styles: "full" = U(0, current), "equal" = current/2 + U(0, current/2)
    jitter: str = "full"


BO_RPC = BackoffConfig("rpc", 100, 2000, "equal")
BO_TXN_LOCK = BackoffConfig("txnLock", 200, 3000, "equal")
BO_REGION_MISS = BackoffConfig("regionMiss", 2, 500, "full")
BO_SERVER_BUSY = BackoffConfig("serverBusy", 2000, 10000, "equal")

# per-request budgets (ms). Ref: backoff.go:100-126
GET_MAX_BACKOFF = 20_000
SCAN_MAX_BACKOFF = 20_000
COP_MAX_BACKOFF = 20_000
PREWRITE_MAX_BACKOFF = 20_000
COMMIT_MAX_BACKOFF = 41_000


class Backoffer:
    """Tracks cumulative sleep across retries of one logical request."""

    def __init__(self, max_sleep_ms: int, sleep_fn=time.sleep):
        self.max_sleep_ms = max_sleep_ms
        self.total_ms = 0
        self.errors: list = []
        self._attempts: dict[str, int] = {}
        self._sleep = sleep_fn

    def backoff(self, cfg: BackoffConfig, err: Exception) -> None:
        """Sleep per cfg; raise BackoffExhausted past the budget."""
        self.errors.append(err)
        n = self._attempts.get(cfg.name, 0)
        self._attempts[cfg.name] = n + 1
        cur = min(cfg.base_ms * (2 ** n), cfg.cap_ms)
        if cfg.jitter == "full":
            ms = random.uniform(0, cur)
        else:
            ms = cur / 2 + random.uniform(0, cur / 2)
        self.total_ms += ms
        if self.total_ms > self.max_sleep_ms:
            raise BackoffExhausted(cfg.name, int(self.total_ms), self.errors)
        self._sleep(ms / 1000.0)

    def fork(self) -> "Backoffer":
        """Child with the remaining budget (ref: Backoffer.Fork)."""
        b = Backoffer(self.max_sleep_ms - int(self.total_ms), self._sleep)
        return b
