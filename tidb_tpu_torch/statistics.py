"""Count-min sketch for point frequency.

A copy of the `CMSketch` class and `cm_key` of the JAX package's
statistics module (and nothing else of it): the hybrid join's streaming
heavy-hitter detection (ops/hybrid.py) counts observed probe-key hashes
in one, and an ANALYZE-time sketch of the probe table, where a caller
has one, seeds the hot set.
"""

from __future__ import annotations

import base64
import hashlib

import numpy as np

__all__ = ["CMSketch", "cm_key", "CM_DEPTH", "CM_WIDTH"]

CM_DEPTH = 4
CM_WIDTH = 2048


class CMSketch:
    """Count-min sketch, inserted per distinct value with its count."""

    def __init__(self, depth: int = CM_DEPTH, width: int = CM_WIDTH):
        self.depth = depth
        self.width = width
        self.count = 0
        self.table = np.zeros((depth, width), dtype=np.int64)

    def _positions(self, key: bytes) -> list[int]:
        d = hashlib.blake2b(key, digest_size=16).digest()
        h1 = int.from_bytes(d[:8], "little")
        h2 = int.from_bytes(d[8:], "little")
        return [(h1 + i * h2) % self.width for i in range(self.depth)]

    def insert(self, key: bytes, cnt: int = 1) -> None:
        self.count += cnt
        for i, p in enumerate(self._positions(key)):
            self.table[i, p] += cnt

    def query(self, key: bytes) -> int:
        return min(int(self.table[i, p])
                   for i, p in enumerate(self._positions(key)))

    def to_obj(self):
        return {"depth": self.depth, "width": self.width, "count": self.count,
                "table": base64.b64encode(
                    self.table.astype("<i8").tobytes()).decode()}

    @staticmethod
    def from_obj(o) -> "CMSketch":
        cm = CMSketch(o["depth"], o["width"])
        cm.count = o["count"]
        cm.table = np.frombuffer(
            base64.b64decode(o["table"]), dtype="<i8").reshape(
                o["depth"], o["width"]).copy()
        return cm


def cm_key(v) -> bytes:
    """CMSketch key encoding of a column value: a consumer must query with
    exactly the encoding the sketch was built with."""
    if isinstance(v, (bytes, bytearray)):
        return bytes(v)
    if isinstance(v, str):
        return b"s" + v.encode("utf-8", "surrogateescape")
    if isinstance(v, (int, np.integer)):
        return b"i" + int(v).to_bytes(8, "little", signed=True)
    return b"f" + np.float64(v).tobytes()
