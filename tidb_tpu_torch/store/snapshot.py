"""On-disk state snapshots for the storage-node process.

Pickle lives HERE, off the wire path: snapshots are trusted local files
this process wrote itself (the same trust domain as the process image),
while everything crossing a socket rides the closed typed contract of
store/wire.py. The `wire-discipline` lint rule (tidb_tpu/lint, see
docs/LINTS.md) pins that split — wire-path modules (wire, remote,
stream, copr, mockstore.rpc) must never import pickle, so a refactor
cannot silently reopen the decode-executes-code hole the typed codec
closed.
"""

from __future__ import annotations

import os
import pickle


def load(path: str):
    """-> (cluster, engine) from a snapshot file written by save()."""
    with open(path, "rb") as f:
        return pickle.load(f)


def save(path: str, cluster, engine) -> None:
    """Atomic write (tmp + rename): a crash mid-save leaves the old
    snapshot intact."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump((cluster, engine), f)
    os.replace(tmp, path)
