"""The one message format of the port's "not ported yet" errors.

The reference's errcode.py is TiDB's MySQL error-code catalog
(mysql/errcode.go) and `classify`, which maps exceptions onto the
(errno, sqlstate) pair of the server's ERR packet. The port has no
server yet, so nothing reads a code; the catalog and `classify` come
with the server.
"""

from __future__ import annotations

__all__ = ["not_ported"]


def not_ported(what: str) -> str:
    """The message of the error the port raises where it has no
    counterpart of the reference's code path yet."""
    return f"{what} is not ported yet"
