"""Privilege subsystem: grant tables, in-memory cache, auth verification.

Reference: TiDB's privilege/privileges/ — grant tables loaded
into an in-memory MySQLPrivilege cache (cache.go:104-112,581),
RequestVerification checks (privileges.go:56), reload on grant
notification. Design deviation (documented): instead of per-privilege
Y/N enum columns, grants are a BIGINT bitmask per (user, host[, db[,
table]]) row — identical semantics, columnar-friendly storage.

Auth is mysql_native_password (ref: util/auth/auth.go):
    stored  = SHA1(SHA1(password))                    ("*HEX" in the table)
    client sends scramble = SHA1(pwd) XOR SHA1(salt + stored)
    server recovers SHA1(pwd) and checks SHA1(of it) == stored.
"""

from __future__ import annotations

import hashlib
import threading

__all__ = ["Priv", "ALL_PRIVS", "PrivilegeCache", "encode_password",
           "check_scramble", "PRIV_BY_NAME"]


class Priv:
    SELECT = 1 << 0
    INSERT = 1 << 1
    UPDATE = 1 << 2
    DELETE = 1 << 3
    CREATE = 1 << 4
    DROP = 1 << 5
    ALTER = 1 << 6
    INDEX = 1 << 7
    CREATE_USER = 1 << 8
    GRANT = 1 << 9
    SUPER = 1 << 10          # SET GLOBAL etc. (system administration)


ALL_PRIVS = (Priv.SELECT | Priv.INSERT | Priv.UPDATE | Priv.DELETE |
             Priv.CREATE | Priv.DROP | Priv.ALTER | Priv.INDEX |
             Priv.CREATE_USER | Priv.GRANT | Priv.SUPER)

PRIV_BY_NAME = {"SELECT": Priv.SELECT, "INSERT": Priv.INSERT,
                "UPDATE": Priv.UPDATE, "DELETE": Priv.DELETE,
                "CREATE": Priv.CREATE, "DROP": Priv.DROP,
                "ALTER": Priv.ALTER, "INDEX": Priv.INDEX,
                "SUPER": Priv.SUPER, "GRANT": Priv.GRANT,
                "CREATE USER": Priv.CREATE_USER,
                "ALL": ALL_PRIVS}


def encode_password(password: str) -> str:
    """PASSWORD(): '*' + hex(SHA1(SHA1(pw))), empty pw -> ''."""
    if not password:
        return ""
    h = hashlib.sha1(hashlib.sha1(password.encode()).digest()).hexdigest()
    return "*" + h.upper()


def check_scramble(auth_response: bytes, salt: bytes, stored: str) -> bool:
    """Verify a mysql_native_password scramble against the stored hash."""
    if not stored:
        return not auth_response        # empty password: empty response
    if len(auth_response) != 20 or not stored.startswith("*"):
        return False
    stage2 = bytes.fromhex(stored[1:])
    mask = hashlib.sha1(salt + stage2).digest()
    sha1_pwd = bytes(a ^ b for a, b in zip(auth_response, mask))
    return hashlib.sha1(sha1_pwd).digest() == stage2


_LOOPBACK = {"localhost", "127.0.0.1", "::1"}


def _host_match(pattern: str, host: str) -> bool:
    if pattern == "%" or pattern == host:
        return True
    # loopback aliases are interchangeable (a 'u'@'localhost' account must
    # authenticate from 127.0.0.1 TCP connections, as in MySQL)
    return pattern in _LOOPBACK and host in _LOOPBACK


class PrivilegeCache:
    """Grant tables snapshot, reloaded on version bump (GRANT/REVOKE/
    CREATE USER notify via `invalidate`). Ref: privileges/cache.go."""

    def __init__(self, storage):
        self.storage = storage
        self._mu = threading.Lock()
        self._loaded = False
        # (user,) -> [(host, auth_string, privs)]
        self._users: dict[str, list] = {}
        # (user, db) matching is by row scan: [(user, host, db, privs)]
        self._dbs: list = []
        self._tables: list = []       # [(user, host, db, tbl, privs)]

    def invalidate(self) -> None:
        with self._mu:
            self._loaded = False

    def _session(self):
        from tidb_tpu_torch.session import Session
        return Session(self.storage, db="mysql", internal=True)

    def _load_locked(self) -> None:
        users: dict[str, list] = {}
        dbs: list = []
        tables: list = []
        s = self._session()
        try:
            if not s.domain.info_schema().has_db("mysql"):
                self._users, self._dbs, self._tables = {}, [], []
                self._loaded = True
                return
            for host, user, auth, privs in s.query(
                    "SELECT host, user, authentication_string, privs "
                    "FROM mysql.user").rows:
                users.setdefault(user, []).append(
                    (host, auth or "", int(privs)))
            for host, user, db, privs in s.query(
                    "SELECT host, user, db, privs FROM mysql.db").rows:
                dbs.append((user, host, db, int(privs)))
            for host, user, db, tbl, privs in s.query(
                    "SELECT host, user, db, table_name, privs "
                    "FROM mysql.tables_priv").rows:
                tables.append((user, host, db, tbl, int(privs)))
        finally:
            s.close()
        self._users, self._dbs, self._tables = users, dbs, tables
        self._loaded = True

    def _ensure(self) -> None:
        with self._mu:
            if not self._loaded:
                self._load_locked()

    # -- connection auth (ref: privileges.go ConnectionVerification) --------

    def connection_verify(self, user: str, host: str, auth_response: bytes,
                          salt: bytes) -> bool:
        self._ensure()
        for pat, stored, _p in self._users.get(user, ()):
            if _host_match(pat, host) and \
                    check_scramble(auth_response, salt, stored):
                return True
        return False

    # -- statement checks (ref: privileges.go RequestVerification) ----------

    def effective_privs(self, user: str, host: str, db: str,
                        table: str) -> int:
        self._ensure()
        privs = 0
        for pat, _a, p in self._users.get(user, ()):
            if _host_match(pat, host):
                privs |= p
        for u, pat, d, p in self._dbs:
            if u == user and _host_match(pat, host) and d == db:
                privs |= p
        for u, pat, d, t, p in self._tables:
            if u == user and _host_match(pat, host) and d == db and \
                    t == table:
                privs |= p
        return privs

    def describe_grants(self, user: str,
                        host: str | None = None) -> list[str]:
        """GRANT statements reconstructing one ACCOUNT's privileges
        (ref: privileges.go ShowGrants). host filters to that exact host
        pattern; None lists every host variant of the name."""
        self._ensure()

        def want(pat: str) -> bool:
            return host is None or pat == host

        def names(p: int) -> str:
            if p & ALL_PRIVS == ALL_PRIVS:
                return "ALL PRIVILEGES"
            display = dict(PRIV_BY_NAME)
            display.pop("ALL", None)
            # bits with multi-word display names (not in the GRANT-able
            # name map)
            display["CREATE USER"] = Priv.CREATE_USER
            display["GRANT OPTION"] = Priv.GRANT
            got = [n for n, bit in display.items() if p & bit]
            return ", ".join(got) if got else "USAGE"

        out = []
        for pat, _a, p in self._users.get(user, ()):
            if want(pat):
                out.append(
                    f"GRANT {names(p)} ON *.* TO '{user}'@'{pat}'")
        for u, pat, d, p in self._dbs:
            if u == user and want(pat):
                out.append(
                    f"GRANT {names(p)} ON `{d}`.* TO '{user}'@'{pat}'")
        for u, pat, d, t, p in self._tables:
            if u == user and want(pat):
                out.append(f"GRANT {names(p)} ON `{d}`.`{t}` "
                           f"TO '{user}'@'{pat}'")
        return out

    def request_verification(self, user: str, host: str, db: str,
                             table: str, want: int) -> bool:
        return (self.effective_privs(user, host, db, table) & want) == want
