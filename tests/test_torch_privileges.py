"""Accounts and privileges: the port against the reference.

The reference's own `tests/test_privileges.py` (bootstrap, the password
hash, CREATE/DROP USER, GRANT/REVOKE at global, database and table
scope, the statement checks, the handshake, SET GLOBAL, credential
redaction, the v2 upgrade, SHOW GRANTS) is replayed against the port,
and the same account traffic through both packages' servers gives equal
responses: error codes and SQLSTATEs (1142 for a denied statement, 1045
for a wrong password, 1396 for a duplicate account), affected rows and
SHOW GRANTS rows.
"""

import pytest

from tests.mysql_client import MySQLError
from tests.test_torch_server import (Pair, WireClient, fast_schema_lease,  # noqa: F401
                                     replay, same)


@pytest.fixture
def pair():
    p = Pair()
    yield p
    p.close()


def _connect_both(pair, **kw):
    out = []
    for srv in (pair.jsrv, pair.psrv):
        try:
            out.append(WireClient("127.0.0.1", srv.port, **kw))
        except MySQLError as e:
            out.append((e.code, str(e)))
    return out


ACCOUNT_TRAFFIC = [
    "CREATE DATABASE app",
    "CREATE TABLE app.t (id BIGINT PRIMARY KEY, v BIGINT)",
    "INSERT INTO app.t VALUES (1, 10), (2, 20)",
    "CREATE USER 'alice'@'%' IDENTIFIED BY 'pw'",
    "CREATE USER 'alice'@'%' IDENTIFIED BY 'pw'",
    "CREATE USER IF NOT EXISTS 'alice'@'%' IDENTIFIED BY 'pw'",
    "CREATE USER 'bob'@'%'",
    "GRANT SELECT ON app.* TO 'alice'@'%'",
    "GRANT INSERT ON app.t TO 'alice'@'%'",
    "SHOW GRANTS FOR alice",
    "SHOW GRANTS FOR bob",
    "SELECT user, host, privs FROM mysql.user ORDER BY user",
    "SELECT user, db, privs FROM mysql.db",
    "SELECT user, db, table_name, privs FROM mysql.tables_priv",
]

ALICE_TRAFFIC = [
    "SELECT v FROM app.t ORDER BY id",
    "INSERT INTO app.t VALUES (3, 30)",
    "UPDATE app.t SET v = 0",
    "DELETE FROM app.t WHERE id = 1",
    "CREATE TABLE app.u (a INT)",
    "CREATE USER 'eve'@'%'",
    "SET GLOBAL tidb_tpu_device_min_rows = 5",
    "SHOW GRANTS",
    "SHOW GRANTS FOR bob",
    "SELECT COUNT(*) FROM information_schema.tables",
    "SET PASSWORD = 'pw2'",
]


def test_account_traffic_equals_the_reference(pair):
    jc, pc = pair.clients()
    for sql in ACCOUNT_TRAFFIC:
        same(jc, pc, sql)
    ja, pa = _connect_both(pair, user="alice", password="pw")
    for sql in ALICE_TRAFFIC:
        same(ja, pa, sql)
    # the new password took; the old one is refused with 1045
    wrong = _connect_both(pair, user="alice", password="pw")
    assert wrong[0] == wrong[1] and wrong[1][0] == 1045
    ja2, pa2 = _connect_both(pair, user="alice", password="pw2")
    same(ja2, pa2, "SELECT COUNT(*) FROM app.t")
    for sql in ["REVOKE SELECT ON app.* FROM 'alice'@'%'",
                "FLUSH PRIVILEGES"]:
        same(jc, pc, sql)
    same(ja2, pa2, "SELECT COUNT(*) FROM app.t")
    same(jc, pc, "DROP USER 'alice'@'%'")
    same(jc, pc, "DROP USER 'alice'@'%'")
    same(jc, pc, "DROP USER IF EXISTS 'alice'@'%'")
    gone = _connect_both(pair, user="alice", password="pw2")
    assert gone[0] == gone[1] and gone[1][0] == 1045
    same(jc, pc, "SELECT COUNT(*) FROM mysql.tables_priv")
    for c in (jc, pc, ja, pa, ja2, pa2):
        c.close()


def test_unknown_user_and_empty_password(pair):
    bad = _connect_both(pair, user="nobody")
    assert bad[0] == bad[1] and bad[1][0] == 1045
    jc, pc = pair.clients()
    same(jc, pc, "CREATE USER 'np'@'%'")
    jn, pn = _connect_both(pair, user="np")
    same(jn, pn, "SELECT CURRENT_USER()")
    same(jn, pn, "SELECT * FROM mysql.user")
    for c in (jc, pc, jn, pn):
        c.close()


replay("test_privileges.py", globals())
