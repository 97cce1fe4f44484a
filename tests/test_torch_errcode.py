"""The MySQL error-code catalog and `classify`: the port against the
reference.

The port's errcode.py equals the reference's catalog (every ER_* code,
its SQLSTATE, the retryable set), and the same failing statements
through both packages' sessions classify to the same (errno, SQLSTATE,
message): codes are compared, not only messages, since `classify`
matches messages where a typed exception does not decide. It knows the
port's own exception classes (ExecError, QuotaExceededError,
AdmissionRejectedError, the KV errors). The reference's own errcode
and binlog cases (`tests/test_binlog_errcode.py` TestErrcode and
TestBinlog) are replayed against the port.
"""

import pytest

from tests.test_torch_server import replay
from tidb_tpu import errcode as jerr
from tidb_tpu.session import Session as JSession
from tidb_tpu.store import new_mock_storage as j_storage
from tidb_tpu_torch import errcode as perr
from tidb_tpu_torch.session import Session as PSession
from tidb_tpu_torch.store.storage import new_mock_storage as p_storage


def test_catalog_equals_the_reference():
    def codes(mod):
        return {k: v for k, v in vars(mod).items()
                if k.startswith("ER_") and isinstance(v, int)}
    assert codes(perr) == codes(jerr)
    assert perr._SQLSTATE == jerr._SQLSTATE
    assert perr.RETRYABLE == jerr.RETRYABLE
    assert [(p.pattern, c) for p, c in perr._PATTERNS] == \
        [(p.pattern, c) for p, c in jerr._PATTERNS]


FAILING = [
    "SELEKT 1",
    "SELECT * FROM nosuch",
    "SELECT nosuch FROM t",
    "USE nosuchdb",
    "CREATE TABLE t (a INT)",
    "CREATE DATABASE d",
    "INSERT INTO t VALUES (1, 1)",
    "INSERT INTO t (a) VALUES (1, 2)",
    "INSERT INTO t VALUES (NULL, 1)",
    "SELECT @@nosuchvar",
    "SET @@tidb_tpu_device_min_rows = 'many'",
    "KILL 987654",
    "EXECUTE nosuch",
    "CREATE VIEW v AS SELECT 1",
    "DROP VIEW v",
    "DROP USER 'nobody'@'%'",
    "GRANT SELECT ON d.* TO 'nobody'@'%'",
    "CREATE INDEX ib ON t (b)",
    "CREATE INDEX ib ON t (b)",
    "ALTER TABLE t ADD COLUMN b INT",
    "SELECT a FROM t, t AS t2 WHERE a = 1",
    "SELECT * FROM performance_schema.nosuch",
    "DROP TABLE nosuch",
    "DROP DATABASE nosuch",
]


@pytest.fixture
def sessions():
    jst, pst = j_storage(), p_storage(device="cpu")
    js, ps = JSession(jst), PSession(pst)
    for s in (js, ps):
        s.execute("CREATE DATABASE d; USE d")
        s.execute("CREATE TABLE t (a BIGINT PRIMARY KEY, b INT)")
        s.execute("INSERT INTO t VALUES (1, 1), (2, 2)")
    yield js, ps
    for s, st in ((js, jst), (ps, pst)):
        s.close()
        st.close()


def _classified(err_mod, session, sql):
    try:
        session.execute(sql)
    except Exception as e:  # noqa: BLE001 - classified below
        return err_mod.classify(e)
    return None


@pytest.mark.parametrize("sql", FAILING)
def test_failing_statement_classifies_as_the_reference(sessions, sql):
    js, ps = sessions
    got = _classified(perr, ps, sql)
    assert got == _classified(jerr, js, sql)
    assert got is not None or sql.startswith("CREATE INDEX")


def test_port_exception_classes():
    from tidb_tpu_torch import kv, memtrack, sched
    from tidb_tpu_torch.executor import ExecError
    assert perr.classify(ExecError("Query execution was interrupted"))[:2] \
        == (perr.ER_QUERY_INTERRUPTED, "70100")
    assert perr.classify(memtrack.QuotaExceededError(
        "Out Of Memory Quota! query tracked 9 bytes"))[0] == \
        perr.ER_MEM_EXCEED_QUOTA
    code = perr.classify(sched.AdmissionRejectedError("busy"))[0]
    assert code == perr.ER_SERVER_BUSY_ADMISSION and perr.is_retryable(code)
    assert perr.is_retryable(perr.classify(
        kv.WriteConflictError(b"k", 1, 2))[0])
    assert perr.classify(RuntimeError("Unknown column 'x'"))[0] == \
        perr.ER_UNKNOWN
    assert perr.not_ported("TRACE") == "TRACE is not ported yet"


replay("test_binlog_errcode.py", globals(),
       subs={"from mysql_client import MiniClient, MySQLError":
             "from tests.mysql_client import MiniClient, MySQLError"})
