"""The port's MySQL server against the reference's, over the wire.

The same traffic goes through the JAX package's `tidb_tpu.server.Server`
and the port's `tidb_tpu_torch.server.Server` (storage on the CPU),
driven by the existing `tests/mysql_client.MiniClient` with a reader of
the whole response beside it (`WireClient.run`): column names and wire
types, rows, affected rows, warning counts, error codes and SQLSTATEs
must be equal. The reference's own `tests/test_server.py` is replayed
against the port (`replay`: its source with the package pointed at
`tidb_tpu_torch` and the storage on the CPU), and `python -m
tidb_tpu_torch --device cpu` serves a client as a real process; without
`--device cpu` on a machine with no card it refuses to start.
"""

import os
import re
import socket
import struct
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from tests.mysql_client import MiniClient, read_lenenc_bytes, read_lenenc_int
from tidb_tpu.server import Server as JServer
from tidb_tpu.store import new_mock_storage as j_storage
from tidb_tpu_torch.server import Server as PServer
from tidb_tpu_torch.store.storage import new_mock_storage as p_storage

ROOT = Path(__file__).resolve().parent.parent

# the reference's test modules read with the package pointed at the port
# (not inside a LIKE pattern: `SHOW VARIABLES LIKE 'tidb_tpu%'` names the
# sysvars both packages share) and every storage, store plane and fleet
# made on the CPU
_TO_PORT = [(re.compile(r"\btidb_tpu\b(?!_torch|%)"), "tidb_tpu_torch"),
            (re.compile(r"new_mock_storage\(\)"),
             'new_mock_storage(device="cpu")'),
            (re.compile(r"StorageServer\(\)"),
             'StorageServer(device="cpu")'),
            (re.compile(r'\bconnect\(("127\.0\.0\.1", [\w.]+)'
                        r'(, local_cache=True)?\)'),
             r'connect(\1\2, device="cpu")'),
            (re.compile(r"\bFleet\(n_sql=(\d+)\)"),
             r'Fleet(n_sql=\1, device="cpu")'),
            (re.compile(r'("-m",\s*"tidb_tpu_torch\.store\.remote",)'),
             r'\1 "--device", "cpu",')]


def port_source(src: str) -> str:
    """A reference test module's source as `replay` runs it."""
    for rx, rep in _TO_PORT:
        src = rx.sub(rep, src)
    return src


def replay(ref_file: str, namespace: dict, drop: dict | None = None,
           subs: dict | None = None) -> None:
    """Define the test cases of the reference's `tests/<ref_file>` in
    `namespace` (a test module's globals), run against the port: the
    source with every `tidb_tpu` module and logger name pointed at
    `tidb_tpu_torch` and every mock storage made on the CPU. `drop` maps
    a case ("Class::test" or "test") to the reason it is not replayed
    (it drives a plane the port has not ported); `subs` maps a line of
    the reference's setup to the port's way of doing the same (each must
    occur in the source)."""
    path = ROOT / "tests" / ref_file
    src = path.read_text()
    for old, new in (subs or {}).items():
        assert old in src, old
        src = src.replace(old, new)
    exec(compile(port_source(src), str(path), "exec"), namespace)
    for case in drop or {}:
        cls, _, meth = case.partition("::")
        if meth:
            delattr(namespace[cls], meth)
        else:
            del namespace[cls]


class WireClient(MiniClient):
    """MiniClient with a reader of the whole text-protocol response:
    `run(sql)` -> ("ok", affected, warnings) | ("rs", [(name, type)],
    rows) | ("err", code, sqlstate, message)."""

    def run(self, sql: str):
        first = self._command(0x03, sql.encode())
        return self._response(first)

    def _response(self, first: bytes):
        if first[0] == 0xFF:
            code = struct.unpack_from("<H", first, 1)[0]
            return ("err", code, first[4:9].decode(),
                    first[9:].decode("utf8", "replace"))
        if first[0] == 0x00:
            affected, off = read_lenenc_int(first, 1)
            _lid, off = read_lenenc_int(first, off)
            warnings = struct.unpack_from("<H", first, off + 2)[0]
            return ("ok", affected, warnings)
        ncols, _ = read_lenenc_int(first, 0)
        cols = [self._parse_coldef(self.pkt.read_packet())
                for _ in range(ncols)]
        assert self.pkt.read_packet()[0] == 0xFE
        rows = []
        while True:
            pkt = self.pkt.read_packet()
            if pkt[0] == 0xFE and len(pkt) < 9:
                return ("rs", cols, rows)
            rows.append(self._parse_row(pkt, ncols))

    def coldefs(self, sql: str):
        """Every field of each column definition of a query's result:
        (name, charset, length, type, flags, decimals)."""
        first = self._command(0x03, sql.encode())
        ncols, _ = read_lenenc_int(first, 0)
        out = []
        for _ in range(ncols):
            pkt = self.pkt.read_packet()
            off = 0
            for _ in range(4):
                _v, off = read_lenenc_bytes(pkt, off)
            name, off = read_lenenc_bytes(pkt, off)
            _org, off = read_lenenc_bytes(pkt, off)
            charset, length, tp, flags, dec = struct.unpack_from(
                "<HIBHB", pkt, off + 1)
            out.append((name.decode(), charset, length, tp, flags, dec))
        assert self.pkt.read_packet()[0] == 0xFE
        while not (lambda p: p[0] == 0xFE and len(p) < 9)(
                self.pkt.read_packet()):
            pass
        return out


class Pair:
    """The reference's server and the port's, each on a fresh mock
    storage, started; `clients(...)` connects one WireClient to each."""

    def __init__(self):
        self.jst = j_storage()
        self.pst = p_storage(device="cpu")
        for st in (self.jst, self.pst):
            st.async_commit_secondaries = False
        self.jsrv = JServer(self.jst, port=0)
        self.psrv = PServer(self.pst, port=0)
        self.jsrv.start()
        self.psrv.start()

    def clients(self, **kw):
        return (WireClient("127.0.0.1", self.jsrv.port, **kw),
                WireClient("127.0.0.1", self.psrv.port, **kw))

    def close(self):
        # the reference's close() closes its listener without waking the
        # accept() blocked on it, then joins that thread for 5 s: wake it
        # first (the port's close() shuts its listener down itself)
        self.jsrv._listener.shutdown(socket.SHUT_RDWR)
        for srv, st in ((self.jsrv, self.jst), (self.psrv, self.pst)):
            srv.close()
            st.close()


def same(jc, pc, sql):
    """Run `sql` on both connections; their whole responses are equal."""
    jr, pr = jc.run(sql), pc.run(sql)
    assert pr == jr, sql
    return pr


@pytest.fixture(autouse=True)
def fast_schema_lease(monkeypatch):
    """Both packages' schema workers on a 100 ms lease (a 50 ms tick): a
    DDL through a server waits for the worker's next tick, 1 s apart at
    the default 2 s lease."""
    from tidb_tpu.session import Domain as JDomain
    from tidb_tpu_torch.session import Domain as PDomain
    for dom in (JDomain, PDomain):
        monkeypatch.setattr(dom, "SCHEMA_LEASE_MS", 100)


@pytest.fixture
def pair():
    p = Pair()
    yield p
    p.close()


@pytest.fixture
def conns(pair):
    jc, pc = pair.clients()
    for c in (jc, pc):
        c.query("CREATE DATABASE test")
        c.use("test")
    yield jc, pc
    jc.close()
    pc.close()


PROTOCOL_TRAFFIC = [
    "SELECT 1",
    "SELECT 1 + 2, 'abc', NULL, 2.5 * 2",
    "CREATE TABLE t (a BIGINT PRIMARY KEY, b INT, c VARCHAR(10), "
    "d DECIMAL(10,2), e DATE, f DOUBLE)",
    "INSERT INTO t VALUES (1, 10, 'x', 1.25, '1995-03-15', 0.5), "
    "(2, 20, 'y', NULL, '1996-01-01', 2.25), (3, NULL, NULL, 3.5, NULL, "
    "NULL)",
    "SELECT * FROM t ORDER BY a",
    "SELECT a, b FROM t WHERE b > 10",
    "SELECT COUNT(*), SUM(b), SUM(d), AVG(f), MIN(e), MAX(c) FROM t",
    "SELECT e, COUNT(*) FROM t GROUP BY e ORDER BY e",
    "UPDATE t SET b = b + 1 WHERE a < 3",
    "DELETE FROM t WHERE a = 3",
    "INSERT IGNORE INTO t VALUES (1, 0, 'dup', 0, NULL, NULL)",
    "REPLACE INTO t VALUES (2, 5, 'r', 1.00, '2000-02-29', 1.0)",
    "SELECT * FROM t ORDER BY a",
    "DROP TABLE IF EXISTS nope",
    "SHOW WARNINGS",
    "SELECT @@autocommit, @@tidb_tpu_device_min_rows, DATABASE()",
    "SET @x = 5",
    "SELECT @x, @x + 1",
    "SELECT @y := 3, @y",
    "DO 1 + 1",
    "SHOW DATABASES",
    "SHOW TABLES",
    "SHOW COLUMNS FROM t",
    "SHOW CREATE TABLE t",
    "SHOW INDEX FROM t",
    "SHOW VARIABLES LIKE 'tidb_tpu_device_min%'",
    "SHOW GRANTS",
    "SHOW COLLATION",
    "SHOW CHARSET",
    "FLUSH PRIVILEGES",
    "BEGIN",
    "INSERT INTO t VALUES (7, 70, 'z', 7.00, '2001-01-01', 7.5)",
    "ROLLBACK",
    "SELECT COUNT(*) FROM t",
    "SELECT * FROM information_schema.tables WHERE table_schema = 'test'",
]

ERROR_TRAFFIC = [
    "SELEC 1",
    "SELECT * FROM nosuch",
    "SELECT nosuch FROM t",
    "USE nosuchdb",
    "CREATE TABLE t (a INT)",
    "CREATE DATABASE test",
    "INSERT INTO t VALUES (1, 1, 'a', 1, NULL, NULL)",
    "INSERT INTO t (a) VALUES (1, 2)",
    "SELECT @@nosuchvar",
    "KILL 987654",
    "EXECUTE nosuch",
    "CREATE VIEW v AS SELECT 1",
    "DROP VIEW v",
    "DROP USER 'nobody'@'%'",
    "GRANT SELECT ON test.* TO 'nobody'@'%'",
    "SELECT * FROM performance_schema.nosuch",
]


def test_protocol_traffic_equals_the_reference(conns):
    jc, pc = conns
    for sql in PROTOCOL_TRAFFIC:
        same(jc, pc, sql)


@pytest.mark.parametrize("sql", ERROR_TRAFFIC)
def test_error_code_and_sqlstate_equal_the_reference(conns, sql):
    jc, pc = conns
    same(jc, pc, "CREATE TABLE t (a BIGINT PRIMARY KEY, b INT, "
                 "c VARCHAR(10), d DECIMAL(10,2), e DATE, f DOUBLE)")
    same(jc, pc, "INSERT INTO t VALUES (1, 1, 'a', 1, NULL, NULL)")
    assert same(jc, pc, sql)[0] == "err"
    # the connection still answers after the error
    same(jc, pc, "SELECT COUNT(*) FROM t")


def test_column_definitions_equal_the_reference(conns):
    jc, pc = conns
    same(jc, pc, "CREATE TABLE w (a BIGINT PRIMARY KEY, b INT, "
                 "c VARCHAR(10), d DECIMAL(12,2), e DATE, f DOUBLE, "
                 "g DATETIME)")
    same(jc, pc, "INSERT INTO w VALUES (1, 2, 'x', 3.5, '1995-01-02', "
                 "0.25, '1995-01-02 03:04:05')")
    for sql in ("SELECT * FROM w",
                "SELECT SUM(d), COUNT(*), AVG(b), MAX(e) FROM w",
                "SELECT d * 2, e + INTERVAL 1 DAY FROM w"):
        assert pc.coldefs(sql) == jc.coldefs(sql), sql


def test_init_db_and_connect_with_db(pair):
    jc, pc = pair.clients()
    for c in (jc, pc):
        c.query("CREATE DATABASE app")
        c.use("app")
    same(jc, pc, "SELECT DATABASE()")
    jd, pd = pair.clients(db="app")
    same(jd, pd, "SELECT DATABASE()")
    for c in (jc, pc, jd, pd):
        c.close()


def test_two_connections_are_isolated(pair):
    j1, p1 = pair.clients()
    for c in (j1, p1):
        c.query("CREATE DATABASE test")
        c.use("test")
    same(j1, p1, "CREATE TABLE t (a BIGINT PRIMARY KEY, b INT)")
    same(j1, p1, "INSERT INTO t VALUES (1, 1)")
    j2, p2 = pair.clients(db="test")
    same(j1, p1, "BEGIN")
    same(j1, p1, "UPDATE t SET b = 99 WHERE a = 1")
    assert same(j2, p2, "SELECT b FROM t WHERE a = 1")[2] == [("1",)]
    same(j1, p1, "SET @v = 7")
    assert same(j2, p2, "SELECT @v")[2] == [(None,)]
    same(j1, p1, "COMMIT")
    assert same(j2, p2, "SELECT b FROM t WHERE a = 1")[2] == [("99",)]
    for c in (j1, p1, j2, p2):
        c.close()


def test_parallel_clients_equal_the_reference(pair):
    boot = pair.clients()
    for c in boot:
        c.query("CREATE DATABASE test")
        c.use("test")
        c.query("CREATE TABLE p (a BIGINT PRIMARY KEY, b INT)")
        c.close()
    errs = []

    def worker(port, i):
        try:
            c = WireClient("127.0.0.1", port, db="test")
            c.query(f"INSERT INTO p VALUES ({i}, {i * 10})")
            assert c.query(f"SELECT b FROM p WHERE a = {i}")[1] == \
                [(str(i * 10),)]
            c.close()
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(srv.port, i))
               for srv in (pair.jsrv, pair.psrv) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errs == []
    jc, pc = pair.clients(db="test")
    assert same(jc, pc, "SELECT COUNT(*), SUM(b) FROM p")[2] == \
        [("6", "150")]
    jc.close()
    pc.close()


def test_ping_and_unknown_command(pair):
    jc, pc = pair.clients()
    for c in (jc, pc):
        c.ping()
    got = []
    for c in (jc, pc):
        got.append(c._response(c._command(0x1F, b"")))
    assert got[0] == got[1] and got[1][0] == "err"
    jc.close()
    pc.close()


def test_server_connection_gauge_and_close(pair):
    from tidb_tpu_torch import metrics
    _jc, pc = pair.clients()
    pc.query("SELECT 1")
    assert metrics.snapshot().get(metrics.CONNECTIONS_CURRENT, 0) >= 1
    pc.close()
    _jc.close()


def _spawn(args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.Popen(
        [sys.executable, "-m", "tidb_tpu_torch", *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT, env=env)


def test_cli_serves_on_the_cpu_and_stops_on_sigterm():
    proc = _spawn(["--device", "cpu", "--port", "0", "--status-port", "0",
                   "--set", "tidb_tpu_device_min_rows=1"])
    port = status = mesh = None
    try:
        for _ in range(200):
            line = proc.stdout.readline()
            if not line:
                break
            if "device mesh:" in line:
                mesh = line.split("device mesh:", 1)[1].strip()
            if "MySQL protocol on" in line:
                port = int(line.rsplit(":", 1)[1])
            if "status API on" in line:
                status = int(line.rsplit(":", 1)[1])
                break
        assert port and status, "server did not report its ports"
        # without --mesh: one shard per device, so nothing is routed
        assert mesh == repr({"batch": 1})
        c = MiniClient("127.0.0.1", port)
        c.query("CREATE DATABASE d")
        c.query("CREATE TABLE d.t (id BIGINT PRIMARY KEY, g INT)")
        c.query("INSERT INTO d.t VALUES " +
                ",".join(f"({i}, {i % 3})" for i in range(64)))
        assert c.query("SELECT g, SUM(id), COUNT(*) FROM d.t GROUP BY g "
                       "ORDER BY g")[1] == \
            [("0", "693", "22"), ("1", "651", "21"), ("2", "672", "21")]
        c.close()
        import json
        import urllib.request
        with urllib.request.urlopen(
                f"http://127.0.0.1:{status}/status", timeout=10) as r:
            doc = json.loads(r.read())
        assert doc["connections"] == 0 and "admission" in doc["serving"]
    finally:
        proc.terminate()
        assert proc.wait(timeout=20) == 0


def test_cli_without_a_card_refuses_to_start():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    proc = _spawn(["--port", "0", "--no-status"])
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode != 0
    assert "CUDA" in out and "MySQL protocol on" not in out


def test_replay_points_modules_at_the_port_not_like_patterns():
    src = ("from tidb_tpu.store import remote\n"
           "log = logging.getLogger('tidb_tpu.server')\n"
           "s.query(\"SHOW VARIABLES LIKE 'tidb_tpu%'\")\n"
           "srv = StorageServer()\n"
           "st = connect(\"127.0.0.1\", srv.port, local_cache=True)\n")
    assert port_source(src) == (
        "from tidb_tpu_torch.store import remote\n"
        "log = logging.getLogger('tidb_tpu_torch.server')\n"
        "s.query(\"SHOW VARIABLES LIKE 'tidb_tpu%'\")\n"
        "srv = StorageServer(device=\"cpu\")\n"
        "st = connect(\"127.0.0.1\", srv.port, local_cache=True, "
        "device=\"cpu\")\n")


def test_show_variables_lists_the_reference_names(conns):
    jc, pc = conns
    sql = "SHOW VARIABLES LIKE 'tidb_tpu%'"
    want, got = jc.run(sql), pc.run(sql)
    assert want[0] == got[0] == "rs"
    assert [r[0] for r in got[2]] == [r[0] for r in want[2]]


replay("test_server.py", globals())
