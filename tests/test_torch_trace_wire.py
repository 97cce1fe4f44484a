"""The wire server's own span and the span records' clock, over the
port's `Server` and its `util/mysqlclient.MiniClient`, every statement
retained (`tidb_tpu_trace_sample = 1`).

A command that returns a result set (COM_QUERY, COM_STMT_EXECUTE) runs
in a trace command scope: its first statement root starts when the
server read its payload, and its response hangs as one `wire.write`
span (tags `packets`, `bytes`, `cpu_us`) under its last root, whose end
and ring record follow it. Each retained record carries
`wall_offset_ns`, which puts its spans on the Unix clock. A statement
run through a `Session` without the server has no `wire.write`, and its
tree has the reference's span names.
"""

import time

import pytest

from tidb_tpu import config as jconfig
from tidb_tpu import trace as jtrace
from tidb_tpu.session import Session as JSession
from tidb_tpu.store.storage import new_mock_storage as jnew_storage
from tidb_tpu_torch import config as pconfig
from tidb_tpu_torch import trace
from tidb_tpu_torch.server import Server
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.store.storage import new_mock_storage
from tidb_tpu_torch.util.mysqlclient import MiniClient, MySQLError

_SAMPLE_ALL = {"tidb_tpu_trace_sample": 1, "tidb_tpu_slow_trace_ms": 0}
SQL = "SELECT v, COUNT(*), SUM(id) FROM t GROUP BY v"


def _load(s):
    s.execute("CREATE DATABASE td")
    s.execute("USE td")
    s.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT)")
    s.execute("INSERT INTO t VALUES " +
              ",".join(f"({i},{i % 7})" for i in range(4000)))
    s.execute("SPLIT TABLE t REGIONS 4")


@pytest.fixture
def sample_all():
    old = {k: (jconfig.get_var(k), pconfig.get_var(k)) for k in _SAMPLE_ALL}
    trace.reset_for_tests()
    jtrace.reset_for_tests()
    yield
    for k, (jv, pv) in old.items():
        jconfig.set_var(k, jv)
        pconfig.set_var(k, pv)
    trace.reset_for_tests()
    jtrace.reset_for_tests()


class _Counting:
    """The client's socket, counting the bytes it receives."""

    def __init__(self, sock):
        self.sock = sock
        self.received = 0

    def recv(self, n):
        b = self.sock.recv(n)
        self.received += len(b)
        return b

    def sendall(self, b):
        self.sock.sendall(b)


@pytest.fixture
def wire(sample_all):
    storage = new_mock_storage(device="cpu")
    s = Session(storage)
    _load(s)
    server = Server(storage, port=0)
    server.start()
    for k, v in _SAMPLE_ALL.items():
        pconfig.set_var(k, v)
    c = MiniClient("127.0.0.1", server.port, db="td")
    c.ping()    # runs the handshake's USE, a command's first root
    c.pkt.sock = _Counting(c.sock)
    yield c
    c.close()
    server.close()
    s.close()
    storage.close()


def _records(sql):
    return [r for r in trace.ring_records() if r["sql"] == sql]


def _run(c, sql):
    """One command: -> (its result, client perf ns and Unix ns before
    the send and after the receipt, bytes received). A ping follows: the
    server ends a command's scope before it reads the next command."""
    c.pkt.sock.received = 0
    t0, w0 = time.perf_counter_ns(), time.time_ns()
    out = c.query(sql)
    t1, w1 = time.perf_counter_ns(), time.time_ns()
    got = c.pkt.sock.received
    c.ping()
    return out, (t0, w0, t1, w1), got


def _walk(s):
    yield s
    for c in s.children:
        yield from _walk(c)


def _writes(root):
    return [ch for ch in root.children if ch.name == "wire.write"]


def test_a_querys_root_has_one_wire_write(wire):
    (cols, rows), _t, received = _run(wire, SQL)
    [rec] = _records(SQL)
    [w] = _writes(rec["root"])
    assert w.tags["packets"] == 3 + len(cols) + len(rows)
    assert w.tags["bytes"] == received
    assert isinstance(w.tags["cpu_us"], int) and w.tags["cpu_us"] >= 0
    assert trace.validate(rec["root"]) == []


def test_the_root_covers_the_read_and_the_write(wire):
    _out, (t0, _w0, _t1, _w1), _n = _run(wire, SQL)
    [rec] = _records(SQL)
    root = rec["root"]
    parse = next(ch for ch in root.children if ch.name == "parse")
    [w] = _writes(root)
    # back-dated to the read of the payload, which the session's parse
    # share follows and the client's send precedes
    assert t0 <= root.start_ns < parse.start_ns
    assert root.end_ns >= w.end_ns >= w.start_ns >= parse.end_ns
    assert rec["duration_ns"] == root.end_ns - root.start_ns
    assert rec["start_unix"] == (root.start_ns + rec["wall_offset_ns"]) / 1e9
    assert rec["span_count"] == sum(1 for _ in _walk(root))


def test_a_multi_statement_command_hangs_the_write_under_its_last_root(wire):
    sql = "SELECT COUNT(*) FROM t; " + SQL
    _run(wire, sql)
    first, last = _records(sql)
    assert _writes(first["root"]) == []
    assert len(_writes(last["root"])) == 1
    # only the command's first root starts at the read
    parse = [next(ch for ch in r["root"].children if ch.name == "parse")
             for r in (first, last)]
    assert first["root"].start_ns < parse[0].start_ns
    assert last["root"].start_ns == parse[1].start_ns
    for r in (first, last):
        assert trace.validate(r["root"]) == []


def test_the_offset_puts_the_root_on_the_clients_unix_clock(wire):
    _out, (_t0, w0, _t1, w1), _n = _run(wire, SQL)
    [rec] = _records(SQL)
    assert w0 <= rec["root"].start_ns + rec["wall_offset_ns"] <= w1


def test_a_prepared_execute_and_an_error_are_timed(wire):
    sql = "SELECT v, COUNT(*) FROM t WHERE v < ? GROUP BY v"
    sid, _n = wire.stmt_prepare(sql)
    cols, rows = wire.stmt_execute(sid, [3])
    wire.ping()
    [rec] = _records(sql)
    [w] = _writes(rec["root"])
    assert w.tags["packets"] == 3 + len(cols) + len(rows) == 3 + 2 + 3
    bad = "SELECT nope FROM t"
    with pytest.raises(MySQLError):
        wire.query(bad)
    wire.ping()
    [rec] = _records(bad)
    assert rec["error"]
    [w] = _writes(rec["root"])
    assert w.tags["packets"] == 1


def test_more_than_256_statements_are_retained_in_the_byte_budget(wire):
    sqls = [f"SELECT v FROM t WHERE id = {i}" for i in range(300)]
    for sql in sqls:
        wire.query(sql)
    wire.ping()
    kept = {r["sql"] for r in trace.ring_records()}
    assert set(sqls) <= kept
    stats = trace.ring_stats()
    assert stats["records"] > 256
    assert stats["bytes"] <= trace._RING_BYTES_CAP


def test_the_chrome_export_carries_the_offset(wire):
    _run(wire, SQL)
    [rec] = _records(SQL)
    doc = trace.to_chrome(rec)
    other = doc["otherData"]
    assert other["wall_offset_ns"] == rec["wall_offset_ns"]
    assert other["start_unix_ns"] == \
        rec["root"].start_ns + rec["wall_offset_ns"]
    assert "wire.write" in {e["name"] for e in doc["traceEvents"]
                            if e["ph"] == "X"}


def _names(s, acc):
    acc.add(s.name)
    for c in s.children:
        _names(c, acc)
    return acc


def test_a_session_without_the_server_keeps_the_references_names(
        sample_all):
    stores = (jnew_storage(), new_mock_storage(device="cpu"))
    sessions = (JSession(stores[0]), Session(stores[1]))
    try:
        for s in sessions:
            _load(s)
        for k, v in _SAMPLE_ALL.items():
            jconfig.set_var(k, v)
            pconfig.set_var(k, v)
        for s in sessions:
            s.query(SQL)
        [jrec] = [r for r in jtrace.ring_records() if r["sql"] == SQL]
        [prec] = _records(SQL)
        pnames = _names(prec["root"], set())
        assert pnames == _names(jrec["root"], set())
        assert "wire.write" not in pnames
        assert trace.validate(prec["root"]) == []
    finally:
        for s, st in zip(sessions, stores):
            s.close()
            st.close()
