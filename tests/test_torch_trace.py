"""Statement tracing (the trace ring, TRACE, the /trace routes) of the
port against the JAX package's.

The same statements go through both packages' Sessions (the port's
storage on the CPU): `TRACE FORMAT='json'` of an aggregate over a table
split into 4 regions gives trees with the same span names in both
packages (statement, parse, admission, plan, execute, the scheduler
slot, dispatch and finalize, the cop tasks or streams on pool threads),
balanced (`trace.validate` finds no open span) and retained in the ring
under the returned id; the row form lists the same operations. The
ring is billed to the `trace-ring` memtrack node, and
`sched.shed_server(0)` returns its bytes to 0.

The reference's own `tests/test_trace.py` is replayed against the port
(`replay`), with its status client (util/statusclient.py, a fleet module
the port has not ported) replaced by a plain HTTP GET. Its TestOverhead
class is not replayed: it holds wall-clock ratios, which a loaded shared
CPU breaks (the JAX package's own copy of it has failed under load), and
the smoke measures the tracing and runtime-stats overhead on the card
instead.
"""

import json
import urllib.request

import pytest

from tests.test_torch_server import replay
from tidb_tpu import config as jconfig
from tidb_tpu import trace as jtrace
from tidb_tpu.session import Session as JSession
from tidb_tpu.store.storage import new_mock_storage as jnew_storage
from tidb_tpu_torch import config as pconfig
from tidb_tpu_torch import memtrack as pmemtrack
from tidb_tpu_torch import perfschema as pperf
from tidb_tpu_torch import sched as psched
from tidb_tpu_torch import trace as ptrace
from tidb_tpu_torch.session import Session as PSession
from tidb_tpu_torch.store.storage import new_mock_storage as pnew_storage

_NO_SAMPLING = {"tidb_tpu_trace_sample": 0, "tidb_tpu_slow_trace_ms": 0}


@pytest.fixture
def pair():
    old = {k: (jconfig.get_var(k), pconfig.get_var(k))
           for k in _NO_SAMPLING}
    for k, v in _NO_SAMPLING.items():
        jconfig.set_var(k, v)
        pconfig.set_var(k, v)
    jtrace.reset_for_tests()
    ptrace.reset_for_tests()
    stores = (jnew_storage(), pnew_storage(device="cpu"))
    sessions = (JSession(stores[0]), PSession(stores[1]))
    for s in sessions:
        s.execute("CREATE DATABASE td")
        s.execute("USE td")
        s.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT)")
        s.execute("INSERT INTO t VALUES " +
                  ",".join(f"({i},{i % 7})" for i in range(4000)))
        s.execute("SPLIT TABLE t REGIONS 4")
    yield sessions
    for s, st in zip(sessions, stores):
        s.close()
        st.close()
    for k, (jv, pv) in old.items():
        jconfig.set_var(k, jv)
        pconfig.set_var(k, pv)
    jtrace.reset_for_tests()
    ptrace.reset_for_tests()


def _names(d: dict, acc: set) -> set:
    acc.add(d["name"])
    for c in d.get("children", ()):
        _names(c, acc)
    return acc


SQL = "SELECT v, COUNT(*), SUM(id) FROM t GROUP BY v"


def test_trace_tree_names_equal_the_reference(pair):
    js, ps = pair
    jdoc = json.loads(js.query("TRACE FORMAT='json' " + SQL).rows[0][0])
    pdoc = json.loads(ps.query("TRACE FORMAT='json' " + SQL).rows[0][0])
    pnames = _names(pdoc["spans"], set())
    assert pnames == _names(jdoc["spans"], set())
    assert {"statement", "parse", "admission", "plan", "execute",
            "sched.slot", "dispatch", "finalize"} <= pnames
    assert pnames & {"copr.task", "copr.stream"}
    rec = ptrace.ring_get(pdoc["trace_id"])
    assert rec is not None and rec["reason"] == "forced"
    assert ptrace.validate(rec["root"]) == []
    tids = set()

    def walk(s):
        tids.add(s.tid)
        for c in s.children:
            walk(c)
    walk(rec["root"])
    assert len(tids) > 1      # the cop workers' spans ride other threads


def test_trace_row_form_lists_the_references_operations(pair):
    js, ps = pair
    jrows = js.query("TRACE " + SQL).rows
    prows = ps.query("TRACE " + SQL).rows

    def ops(rows):
        return sorted({r[0].split()[0] for r in rows})
    assert ops(prows) == ops(jrows)
    assert [len(r) for r in prows] == [3] * len(prows)


def test_ring_is_billed_and_shed(pair):
    _js, ps = pair
    ps.query("TRACE " + SQL)
    stats = ptrace.ring_stats()
    assert stats["records"] >= 1 and stats["bytes"] > 0
    node = [c for c in pmemtrack.SERVER.children.values()
            if c.label == "trace-ring"]
    assert node and node[0].host >= stats["bytes"]
    psched.shed_server(0)
    assert ptrace.ring_stats()["bytes"] == 0


def test_digest_links_the_retained_trace(pair):
    _js, ps = pair
    ps.execute("SET @@tidb_tpu_slow_trace_ms = 0")
    ps.execute("SET @@tidb_tpu_trace_sample = 1")
    sql = "SELECT COUNT(*) FROM t WHERE v = 3"
    ps.query(sql)
    ids = [r["trace_id"] for r in ptrace.ring_snapshot()]
    digest = pperf.sql_digest(sql)[0]
    rows = ps.query(
        "SELECT last_trace_id FROM performance_schema."
        f"events_statements_summary_by_digest WHERE digest = '{digest}'"
    ).rows
    assert rows and rows[0][0] in ids


class _StatusClient:
    """The one call of util/statusclient.py the replayed tests make."""

    @staticmethod
    def get_json(host: str, port: int, path: str, timeout: float = 10):
        with urllib.request.urlopen(f"http://{host}:{port}{path}",
                                    timeout=timeout) as r:
            return json.loads(r.read().decode())


replay("test_trace.py", globals(), drop={
    "TestOverhead": "wall-clock overhead ratios, which a loaded shared "
                    "CPU breaks (the JAX package's own copy has failed "
                    "under load); the smoke measures the overhead on the "
                    "card"},
    subs={"from tidb_tpu.util import statusclient\n":
          "statusclient = _StatusClient\n"})
