"""Bootstrap of the `mysql` catalog and its upgrades: the port against
the reference.

`bootstrap` through both packages writes the same catalog (the same
tables, the same root row, the same version row) and is idempotent: a
second and third run change no key. A store rewound to version 1 runs
the upgrade chain to the current version in both. SET GLOBAL persists
into mysql.global_variables and `load_global_variables` applies it to a
fresh process registry. The reference's own
`tests/test_bootstrap_upgrade.py` is replayed against the port.
"""

from tests.test_torch_server import replay
from tidb_tpu import bootstrap as jbs
from tidb_tpu import config as jconfig
from tidb_tpu.session import Session as JSession
from tidb_tpu.store import new_mock_storage as j_storage
from tidb_tpu_torch import bootstrap as pbs
from tidb_tpu_torch import config as pconfig
from tidb_tpu_torch.session import Session as PSession
from tidb_tpu_torch.store.storage import new_mock_storage as p_storage

CATALOG = ["SELECT host, user, authentication_string, privs FROM mysql.user",
           "SELECT variable_name, variable_value FROM mysql.tidb",
           "SELECT COUNT(*) FROM mysql.db",
           "SELECT COUNT(*) FROM mysql.tables_priv",
           "SELECT COUNT(*) FROM mysql.global_variables",
           "SELECT COUNT(*) FROM mysql.help_topic",
           "SHOW TABLES FROM mysql"]


def _kv(storage):
    snap = storage.snapshot(storage.current_ts())
    return list(snap.iter_range(b"", b""))


def test_catalog_equals_the_reference_and_is_idempotent():
    jst, pst = j_storage(), p_storage(device="cpu")
    jbs.bootstrap(jst)
    pbs.bootstrap(pst)
    assert pbs.BOOTSTRAP_VERSION == jbs.BOOTSTRAP_VERSION
    js, ps = JSession(jst), PSession(pst)
    for sql in CATALOG:
        assert ps.query(sql).rows == js.query(sql).rows, sql
    before = _kv(pst)
    pbs.bootstrap(pst)
    pbs.bootstrap(pst)
    assert _kv(pst) == before
    assert [k for k, _v in before] == [k for k, _v in _kv(jst)]
    for s, st in ((js, jst), (ps, pst)):
        s.close()
        st.close()


def test_upgrade_chain_equals_the_reference():
    out = []
    for bs, st, Sess in ((jbs, j_storage(), JSession),
                         (pbs, p_storage(device="cpu"), PSession)):
        bs.bootstrap(st)
        s = Sess(st, internal=True)
        s.execute("UPDATE mysql.tidb SET variable_value = '1' "
                  "WHERE variable_name = 'bootstrapped'")
        s.execute("UPDATE mysql.user SET privs = 1 WHERE user = 'root'")
        s.execute("DROP TABLE mysql.help_topic")
        bs.bootstrap(st)
        out.append([s.query(sql).rows for sql in CATALOG])
        s.close()
        st.close()
    assert out[1] == out[0]


def test_set_global_persists_and_reloads():
    got = []
    for bs, cfg, st, Sess in ((jbs, jconfig, j_storage(), JSession),
                              (pbs, pconfig, p_storage(device="cpu"),
                               PSession)):
        old = cfg.get_var("tidb_tpu_admission_timeout_ms")
        bs.bootstrap(st)
        s = Sess(st)
        s.execute("SET GLOBAL tidb_tpu_admission_timeout_ms = 777")
        s.execute("SET GLOBAL tidb_tpu_admission_timeout_ms = 778")
        rows = s.query("SELECT variable_name, variable_value FROM "
                       "mysql.global_variables").rows
        cfg.set_var("tidb_tpu_admission_timeout_ms", old)
        bs.load_global_variables(st)
        got.append((rows, cfg.get_var("tidb_tpu_admission_timeout_ms")))
        cfg.set_var("tidb_tpu_admission_timeout_ms", old)
        s.close()
        st.close()
    assert got[1] == got[0] == (
        [("tidb_tpu_admission_timeout_ms", "778")], 778)


replay("test_bootstrap_upgrade.py", globals())
