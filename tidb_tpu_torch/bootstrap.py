"""First-run bootstrap + versioned upgrades of the `mysql` catalog.

Reference: TiDB's bootstrap.go:40-180 — DDL+DML creating
mysql.user / db / tables_priv / GLOBAL_VARIABLES / tidb / help_topic,
with a persisted bootstrap version and an `upgradeToVerN` chain so a
store written by version N opens under version N+1 code (bootstrap.go
upgrade() dispatching upgradeToVer2...). Grant rows here use a BIGINT
privilege bitmask (see privilege.py) instead of per-priv enum
columns.

Adding a migration: bump BOOTSTRAP_VERSION, append `_upgrade_to_verN`
to _UPGRADES. Each step must be idempotent — a crash between a step and
the version-row update replays the step on next open.
"""

from __future__ import annotations

import threading

from tidb_tpu_torch.privilege import ALL_PRIVS

__all__ = ["bootstrap", "load_global_variables", "BOOTSTRAP_VERSION"]

BOOTSTRAP_VERSION = 3

_DDL = [
    "CREATE DATABASE IF NOT EXISTS mysql",
    # id handles are implicit (no int pk): account rows are small
    """CREATE TABLE IF NOT EXISTS mysql.user (
        host VARCHAR(255), user VARCHAR(32),
        authentication_string VARCHAR(64), privs BIGINT)""",
    """CREATE TABLE IF NOT EXISTS mysql.db (
        host VARCHAR(255), user VARCHAR(32), db VARCHAR(64),
        privs BIGINT)""",
    """CREATE TABLE IF NOT EXISTS mysql.tables_priv (
        host VARCHAR(255), user VARCHAR(32), db VARCHAR(64),
        table_name VARCHAR(64), privs BIGINT)""",
    """CREATE TABLE IF NOT EXISTS mysql.global_variables (
        variable_name VARCHAR(64), variable_value VARCHAR(1024))""",
    """CREATE TABLE IF NOT EXISTS mysql.tidb (
        variable_name VARCHAR(64), variable_value VARCHAR(1024),
        comment VARCHAR(1024))""",
]

_lock = threading.Lock()


def _bootstrapped_version(session) -> int:
    if not session.domain.info_schema().has_db("mysql"):
        return 0
    try:
        rows = session.query(
            "SELECT variable_value FROM mysql.tidb "
            "WHERE variable_name = 'bootstrapped'").rows
    except Exception:  # noqa: BLE001 - partial earlier bootstrap
        return 0
    return int(rows[0][0]) if rows else 0


def load_global_variables(storage) -> None:
    """Apply persisted SET GLOBAL values to the process config registry
    (ref: session.go:1166 loading GLOBAL_VARIABLES at session start)."""
    from tidb_tpu_torch import config
    from tidb_tpu_torch.session import Session

    s = Session(storage, internal=True)
    try:
        if not s.domain.info_schema().has_db("mysql"):
            return
        for name, value in s.query(
                "SELECT variable_name, variable_value "
                "FROM mysql.global_variables").rows:
            if config.is_known(name):
                try:
                    config.set_var(name, value)
                except (TypeError, ValueError):
                    pass   # stale row with an invalid value: ignore
    finally:
        s.close()


_HELP_TOPIC_DDL = """CREATE TABLE IF NOT EXISTS mysql.help_topic (
    help_topic_id BIGINT PRIMARY KEY, name VARCHAR(64),
    help_category_id BIGINT, description VARCHAR(1024),
    example VARCHAR(1024), url VARCHAR(128))"""


def _upgrade_to_ver2(session) -> None:
    """SUPER joined ALL_PRIVS — re-grant root (ref: bootstrap.go's
    upgradeToVer2 re-granting new privileges)."""
    session.execute(
        f"UPDATE mysql.user SET privs = {ALL_PRIVS} "
        "WHERE user = 'root' AND host = '%'")


def _upgrade_to_ver3(session) -> None:
    """mysql.help_topic, bootstrapped by the reference since its first
    version (ref: bootstrap.go:100 tableHelpTopic) — created on upgrade
    for stores bootstrapped before round 5."""
    session.execute(_HELP_TOPIC_DDL)


_UPGRADES = {2: _upgrade_to_ver2, 3: _upgrade_to_ver3}
assert set(_UPGRADES) == set(range(2, BOOTSTRAP_VERSION + 1))


def _write_version(session, ver: int, fresh: bool) -> None:
    if fresh:
        session.execute(
            f"INSERT INTO mysql.tidb VALUES ('bootstrapped', '{ver}', "
            "'Bootstrap version. Do not delete.')")
    else:
        session.execute(
            f"UPDATE mysql.tidb SET variable_value = '{ver}' "
            "WHERE variable_name = 'bootstrapped'")


def bootstrap(storage) -> None:
    """Idempotent: fresh stores get the full current catalog; stores
    bootstrapped by older code run the upgrade chain one version at a
    time, persisting the version after each step (ref: bootstrap.go
    runInBootstrapSession / doDDLWorks / doDMLWorks / upgrade)."""
    from tidb_tpu_torch.session import Session

    with _lock:
        session = Session(storage, internal=True)
        try:
            ver = _bootstrapped_version(session)
            if ver >= BOOTSTRAP_VERSION:
                return
            if ver == 0:
                for ddl in _DDL + [_HELP_TOPIC_DDL]:
                    session.execute(ddl)
                if not session.query("SELECT user FROM mysql.user "
                                     "WHERE user = 'root'").rows:
                    session.execute(
                        "INSERT INTO mysql.user VALUES "
                        f"('%', 'root', '', {ALL_PRIVS})")
                _write_version(session, BOOTSTRAP_VERSION, fresh=True)
                return
            for v in range(ver + 1, BOOTSTRAP_VERSION + 1):
                _UPGRADES[v](session)
                _write_version(session, v, fresh=False)
        finally:
            session.close()
