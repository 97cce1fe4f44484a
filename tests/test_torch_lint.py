"""The port's lint suite (`python -m tidb_tpu_torch.lint`) over the port's
tree.

The reference's `tests/test_lint.py` is replayed against the port
(`replay`: its source with the package pointed at `tidb_tpu_torch`): one
engine run — one parse of `tidb_tpu_torch/` — shared by every per-rule
assertion, the single-parse instrumentation, and the CLI's exit codes
and `--json` schema. The one case not replayed names the JAX package's
`donation-safety` rule, which the port replaces with `inplace-safety`;
`test_catalog_is_complete_for_the_port` stands in its place. The CLI run
on the tree must be clean with 22 rules.
"""

import json
import os
import subprocess
import sys

from tests.test_torch_server import replay
from tidb_tpu_torch.lint import REGISTRY
from tidb_tpu_torch.lint.engine import PKG_REL, REPO

replay("test_lint.py", globals(), drop={
    "test_catalog_is_complete":
        "names donation-safety: torch has no buffer donation, and the "
        "port's catalog holds its counterpart inplace-safety instead "
        "(test_catalog_is_complete_for_the_port)",
})


def test_catalog_is_complete_for_the_port():
    """The reference's 22 rules, with donation-safety's place taken by
    inplace-safety, in the reference's order."""
    names = list(REGISTRY)
    assert len(names) == 22, names
    assert "donation-safety" not in names
    assert names.index("inplace-safety") == 19
    for kept in ("wire-discipline", "hot-path-sync", "metric-names",
                 "memtrack-alloc", "lock-discipline", "sysvar-registry",
                 "errcode-discipline", "device-sync", "dtype-discipline",
                 "bare-except", "device-cache", "decode-discipline",
                 "failpoint-discipline", "trace-names",
                 "no-parallel-import", "metric-cardinality", "lock-order",
                 "guarded-by", "paired-resource", "cache-key",
                 "retrace-hazard"):
        assert kept in names


def test_engine_walks_the_port_and_not_the_reference():
    assert PKG_REL == "tidb_tpu_torch"
    assert REPO == os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))


def test_cli_json_on_the_tree_is_clean_with_22_rules():
    proc = subprocess.run(
        [sys.executable, "-m", "tidb_tpu_torch.lint", "--json"],
        capture_output=True, text=True, timeout=240, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["clean"] is True and doc["findings"] == []
    assert len(doc["rules"]) == 22
    assert set(doc["timing"]["rule_ms"]) == set(doc["rules"])
