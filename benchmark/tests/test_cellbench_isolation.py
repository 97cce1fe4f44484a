"""Nothing the harness, the reference or the control loads has the
top-level name jax, jaxlib, flax or tidb_tpu (compared whole, so
tidb_tpu_torch passes), and no file under benchmark/ imports one."""

import ast
import json
import subprocess
import sys

from benchmark import catalog, harness

FORBIDDEN = set(harness.FORBIDDEN)


def test_no_source_imports_a_forbidden_module():
    for path in catalog.HERE.rglob("*.py"):
        tree = ast.parse(path.read_text(encoding="utf-8"))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path, n)


def test_loaded_modules_have_no_forbidden_top_level_name():
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(catalog.ROOT)!r})\n"
        "from benchmark import harness, control, cli, loadgen, devtrace\n"
        "from benchmark.datasets import tpch\n"
        "import tidb_tpu_torch.server, tidb_tpu_torch.session\n"
        "import tidb_tpu_torch.util.mysqlclient\n"
        f"bench = json.load(open({str(catalog.SPEC)!r}))\n"
        "for m in bench['end_to_end'] + bench['per_layer']:\n"
        "    harness.catalog.metric_reader(m['name'])\n"
        "for w in bench['workloads']:\n"
        "    cell = harness.catalog.Cell(w['name'])\n"
        "    for st in cell.traffic['analytic']['statements']:\n"
        "        cell.reference(st)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True,
                         env={"PATH": "/usr/bin:/bin", "HOME": "/tmp"})
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "tidb_tpu_torch" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_forbidden_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tidb_tpu_torch_x", sys)
    assert "tidb_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tidb_tpu.sub", sys)
    assert "tidb_tpu" in harness.forbidden_modules()
