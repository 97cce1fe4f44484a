"""Finds every part of the benchmark by name, from its files.

A cell is workloads/<cell>.json (its configuration, its traffic mix and
why it exists), checked against its entry in BENCHMARK.json. A
configuration is the file BENCHMARK.json names for it; its "dataset"
names the generator (datasets/<dataset>.py) and the folders of the
statements: queries/<dataset>/<statement>.sql, the text the clients
send, and reference/<dataset>/<statement>.py, its plain reference
(`answer(tables, precision)` and `BASE_TABLE`). A traffic mix is
traffic/<mix>.json. Every metric, end to end or per layer, is
metrics/<metric>.py, whose `read(readings)` returns the metric's value
or None. A later cell, statement, mix or metric adds files and entries;
no file here needs an edit.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC = ROOT / "BENCHMARK.json"


def _json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def spec() -> dict:
    return _json(SPEC)


def _module(path: Path, name: str):
    """The module at `path` (a statement's or a metric's name may hold a
    dot, so it is loaded from its file)."""
    mod_name = name.replace(".", "_").replace("-", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec_ = importlib.util.spec_from_file_location(mod_name, path)
    if spec_ is None:
        raise KeyError(f"no file {path}")
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    sys.modules[mod_name] = mod
    return mod


class Cell:
    """One cell with everything it names, loaded from the files."""

    def __init__(self, name: str, bench: dict | None = None):
        bench = bench or spec()
        entry = next((w for w in bench["workloads"] if w["name"] == name),
                     None)
        if entry is None:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json")
        own = _json(HERE / "workloads" / f"{name}.json")
        for key in ("config", "traffic", "chips"):
            if own.get(key) != entry[key]:
                raise ValueError(f"cell {name}: workloads/{name}.json says "
                                 f"{key}={own.get(key)!r}, BENCHMARK.json "
                                 f"says {entry[key]!r}")
        self.name = name
        self.chips = int(entry["chips"])
        cfg_entry = next(c for c in bench["configs"]
                         if c["name"] == entry["config"])
        self.config = _json(ROOT / cfg_entry["file"])
        self.config_name = entry["config"]
        self.traffic = _json(HERE / "traffic" / f"{entry['traffic']}.json")
        ds = self.config["dataset"]
        self.dataset = importlib.import_module(f"benchmark.datasets.{ds}")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]

    def statement(self, name: str) -> str:
        path = HERE / "queries" / self.config["dataset"] / f"{name}.sql"
        return path.read_text(encoding="utf-8").strip()

    def reference(self, name: str):
        """reference/<dataset>/<statement>.py."""
        ds = self.config["dataset"]
        return _module(HERE / "reference" / ds / f"{name}.py",
                       f"benchmark.reference.{ds}.{name}")


def metric_reader(name: str):
    """metrics/<name>.py's `read` function."""
    return _module(HERE / "metrics" / f"{name}.py",
                   f"benchmark.metrics.{name}").read
