"""Every cell, configuration, traffic mix, statement, reference and
metric is found by name from its files."""

import json

import pytest

from benchmark import catalog

BENCH = catalog.spec()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = catalog.Cell(name)
    assert cell.config["name"] == cell.config_name
    assert cell.traffic["analytic"]["statements"]
    for st in cell.traffic["analytic"]["statements"]:
        assert cell.statement(st).upper().startswith("SELECT")
        ref = cell.reference(st)
        assert callable(ref.answer)
        assert ref.BASE_TABLE in cell.traffic["tables"]
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer


@pytest.mark.parametrize("entry", METRICS, ids=lambda m: m["name"])
def test_metric_reader_found_by_name(entry):
    read = catalog.metric_reader(entry["name"])
    assert callable(read)
    if "moves" in entry:
        assert entry["moves"] in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_names_its_cuts(entry):
    with open(catalog.ROOT / entry["file"], encoding="utf-8") as f:
        cfg = json.load(f)
    assert cfg["name"] == entry["name"]
    assert set(entry["reduced"]) == set(cfg["reduced"])
    for key in entry["reduced"]:
        assert key in cfg, key
    assert {"guarantees", "layout", "assumed", "source",
            "control_precision"} <= set(cfg)


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        catalog.Cell("no-such-cell")


def test_cell_file_must_agree_with_the_spec():
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"][0]["traffic"] = "other"
    with pytest.raises(ValueError):
        catalog.Cell(bench["workloads"][0]["name"], bench)
