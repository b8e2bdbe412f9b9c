"""Every cell, configuration, traffic mix, driver and per-layer metric of
``BENCHMARK.json`` is a file of its own under ``portbench/``, found by name."""

import json
import os

import pytest
from conftest import ROOT

from portbench import harness

MANIFEST = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in MANIFEST["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_are_found_by_name(name):
    cell = harness.cell(name)
    entry = next(w for w in MANIFEST["workloads"] if w["name"] == name)
    assert cell["config"] == entry["config"] and cell["traffic"] == entry["traffic"]
    assert cell["chips"] == entry["chips"]
    assert callable(harness.driver(cell["mix"]["driver"]).run)
    config = next(c for c in MANIFEST["configs"] if c["name"] == entry["config"])
    assert os.path.samefile(os.path.join(ROOT, config["file"]),
                            os.path.join(harness.HERE, "configs", entry["config"] + ".json"))
    assert cell["limits"], "a cell names the numbers that decide correct"


@pytest.mark.parametrize("name", [m["name"] for m in MANIFEST["per_layer"]])
def test_metric_readers_are_found_by_name(name):
    reader = harness.metric_reader(name)
    view = {"unit": "other", "units": 0, "trace": None}
    assert reader.read(view) is None  # nothing to read: the metric stays out of the line


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(name):
    e2e, per_layer = harness.cell_metrics(name, MANIFEST)
    names = [m["name"] for m in e2e]
    assert "setup_s" in names and len(names) >= 2 and per_layer
    for m in per_layer:
        assert m["moves"] in names


def test_a_cell_added_as_files_needs_no_edit(tmp_path, monkeypatch):
    """A new cell is a workload file naming existing (or new) files."""
    for sub in ("workloads", "configs", "traffic"):
        (tmp_path / sub).mkdir()
    cell = json.load(open(os.path.join(harness.HERE, "workloads", CELLS[0] + ".json")))
    (tmp_path / "workloads" / "new.cell.json").write_text(json.dumps(cell))
    for sub, name in (("configs", cell["config"]), ("traffic", cell["traffic"])):
        with open(os.path.join(harness.HERE, sub, name + ".json")) as f:
            (tmp_path / sub / (name + ".json")).write_text(f.read())
    monkeypatch.setattr(harness, "HERE", str(tmp_path))
    assert harness.cell("new.cell")["name"] == "new.cell"
    manifest = dict(MANIFEST, end_to_end=[{"name": "setup_s", "unit": "s"}], per_layer=[])
    assert harness.cell_metrics("new.cell", manifest) == ([{"name": "setup_s", "unit": "s"}], [])
