"""``BENCHMARK.json`` against the benchmark's contract: its keys, names,
units, limits and the budget of a full check."""

import json
import os
import re

import pytest
from conftest import ROOT

MANIFEST = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source", "workloads"}


def one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(MANIFEST["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in MANIFEST["paths"])
    assert len(MANIFEST["command"]) <= 32 and all(one_line(w) for w in MANIFEST["command"])
    for word in MANIFEST["command"][1:]:
        assert not word.startswith("/") and any(word.startswith(p + "/") for p in MANIFEST["paths"])
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


def test_run_seconds_fit_a_full_check_of_24_cells():
    s = MANIFEST["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    names = [c["name"] for c in MANIFEST["configs"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    used = {w["config"] for w in MANIFEST["workloads"]}
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["why"]) and one_line(c["source"]) and c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in MANIFEST["paths"])
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    assert len({c["file"] for c in MANIFEST["configs"]}) == len(names)


def test_workloads():
    cells = MANIFEST["workloads"]
    assert 1 <= len(cells) <= 24 and len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and one_line(w["why"])
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metric_names_units_and_sources(kind):
    metrics = MANIFEST[kind]
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        if kind == "end_to_end":
            assert set(m) <= METRIC_KEYS | {"bound"} and m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert set(m) <= METRIC_KEYS | {"layer", "moves"} and one_line(m["layer"])
            assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
            assert m["moves"] in {e["name"] for e in MANIFEST["end_to_end"]}
            if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
                assert m["unit"] == "%"
    assert len({m["name"] for m in metrics}) == len(metrics)


def test_setup_time_is_an_end_to_end_metric_of_every_cell():
    setup = next(m for m in MANIFEST["end_to_end"] if m["name"] == "setup_s")
    assert "workloads" not in setup and setup["bound"] <= 0.25


def test_layers_are_named_alike():
    layers = {}
    for m in MANIFEST["per_layer"]:
        base = m["name"].split(".")[0]
        layers.setdefault(base, set()).add(m["layer"])
    assert all(len(v) == 1 for k, v in layers.items() if k != "mfu")
