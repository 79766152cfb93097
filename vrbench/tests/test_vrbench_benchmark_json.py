"""``BENCHMARK.json`` against the benchmark's contract: its keys, names,
units and limits, and the files its names lead to."""

from __future__ import annotations

import importlib
import json
import re

import pytest

from vrbench import spec

BENCH = spec.load_json(spec.BENCHMARK)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert line(word) and not word.startswith("/") and ".." not in word
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


@pytest.mark.parametrize("name", [x["name"] for x in
                                  BENCH["configs"] + BENCH["workloads"]
                                  + METRICS])
def test_names(name):
    assert NAME.match(name)


def test_names_unique_and_texts_on_one_line():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert line(x["why"])
    for c in BENCH["configs"]:
        assert line(c["source"]) and c["source"].startswith("https://")
        assert len(c["reduced"]) <= 16
    for m in BENCH["per_layer"]:
        assert line(m["layer"])
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert metric["moves"] in [m["name"] for m in BENCH["end_to_end"]]
    if metric["name"].endswith("_roofline_pct"):
        assert metric["unit"] == "%"
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    importlib.import_module(f"vrbench.metrics.{metric['name']}").read


def test_setup_s_bound():
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25 and setup["unit"] == "s"


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    c = spec.load_cell(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    w = next(x for x in BENCH["workloads"] if x["name"] == cell)
    c = spec.load_cell(cell)
    assert w["chips"] == 1
    assert set(c.limits) == {"off_share_worst", "far_share_worst",
                             "surface_bad"}
    assert c.limits["surface_bad"] == 0
    spec.module("entries", c.config["entry"]).build
    spec.module("costs", c.config["chain"]).stages
    spec.module("reference", c.config["reference"]).frame
    spec.module("surfaces", c.config["surface"]).codes
    spec.module("frames", c.config["video_source"]["format"].lower()).batch


def test_configs_files():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"] == f"vrbench/configs/{c['name']}.json"
        data = spec.load_json(spec.ROOT / c["file"])
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] == []
        assert "assumed" in data and "precision" in data
    # at most a quarter of the cells on four chips, one always
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)
