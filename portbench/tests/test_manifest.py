"""BENCHMARK.json against the benchmark's contract, and the files it names."""

from __future__ import annotations

import json
import os
import re

import pytest

from portbench.tests.conftest import ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][:2] == ["python3", "portbench/run.py"]
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("m", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_entry(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert set(m["workloads"]) <= set(CELLS) if "workloads" in m else True
    if m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    else:
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics", f"{m['name']}.py"))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=[m["name"] for m in BENCH["per_layer"]])
def test_per_layer_cells_report_what_it_moves(m):
    moved = {e["name"]: e for e in BENCH["end_to_end"]}[m["moves"]]
    for cell in m.get("workloads", CELLS):
        assert cell in moved.get("workloads", CELLS)


@pytest.mark.parametrize("w", BENCH["workloads"], ids=CELLS)
def test_cell(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    assert w["config"] in {c["name"] for c in BENCH["configs"]}
    with open(os.path.join(ROOT, "portbench", "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    assert os.path.exists(os.path.join(ROOT, "portbench", "drivers",
                                       f"{traffic['driver']}.py"))
    e2e = [m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", CELLS)]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert any(w["name"] in m.get("workloads", CELLS) for m in BENCH["per_layer"])


@pytest.mark.parametrize("c", BENCH["configs"], ids=[c["name"] for c in BENCH["configs"]])
def test_config(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"].startswith("portbench/") and len(c["reduced"]) <= 16
    with open(os.path.join(ROOT, c["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    assert all(k in cfg for k in c["reduced"])
    assert cfg["limits"] and all(v >= 0 for v in cfg["limits"].values())
    assert any(c["name"] == w["config"] for w in BENCH["workloads"])


def test_names_unique_and_layers_one_line():
    for group in (METRICS, BENCH["workloads"], BENCH["configs"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    assert all("\n" not in m["layer"] and len(m["layer"]) <= 200 for m in BENCH["per_layer"])


def test_run_seconds_fits_a_full_check():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
