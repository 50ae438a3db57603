"""BENCHMARK.json: its keys, names, units and bounds, and every file it names
found by name."""
from __future__ import annotations

import json
import re

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return harness.manifest()


def test_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(bench)) <= 64 * 1024
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["traffic"] for w in bench["workloads"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    for name in names:
        assert NAME.match(name), name
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in bench[kind]}) == len(bench[kind])
    for metric in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(metric["unit"]), metric
        assert metric["better"] in ("lower", "higher")
        assert metric["source"] in SOURCES
    for metric in bench["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    for text in [w["why"] for w in bench["workloads"]] + [c["why"] for c in bench["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_cell_reports_setup_another_metric_and_a_layer(bench):
    for cell in bench["workloads"]:
        e2e = [m["name"] for m in bench["end_to_end"]
               if cell["name"] in m.get("workloads", [cell["name"]])]
        layers = [m for m in bench["per_layer"] if cell["name"] in m["workloads"]]
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert layers, cell
        for m in layers:  # the metric a layer moves is reported in that cell
            assert m["moves"] in e2e, (cell["name"], m["name"])
        assert cell["chips"] == 1


def test_files_found_by_name(bench):
    for cfg in bench["configs"]:
        data = harness.load_json(harness.ROOT / cfg["file"])
        assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
        assert data["reduced"] == cfg["reduced"]
        assert harness.load_by_name("drivers", data["driver"]).run
    for cell in bench["workloads"]:
        _, _, mix = harness.workload(cell["name"])
        assert mix["limits"]
    for metric in bench["per_layer"]:
        assert harness.load_by_name("metrics", metric["name"]).read
    layers = {}
    for metric in bench["per_layer"]:
        assert layers.setdefault(metric["layer"], metric["layer"]) == metric["layer"]


def test_a_full_check_fits(bench):
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (bench["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert 1 <= bench["run_seconds"] <= 51 and total <= 43200


def test_command_and_paths(bench):
    assert bench["paths"] == ["portbench"]
    assert bench["command"][:3] == ["python3", "-m", "portbench.run"]
