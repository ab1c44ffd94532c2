"""BENCHMARK.json against the files it names: every configuration, cell
and metric is a file of its own, and the two say the same."""
import json
import re

import pytest

from portbench import spec
from _runs import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, cells // 4)
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    path = ROOT / entry["file"]
    assert path == spec.HERE / "configs" / f"{entry['name']}.json"
    config = json.loads(path.read_text())
    assert config["name"] == entry["name"] and config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"]
    assert set(entry["reduced"]) <= set(config) and len(entry["reduced"]) <= 16
    assert {"n", "k", "block_bytes", "cluster_nodes", "assumed",
            "guarantees"} <= set(config)
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_file(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and entry["chips"] in (1, 4)
    assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    cell = json.loads((spec.HERE / "workloads" / f"{entry['name']}.json").read_text())
    assert cell == entry
    loaded = spec.load_cell(entry["name"])
    assert loaded.traffic["name"] == entry["traffic"]
    assert loaded.end_to_end and loaded.per_layer
    assert "setup_s" in {m.name for m in loaded.end_to_end}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("entry", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda e: e["name"])
def test_metric_reader(entry):
    reader = spec.load_reader(spec.HERE / "metrics" / f"{entry['name']}.py")
    assert NAME.match(entry["name"]) and UNIT.match(entry["unit"])
    assert (entry["unit"], entry["better"], entry["source"]) == (
        reader.UNIT, reader.BETTER, reader.SOURCE)
    assert entry["source"] in SOURCES and entry["better"] in ("lower", "higher")
    if entry in BENCH["per_layer"]:
        assert (entry["layer"], entry["moves"]) == (reader.LAYER, reader.MOVES)
        assert entry["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    else:
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    for cell in entry.get("workloads", []):
        assert cell in {w["name"] for w in BENCH["workloads"]}


def test_nothing_reads_the_jax_package_or_its_benchmarks():
    for path in spec.HERE.rglob("*.py"):
        text = path.read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|flax|repro|benchmarks)\b",
                             text, re.M), path
