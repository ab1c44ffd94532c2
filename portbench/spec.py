"""The cell a run measures, found by name in files of their own.

`BENCHMARK.json` at the checkout's root lists the cells and metrics. A
cell is `portbench/workloads/<name>.json`, which names its configuration
(`portbench/configs/<config>.json`) and its traffic mix
(`portbench/traffic/<traffic>.json`); each metric is a reader in
`portbench/metrics/<metric>.py`. Nothing here knows a cell, a
configuration or a metric by name.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclasses.dataclass
class Metric:
    entry: dict                 # its entry in BENCHMARK.json
    reader: ModuleType          # portbench/metrics/<name>.py

    @property
    def name(self) -> str:
        return self.entry["name"]


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list[Metric]
    per_layer: list[Metric]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _checked(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"bad {what} name {name!r}")
    return name


def load_reader(path: Path) -> ModuleType:
    """A metric's reader module, imported from its file."""
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", path.stem), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if not callable(getattr(module, "read", None)):
        raise ValueError(f"{path} has no read(run) function")
    return module


def load_cell(name: str, here: Path = HERE) -> Cell:
    """The cell `name` with its configuration, traffic and metrics."""
    bench = _json(here.parent / "BENCHMARK.json")
    _checked(name, "workload")
    listed = [w for w in bench["workloads"] if w["name"] == name]
    if not listed:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = _json(here / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if cell[key] != listed[0][key]:
            raise ValueError(f"{name}: {key} {cell[key]!r} in its file, "
                             f"{listed[0][key]!r} in BENCHMARK.json")
    config = _json(here / "configs" / f"{_checked(cell['config'], 'config')}.json")
    traffic = _json(here / "traffic" / f"{_checked(cell['traffic'], 'traffic')}.json")

    def metrics(kind: str) -> list[Metric]:
        return [Metric(m, load_reader(here / "metrics" / f"{_checked(m['name'], 'metric')}.py"))
                for m in bench[kind]
                if "workloads" not in m or name in m["workloads"]]

    return Cell(name=name, config=config, traffic=traffic,
                chips=int(cell["chips"]), end_to_end=metrics("end_to_end"),
                per_layer=metrics("per_layer"))
