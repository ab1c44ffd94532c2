"""Each cell end to end on the CPU at 4 KiB blocks, through the port's
plain byte versions: the result line keeps to the benchmark's contract."""
import json

import pytest

from portbench import check
from _runs import ROOT, cell_args, result

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
HOST_METRICS = {m["name"] for m in BENCH["per_layer"]
                if m["source"] != "device_trace"}


def _applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_end_to_end(cell):
    res, err = result(cell_args(cell))
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    want = {m["name"]: m["unit"] for m in BENCH["end_to_end"] if _applies(m, cell)}
    assert {k: v["unit"] for k, v in res["metrics"].items()} == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert res["device"]["platform"] == "cpu" and res["device"]["count"] == 1
    names = set(check.LIMITS) | set(check.LEAST) | {"blocks_lost_most"}
    assert set(res["checks"]) == names
    assert all({"value", "limit"} <= set(c) for c in res["checks"].values())
    assert [line.split()[1] for line in err[-len(names):]] == list(res["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_traced(cell):
    res, _ = result(cell_args(cell, trace=1))
    assert res["correct"] is True
    want = {m["name"] for m in BENCH["per_layer"] if _applies(m, cell)}
    # off the card the profiler shows no device op: only host numbers
    assert set(res["metrics"]) == want & HOST_METRICS
    assert res["device"]["window_s"] > 0 and "breakdown" not in res


def test_same_seed_same_work():
    a, _ = result(cell_args(CELLS[0], seed=11, trace=1))
    b, _ = result(cell_args(CELLS[0], seed=11, trace=1))
    c, _ = result(cell_args(CELLS[0], seed=12, trace=1))
    key = "net_bytes_per_lost_byte"
    assert a["metrics"][key] == b["metrics"][key]
    assert a["metrics"][key]["value"] > 1 and c["metrics"][key]["value"] > 1
