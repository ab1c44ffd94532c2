"""Each cell end to end on the CPU at 4 KiB blocks, through the port's
plain byte versions: the result line keeps to the benchmark's contract."""
import json

import pytest

from portbench import check, diagnose
from _runs import ROOT, cell_args, result, run

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


SAMPLES = ("batches", "stripes", "beyond_p95", "restored_blocks_sampled",
           "restored_blocks_offered", "traced_batches", "plan_ms_mean",
           "plan_ms_median", "dataplane_ms_mean", "dataplane_ms_median",
           "repair_GBps_halves", "gc_full", "gc_full_s", "gc_young",
           "cpu_affinity", "cpus_ran_on", "clocks_sm_MHz", "temperature_C")


def test_samples_line_says_where_the_time_went():
    code, out, err = run(cell_args(CELLS[0]))
    assert code == 0, "\n".join(err[-30:])
    lines = [json.loads(line) for line in out if line.startswith('{"samples"')]
    assert len(lines) == 1 and json.loads(out[-1])["correct"] is True
    samples = lines[0]["samples"]
    assert tuple(samples) == SAMPLES
    assert 0 < samples["plan_ms_median"] and 0 < samples["dataplane_ms_median"]
    assert len(samples["repair_GBps_halves"]) == 2
    assert all(v > 0 for v in samples["repair_GBps_halves"])
    assert samples["gc_full"] >= 0 and samples["gc_full_s"] >= 0
    assert sum(samples["cpus_ran_on"].values()) == samples["batches"]
    assert samples["clocks_sm_MHz"] is None and samples["temperature_C"] is None


def test_cpu_list_round_trip():
    assert diagnose.cpu_list({0, 1, 2, 3, 8}) == "0-3,8"
    assert diagnose.cpu_list(set(range(16)) | set(range(32, 48))) == "0-15,32-47"
    assert diagnose.cpu_list({5}) == "5"


def test_same_seed_same_work():
    a, _ = result(cell_args(CELLS[0], seed=11, trace=1))
    b, _ = result(cell_args(CELLS[0], seed=11, trace=1))
    c, _ = result(cell_args(CELLS[0], seed=12, trace=1))
    key = "net_bytes_per_lost_byte"
    assert a["metrics"][key] == b["metrics"][key]
    assert a["metrics"][key]["value"] > 1 and c["metrics"][key]["value"] > 1
