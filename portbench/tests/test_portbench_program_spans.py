"""The readers of the program's own spans and counts
(`portbench/program_spans.py`): the clock alignment in process on the
CPU, the byte count's repeatability, and on the card the idle share
inside planning against the whole idle share."""
import json

import pytest
import torch

from portbench import harness, program_spans, spec
from _runs import ROOT, cell_args, result, run

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_plan_spans_align_with_the_plan_stages(cell):
    loaded = spec.load_cell(cell)
    bench = harness.Bench(loaded, 2**31 + 21, torch.device("cpu"), 4096)
    bench.make_pool()
    traced = harness.profile_stretch(bench, loaded.traffic["traced_batches"])
    rn = harness.Run(device_name="cpu", nbytes=4096, setup_s=0.0,
                     window_s=0.0, batches=traced.batches, traced=traced)
    spans = program_spans.aligned(rn)
    stages = sorted((s, e) for name, s, e in traced.profile.stages
                    if name == "plan")
    plans = [a for a in spans if a.span.name == "plan"]
    assert len(plans) == len(stages) == len(traced.batches)
    for a, (s, e) in zip(plans, stages):
        assert s - 1e-3 <= a.start <= a.end <= e + 1e-3
    assert [a.batch for a in plans] == list(range(len(traced.batches)))


def test_same_seed_same_dataplane_bytes():
    key = "dataplane_bytes_per_lost_byte"
    a, _ = result(cell_args(CELLS[0], seed=21, trace=1))
    b, _ = result(cell_args(CELLS[0], seed=21, trace=1))
    c, _ = result(cell_args(CELLS[0], seed=22, trace=1))
    assert a["metrics"][key] == b["metrics"][key]
    assert a["metrics"][key]["value"] > 1 and c["metrics"][key]["value"] > 1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible: the kernels run only on one")


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_idle_in_planning_within_the_idle_share(card, cell):
    args = ["--workload", cell, "--seed", "2147483999", "--seconds", "2",
            "--trace", "1", "--block-bytes", str(1 << 20)]
    code, out, err = run(args)
    assert code == 0, "\n".join(err[-30:])
    res = json.loads(out[-1])
    metrics = {k: v["value"] for k, v in res["metrics"].items()}
    assert 0 < metrics["idle_in_planning_pct"] <= metrics["device_idle_pct"]
    # the program's spans are host ranges: none is summed as device work
    assert not any(name.startswith("repro_torch.")
                   for name, _ in res["breakdown"]["device_ops"])
