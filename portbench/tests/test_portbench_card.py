"""On the card: each cell at 1 MiB blocks holds, and its control and
each fault fail it.
Run on a machine with a card: `python3 -m pytest -m card portbench/tests`."""
import json

import pytest
import torch

from portbench import faults
from _runs import ROOT, run

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible: the kernels run only on one")


@pytest.mark.card
@pytest.mark.parametrize("fault", [None, *faults.NAMES])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell, fault):
    args = ["--workload", cell, "--seed", "2147483999", "--seconds", "2",
            "--trace", "1", "--block-bytes", str(1 << 20)]
    code, out, err = run(args + (["--fault", fault] if fault else []))
    assert code == 0, "\n".join(err[-30:])
    res = json.loads(out[-1])
    assert res["correct"] is (fault is None)
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
