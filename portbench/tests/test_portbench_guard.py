"""The import guard: the JAX package and JAX by top-level name, whole."""
import json
import sys
import time
import types

import pytest
import torch

from portbench import guard, harness


def test_top_level_names_compared_whole():
    assert guard.loaded({"repro_torch": 0, "repro_torch.ec.rs": 0, "reprox": 0,
                         "numpy": 0, "jaxtyping": 0}) == []
    assert guard.loaded({"repro": 0, "repro.core.plan": 0, "jax.numpy": 0,
                         "jaxlib": 0, "flax.linen": 0, "repro_torch": 0}) == [
        "flax.linen", "jax.numpy", "jaxlib", "repro", "repro.core.plan"]


def test_the_harness_loads_none_of_them():
    assert guard.loaded() == []


@pytest.mark.parametrize("name", ["repro", "jax"])
def test_a_run_with_it_loaded_prints_no_result(monkeypatch, capsys, name):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    code = harness.main(["--workload", "rs63_node_loss", "--seed", "1",
                         "--seconds", "0.2", "--device", "cpu",
                         "--block-bytes", "256"], time.perf_counter())
    out, err = capsys.readouterr()
    assert code != 0 and name in err
    assert not any(line.startswith('{"correct"') for line in out.splitlines())


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the refusal is for runs without one")
    code = harness.main(["--workload", "rs63_node_loss", "--seed", "1",
                         "--seconds", "1"], time.perf_counter())
    out, err = capsys.readouterr()
    assert code != 0 and out == "" and "is_available" in err


def test_reservoir_is_seeded_and_uniform():
    from portbench import check

    picks = []
    for seed in range(2):
        r = check.Reservoir(50, seed)
        for i in range(1000):
            r.offer(i)
        picks.append(sorted(r.jobs))
        assert r.offered == 1000 and len(r.jobs) == 50
    assert picks[0] != picks[1]
    again = check.Reservoir(50, 0)
    for i in range(1000):
        again.offer(i)
    assert sorted(again.jobs) == picks[0]
    assert 300 < sum(picks[0]) / 50 < 700
