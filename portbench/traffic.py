"""The one traffic generator: repair scenarios drawn from the seed.

A copy of the draws of the port's `MonteCarloSuite._make_case`
(`repro_torch/sim/suite.py`): the lost block positions, the base
bandwidth matrix and the churn and ingress seeds, kept here so that a
change to the port cannot move the yardstick. The parameters come from
a cell's configuration (code, cluster, links, churn, ingress) and its
traffic mix (failure pattern, scheme); the draws are made into the
port's own `Scenario`s, which its planner takes.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.bandwidth import BandwidthProcess, IngressModel
from repro_torch.core.simulator import Scenario
from repro_torch.ec.rs import RSCode
from repro_torch.sim.suite import ScenarioCase, ScenarioSuite

# streams of draws a run takes from its seed, each indexed from 0
WARM, WINDOW, TRACED, STRIPES, SAMPLE = range(5)


def case_seed(seed: int, stream: int, index: int) -> int:
    """Counter-based per-case seed (the port's `case_seed`, per stream)."""
    state = np.random.SeedSequence([seed, stream, index]).generate_state(1)
    return int(state[0] & 0x7FFFFFFF)


def failures(rng: np.random.Generator, n: int, k: int, pattern: str,
             rack_size: int) -> tuple[int, ...]:
    """A repairable set of lost block positions (`sample_failures`)."""
    if pattern == "single":
        return (int(rng.integers(n)),)
    if pattern == "double":
        picks = rng.choice(n, size=2, replace=False)
        return tuple(sorted(int(x) for x in picks))
    if pattern == "rack":
        racks = (n + rack_size - 1) // rack_size
        rack = int(rng.integers(racks))
        members = list(range(rack * rack_size, min((rack + 1) * rack_size, n)))
        count = min(2, n - k, len(members))
        picks = rng.choice(len(members), size=count, replace=False)
        return tuple(sorted(members[int(i)] for i in picks))
    raise ValueError(f"unknown failure pattern {pattern!r}")


def link_matrix(nodes: int, low: float, high: float, seed: int) -> np.ndarray:
    """Asymmetric uniform link bandwidths in MB/s (`heterogeneous_matrix`)."""
    m = np.random.default_rng(seed).uniform(low, high, size=(nodes, nodes))
    np.fill_diagonal(m, 0.0)
    return m


def draw_case(config: dict, traffic: dict, seed: int, stream: int,
              index: int) -> ScenarioCase:
    """Case `index` of `stream`: the same for a seed, whatever else runs."""
    n, k, nodes = config["n"], config["k"], config["cluster_nodes"]
    rng = np.random.default_rng(np.random.SeedSequence([seed, stream, index]))
    cseed = case_seed(seed, stream, index)
    lost = failures(rng, n, k, traffic["failure_pattern"], traffic["rack_size"])
    if not 0 < len(lost) <= n - k:
        raise ValueError(f"{lost} lost of RS({n},{k})")
    low, high = config["link_MBps"]
    bwp = BandwidthProcess(base=link_matrix(nodes, low, high, cseed),
                           seed=cseed, **config["volatility"])
    ingress = IngressModel(seed=cseed, **config["ingress"])
    scenario = Scenario(num_nodes=nodes, code=RSCode(n, k), failed=lost,
                        bw=bwp, ingress=ingress,
                        chunk_mb=config["block_bytes"] / 1e6)
    return ScenarioCase(suite=traffic["name"], index=index, seed=cseed,
                        params=dict(failed=lost), scenario=scenario)


class BatchSuite(ScenarioSuite):
    """The drawn cases of one batch, as a suite the port's sweep runs."""

    def __init__(self, name: str, cases: list[ScenarioCase],
                 scheme: str):
        self.name = name
        self.schemes = (scheme,)
        self._cases = cases

    def cases(self):
        return iter(self._cases)

    def __len__(self) -> int:
        return len(self._cases)
