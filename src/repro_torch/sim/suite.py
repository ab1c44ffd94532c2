"""Scenario families: grid, Monte-Carlo and trace-replay suite generators.

A `ScenarioSuite` is an ordered, reproducible family of `ScenarioCase`s.
Every case carries its own derived seed (counter-based off the suite's
`base_seed`, so case i is identical no matter which subset of the suite is
generated or in which order the sweep engine runs it) plus the parameter
dict that produced it, which the result layer uses for grouping.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections.abc import Callable, Iterator, Mapping, Sequence

import numpy as np

from repro_torch.core import topology
from repro_torch.core.bandwidth import BandwidthProcess, BandwidthTrace, IngressModel
from repro_torch.core.simulator import MULTI_SCHEMES, Scenario
from repro_torch.ec.rs import RSCode

# Named bandwidth-volatility regimes (kwargs for BandwidthProcess). The
# paper's measured settings: 5 s epoch for cold storage, 2 s for hot
# (Fig. 11), and the Aliyun WAN drift of Figs. 12/13 (fast, high-variance,
# correlated — markov sigma=1.0 rho=0.9 as in benchmarks.common).
VOLATILITY_REGIMES: dict[str, dict] = {
    "static": dict(change_interval=None),
    "cold5s": dict(change_interval=5.0, mode="markov"),
    "hot2s": dict(change_interval=2.0, mode="markov"),
    "jitter2s": dict(change_interval=2.0, mode="jitter", jitter=0.5),
    "redraw2s": dict(change_interval=2.0, mode="redraw"),
    "wan_drift": dict(change_interval=2.0, mode="markov", sigma=1.0, rho=0.9),
}

FAILURE_PATTERNS = ("single", "double", "rack")


def sample_failures(
    rng: np.random.Generator,
    n: int,
    k: int,
    pattern: str,
    *,
    rack_size: int = 4,
) -> tuple[int, ...]:
    """Sample a repairable failure set among codeword positions 0..n-1.

    * "single": one uniform node,
    * "double": two distinct uniform nodes (requires n - k >= 2),
    * "rack":   correlated, rack-aware — nodes are grouped into racks of
      `rack_size` consecutive ids; one rack fails up to min(2, n-k) of its
      members at once (the classic correlated-failure model: a ToR switch
      or PDU takes out co-located blocks together).
    """
    max_failures = n - k
    if max_failures < 1:
        raise ValueError(f"RS({n},{k}) cannot lose any node")
    if pattern == "single":
        return (int(rng.integers(n)),)
    if pattern == "double":
        if max_failures < 2:
            raise ValueError(f"RS({n},{k}) cannot lose two nodes")
        picks = rng.choice(n, size=2, replace=False)
        return tuple(sorted(int(x) for x in picks))
    if pattern == "rack":
        num_racks = (n + rack_size - 1) // rack_size
        rack = int(rng.integers(num_racks))
        members = list(range(rack * rack_size, min((rack + 1) * rack_size, n)))
        count = min(2, max_failures, len(members))
        picks = rng.choice(len(members), size=count, replace=False)
        return tuple(sorted(members[int(i)] for i in picks))
    raise ValueError(f"unknown failure pattern {pattern!r}")


@dataclasses.dataclass
class ScenarioCase:
    """One concrete scenario plus the metadata to reproduce/aggregate it."""

    suite: str
    index: int
    seed: int                               # per-case derived seed
    params: dict                            # generator parameters (grouping)
    scenario: Scenario
    schemes: tuple[str, ...] | None = None  # per-case override (else suite's)


class ScenarioSuite:
    """Base: an ordered, reproducible family of `ScenarioCase`s."""

    name: str = "suite"
    schemes: tuple[str, ...] = ("bmf",)

    def cases(self) -> Iterator[ScenarioCase]:
        raise NotImplementedError

    def __iter__(self) -> Iterator[ScenarioCase]:
        return self.cases()

    def __len__(self) -> int:
        raise NotImplementedError


def case_seed(base_seed: int, index: int) -> int:
    """Counter-based per-case seed: stable under subsetting/reordering."""
    return int(np.random.SeedSequence([base_seed, index]).generate_state(1)[0] & 0x7FFFFFFF)


# ------------------------------------------------------------------- grid
class GridSuite(ScenarioSuite):
    """Cartesian product of parameter axes x `trials` seeded repetitions.

    `build(params, seed)` receives one axis combination (plus "trial") and
    the trial's seed, and returns the `Scenario`. Trial t of every
    combination uses seed `base_seed + t` — matching the legacy
    `benchmarks.common.run_trials` convention so a grid sweep is
    bit-compatible with the old serial loops.
    """

    def __init__(
        self,
        name: str,
        axes: Mapping[str, Sequence],
        build: Callable[[dict, int], Scenario],
        *,
        trials: int = 1,
        schemes: Sequence[str] = ("bmf",),
        base_seed: int = 0,
    ):
        if trials < 1:
            raise ValueError("trials must be >= 1")
        self.name = name
        self.axes = {k: list(v) for k, v in axes.items()}
        self.build = build
        self.trials = trials
        self.schemes = tuple(schemes)
        self.base_seed = base_seed

    def combos(self) -> list[dict]:
        keys = list(self.axes)
        return [
            dict(zip(keys, vals))
            for vals in itertools.product(*(self.axes[k] for k in keys))
        ]

    def cases(self) -> Iterator[ScenarioCase]:
        index = 0
        for combo in self.combos():
            for trial in range(self.trials):
                seed = self.base_seed + trial
                params = dict(combo)
                params["trial"] = trial
                yield ScenarioCase(
                    suite=self.name, index=index, seed=seed, params=params,
                    scenario=self.build(dict(params), seed),
                )
                index += 1

    def __len__(self) -> int:
        combos = 1
        for vals in self.axes.values():
            combos *= len(vals)
        return combos * self.trials


# ------------------------------------------------------------ monte carlo
@dataclasses.dataclass(frozen=True)
class SampleSpace:
    """Distributions a `MonteCarloSuite` samples scenarios from."""

    codes: tuple[tuple[int, int], ...] = ((4, 2), (6, 3), (7, 4))
    cluster_sizes: tuple[int, ...] = (10, 14)
    chunk_mb: tuple[float, ...] = (8.0, 16.0, 32.0)
    regimes: tuple[str, ...] = ("cold5s", "hot2s", "wan_drift")
    failure_patterns: tuple[str, ...] = ("single",)
    bw_low: float = 3.0
    bw_high: float = 30.0
    rack_size: int = 4
    ingress_degrade: float = 0.10
    ingress_floor: float = 0.40
    ingress_alpha: float = 1.0
    ingress_duplex: float = 0.65

    def __post_init__(self):
        for n, k in self.codes:
            if not 0 < k < n:
                raise ValueError(f"invalid code ({n},{k})")
        for r in self.regimes:
            if r not in VOLATILITY_REGIMES:
                raise ValueError(f"unknown regime {r!r} (have {list(VOLATILITY_REGIMES)})")
        for p in self.failure_patterns:
            if p not in FAILURE_PATTERNS:
                raise ValueError(f"unknown failure pattern {p!r}")
        if self.bw_low <= 0 or self.bw_high < self.bw_low:
            raise ValueError("need 0 < bw_low <= bw_high")


class MonteCarloSuite(ScenarioSuite):
    """`num_cases` scenarios sampled i.i.d. from a `SampleSpace`.

    Case i's draws come from `SeedSequence([base_seed, i])`, so the suite
    is fully reproducible, and any case can be regenerated in isolation.
    When `schemes` is None, each case gets the scheme set matching its
    failure cardinality: single-failure cases compare
    traditional/ppr/ppt/bmf, multi-failure cases mppr/random/msrepair —
    one sweep can therefore span both of the paper's evaluation families.
    """

    def __init__(
        self,
        name: str,
        num_cases: int,
        space: SampleSpace | None = None,
        *,
        schemes: Sequence[str] | None = None,
        base_seed: int = 0,
    ):
        if num_cases < 1:
            raise ValueError("num_cases must be >= 1")
        self.name = name
        self.num_cases = num_cases
        self.space = space or SampleSpace()
        self.schemes = tuple(schemes) if schemes is not None else None
        self.base_seed = base_seed

    def _make_case(self, i: int) -> ScenarioCase:
        sp = self.space
        rng = np.random.default_rng(np.random.SeedSequence([self.base_seed, i]))
        seed = case_seed(self.base_seed, i)
        n, k = sp.codes[int(rng.integers(len(sp.codes)))]
        fits = [c for c in sp.cluster_sizes if c >= n] or [max(max(sp.cluster_sizes), n)]
        cluster = int(fits[int(rng.integers(len(fits)))])
        chunk = float(sp.chunk_mb[int(rng.integers(len(sp.chunk_mb)))])
        regime = sp.regimes[int(rng.integers(len(sp.regimes)))]
        feasible = [
            p for p in sp.failure_patterns
            if not (p == "double" and n - k < 2)
        ]
        pattern = feasible[int(rng.integers(len(feasible)))]
        failed = sample_failures(rng, n, k, pattern, rack_size=sp.rack_size)
        base = topology.heterogeneous_matrix(
            cluster, low=sp.bw_low, high=sp.bw_high, seed=seed)
        bwp = BandwidthProcess(base=base, seed=seed, **VOLATILITY_REGIMES[regime])
        ingress = IngressModel(
            seed=seed, degrade=sp.ingress_degrade, floor=sp.ingress_floor,
            alpha=sp.ingress_alpha, duplex=sp.ingress_duplex)
        scenario = Scenario(
            num_nodes=cluster, code=RSCode(n, k), failed=failed,
            bw=bwp, ingress=ingress, chunk_mb=chunk)
        if self.schemes is not None:
            schemes = None  # suite-level set applies
        elif len(failed) > 1:
            schemes = MULTI_SCHEMES
        else:
            schemes = ("traditional", "ppr", "ppt", "bmf")
        params = dict(code=(n, k), cluster=cluster, chunk_mb=chunk,
                      regime=regime, pattern=pattern, failed=failed)
        return ScenarioCase(
            suite=self.name, index=i, seed=seed, params=params,
            scenario=scenario, schemes=schemes,
        )

    def cases(self) -> Iterator[ScenarioCase]:
        for i in range(self.num_cases):
            yield self._make_case(i)

    def __len__(self) -> int:
        return self.num_cases


# ------------------------------------------------------------ trace replay
class TraceSuite(ScenarioSuite):
    """A suite whose bandwidth processes are recorded `BandwidthTrace`s.

    `freeze()` snapshots every case of another suite: each scenario's
    synthetic bandwidth process is recorded for `num_epochs` epochs and
    replaced by its replay, so *every* scheme — and every future planner
    variant — sees the exact same sample path, epoch for epoch. This is
    the apples-to-apples mode for A/B-ing planner changes.
    """

    def __init__(
        self,
        name: str,
        cases: Sequence[ScenarioCase],
        *,
        schemes: Sequence[str] = ("bmf",),
    ):
        self.name = name
        self._cases = list(cases)
        self.schemes = tuple(schemes)

    @classmethod
    def freeze(
        cls,
        suite: ScenarioSuite,
        *,
        num_epochs: int = 64,
        name: str | None = None,
    ) -> "TraceSuite":
        frozen: list[ScenarioCase] = []
        for case in suite.cases():
            bw = case.scenario.bw
            if isinstance(bw, BandwidthProcess):
                bw = BandwidthTrace.record(bw, num_epochs)
            sc = dataclasses.replace(case.scenario, bw=bw)
            frozen.append(dataclasses.replace(
                case, suite=name or f"{suite.name}@trace", scenario=sc))
        out = cls(name or f"{suite.name}@trace", frozen,
                  schemes=suite.schemes or ("bmf",))
        return out

    def cases(self) -> Iterator[ScenarioCase]:
        return iter(self._cases)

    def __len__(self) -> int:
        return len(self._cases)
