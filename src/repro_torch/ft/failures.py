"""Failure injection + straggler detection.

`FailureInjector` produces a seeded schedule of host/domain failures by
step index — the training loop consults it each step and exercises the full
recovery path (EC checkpoint repair + elastic re-mesh) exactly as a real
cluster's health monitor would.

`StragglerMonitor` keeps an EWMA of per-host step durations and flags
hosts whose recent steps exceed `threshold` x the fleet median — the
training-side analogue of BMFRepair's reroute-the-slowest-link loop (the
repair-traffic side is handled inside the planners themselves).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class FailureEvent:
    step: int
    domains: tuple[int, ...]           # failure domains lost at this step


class FailureInjector:
    def __init__(self, *, num_domains: int, rate_per_step: float = 0.0,
                 max_concurrent: int = 2, seed: int = 0,
                 scheduled: tuple[FailureEvent, ...] = ()):
        self.num_domains = num_domains
        self.rate = rate_per_step
        self.max_concurrent = max_concurrent
        self.seed = seed
        self.scheduled = {e.step: e for e in scheduled}

    def check(self, step: int) -> FailureEvent | None:
        if step in self.scheduled:
            return self.scheduled[step]
        if self.rate <= 0:
            return None
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        if rng.uniform() >= self.rate:
            return None
        k = int(rng.integers(1, self.max_concurrent + 1))
        domains = tuple(
            int(x) for x in rng.choice(self.num_domains, size=k, replace=False)
        )
        return FailureEvent(step=step, domains=domains)


class StragglerMonitor:
    def __init__(self, num_hosts: int, *, alpha: float = 0.2,
                 threshold: float = 1.8, min_steps: int = 5):
        self.ewma = np.zeros(num_hosts)
        self.count = np.zeros(num_hosts, dtype=int)
        self.alpha = alpha
        self.threshold = threshold
        self.min_steps = min_steps

    def record(self, host: int, duration: float) -> None:
        if self.count[host] == 0:
            self.ewma[host] = duration
        else:
            self.ewma[host] = (
                self.alpha * duration + (1 - self.alpha) * self.ewma[host])
        self.count[host] += 1

    def stragglers(self) -> list[int]:
        ready = self.count >= self.min_steps
        if ready.sum() < 2:
            return []
        med = float(np.median(self.ewma[ready]))
        return [int(h) for h in np.nonzero(
            ready & (self.ewma > self.threshold * med))[0]]
