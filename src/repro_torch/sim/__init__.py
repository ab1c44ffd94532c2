"""Scenario-sweep subsystem: statistical evaluation over *families* of
repair scenarios.

The paper's claim — per-round monitoring (BMFRepair/MSRepair) tracks a
rapidly-changing network better than plan-once schemes (PPT) and static
pipelines (PPR) — is a distributional statement. This layer provides the
substrate to test it at scale:

* `repro_torch.sim.suite`  — `ScenarioSuite` generators: parameter grids,
  Monte-Carlo sampling over codes / cluster sizes / volatility regimes /
  failure patterns, and trace-replay of recorded bandwidth epochs (numpy
  draws on the host, so cases equal the JAX package's).
* `repro_torch.sim.sweep`  — the batched sweep engine: runs every
  (scenario, scheme) pair of a suite (serial / thread / process /
  vectorized / device dispatch), with deterministic per-scenario seeding,
  and aggregates per-scheme time distributions, speedup CDFs and
  planning-overhead stats; `verify_bytes` repairs sampled cases over real
  bytes through the batched data plane.

Layering: ec -> core -> sim.
"""
from repro_torch.sim.suite import (  # noqa: F401
    FAILURE_PATTERNS,
    VOLATILITY_REGIMES,
    GridSuite,
    MonteCarloSuite,
    SampleSpace,
    ScenarioCase,
    ScenarioSuite,
    TraceSuite,
    sample_failures,
)
from repro_torch.sim.sweep import (  # noqa: F401
    ByteVerification,
    CaseResult,
    SchemeStats,
    SweepResult,
    run_sweep,
)
