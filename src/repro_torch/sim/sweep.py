"""Batched sweep engine: run a `ScenarioSuite` across schemes, in parallel.

The unit of work is one `ScenarioCase`: every scheme runs against the same
scenario object, so per-case comparisons (speedups, CDFs) are paired. Work
items are independent and seeded by the suite, so results are identical
under serial, thread and process dispatch — the executor only changes
wall-clock, never output (apart from the wall-clock `planning_time`
measurements themselves).

Process dispatch uses the "spawn" start method by default: sweep workers
run the host object engine (`repro_torch.core.simulator`, numpy) and never
touch the card, and spawning avoids the fork-safety issues of a parent
that has initialised CUDA.

Executors are the JAX package's, with its "jax" executor renamed
"device": the vectorized engine with the torch device stepper
(`repro_torch.core.engine.device_stepper`) on `device` (`None` = the
card, raising without one). `device` also places the byte verification.
Unlike the JAX package's, "auto" never picks the device stepper: it is
slower than the vectorized engine on every suite measured on an H100.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import math
import multiprocessing
import os
import warnings
from collections.abc import Callable, Sequence

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.simulator import SimResult, run_scheme
from repro_torch.sim.suite import ScenarioCase, ScenarioSuite


# ------------------------------------------------------------------ records
@dataclasses.dataclass
class CaseResult:
    """All schemes' results for one scenario case."""

    index: int
    seed: int
    params: dict
    results: dict[str, SimResult]

    def time(self, scheme: str) -> float:
        return self.results[scheme].total_time


@dataclasses.dataclass(frozen=True)
class SchemeStats:
    """Distributional summary of one scheme over a sweep."""

    scheme: str
    count: int
    mean: float
    std: float
    p50: float
    p90: float
    min: float
    max: float
    mean_planning: float       # seconds of plan/optimize wall-clock per case
    planning_frac: float       # mean planning / (planning + simulated time)
    mean_rounds: float
    mean_relay_hops: float

    def __str__(self) -> str:
        return (
            f"{self.scheme}: n={self.count} mean={self.mean:.2f}s "
            f"std={self.std:.2f} p50={self.p50:.2f} p90={self.p90:.2f} "
            f"plan={self.mean_planning * 1e3:.2f}ms ({self.planning_frac * 100:.2f}%) "
            f"rounds={self.mean_rounds:.1f} relays={self.mean_relay_hops:.1f}"
        )


@dataclasses.dataclass(frozen=True)
class ByteVerification:
    """Outcome of `run_sweep(verify_bytes=...)`: a sampled subset of the
    sweep's cases re-planned and executed over *real bytes* (the batched
    data plane, `repro_torch.core.engine.dataplane`) against stripes placed
    by `repro_torch.ec.stripe` — every job's reconstructed block must equal
    the lost block bit-for-bit."""

    checked: tuple[tuple[int, str], ...]   # (case index, scheme) pairs
    failures: tuple[tuple[int, str], ...]
    nbytes: int                            # chunk size executed
    rounds: int = 0                        # data-plane rounds of the call

    @property
    def verified(self) -> bool:
        return not self.failures


@dataclasses.dataclass
class SweepResult:
    """Structured output of `run_sweep`, with aggregation helpers."""

    suite: str
    schemes: tuple[str, ...]
    cases: list[CaseResult]
    byte_verification: ByteVerification | None = None

    def __len__(self) -> int:
        return len(self.cases)

    def _with(self, scheme: str) -> list[CaseResult]:
        return [c for c in self.cases if scheme in c.results]

    def times(self, scheme: str) -> np.ndarray:
        return np.array([c.results[scheme].total_time for c in self._with(scheme)])

    def stats(self, scheme: str) -> SchemeStats:
        sub = self._with(scheme)
        if not sub:
            raise KeyError(f"scheme {scheme!r} has no results in this sweep")
        t = np.array([c.results[scheme].total_time for c in sub])
        plan = np.array([c.results[scheme].planning_time for c in sub])
        rounds = np.array([c.results[scheme].num_rounds for c in sub])
        relays = np.array([c.results[scheme].relay_hops for c in sub])
        return SchemeStats(
            scheme=scheme, count=len(sub),
            mean=float(t.mean()), std=float(t.std()),
            p50=float(np.percentile(t, 50)), p90=float(np.percentile(t, 90)),
            min=float(t.min()), max=float(t.max()),
            mean_planning=float(plan.mean()),
            planning_frac=float((plan / (plan + t)).mean()),
            mean_rounds=float(rounds.mean()),
            mean_relay_hops=float(relays.mean()),
        )

    def summary(self) -> dict[str, SchemeStats]:
        return {s: self.stats(s) for s in self.schemes if self._with(s)}

    def speedups(self, baseline: str, scheme: str) -> np.ndarray:
        """Paired per-case ratios baseline_time / scheme_time (>1 = faster)."""
        pairs = [
            c for c in self.cases
            if baseline in c.results and scheme in c.results
        ]
        return np.array([
            c.results[baseline].total_time / c.results[scheme].total_time
            for c in pairs
        ])

    def speedup_cdf(self, baseline: str, scheme: str) -> tuple[np.ndarray, np.ndarray]:
        """(sorted speedups, empirical CDF) of `scheme` vs `baseline`."""
        s = np.sort(self.speedups(baseline, scheme))
        return s, np.arange(1, len(s) + 1) / len(s)

    def speedup_percentile(self, baseline: str, scheme: str, q: float) -> float:
        """The q-th percentile (0..100) of the paired speedup distribution,
        with the same interpolation convention as `SchemeStats` p50/p90."""
        return float(np.percentile(self.speedups(baseline, scheme), q))

    def reduction_pct(self, baseline: str, scheme: str) -> float:
        """Mean % repair-time reduction of `scheme` vs `baseline` (paper's
        headline metric): 100 * (1 - mean(scheme) / mean(baseline))."""
        pairs = [
            c for c in self.cases
            if baseline in c.results and scheme in c.results
        ]
        if not pairs:
            return float("nan")
        b = np.mean([c.results[baseline].total_time for c in pairs])
        s = np.mean([c.results[scheme].total_time for c in pairs])
        return float(100.0 * (1.0 - s / b))

    def filter(self, pred: Callable[[CaseResult], bool]) -> "SweepResult":
        return SweepResult(self.suite, self.schemes,
                           [c for c in self.cases if pred(c)])

    def group_by(self, *keys: str) -> dict[tuple, "SweepResult"]:
        """Split into sub-sweeps keyed by case-param values (grid axes)."""
        groups: dict[tuple, list[CaseResult]] = {}
        for c in self.cases:
            key = tuple(c.params.get(k) for k in keys)
            groups.setdefault(key, []).append(c)
        return {
            key: SweepResult(self.suite, self.schemes, sub)
            for key, sub in sorted(groups.items(), key=lambda kv: str(kv[0]))
        }

    def summary_table(self) -> str:
        return "\n".join(str(st) for st in self.summary().values())


# ------------------------------------------------------------------- engine
def _strip(r: SimResult) -> SimResult:
    """Drop the executed plan/log to keep cross-process results light."""
    return dataclasses.replace(r, plan=None, log=[])


def _run_case(
    case: ScenarioCase,
    schemes: tuple[str, ...],
    keep_plans: bool,
    bmf_optimize_all: bool,
) -> CaseResult:
    results: dict[str, SimResult] = {}
    for scheme in schemes:
        r = run_scheme(
            case.scenario, scheme,
            bmf_optimize_all=bmf_optimize_all, random_seed=case.seed,
        )
        results[scheme] = r if keep_plans else _strip(r)
    return CaseResult(
        index=case.index, seed=case.seed, params=dict(case.params),
        results=results,
    )


# Spawn amortization: a spawned worker must be fed at least this many
# cases to pay for its interpreter start-up + imports; below it a process
# pool is slower than the serial loop. The threshold is the JAX package's
# (set from its own CPU measurements), kept so both packages route alike.
_MIN_CASES_PER_WORKER = 64


def _process_workers(num_items: int, max_workers: int | None) -> int:
    """Worker count for the process executor: never more than the spawn
    amortization threshold can feed. 0 means 'do not spawn — go serial'."""
    cap = max_workers or os.cpu_count() or 1
    return min(cap, num_items // _MIN_CASES_PER_WORKER)


def _resolve_executor(executor: str, cases,
                      max_workers: int | None = None) -> str:
    """"auto" = the vectorized engine. The JAX package's auto picks its
    jax stepper for large trace-frozen suites on an accelerator; this
    package's device stepper, as a host loop of eager torch ops, was
    slower than the vectorized engine on every suite measured on an H100,
    and its event-loop kernels have no measured crossover yet (PERF.md),
    so it stays an explicit opt-in. The process pool stays opt-in too: it only beats the
    vectorized engine for very long individual cases, which a heuristic
    cannot see. Every executor matches the serial one case for case."""
    if executor == "jax":
        raise ValueError("executor 'jax' names the JAX package's stepper; "
                         "this package's device stepper is "
                         "executor='device'")
    if executor != "auto":
        return executor
    return "vectorized"


@tracing.spanned("plan")
def run_sweep(
    suite: ScenarioSuite,
    *,
    schemes: Sequence[str] | None = None,
    executor: str = "auto",
    max_workers: int | None = None,
    keep_plans: bool = False,
    bmf_optimize_all: bool = False,
    mp_context: str = "spawn",
    verify_bytes: int | None = None,
    device=None,
) -> SweepResult:
    """Run every case of `suite` under every applicable scheme.

    `schemes` overrides both the suite default and per-case scheme sets;
    otherwise each case runs `case.schemes or suite.schemes`. Executors:
    "serial", "thread", "process" (object engine on a spawn pool; below
    the spawn-amortization threshold it warns and runs serial),
    "vectorized" (batched array engine — compatible cases step through
    `repro_torch.core.engine` together), "device" (the vectorized engine
    with the torch device stepper from
    `repro_torch.core.engine.device_stepper` on `device`: `None` is the
    card and raises without one; a batch the stepper declines runs on the
    numpy steppers, is counted in `device_stepper.COUNTS` (routing only)
    and warned of) or "auto" (vectorized: the device stepper is opt-in,
    see `_resolve_executor`). Output is independent of the executor
    choice. The call's time, and that of its search, replan, stepping
    and conversions, are the `repro_torch.tracing` spans `plan` and its
    children.

    `verify_bytes=k` additionally byte-verifies `k` sampled cases: their
    plans are re-derived and executed over real bytes by the batched
    data plane on `device` (`None` = the card, raising without one)
    against stripes placed by `repro_torch.ec.stripe` (every scheme, PPT
    included via its store-and-forward lowering); the outcome lands in
    `SweepResult.byte_verification`. This turns a timing sweep into an
    end-to-end correctness probe of the whole planner + placement +
    GF(256) stack at a marginal cost.
    """
    cases = list(suite.cases())
    work = [
        (case, tuple(schemes) if schemes is not None
         else (case.schemes or tuple(suite.schemes)))
        for case in cases
    ]
    mode = _resolve_executor(executor, cases, max_workers)
    if mode == "process":
        workers = _process_workers(len(work), max_workers)
        if workers < 2:
            warnings.warn(
                f"process executor: {len(work)} cases cannot amortize "
                f"worker spawn cost (< {2 * _MIN_CASES_PER_WORKER} cases); "
                "falling back to serial",
                RuntimeWarning, stacklevel=2)
            mode = "serial"

    def jobs():
        for case, case_schemes in work:
            yield case, case_schemes, keep_plans, bmf_optimize_all

    if mode in ("vectorized", "device"):
        results = _run_vectorized(
            work, keep_plans, bmf_optimize_all,
            backend="device" if mode == "device" else "numpy", device=device)
    elif mode == "serial":
        results = [_run_case(*args) for args in jobs()]
    elif mode == "thread":
        with concurrent.futures.ThreadPoolExecutor(max_workers=max_workers) as pool:
            results = list(pool.map(lambda args: _run_case(*args), jobs()))
    elif mode == "process":
        ctx = multiprocessing.get_context(mp_context)
        # few large tasks, not many tiny ones: each submitted task carries
        # a chunk of cases so per-task IPC/pickling is amortized too
        chunk = max(1, math.ceil(len(work) / (workers * 2)))
        with concurrent.futures.ProcessPoolExecutor(
                max_workers=workers, mp_context=ctx) as pool:
            results = list(pool.map(
                _run_case_star, jobs(), chunksize=chunk))
    else:
        raise ValueError(f"unknown executor {executor!r}")

    all_schemes: list[str] = []
    for _, case_schemes in work:
        for s in case_schemes:
            if s not in all_schemes:
                all_schemes.append(s)
    verification = None
    if verify_bytes:
        verification = _byte_verify(work, verify_bytes,
                                    bmf_optimize_all=bmf_optimize_all,
                                    device=device)
    return SweepResult(suite=suite.name, schemes=tuple(all_schemes),
                       cases=results, byte_verification=verification)


def _run_case_star(args) -> CaseResult:
    return _run_case(*args)


# ------------------------------------------------------------ byte verify
_VERIFY_NBYTES = 512


def _verify_plan(scenario, scheme: str, seed: int, bmf_optimize_all: bool):
    """The executed plan a (scenario, scheme) pair would produce — plans
    are pure functions of (scenario, scheme, seed), so re-deriving them
    here reproduces exactly what the sweep timed (including per-round BMF
    relay splices). PPT plans a pipeline tree, not rounds; its bytes are
    executed through the store-and-forward lowering `ppt_round_plan`."""
    from repro_torch.core.ppt import build_ppt_tree, ppt_round_plan

    if scheme == "ppt":
        tree = build_ppt_tree(scenario.make_jobs()[0],
                              scenario.bw.matrix_at(0.0))
        return ppt_round_plan(tree)
    return run_scheme(scenario, scheme, bmf_optimize_all=bmf_optimize_all,
                      random_seed=seed).plan


def _byte_verify(work, num_cases: int, *, bmf_optimize_all: bool,
                 device=None) -> ByteVerification:
    """Byte-verify a deterministic sample of the sweep's cases.

    Every sampled (case, scheme) pair gets its own stripe from
    `place_stripes` (RAID-5-style rotated placement over the case's
    failure domains), random payload bytes split by `split_blob`, and its
    plan relabeled through the placement — then the whole sample executes
    as ONE batched data-plane call on `device` (one `gf256_scale_bytes`
    launch, one `xor_reduce_groups_words` launch per round on the card).
    A failure here means some layer (planner, relabeling, placement,
    GF(256) math) corrupted bytes.
    """
    from repro_torch.core.engine.arrays import (compile_plan,
                                                relabel_plan_nodes)
    from repro_torch.core.engine.dataplane import execute_plans_batch
    from repro_torch.ec.stripe import place_stripes, split_blob

    rng = np.random.default_rng(0x5712BE)
    picks = sorted(rng.choice(len(work), size=min(num_cases, len(work)),
                              replace=False).tolist())
    checked: list[tuple[int, str]] = []
    plans, codes, cws, bmaps = [], [], [], []
    for p in picks:
        case, case_schemes = work[p]
        sc = case.scenario
        code, cluster = sc.code, sc.num_nodes
        stripes = place_stripes(len(case_schemes), code, cluster)
        blob_rng = np.random.default_rng(case.seed)
        blob = blob_rng.integers(
            0, 256, size=len(case_schemes) * code.k * _VERIFY_NBYTES,
            dtype=np.uint8)
        datas = split_blob(blob, code.k, _VERIFY_NBYTES)
        for si, scheme in enumerate(case_schemes):
            plan = _verify_plan(sc, scheme, case.seed, bmf_optimize_all)
            stripe = stripes[si]
            pa = relabel_plan_nodes(compile_plan(plan), stripe.perm(cluster))
            checked.append((case.index, scheme))
            plans.append(pa)
            codes.append(code)
            # encoded on the host (the stripes are 512-byte samples);
            # the batch call moves the codewords to `device`
            cws.append(code.encode(torch.from_numpy(datas[si])))
            bmaps.append(stripe.block_map(cluster))
    res = execute_plans_batch(plans, codes, cws, block_of=bmaps,
                              device=device)
    failures = tuple(pair for pair, ok in zip(checked, res.verified)
                     if not ok)
    return ByteVerification(checked=tuple(checked), failures=failures,
                            nbytes=_VERIFY_NBYTES, rounds=res.rounds)


def _run_vectorized(
    work: list[tuple[ScenarioCase, tuple[str, ...]]],
    keep_plans: bool,
    bmf_optimize_all: bool,
    backend: str = "numpy",
    device=None,
) -> list[CaseResult]:
    """Dispatch work through the batched array engine, scheme by scheme.

    Cases sharing a scheme are handed to `run_scheme_vectorized`, which
    plans every case directly in `PlanArrays` space (true batched
    planning — each case owns its plan, no dedup/copy workarounds),
    groups them into structurally compatible batches (same cluster size
    and round count) and falls back to the object engine per case when a
    plan cannot be lowered to arrays. `backend="device"` swaps the batch
    steppers for the torch programs of
    `repro_torch.core.engine.device_stepper` on `device` (unsupported
    batches drop back to numpy, counted). Results are identical to the
    serial executor (the engine parity tests pin this), only wall-clock
    changes.
    """
    from repro_torch.core.engine.vectorized import run_work_vectorized

    flat: list[tuple[int, str]] = []
    rows = []
    for pos, (case, case_schemes) in enumerate(work):
        for s in case_schemes:
            flat.append((pos, s))
            rows.append((case.scenario, s, case.seed))

    by_pos: list[dict[str, SimResult]] = [{} for _ in work]
    sims = run_work_vectorized(rows, bmf_optimize_all=bmf_optimize_all,
                               keep_plans=keep_plans, backend=backend,
                               device=device)
    for (pos, scheme), r in zip(flat, sims):
        by_pos[pos][scheme] = r if keep_plans else _strip(r)
    return [
        CaseResult(
            index=case.index, seed=case.seed, params=dict(case.params),
            results={s: by_pos[pos][s] for s in case_schemes},
        )
        for pos, (case, case_schemes) in enumerate(work)
    ]
