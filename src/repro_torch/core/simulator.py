"""Event-driven repair simulator under dynamic bandwidth.

This is the Mininet-equivalent test bench (no multi-host network needed):
transfers progress continuously at rates set by the current
bandwidth epoch (BandwidthProcess) and receiver fan-in contention
(IngressModel); events are hop completions and bandwidth-change epochs.

Scheme dispatch:
  traditional / ppr / ppt / bmf        (single-node, paper Figs. 9, 11, 12)
  mppr / random / msrepair             (multi-node,  paper Fig. 10, Table II)

Online schemes (bmf, msrepair) re-run BMFRepair link optimization at every
round boundary with the *current* bandwidth matrix — the paper's central
"local optimum per timestamp tracks the changing network" mechanism.
Offline schemes (ppt notably) plan once from the t=0 snapshot.
"""
from __future__ import annotations

import dataclasses
import time as _time

import numpy as np

from repro_torch.core import bmf
from repro_torch.core.bandwidth import BandwidthProcess, IngressModel
from repro_torch.core.msrepair import (
    plan_mppr,
    plan_msrepair,
    plan_random,
    select_helpers_multi,
)
from repro_torch.core.plan import Job, RepairPlan, Round, validate_plan
from repro_torch.core.ppr import plan_ppr, plan_traditional
from repro_torch.core.ppt import PPTTree, build_ppt_tree
from repro_torch.ec.rs import RSCode

_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class Scenario:
    num_nodes: int                      # cluster size (>= code.n)
    code: RSCode
    failed: tuple[int, ...]
    bw: BandwidthProcess
    ingress: IngressModel
    chunk_mb: float = 16.0
    helpers: tuple[tuple[int, ...], ...] | None = None  # per-job override

    def make_jobs(self) -> list[Job]:
        # helper selection is a pure function of the (frozen) scenario and
        # is requested once per scheme — memoize the Job prototypes and
        # hand out a fresh list each call (Jobs themselves are read-only)
        jobs = getattr(self, "_jobs_cache", None)
        if jobs is None:
            failed = list(self.failed)
            if self.helpers is not None:
                helper_sets = [tuple(h) for h in self.helpers]
            elif len(failed) == 1:
                survivors = [x for x in range(self.code.n) if x not in failed]
                helper_sets = [tuple(survivors[: self.code.k])]
            else:
                helper_sets = select_helpers_multi(
                    self.code.n, self.code.k, failed)
            jobs = [
                Job(job_id=i, failed_node=f, requestor=f,
                    helpers=helper_sets[i])
                for i, f in enumerate(failed)
            ]
            object.__setattr__(self, "_jobs_cache", jobs)
        return list(jobs)


@dataclasses.dataclass
class SimResult:
    scheme: str
    total_time: float
    round_times: list[float]
    planning_time: float                # wall-clock seconds in plan/optimize
    plan: RepairPlan | None
    relay_hops: int = 0
    log: list[str] = dataclasses.field(default_factory=list)

    @property
    def num_rounds(self) -> int:
        return len(self.round_times)


# ------------------------------------------------------------- round engine
def execute_round(
    transfers,
    t0: float,
    bwp: BandwidthProcess,
    ingress: IngressModel,
    chunk_mb: float,
) -> float:
    """Advance simulated time until all transfers of a round complete.

    State is index-based (parallel lists over the transfer index), the
    scalar sibling of the batched `(B, T)` arrays of the reference's
    `core/engine/vectorized.py::execute_round_batch`.
    """
    hops = [list(zip(tr.path[:-1], tr.path[1:])) for tr in transfers]
    n_hops = [len(h) for h in hops]
    hop = [0] * len(transfers)
    left = [chunk_mb] * len(transfers)
    t = t0
    guard = 0
    while any(hop[i] < n_hops[i] for i in range(len(transfers))):
        guard += 1
        if guard > 100_000:
            raise RuntimeError("simulator failed to converge")
        bw = bwp.matrix_at(t)
        epoch = bwp.epoch_of(t)
        active = [i for i in range(len(transfers)) if hop[i] < n_hops[i]]
        # fan-in contention per receiver (Fig. 2 model)
        by_recv: dict[int, list[int]] = {}
        for i in active:
            _, v = hops[i][hop[i]]
            by_recv.setdefault(v, []).append(i)
        rates = [0.0] * len(transfers)
        for v, senders in by_recv.items():
            standalone = np.array([bw[hops[i][hop[i]][0], v] for i in senders])
            eff = ingress.effective_rates(standalone, v, epoch)
            for i, r in zip(senders, eff):
                rates[i] = max(float(r), 0.0)
        # next event: a hop completes or the bandwidth epoch flips
        dt = bwp.epoch_end(t) - t
        for i in active:
            if rates[i] > 0:
                dt = min(dt, left[i] / rates[i])
        if not np.isfinite(dt) or dt <= 0:
            dt = _EPS      # e.g. an all-zero-bandwidth epoch: creep, don't
            #                keep dt = inf (which poisoned left with NaN)
        for i in active:
            left[i] -= rates[i] * dt
        t += dt
        for i in active:
            if left[i] <= _EPS * chunk_mb:
                hop[i] += 1            # store-and-forward: next hop restarts
                left[i] = chunk_mb
    return t


def pipeline_fill_latency(
    tree: PPTTree,
    bw0: np.ndarray,
    chunk_mb: float,
    slice_frac: float = 1.0 / 32.0,
) -> float:
    """Pipeline-fill latency of PPT's deepest path at the t=0 snapshot.

    Shared by `execute_pipeline` and the batched engine (the reference's
    `core/engine/vectorized.py`) so the two stay expression-identical.
    """
    depth = max(tree.depths().values(), default=0)
    bn0 = max(tree.assumed_bottleneck(bw0), _EPS)
    return (depth - 1) * (chunk_mb * slice_frac) / bn0 if depth > 1 else 0.0


def execute_pipeline(
    tree: PPTTree,
    t0: float,
    bwp: BandwidthProcess,
    ingress: IngressModel,
    chunk_mb: float,
    slice_frac: float = 1.0 / 32.0,
) -> float:
    """PPT: slices stream down the tree concurrently on every edge.

    Edge (c -> p) carries the full chunk (RS aggregates stay block-sized);
    its instantaneous rate is its contended bandwidth (fan-in at p, Fig. 2)
    capped by the slowest edge in the subtree feeding c (a node forwards
    aggregate slices no faster than its children supply theirs). Repair
    completes when every edge has moved chunk_mb, plus the pipeline-fill
    latency of the deepest path.
    """
    t = t0
    edges = list(tree.parent.items())                    # (child, parent)
    left = {c: chunk_mb for c, _ in edges}
    children: dict[int, list[int]] = {}
    for c, p in edges:
        children.setdefault(p, []).append(c)
    # pipeline fill latency: deepest path at the initial snapshot
    t += pipeline_fill_latency(tree, bwp.matrix_at(t0), chunk_mb, slice_frac)

    guard = 0
    while any(v > _EPS * chunk_mb for v in left.values()):
        guard += 1
        if guard > 100_000:
            raise RuntimeError("pipeline simulation failed to converge")
        bw = bwp.matrix_at(t)
        epoch = bwp.epoch_of(t)
        # Node-level capacity split: every node's concurrent live links
        # (rx from children + tx to parent) share its capacity — interior
        # pipeline nodes receive and send at once, the "single node
        # accessing multiple links" effect the paper measured on Aliyun.
        live_edges = [c for c in left if left[c] > _EPS * chunk_mb]
        links_at: dict[int, list[tuple[int, str]]] = {}
        for c in live_edges:
            p = tree.parent[c]
            links_at.setdefault(p, []).append((c, "rx"))
            links_at.setdefault(c, []).append((c, "tx"))
        alloc: dict[tuple[int, str], float] = {}
        for v, links in links_at.items():
            standalone = np.array([bw[c, tree.parent[c]] for c, _ in links])
            kinds = tuple("rx" if kind == "rx" else "tx" for _, kind in links)
            eff = ingress.node_allocations(standalone, kinds, v, epoch)
            for (c, kind), r in zip(links, eff):
                alloc[(c, kind)] = max(float(r), 0.0)
        raw: dict[int, float] = {
            c: min(alloc[(c, "rx")], alloc[(c, "tx")]) for c in live_edges
        }

        def supply_rate(node: int) -> float:
            """Slowest live edge in the subtree rooted at `node`."""
            rate = float("inf")
            for c in children.get(node, ()):  # edges feeding `node`
                if left.get(c, 0.0) > _EPS * chunk_mb:
                    rate = min(rate, raw.get(c, 0.0), supply_rate(c))
            return rate

        rates = {
            c: min(raw.get(c, 0.0), supply_rate(c))
            for c in left if left[c] > _EPS * chunk_mb
        }
        dt = bwp.epoch_end(t) - t
        for c, r in rates.items():
            if r > 0:
                dt = min(dt, left[c] / r)
        if not np.isfinite(dt) or dt <= 0:
            dt = _EPS
        for c, r in rates.items():
            left[c] -= r * dt
        t += dt
    return t


# ---------------------------------------------------------------- simulator
SINGLE_SCHEMES = ("traditional", "ppr", "bmf", "ppt", "bmf_static")
MULTI_SCHEMES = ("mppr", "random", "msrepair")
ALL_SCHEMES = SINGLE_SCHEMES + MULTI_SCHEMES
# bmf_static: ablation — BMF's link optimization applied once from the
# t=0 snapshot (plan-once, like PPT) instead of per round. Isolates the
# paper's real-time-monitoring contribution from the relay mechanism.


def _idle_pool(sc: Scenario, jobs: list[Job]) -> list[int]:
    involved = {j.requestor for j in jobs} | {j.failed_node for j in jobs}
    return [x for x in range(sc.num_nodes) if x not in involved]


def plan_for_scheme(scheme: str, jobs: list[Job], *, random_seed: int = 0) -> RepairPlan:
    """Static round plan for any non-PPT scheme (PPT plans a pipeline tree,
    not rounds — see `run_scheme`)."""
    if scheme == "traditional":
        return plan_traditional(jobs[0])
    if scheme in ("ppr", "bmf", "bmf_static"):
        return plan_ppr(jobs[0])
    if scheme == "mppr":
        return plan_mppr(jobs)
    if scheme == "random":
        return plan_random(jobs, seed=random_seed)
    if scheme == "msrepair":
        return plan_msrepair(jobs)
    raise ValueError(f"unknown scheme {scheme!r}")


def run_scheme(
    sc: Scenario,
    scheme: str,
    *,
    bmf_optimize_all: bool = False,
    random_seed: int = 0,
) -> SimResult:
    """Plan + execute one scheme on one scenario.

    This is the shared round engine: `RepairSimulator.run` wraps it for the
    legacy single-scenario path and the reference's sweep calls it per
    (scenario, scheme) work item. Results are a pure function of
    (scenario, scheme, bmf_optimize_all, random_seed) — only
    `planning_time` is wall-clock and may vary between runs.
    """
    jobs = sc.make_jobs()
    plan_clock = 0.0

    tic = _time.perf_counter()
    if scheme == "ppt":
        tree = build_ppt_tree(jobs[0], sc.bw.matrix_at(0.0))
        plan_clock += _time.perf_counter() - tic
        t_end = execute_pipeline(tree, 0.0, sc.bw, sc.ingress, sc.chunk_mb)
        return SimResult(
            scheme=scheme, total_time=t_end, round_times=[t_end],
            planning_time=plan_clock, plan=None,
            log=[f"ppt tree edges={tree.edges}"],
        )
    plan = plan_for_scheme(scheme, jobs, random_seed=random_seed)
    plan_clock += _time.perf_counter() - tic

    validate_plan(
        plan, max_recv_per_round=len(jobs[0].helpers)
        if scheme == "traditional" else 1,
    )

    use_bmf = scheme in ("bmf", "msrepair", "bmf_static")
    static_plan_time = scheme == "bmf_static"
    t = 0.0
    round_times: list[float] = []
    relay_hops = 0
    log: list[str] = []
    executed_rounds: list[Round] = []
    for rnd in plan.rounds:
        if use_bmf:
            tic = _time.perf_counter()
            bw_now = sc.bw.matrix_at(0.0 if static_plan_time else t)
            idle = [
                x for x in _idle_pool(sc, jobs)
                if x not in rnd.nodes_in_use()
            ]
            rnd, stats = bmf.optimize_round(
                rnd, bw_now, idle, sc.chunk_mb,
                optimize_all=bmf_optimize_all,
            )
            plan_clock += _time.perf_counter() - tic
            relay_hops += sum(len(tr.relays) for tr in rnd.transfers)
            if stats.improved_links:
                log.append(
                    f"t={t:.2f}s round {len(round_times)}: BMF rerouted "
                    f"{stats.improved_links} link(s), est -{stats.time_saved:.2f}s"
                )
        t_end = execute_round(rnd.transfers, t, sc.bw, sc.ingress, sc.chunk_mb)
        round_times.append(t_end - t)
        t = t_end
        executed_rounds.append(rnd)

    final_plan = RepairPlan(jobs=plan.jobs, rounds=executed_rounds, meta=plan.meta)
    return SimResult(
        scheme=scheme, total_time=t, round_times=round_times,
        planning_time=plan_clock, plan=final_plan, relay_hops=relay_hops,
        log=log,
    )


class RepairSimulator:
    """Single-scenario façade over `run_scheme` (the legacy public API)."""

    SINGLE_SCHEMES = SINGLE_SCHEMES
    MULTI_SCHEMES = MULTI_SCHEMES

    def __init__(self, scenario: Scenario, *, bmf_optimize_all: bool = False,
                 random_seed: int = 0):
        self.sc = scenario
        self.bmf_optimize_all = bmf_optimize_all
        self.random_seed = random_seed

    def run(self, scheme: str) -> SimResult:
        return run_scheme(
            self.sc, scheme,
            bmf_optimize_all=self.bmf_optimize_all,
            random_seed=self.random_seed,
        )
