"""Batched vectorized round/pipeline engine over `PlanArrays`.

This is the array-native twin of `repro_torch.core.simulator`: instead of one
Python event loop per scenario, a whole *batch* of scenarios advances
together through masked `(B, ...)` state arrays. Every case still takes
exactly the event steps it would take alone — each case has its own
`dt`, epoch boundary and completion mask — so per-case results match the
object engine (same float ops in the same order — bit-identical in
practice; the parity tests pin 1e-6 relative); only the bookkeeping
between events is vectorized:

* fan-in contention groups become a stable sort + segment reductions
  (`np.maximum.reduceat`) instead of per-receiver dict building, with
  Dirichlet share vectors (`IngressModel.share_weights`) memoized per
  (case, receiver, fan-in) across the whole batch instead of redrawn
  every event;
* PPT's recursive `supply_rate` becomes an iterative topological
  min-scan over edge-depth levels (`np.minimum.at` scatters);
* epoch flips refresh a per-case `(B, N, N)` bandwidth stack only when a
  case actually crosses its epoch boundary.

Planning is array-native too (`repro_torch.core.engine.planner_arrays`): each
case's schedule is lowered straight to `PlanArrays` (no object plan on
the hot path), and the per-round BMF re-optimization — the paper's
"monitor + replan every timestamp" logic — runs *inside* the stepper as
`optimize_round_batch`: one batched candidate-path enumeration over the
live `(B, N, N)` bandwidth stack reroutes the bottleneck transfer of
every case at once, splicing the relayed paths back into the compiled
plans in place. The `(B, ...)` layout is the seam a device stepper
plugs into: both execution *and* replanning are array math over static
shapes, and `repro_torch.core.engine.device_stepper` exploits exactly
that — `run_work_vectorized(backend="device")` swaps the numpy event
loops for float64 event-loop kernels on the card while this module
keeps owning the host-side orchestration (planning, the per-round BMF
monitor-and-replan step, result bookkeeping).

The numpy steppers here stay numpy on the host, as in the JAX package:
they are the yardstick the device stepper is held against, and the host
route for the batches the device stepper declines (non-persistent
ingress shares, epoch stacks past its memory cap, a capped horizon).
`device_stepper.COUNTS` counts the batches that took each route;
`repro_torch.tracing` times the search, replan, stepping and conversion
spans of the repair path.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import time as _time

import numpy as np

from repro_torch import tracing
from repro_torch.core.engine.arrays import PlanArrays, decompile, splice_path
from repro_torch.core.engine.planner_arrays import (lower_schedules_batch,
                                                    msrepair_schedule_batch,
                                                    optimize_round_batch,
                                                    schedule_for_scheme)
from repro_torch.core.ppt import build_ppt_tree
from repro_torch.core.simulator import (Scenario, SimResult,
                                        pipeline_fill_latency, run_scheme)

_EPS = 1e-9
_GUARD = 100_000


# ------------------------------------------------------------ batch context
class _BatchBandwidth:
    """Per-case `(B, N, N)` bandwidth stack, refreshed on epoch crossings.

    `BandwidthTrace` cases (the bulk `sample_epochs` recordings from
    `TraceSuite.freeze`) index the recorded epoch stack directly;
    everything else goes through `matrix_at`, whose per-instance epoch
    memo is shared with the object engine and across a case's schemes.
    Either way a case's matrix is reloaded only when its own epoch
    boundary passes — between epochs the stack row is reused as-is.
    """

    _DENSE_LIMIT_BYTES = 128 * 1024 * 1024
    # build the dense all-trace gather stack only once this many crossings
    # per case have been served — batches that barely touch their traces
    # never pay the full (B, Emax, N, N) prefill copy, while churn-heavy
    # runs (the stress suites) amortize it almost immediately
    _DENSE_AFTER_CROSSINGS = 2

    def __init__(self, bwps, num_nodes: int):
        from repro_torch.core.bandwidth import BandwidthTrace

        self.bwps = list(bwps)
        b = len(self.bwps)
        self.num_nodes = num_nodes
        self.stack = np.zeros((b, num_nodes, num_nodes), dtype=float)
        self.epoch = np.zeros(b, dtype=np.int64)
        self.epoch_end = np.full(b, -np.inf)
        # per-case prefetch block for live processes: (start_epoch, stack)
        self._live_block: list = [None] * b
        # per-case serving recipe: (interval, epochs, num_epochs, cycle)
        # for traces, None for everything served through matrix_at
        self._trace = [
            (bwp.change_interval, bwp.epochs, bwp.num_epochs, bwp.cycle)
            if type(bwp) is BandwidthTrace else None
            for bwp in self.bwps
        ]
        self._dense = None
        self._crossings = 0
        self._dense_ok = (
            b > 0 and all(tr is not None for tr in self._trace)
            and (b * max(tr[2] for tr in self._trace)
                 * num_nodes * num_nodes * 8) <= self._DENSE_LIMIT_BYTES
        )

    def _build_dense(self) -> None:
        """All-trace batches get a padded (B, Emax, N, N) stack so a whole
        refresh is one fancy gather instead of a per-case python loop."""
        b = len(self.bwps)
        emax = max(tr[2] for tr in self._trace)
        dense = np.zeros((b, emax, self.num_nodes, self.num_nodes))
        for i, (_, epochs, num_e, _) in enumerate(self._trace):
            n = epochs.shape[1]
            dense[i, :num_e, :n, :n] = epochs
        self._dense = dense
        self._interval = np.array([tr[0] for tr in self._trace])
        self._num_epochs = np.array([tr[2] for tr in self._trace])
        self._cycle = np.array([tr[3] for tr in self._trace])

    def refresh(self, t: np.ndarray, active: np.ndarray) -> None:
        """Reload matrices for active cases whose epoch boundary passed."""
        crossed = active & (t >= self.epoch_end)
        if self._dense is not None:
            rows = np.nonzero(crossed)[0]
            if rows.size:
                # floor of true division == BandwidthTrace.epoch_of
                # (floor(t / i), NOT t // i — float floordiv is fmod-based
                # and can differ by one epoch at exact-multiple boundaries)
                e = np.floor(t[rows] / self._interval[rows]).astype(np.int64)
                idx = np.where(self._cycle[rows], e % self._num_epochs[rows],
                               np.minimum(e, self._num_epochs[rows] - 1))
                self.stack[rows] = self._dense[rows, idx]
                self.epoch[rows] = e
                self.epoch_end[rows] = (e + 1) * self._interval[rows]
            return
        if self._dense_ok:
            self._crossings += int(crossed.sum())
            if self._crossings > self._DENSE_AFTER_CROSSINGS * len(self.bwps):
                self._build_dense()
                self.refresh(t, active)
                return
        for b in np.nonzero(crossed)[0]:
            tb = float(t[b])
            trace = self._trace[b]
            if trace is not None:
                interval, epochs, num_epochs, cycle = trace
                e = math.floor(tb / interval)   # == epoch_of(tb)
                self.epoch[b] = e
                self.epoch_end[b] = (e + 1) * interval
                self.stack[b] = epochs[e % num_epochs if cycle
                                       else min(e, num_epochs - 1)]
            else:
                bwp = self.bwps[b]
                interval = bwp.change_interval
                if interval is None:
                    self.epoch[b] = 0
                    self.epoch_end[b] = np.inf
                    self.stack[b] = bwp.matrix_at(tb)
                    continue
                e = bwp.epoch_of(tb)
                self.epoch[b] = e
                self.epoch_end[b] = (e + 1) * interval
                # serve from the process's aligned epoch block (one
                # vectorized `sample_epochs` per block, memoized on the
                # process instance — bit-identical to `matrix_at`, minus
                # the per-epoch wrapper overhead, shared across schemes)
                blk = self._live_block[b]
                if blk is None or not blk[0] <= e < blk[0] + blk[1].shape[0]:
                    blk = bwp.epochs_block(e)
                    self._live_block[b] = blk
                self.stack[b] = blk[1][e - blk[0]]


def _group_structure(
    b_idx: np.ndarray,
    recv: np.ndarray,
    epoch: np.ndarray,
    num_nodes: int,
    ingresses,
    degrade: np.ndarray,
    floor: np.ndarray,
    wcache: dict,
):
    """Precompute the fan-in grouping of concurrent (case, link) pairs.

    Returns None when every receiver has a single sender (m = 1
    degenerates to the standalone rate), else the sort order, segment
    starts, per-pair Dirichlet shares and per-group degradation factors.
    Reusable across event steps for as long as the *set* of concurrent
    pairs is unchanged (rates then vary only through the bandwidth
    matrices) and shares are persistent.
    """
    n = b_idx.size
    key = b_idx * num_nodes + recv
    order = np.argsort(key, kind="stable")
    skey = key[order]
    boundary = np.empty(n, dtype=bool)
    boundary[0] = True
    np.not_equal(skey[1:], skey[:-1], out=boundary[1:])
    starts = np.nonzero(boundary)[0]
    if starts.size == n:
        return None
    counts = np.diff(np.append(starts, n))
    gkey = skey[starts]
    gb = gkey // num_nodes
    factor = np.maximum(floor[gb], 1.0 - degrade[gb] * (counts - 1))

    w = np.ones(n)
    reusable = True
    for gi in np.nonzero(counts > 1)[0]:
        b, m = int(gb[gi]), int(counts[gi])
        v = int(gkey[gi]) % num_nodes
        ing = ingresses[b]
        if ing.persistent_shares:
            ck = (b, v, m)
        else:
            ck = (b, v, m, int(epoch[b]))
            reusable = False     # shares re-drawn per epoch: don't reuse
        ww = wcache.get(ck)
        if ww is None:
            ww = ing.share_weights(m, v, int(epoch[b]))
            wcache[ck] = ww
        w[starts[gi]: starts[gi] + m] = ww
    return order, starts, counts, factor, w, reusable


def _contended_rates_grouped(structure, standalone: np.ndarray) -> np.ndarray:
    """Apply a precomputed fan-in grouping to current standalone rates.

    Same arithmetic as `IngressModel.effective_rates` per group:
    cap = max(group) * factor(m), eff = min(standalone, share * cap).
    """
    if structure is None:
        return standalone
    order, starts, counts, factor, w, _ = structure
    sval = standalone[order]
    cap = np.maximum.reduceat(sval, starts) * factor
    eff = np.empty(sval.size)
    eff[order] = np.minimum(sval, w * np.repeat(cap, counts))
    return eff


# ------------------------------------------------------------- round engine
def execute_round_batch(
    hop_u: np.ndarray,           # (B, T, H) int, -1 padded
    hop_v: np.ndarray,           # (B, T, H) int
    n_hops: np.ndarray,          # (B, T) int — 0 marks padding transfers
    t0: np.ndarray,              # (B,) float
    bb: _BatchBandwidth,
    ingresses,
    chunk_mb: np.ndarray,        # (B,) float
    wcache: dict,
    degrade: np.ndarray,
    floor: np.ndarray,
) -> np.ndarray:
    """Advance every case until all its round transfers complete.

    The masked-array twin of `simulator.execute_round`: one iteration =
    one event (hop completion or epoch flip) *per active case*, all cases
    stepping concurrently, each by its own `dt`.
    """
    B, T, _ = hop_u.shape
    num_nodes = bb.stack.shape[1]
    t = np.asarray(t0, dtype=float).copy()
    if T == 0:
        return t
    hop_i = np.zeros((B, T), dtype=np.int64)
    left = np.broadcast_to(chunk_mb[:, None], (B, T)).copy()
    chunk_col = chunk_mb[:, None]
    eps_chunk = _EPS * chunk_col
    done = (hop_i >= n_hops).all(axis=1)
    iters = 0
    rates = np.zeros((B, T))
    cand = np.empty((B, T))
    # the (case, transfer) -> current-hop structure only changes when a hop
    # completes; between completions (i.e. across pure epoch-flip events)
    # the fan-in grouping and Dirichlet shares are reused as-is
    pairs_dirty = True
    act = bi = ti = u = v = structure = None

    while not done.all():
        iters += 1
        if iters > _GUARD:
            raise RuntimeError("simulator failed to converge")
        bb.refresh(t, ~done)
        if pairs_dirty:
            act = (hop_i < n_hops) & ~done[:, None]
            bi, ti = np.nonzero(act)         # row-major: per-case transfer order
            h = hop_i[bi, ti]
            u = hop_u[bi, ti, h]
            v = hop_v[bi, ti, h]
            structure = _group_structure(
                bi, v, bb.epoch, num_nodes, ingresses, degrade, floor, wcache)
            # non-persistent shares are epoch-keyed: rebuild every event
            pairs_dirty = structure is not None and not structure[5]
        eff = _contended_rates_grouped(structure, bb.stack[bi, u, v])
        rates.fill(0.0)
        rates[bi, ti] = np.maximum(eff, 0.0)

        cand.fill(np.inf)
        np.divide(left, rates, out=cand, where=act & (rates > 0))
        dt = np.minimum(bb.epoch_end - t, cand.min(axis=1))
        dt[~np.isfinite(dt) | (dt <= 0)] = _EPS
        dt[done] = 0.0

        rates *= dt[:, None]
        np.subtract(left, rates, out=left, where=act)
        t += dt
        compl = act & (left <= eps_chunk)
        if compl.any():
            hop_i += compl
            np.copyto(left, chunk_col, where=compl)
            done = (hop_i >= n_hops).all(axis=1)
            pairs_dirty = True
    return t


def _gather_all_rounds(
    arrays: list[PlanArrays],
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad every plan's rounds into (B, R, T, H) hop tensors, one pass.

    A plan with fewer than R rounds contributes all-padding rows for the
    missing rounds — batches mix round counts, and cases whose plan is
    exhausted just sit out the remaining rounds (their transfers are
    masked everywhere). Padding hops index node 0 so fancy-indexing
    stays in bounds; they are masked out by n_hops == 0 / hop_i >=
    n_hops before any rate math.
    """
    B = len(arrays)
    R = max(pa.num_rounds for pa in arrays)
    T = max((int(np.diff(pa.round_start).max(initial=0))
             for pa in arrays), default=0)
    H = max(pa.t_path.shape[1] - 1 for pa in arrays)
    hop_u = np.zeros((B, R, max(T, 1), max(H, 1)), dtype=np.int64)
    hop_v = np.zeros_like(hop_u)
    n_hops = np.zeros((B, R, max(T, 1)), dtype=np.int64)
    for b, pa in enumerate(arrays):
        nt = pa.num_transfers
        if not nt:
            continue
        starts = pa.round_start
        counts = np.diff(starts)
        rid = np.repeat(np.arange(pa.num_rounds), counts)
        pos = np.arange(nt) - np.repeat(starts[:-1], counts)
        path = pa.t_path
        hw = path.shape[1] - 1
        hop_u[b, rid, pos, :hw] = path[:, :-1]
        hop_v[b, rid, pos, :hw] = path[:, 1:]
        n_hops[b, rid, pos] = pa.t_path_len - 1
    # lift the -1 path padding to node 0 in one pass over the batch
    np.maximum(hop_u, 0, out=hop_u)
    np.maximum(hop_v, 0, out=hop_v)
    return hop_u, hop_v, n_hops


# ---------------------------------------------------------- pipeline engine
@dataclasses.dataclass
class _PipelinePrep:
    tree: object
    t_start: float
    plan_clock: float


def execute_pipeline_batch(
    child: np.ndarray,           # (B, E) int — 0-padded, dead via left == 0
    parent: np.ndarray,          # (B, E) int
    depth: np.ndarray,           # (B, E) int — child-node depth, 0 on padding
    edge_valid: np.ndarray,      # (B, E) bool
    t0: np.ndarray,              # (B,) float
    bb: _BatchBandwidth,
    ingresses,
    chunk_mb: np.ndarray,        # (B,) float
    wcache: dict,
    degrade: np.ndarray,
    floor: np.ndarray,
    duplex: np.ndarray,          # (B,) float
) -> np.ndarray:
    """Masked-array twin of `simulator.execute_pipeline`'s event loop.

    The recursive `supply_rate` (slowest live edge in the subtree feeding
    each node) is an iterative topological min-scan: edges are processed
    by descending child depth, scattering each edge's effective rate into
    its parent's supply cell with `np.minimum.at`.
    """
    B, E = child.shape
    num_nodes = bb.stack.shape[1]
    t = np.asarray(t0, dtype=float).copy()
    left = np.where(edge_valid, chunk_mb[:, None], 0.0)
    live = left > _EPS * chunk_mb[:, None]
    iters = np.zeros(B, dtype=np.int64)
    dmax = int(depth.max()) if depth.size else 0
    # live-edge structure (fan-in groups, duplex factors) changes only
    # when an edge drains; reuse it across pure epoch-flip events
    edges_dirty = True
    bi = ei = c = p = structure = rx_dup = tx_dup = None

    while live.any():
        case_on = live.any(axis=1)
        iters[case_on] += 1
        if iters.max() > _GUARD:
            raise RuntimeError("pipeline simulation failed to converge")
        bb.refresh(t, case_on)

        if edges_dirty:
            bi, ei = np.nonzero(live)        # row-major: per-case edge order
            c = child[bi, ei]
            p = parent[bi, ei]
            # rx fan-in contention at each parent; tx groups are singletons
            structure = _group_structure(
                bi, p, bb.epoch, num_nodes, ingresses, degrade, floor, wcache)
            has_rx = np.zeros((B, num_nodes), dtype=bool)
            has_rx[bi, p] = True
            has_tx = np.zeros((B, num_nodes), dtype=bool)
            has_tx[bi, c] = True
            rx_dup = np.where(has_tx[bi, p], duplex[bi], 1.0)
            tx_dup = np.where(has_rx[bi, c], duplex[bi], 1.0)
            edges_dirty = structure is not None and not structure[5]
        s = bb.stack[bi, c, p]
        rx_alloc = _contended_rates_grouped(structure, s) * rx_dup
        tx_alloc = s * tx_dup
        raw = np.minimum(np.maximum(rx_alloc, 0.0), np.maximum(tx_alloc, 0.0))
        raw_full = np.zeros((B, E))
        raw_full[bi, ei] = raw

        # iterative topological min-scan, deepest edges first
        node_supply = np.full((B, num_nodes), np.inf)
        eff_edge = raw_full.copy()
        for d in range(dmax, 0, -1):
            sel = live & (depth == d)
            if not sel.any():
                continue
            sb, se = np.nonzero(sel)
            val = np.minimum(raw_full[sb, se],
                             node_supply[sb, child[sb, se]])
            eff_edge[sb, se] = val
            np.minimum.at(node_supply, (sb, parent[sb, se]), val)
        rates = np.where(live, eff_edge, 0.0)

        cand = np.full((B, E), np.inf)
        np.divide(left, rates, out=cand, where=live & (rates > 0))
        dt = np.minimum(bb.epoch_end - t, cand.min(axis=1))
        dt = np.where(~np.isfinite(dt) | (dt <= 0), _EPS, dt)
        dt = np.where(case_on, dt, 0.0)

        left = np.where(live, left - rates * dt[:, None], left)
        t = t + dt
        new_live = left > _EPS * chunk_mb[:, None]
        if not np.array_equal(new_live, live):
            edges_dirty = True
        live = new_live
    return t


# ----------------------------------------------------------- batched scheme
def _ingress_params(scenarios):
    degrade = np.array([sc.ingress.degrade for sc in scenarios], dtype=float)
    floor = np.array([sc.ingress.floor for sc in scenarios], dtype=float)
    duplex = np.array([sc.ingress.duplex for sc in scenarios], dtype=float)
    return degrade, floor, duplex


def _chunk_array(scenarios) -> np.ndarray:
    # chunk_mb may arrive as python ints (benchmark grids use [8, 16, 32]);
    # the batched state math must stay float64
    return np.array([sc.chunk_mb for sc in scenarios], dtype=float)


def _run_ppt_batch(scenarios: list[Scenario],
                   engine_factory=None) -> list[SimResult]:
    B = len(scenarios)
    num_nodes = max(sc.num_nodes for sc in scenarios)
    preps: list[_PipelinePrep] = []
    for sc in scenarios:
        with tracing.span("plan.search"):
            tic = _time.perf_counter()
            tree = build_ppt_tree(sc.make_jobs()[0], sc.bw.matrix_at(0.0))
            plan_clock = _time.perf_counter() - tic
        t_start = pipeline_fill_latency(tree, sc.bw.matrix_at(0.0),
                                        sc.chunk_mb)
        preps.append(_PipelinePrep(tree=tree, t_start=t_start,
                                   plan_clock=plan_clock))

    E = max(len(p.tree.parent) for p in preps)
    child = np.zeros((B, E), dtype=np.int64)
    parent = np.zeros((B, E), dtype=np.int64)
    depth_arr = np.zeros((B, E), dtype=np.int64)
    edge_valid = np.zeros((B, E), dtype=bool)
    for b, p in enumerate(preps):
        depths = p.tree.depths()
        for e, (c, par) in enumerate(p.tree.parent.items()):
            child[b, e] = c
            parent[b, e] = par
            depth_arr[b, e] = depths[c]
            edge_valid[b, e] = True

    t0 = np.array([p.t_start for p in preps])
    t_end = None
    if engine_factory is not None:
        from repro_torch.core.engine import device_stepper

        engine = engine_factory(scenarios, num_nodes, parent, edge_valid)
        while engine is not None:       # grow the epoch horizon on overrun
            try:
                with tracing.span("plan.step"):
                    t_end = engine.execute(child, parent, depth_arr,
                                           edge_valid, t0)
                break
            except device_stepper.EpochHorizonError:
                engine = engine.grow()  # None once capped -> numpy fallback
        device_stepper.record_batch(on_device=t_end is not None)
    if t_end is None:
        bb = _BatchBandwidth([sc.bw for sc in scenarios], num_nodes)
        degrade, floor, duplex = _ingress_params(scenarios)
        chunk = _chunk_array(scenarios)
        with tracing.span("plan.step"):
            t_end = execute_pipeline_batch(
                child, parent, depth_arr, edge_valid, t0, bb,
                [sc.ingress for sc in scenarios], chunk, {}, degrade, floor,
                duplex,
            )
    return [
        SimResult(
            scheme="ppt", total_time=float(t_end[b]),
            round_times=[float(t_end[b])], planning_time=preps[b].plan_clock,
            plan=None, log=[f"ppt tree edges={preps[b].tree.edges}"],
        )
        for b in range(B)
    ]


def _run_rounds_batch(
    scenarios: list[Scenario],
    schemes: list[str],
    arrays: list[PlanArrays],
    plan_clocks: list[float],
    *,
    bmf_rows: np.ndarray,          # (B,) bool — rows with per-round replan
    static_plan_time: bool,
    bmf_optimize_all: bool,
    keep_plans: bool,
    engine_factory=None,
) -> list[SimResult]:
    """Retry wrapper around `_run_rounds_once`: a device engine whose
    pre-sampled epoch horizon overflows gets its horizon grown and the
    attempt re-runs from scratch — any BMF splices the aborted attempt
    wrote into the compiled plans are rolled back first, so the retry
    replans from the same pristine state (results are identical; only
    the wasted attempt's wall-clock differs). `engine.grow()` returns
    None once capped, which drops the batch to the numpy steppers."""
    num_nodes = max(max(sc.num_nodes, pa.num_nodes)
                    for sc, pa in zip(scenarios, arrays))
    kw = dict(bmf_rows=bmf_rows, static_plan_time=static_plan_time,
              bmf_optimize_all=bmf_optimize_all, keep_plans=keep_plans)
    if engine_factory is None:
        return _run_rounds_once(scenarios, schemes, arrays, plan_clocks,
                                num_nodes, None, **kw)
    from repro_torch.core.engine import device_stepper

    engine = engine_factory(scenarios, num_nodes, arrays)
    # rollback copies are only reachable through an engine's horizon
    # overflow — don't pay for them when the factory declined the batch
    snap = ([(pa.t_path.copy(), pa.t_path_len.copy(), pa.num_nodes)
             for pa in arrays]
            if engine is not None and bmf_rows.any() else None)
    while True:
        try:
            out = _run_rounds_once(scenarios, schemes, arrays, plan_clocks,
                                   num_nodes, engine, **kw)
            break
        except device_stepper.EpochHorizonError:
            if snap is not None:
                for pa, (tp, tl, nn) in zip(arrays, snap):
                    pa.t_path = tp.copy()
                    pa.t_path_len = tl.copy()
                    pa.num_nodes = nn
            engine = engine.grow()
    device_stepper.record_batch(on_device=engine is not None)
    return out


def _run_rounds_once(
    scenarios: list[Scenario],
    schemes: list[str],
    arrays: list[PlanArrays],
    plan_clocks: list[float],
    num_nodes: int,
    engine,                        # device round engine, or None for numpy
    *,
    bmf_rows: np.ndarray,
    static_plan_time: bool,
    bmf_optimize_all: bool,
    keep_plans: bool,
) -> list[SimResult]:
    B = len(scenarios)
    rounds_of = [pa.num_rounds for pa in arrays]

    t = np.zeros(B)
    relay_hops = np.zeros(B, dtype=np.int64)
    logs: list[list[str]] = [[] for _ in range(B)]
    plan_clock = np.array(plan_clocks)
    hop_all_u, hop_all_v, n_hops_all = _gather_all_rounds(arrays)
    R = hop_all_u.shape[1]
    rt = np.zeros((R, B))
    brows = np.nonzero(bmf_rows)[0]

    if engine is not None and not brows.size:
        # no per-round replanning: the whole plan runs as one device
        # scan over the round axis instead of R host round-trips (and
        # none of the numpy batch prep below is needed)
        with tracing.span("plan.step"):
            rt_all, t = engine.execute_rounds(hop_all_u, hop_all_v,
                                              n_hops_all, t)
        rt[:] = rt_all
        return _round_results(scenarios, schemes, arrays, rounds_of, t, rt,
                              plan_clock, relay_hops, logs, keep_plans)

    bb = _BatchBandwidth([sc.bw for sc in scenarios], num_nodes)
    degrade, floor, _ = _ingress_params(scenarios)
    ingresses = [sc.ingress for sc in scenarios]
    chunk = _chunk_array(scenarios)
    wcache: dict = {}

    bb_plan = bb
    idle_base = None
    if brows.size:
        # per-case idle pool: nodes outside every job's requestor/failed
        # set, limited to the case's own cluster (== simulator._idle_pool).
        # NOTE: built from the *scenario's* jobs, not the plan's — for
        # bmf/bmf_static the plan carries only the first job, but every
        # failed node must stay out of the relay pool.
        idle_base = np.zeros((brows.size, num_nodes), dtype=bool)
        for k, b in enumerate(brows):
            sc = scenarios[b]
            idle_base[k, : sc.num_nodes] = True
            for j in sc.make_jobs():
                idle_base[k, j.requestor] = False
                idle_base[k, j.failed_node] = False
        if static_plan_time:   # plan-once ablation: t=0 snapshot throughout
            bb_plan = _BatchBandwidth([sc.bw for sc in scenarios], num_nodes)
            bb_plan.refresh(np.zeros(B), np.ones(B, dtype=bool))

    for r in range(R):
        hop_u = hop_all_u[:, r]
        hop_v = hop_all_v[:, r]
        n_hops = n_hops_all[:, r]
        if brows.size:
            # in-stepper replan: one batched BMF pass reroutes every
            # replanning row's bottleneck transfers on the live stack
            with tracing.span("plan.replan"):
                tic = _time.perf_counter()
                if not static_plan_time:
                    bb_plan.refresh(t, bmf_rows)
                hu, hv, nh = hop_u[brows], hop_v[brows], n_hops[brows]
                H = hu.shape[2]
                valid = np.arange(H)[None, None, :] < nh[:, :, None]
                vb, vt, vh = np.nonzero(valid)
                used = np.zeros((brows.size, num_nodes), dtype=bool)
                used[vb, hu[vb, vt, vh]] = True
                used[vb, hv[vb, vt, vh]] = True
                avail = idle_base & ~used
                hu, hv, stats, spliced = optimize_round_batch(
                    hu, hv, nh, bb_plan.stack[brows], chunk[brows], avail,
                    optimize_all=bmf_optimize_all,
                )
                if hu.shape[2] > H:     # a relayed path outgrew the hop axis
                    pad = ((0, 0), (0, 0), (0, 0), (0, hu.shape[2] - H))
                    hop_all_u = np.pad(hop_all_u, pad)
                    hop_all_v = np.pad(hop_all_v, pad)
                    hop_u, hop_v = hop_all_u[:, r], hop_all_v[:, r]
                hop_u[brows] = hu
                hop_v[brows] = hv
                n_hops[brows] = nh
                # batched planning wall-clock is shared: charge each replan
                # row its share (keeps sweep-level planning totals honest)
                plan_clock[brows] += (_time.perf_counter() - tic) / brows.size
            relay_hops[brows] += np.where(nh > 0, nh - 1, 0).sum(axis=1)
            for k in np.nonzero(stats.improved_links)[0]:
                b = brows[k]
                logs[b].append(
                    f"t={float(t[b]):.2f}s round {r}: BMF rerouted "
                    f"{int(stats.improved_links[k])} link(s), "
                    f"est -{float(stats.time_saved[k]):.2f}s"
                )
            for k, row, path in spliced:
                pa = arrays[brows[k]]
                splice_path(pa, int(pa.round_start[r]) + row, path)
        with tracing.span("plan.step"):
            if engine is not None:
                t_end = engine.execute_round(hop_u, hop_v, n_hops, t)
            else:
                t_end = execute_round_batch(
                    hop_u, hop_v, n_hops, t, bb, ingresses, chunk,
                    wcache, degrade, floor,
                )
        rt[r] = t_end - t
        t = t_end

    return _round_results(scenarios, schemes, arrays, rounds_of, t, rt,
                          plan_clock, relay_hops, logs, keep_plans)


def _round_results(scenarios, schemes, arrays, rounds_of, t, rt, plan_clock,
                   relay_hops, logs, keep_plans) -> list[SimResult]:
    plans = [None] * len(arrays)
    if keep_plans:
        with tracing.span("plan.convert"):
            plans = [decompile(pa) for pa in arrays]
    return [
        SimResult(
            scheme=schemes[b], total_time=float(t[b]),
            round_times=rt[: rounds_of[b], b].tolist(),
            planning_time=float(plan_clock[b]),
            plan=plans[b],
            relay_hops=int(relay_hops[b]), log=logs[b],
        )
        for b in range(len(scenarios))
    ]


_BMF_SCHEMES = ("bmf", "msrepair", "bmf_static")


def run_work_vectorized(
    work: list[tuple[Scenario, str, int]],
    *,
    bmf_optimize_all: bool = False,
    keep_plans: bool = True,
    backend: str = "numpy",
    device=None,
) -> list[SimResult]:
    """Run `(scenario, scheme, seed)` work rows through the batched engine.

    This is the sweep engine's entry point: rows from *different schemes*
    share execution batches. Every row is planned straight into
    `PlanArrays` by the array-native planner layer — MSRepair rows
    through the lockstep batch scheduler, everything else per row — and
    all rows are lowered + validated in one array pass (no object plans,
    no compile step, no planner-input dedup). Rows then group by
    (cluster size, BMF replan mode): within a batch the steppers mask
    per-case round counts (a case whose plan is exhausted sits out the
    remaining rounds) and the per-round BMF re-optimization runs inside
    the stepper. PPT rows take the pipeline engine; a row whose plan
    cannot be lowered (term ids >= 64) falls back to the object engine.
    Results come back in input order and match `run_scheme` row for row
    (modulo wall-clock `planning_time`). `keep_plans=False` skips
    decompiling executed plans back to objects — the sweep default,
    since it strips plans anyway.

    `backend` picks the *execution* stepper: "numpy" (this module's
    masked-array loops) or "device"
    (`repro_torch.core.engine.device_stepper`'s torch float64 programs on
    `device`: `None` is the card, and raises without one; planning and
    the BMF replan host loop are unchanged). Batches the device stepper
    cannot take (non-persistent ingress shares, epoch stacks past its
    memory cap, a capped horizon) run on the numpy steppers and are
    counted in `device_stepper.COUNTS` (routing); `repro_torch.tracing`
    times the search, replan, stepping and conversions (the repair
    path's spans). Results are backend-independent either way. Only
    `backend="device"` reads `device`.
    """
    round_factory = ppt_factory = None
    if backend == "device":
        from repro_torch.core.engine import device_stepper
        from repro_torch.device import resolve_device

        dev = resolve_device(device)
        round_factory = functools.partial(device_stepper.make_round_engine,
                                          device=dev)
        ppt_factory = functools.partial(device_stepper.make_pipeline_engine,
                                        device=dev)
    elif backend == "jax":
        raise ValueError("backend 'jax' names the JAX package's stepper; "
                         "this package's device stepper is "
                         "backend='device'")
    elif backend != "numpy":
        raise ValueError(f"unknown backend {backend!r}")

    results: list[SimResult | None] = [None] * len(work)

    ppt_groups: dict[int, list[int]] = {}
    for i, (sc, scheme, _) in enumerate(work):
        if scheme == "ppt":
            ppt_groups.setdefault(sc.num_nodes, []).append(i)
    for idxs in ppt_groups.values():
        for i, r in zip(idxs, _run_ppt_batch([work[i][0] for i in idxs],
                                             engine_factory=ppt_factory)):
            results[i] = r

    rows = [i for i, (_, scheme, _) in enumerate(work) if scheme != "ppt"]
    items: dict[int, tuple] = {}
    clocks: dict[int, float] = {}
    recv_lims: dict[int, int] = {}
    ms_rows = [i for i in rows if work[i][1] == "msrepair"]
    if ms_rows:
        # true batched planning: all MSRepair rows in one lockstep pass
        jobs_list = [work[i][0].make_jobs() for i in ms_rows]
        with tracing.span("plan.search"):
            tic = _time.perf_counter()
            scheds = msrepair_schedule_batch(jobs_list)
            share = (_time.perf_counter() - tic) / len(ms_rows)
        for i, jobs, sched in zip(ms_rows, jobs_list, scheds):
            items[i] = (jobs, sched, {"scheme": "msrepair"})
            clocks[i] = share
            recv_lims[i] = 1
    for i in rows:
        if i in items:
            continue
        sc, scheme, seed = work[i]
        jobs = sc.make_jobs()
        recv_lims[i] = (len(jobs[0].helpers)
                        if scheme == "traditional" else 1)
        with tracing.span("plan.search"):
            tic = _time.perf_counter()
            items[i] = schedule_for_scheme(scheme, jobs, random_seed=seed)
            clocks[i] = _time.perf_counter() - tic

    with tracing.span("plan.convert"):
        pas = lower_schedules_batch(
            [items[i] for i in rows],
            max_recv_per_round=[recv_lims[i] for i in rows])
    prepared = {i: pa for i, pa in zip(rows, pas) if pa is not None}
    fallback = [i for i, pa in zip(rows, pas) if pa is None]

    # planning was batched across schemes above; execution batches are per
    # (cluster size, scheme): a scheme's cases share event structure, while
    # mixing schemes with very different event counts (star fan-in vs tree
    # rounds) would make short rows pay for the longest row's lockstep
    groups: dict[tuple, list[int]] = {}
    for i in prepared:
        groups.setdefault((work[i][0].num_nodes, work[i][1]), []).append(i)
    for (_, scheme), idxs in groups.items():
        static = scheme == "bmf_static"
        sims = _run_rounds_batch(
            [work[i][0] for i in idxs],
            [work[i][1] for i in idxs],
            [prepared[i] for i in idxs],
            [clocks[i] for i in idxs],
            bmf_rows=np.array([work[i][1] in _BMF_SCHEMES for i in idxs]),
            static_plan_time=static,
            bmf_optimize_all=bmf_optimize_all,
            keep_plans=keep_plans,
            engine_factory=round_factory,
        )
        for i, r in zip(idxs, sims):
            results[i] = r
    for i in fallback:
        sc, scheme, seed = work[i]
        r = run_scheme(sc, scheme,
                       bmf_optimize_all=bmf_optimize_all, random_seed=seed)
        results[i] = r if keep_plans else dataclasses.replace(r, plan=None)
    return results


def run_scheme_vectorized(
    scenarios: list[Scenario],
    scheme: str,
    *,
    seeds: list[int] | None = None,
    bmf_optimize_all: bool = False,
    keep_plans: bool = True,
    backend: str = "numpy",
    device=None,
) -> list[SimResult]:
    """Batched `run_scheme` for one scheme: see `run_work_vectorized`."""
    seeds = list(seeds) if seeds is not None else [0] * len(scenarios)
    if len(seeds) != len(scenarios):
        raise ValueError("seeds must match scenarios")
    return run_work_vectorized(
        [(sc, scheme, seed) for sc, seed in zip(scenarios, seeds)],
        bmf_optimize_all=bmf_optimize_all, keep_plans=keep_plans,
        backend=backend, device=device,
    )
