"""Array-native planner layer: batched BMF path search + tuple schedulers.

Two families live here, both pinned bit-identical to the object planners:

* **Batched BMF (paper Algorithm 1).** `find_min_time_paths_batch`
  re-expresses `repro_torch.core.bmf.find_min_time_path`'s pruned DFS as
  vectorized candidate-path enumeration over a bounded relay depth: hop
  times `chunk_mb / bw` become a `(B, N, N)` tensor, every src→relays→dst
  combination up to `max_relays` is priced in one broadcast sum, and a
  single `argmin` over the candidates — laid out in the DFS's exact
  pre-order, so ties break identically — reroutes the bottleneck transfer
  of *every* case in a batch at once. Exactness beyond the depth bound is
  certified by a min-plus Bellman-Ford sweep over the idle subgraph (with
  positive hop times the optimal relay route is a shortest simple path);
  the rare case whose optimum is deeper than the bound falls back to the
  scalar DFS. `optimize_round_batch` wraps the search in Algorithm 1's
  monitor-and-replan loop (bottleneck argmax, avail-mask bookkeeping,
  optional optimize-all pass), operating directly on the engine's
  `(B, T, H)` hop arrays — this is what lets `engine.vectorized` replan
  every round *inside* the batched stepper instead of dropping to
  per-case Python.

* **Tuple schedulers.** `msrepair_schedule` / `random_schedule` /
  `ppr_schedule` / `traditional_schedule` re-implement the round planners
  on uint-style term bitmasks (plain Python ints, so node ids >= 64 still
  work) and `(src, dst, job, mask)` tuples — no `Transfer`/`Round`/
  `FragmentState` allocation on the hot path. MSRepair's per-pick
  candidate recomputation collapses to one sorted scan per priority
  class: a commit only mutates holdings at nodes that just became busy,
  so the remaining candidates' keys, order and usefulness are unchanged
  (the random scheduler's within-round draw sequence survives the same
  way — filtering the snapshot equals recomputing it; across rounds its
  rng is counter-keyed on `(seed, round)`, see
  `RANDOM_SCHEDULE_VERSION`). `repro_torch.core.msrepair` is a thin object
  facade over these. `plan_arrays_for_scheme` lowers a schedule straight
  to `PlanArrays` for the vectorized engine.

This module is host numpy code, as in the JAX package: plans must equal
the reference's to the last hop (`tests/test_torch_planner_arrays.py`).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.bmf import find_min_time_path
from repro_torch.core.engine.arrays import (PlanArrays,
                                            UnsupportedPlanError,
                                            plan_arrays_from_schedule)
from repro_torch.core.plan import Job

# one transfer tuple: (src, dst, job_id, terms_mask)
Sched = list[list[tuple[int, int, int, int]]]


def hop_time_stack(bw_stack: np.ndarray, chunk_mb: np.ndarray) -> np.ndarray:
    """`(B, N, N)` per-hop transfer times: chunk_mb / bw, inf where bw <= 0
    (matching `bmf.path_time`'s unreachable-hop semantics)."""
    B, N, _ = bw_stack.shape
    w = np.full((B, N, N), np.inf)
    np.divide(chunk_mb[:, None, None], bw_stack, out=w, where=bw_stack > 0)
    return w


def batched_path_times(
    hop_u: np.ndarray,          # (B, T, H) int
    hop_v: np.ndarray,          # (B, T, H) int
    n_hops: np.ndarray,         # (B, T) int — 0 marks padding
    w: np.ndarray,              # (B, N, N) hop times
) -> np.ndarray:
    """Per-transfer path times (B, T); padding transfers get -inf so they
    never win the bottleneck argmax. Hop times add left-to-right, the same
    association order as `bmf.path_time`."""
    B, T, H = hop_u.shape
    bi = np.arange(B)[:, None, None]
    hw = w[bi, hop_u, hop_v]
    valid = np.arange(H)[None, None, :] < n_hops[:, :, None]
    times = np.where(valid, hw, 0.0).sum(axis=2)
    return np.where(n_hops > 0, times, -np.inf)


# ----------------------------------------------------- batched path search
def find_min_time_paths_batch(
    src: np.ndarray,            # (B,) int
    dst: np.ndarray,            # (B,) int
    avail: np.ndarray,          # (B, N) bool — usable idle nodes
    w: np.ndarray,              # (B, N, N) hop times
    bound: np.ndarray,          # (B,) float
    *,
    bw_stack: np.ndarray | None = None,   # for the scalar DFS fallback
    chunk_mb: np.ndarray | None = None,
    max_relays: int = 3,
) -> tuple[list[tuple[int, ...]], np.ndarray, np.ndarray]:
    """Batched twin of `bmf.find_min_time_path` — exact, including ties.

    Enumerates every relay route up to `max_relays` deep as one broadcast
    cost tensor and takes a first-wins `argmin` whose flattened order is
    the DFS pre-order (hop-to-dst before extending, relays in ascending
    idle order), so equal-cost routes resolve to the same path the scalar
    search returns. A converged min-plus Bellman-Ford over the idle
    subgraph certifies the depth bound: positive hop times make the
    optimum a shortest simple path, so if the converged distance beats the
    bounded enumeration a deeper route exists and that case falls back to
    the scalar DFS (`bw_stack`/`chunk_mb` must then be provided).

    Returns `(paths, times, improved)`; non-improved cases report the
    direct path and `min(bound, direct)`, mirroring the DFS contract.
    """
    B, N, _ = w.shape
    bidx = np.arange(B)
    avail = avail.copy()
    avail[bidx, src] = False
    avail[bidx, dst] = False
    counts = avail.sum(axis=1)
    direct = w[bidx, src, dst]
    cap = np.minimum(bound, direct)
    M = int(counts.max()) if B else 0

    def _direct(b):
        return (int(src[b]), int(dst[b]))

    if M == 0:
        return ([_direct(b) for b in range(B)], cap.copy(),
                np.zeros(B, dtype=bool))

    # available node ids, ascending, padded to M; every hop touching a
    # padding slot costs inf so no route can pass through one
    order = np.argsort(~avail, axis=1, kind="stable")
    idle = order[:, :M]
    valid = np.arange(M)[None, :] < counts[:, None]
    bi = bidx[:, None]
    A = np.where(valid, w[bi, src[:, None], idle], np.inf)   # src -> relay
    C = np.where(valid, w[bi, idle, dst[:, None]], np.inf)   # relay -> dst
    B2 = np.where(valid[:, :, None] & valid[:, None, :],
                  w[bi[:, :, None], idle[:, :, None], idle[:, None, :]],
                  np.inf)

    # Candidate tensor indexed (q1, q2, q3), q = 0 meaning "stop here",
    # q >= 1 meaning relay idle[q - 1]. Flattened C-order == DFS pre-order:
    # direct, (r0), (r0,r1), (r0,r1,r2), ..., (r1), ... Invalid slots
    # (repeats, stop-then-relay) stay inf and can never win the argmin.
    if max_relays > 3:
        raise ValueError("max_relays > 3 not supported by the enumerator")
    Q = M + 1
    cand = np.full((B, Q, Q, Q), np.inf)
    cand[:, 0, 0, 0] = direct
    d1 = A + C
    cand[:, 1:, 0, 0] = d1
    best2 = np.minimum(direct, d1.min(axis=1))
    minw = w.min(axis=(1, 2))
    if max_relays >= 2 and M >= 2:
        d2 = (A[:, :, None] + B2) + C[:, None, :]
        d2[:, np.eye(M, dtype=bool)] = np.inf
        cand[:, 1:, 1:, 0] = d2
        best2 = np.minimum(best2, d2.min(axis=(1, 2)))
    # depth 3 is the expensive block (M^3 candidates) — price it only for
    # cases where a 3-relay route (>= 4 hops, each >= the cheapest hop)
    # could still beat *or tie* the depth-<=2 optimum and the caller's
    # bound (<=, not <: on an exact tie the DFS pre-order may prefer the
    # deeper route, so it must be enumerated)
    if max_relays >= 3 and M >= 3:
        rows = np.nonzero((counts >= 3)
                          & (4.0 * minw <= np.minimum(best2, cap)))[0]
        if rows.size:
            Ar, Br, Cr = A[rows], B2[rows], C[rows]
            d3 = (((Ar[:, :, None, None] + Br[:, :, :, None])
                   + Br[:, None, :, :]) + Cr[:, None, None, :])
            ii = np.arange(M)
            rep = ((ii[:, None, None] == ii[None, :, None])
                   | (ii[None, :, None] == ii[None, None, :])
                   | (ii[:, None, None] == ii[None, None, :]))
            d3[:, rep] = np.inf
            cand[rows, 1:, 1:, 1:] = d3
    flat = cand.reshape(B, -1)
    best = flat.argmin(axis=1)
    btime = flat[bidx, best]

    # Exactness certificate. Cheap bound first: a route deeper than 3
    # relays has >= 5 hops, each costing at least the case's cheapest hop,
    # so when 5 * min(w) cannot beat the enumerated optimum no deeper
    # route can either. Only cases failing that bound (and with enough
    # idle nodes to even form one) pay for the Bellman-Ford sweep —
    # converged min-plus shortest distances through the idle subgraph,
    # with the same left-to-right hop-sum association as the enumeration.
    target = np.minimum(btime, cap)
    suspect = (counts > max_relays) & ((max_relays + 2.0) * minw <= target)
    deeper = np.zeros(B, dtype=bool)
    if suspect.any():
        sus = np.nonzero(suspect)[0]
        ws = w[sus]
        av = avail[sus]
        dist = ws[np.arange(sus.size), src[sus]].copy()
        for _ in range(N):
            du = np.where(av, dist, np.inf)
            nd = np.minimum(dist, (du[:, :, None] + ws).min(axis=1))
            if np.array_equal(nd, dist):
                break
            dist = nd
        deeper[sus] = dist[np.arange(sus.size), dst[sus]] < target[sus]

    improved = btime < cap
    paths: list[tuple[int, ...]] = []
    times = np.where(improved, btime, cap)
    for b in range(B):
        if deeper[b]:
            if bw_stack is None or chunk_mb is None:
                raise ValueError(
                    "optimum deeper than max_relays and no bw_stack/chunk_mb "
                    "given for the scalar fallback")
            idle_list = [int(x) for x in np.nonzero(avail[b])[0]]
            path, t = find_min_time_path(
                int(src[b]), int(dst[b]), idle_list, bw_stack[b],
                float(chunk_mb[b]), float(bound[b]))
            paths.append(path)
            times[b] = t
            improved[b] = t < cap[b] and path != _direct(b)
            continue
        if not improved[b]:
            paths.append(_direct(b))
            continue
        q, rest = divmod(int(best[b]), Q * Q)
        q2, q3 = divmod(rest, Q)
        relays = tuple(int(idle[b, qq - 1]) for qq in (q, q2, q3) if qq > 0)
        paths.append((int(src[b]), *relays, int(dst[b])))
    return paths, times, improved


# ------------------------------------------------------ batched Algorithm 1
@dataclasses.dataclass
class BatchBMFStats:
    """Per-case `bmf.BMFStats` twin, accumulated in commit order so the
    `time_saved` floats match the scalar loop exactly."""

    iterations: np.ndarray
    improved_links: np.ndarray
    time_saved: np.ndarray
    time_saved_bottleneck: np.ndarray
    time_saved_extra: np.ndarray


def _set_path(hop_u, hop_v, n_hops, b, t, path):
    """Write `path`'s hops into row (b, t), widening H if needed."""
    nh = len(path) - 1
    H = hop_u.shape[2]
    if nh > H:
        pad = ((0, 0), (0, 0), (0, nh - H))
        hop_u = np.pad(hop_u, pad)
        hop_v = np.pad(hop_v, pad)
    hop_u[b, t, :nh] = path[:-1]
    hop_v[b, t, :nh] = path[1:]
    hop_u[b, t, nh:] = 0
    hop_v[b, t, nh:] = 0
    n_hops[b, t] = nh
    return hop_u, hop_v


def optimize_round_batch(
    hop_u: np.ndarray,          # (B, T, H) int
    hop_v: np.ndarray,          # (B, T, H) int
    n_hops: np.ndarray,         # (B, T) int — 0 marks padding
    bw_stack: np.ndarray,       # (B, N, N)
    chunk_mb: np.ndarray,       # (B,)
    avail: np.ndarray,          # (B, N) bool — mutated in place
    *,
    optimize_all: bool = False,
    max_iters: int = 64,
) -> tuple[np.ndarray, np.ndarray, BatchBMFStats,
           list[tuple[int, int, tuple[int, ...]]]]:
    """Algorithm 1 (BMFRepair) on one round of a whole batch of cases.

    The scalar loop's structure is kept case for case — bottleneck argmax
    (first max wins, like `max(key=...)`), reroute on strict improvement
    only, avail shrinks and never returns — but each iteration reroutes
    the bottleneck of *every still-improving case* with one batched path
    search. Returns the (possibly widened) hop arrays, per-case stats and
    the `(case, round_row, path)` splices applied, for write-back into
    each case's `PlanArrays`.
    """
    B, T, _ = hop_u.shape
    stats = BatchBMFStats(*(np.zeros(B, dtype=np.int64) for _ in range(2)),
                          *(np.zeros(B) for _ in range(3)))
    changed: list[tuple[int, int, tuple[int, ...]]] = []
    if T == 0:
        return hop_u, hop_v, stats, changed
    w = hop_time_stack(bw_stack, chunk_mb)
    times = batched_path_times(hop_u, hop_v, n_hops, w)
    active = (n_hops > 0).any(axis=1)

    def commit(b, t, path, saved, extra):
        nonlocal hop_u, hop_v
        hop_u, hop_v = _set_path(hop_u, hop_v, n_hops, b, t, path)
        for relay in path[1:-1]:
            avail[b, relay] = False
        stats.improved_links[b] += 1
        stats.time_saved[b] += saved
        if extra:
            stats.time_saved_extra[b] += saved
        else:
            stats.time_saved_bottleneck[b] += saved
        changed.append((b, t, path))

    for _ in range(max_iters):
        idx = np.nonzero(active)[0]
        if not idx.size:
            break
        stats.iterations[idx] += 1
        worst = times[idx].argmax(axis=1)
        wt = times[idx, worst]
        src = hop_u[idx, worst, 0]
        dst = hop_v[idx, worst, n_hops[idx, worst] - 1]
        paths, ptimes, improved = find_min_time_paths_batch(
            src, dst, avail[idx], w[idx], wt,
            bw_stack=bw_stack[idx], chunk_mb=chunk_mb[idx])
        for j, b in enumerate(idx):
            if not improved[j]:
                active[b] = False     # bottleneck can't improve -> exit
                continue
            commit(int(b), int(worst[j]), paths[j],
                   float(wt[j]) - float(ptimes[j]), extra=False)
            times[b, worst[j]] = ptimes[j]

    if optimize_all:   # beyond-paper pass, batched by descending-time rank
        rank_order = np.argsort(-times, axis=1, kind="stable")
        arange_b = np.arange(B)
        for rank in range(T):
            tr = rank_order[:, rank]
            idx = np.nonzero(n_hops[arange_b, tr] > 0)[0]
            if not idx.size:
                continue
            tj = tr[idx]
            cur = times[idx, tj]
            src = hop_u[idx, tj, 0]
            dst = hop_v[idx, tj, n_hops[idx, tj] - 1]
            paths, ptimes, improved = find_min_time_paths_batch(
                src, dst, avail[idx], w[idx], cur,
                bw_stack=bw_stack[idx], chunk_mb=chunk_mb[idx])
            for j, b in enumerate(idx):
                if improved[j]:
                    commit(int(b), int(tj[j]), paths[j],
                           float(cur[j]) - float(ptimes[j]), extra=True)
                    times[b, tj[j]] = ptimes[j]

    return hop_u, hop_v, stats, changed


# --------------------------------------------------------- tuple schedulers
def _terms_mask_any(ids) -> int:
    """Term bitmask as an unbounded Python int (ids >= 64 allowed — only
    the `PlanArrays` lowering requires uint64)."""
    mask = 0
    for x in ids:
        mask |= 1 << int(x)
    return mask


def traditional_schedule(job: Job) -> Sched:
    """Star repair: every helper streams straight to the requestor."""
    return [[(h, job.requestor, job.job_id, 1 << h) for h in job.helpers]]


# binomial-tree transfer pattern per helper count k, over *positions*
# 0..k (0 = requestor): rounds of (src_pos, dst_pos, term_positions).
# Structural — independent of node ids — so it is computed once per k.
_PPR_PATTERNS: dict[int, list[list[tuple[int, int, tuple[int, ...]]]]] = {}


def _ppr_pattern(k: int) -> list[list[tuple[int, int, tuple[int, ...]]]]:
    pattern = _PPR_PATTERNS.get(k)
    if pattern is None:
        hold: dict[int, set[int]] = {p: {p} for p in range(1, k + 1)}
        pattern = []
        num_rounds = math.ceil(math.log2(k + 1)) if k > 0 else 0
        for t in range(1, num_rounds + 1):
            stride = 1 << (t - 1)
            rnd = []
            for i in range(stride, k + 1, 2 * stride):
                frag = hold.get(i)
                if not frag:
                    continue
                del hold[i]
                hold.setdefault(i - stride, set()).update(frag)
                rnd.append((i, i - stride, tuple(sorted(frag))))
            if rnd:
                pattern.append(rnd)
        assert hold.get(0, set()) == set(range(1, k + 1)), \
            "PPR schedule incomplete"
        _PPR_PATTERNS[k] = pattern
    return pattern


def ppr_schedule(job: Job) -> Sched:
    """PPR binomial-tree reduction (`repro_torch.core.ppr.ppr_rounds` twin):
    the cached position pattern for k helpers, mapped to this job's
    node ids."""
    nodes = (job.requestor, *job.helpers)
    bits = [0, *(1 << h for h in job.helpers)]
    out: Sched = []
    for rnd in _ppr_pattern(len(job.helpers)):
        out.append([
            (nodes[i], nodes[j],
             job.job_id, sum(bits[p] for p in terms))
            for i, j, terms in rnd
        ])
    return out


def mppr_schedule(jobs: list[Job]) -> Sched:
    """m-PPR: each job's PPR schedule back-to-back (jobs serialize)."""
    rounds: Sched = []
    for job in jobs:
        rounds.extend(ppr_schedule(job))
    return rounds


class _MaskState:
    """Bitmask twin of `plan.FragmentState`: per-job insertion-ordered
    `{node: terms_mask}` dicts (same order semantics as the dict-of-set
    walk: delete removes, first merge appends at the end) plus an
    incrementally maintained per-node load (number of jobs holding there,
    the MSRepair tie-break key)."""

    def __init__(self, jobs: list[Job]):
        self.jobs = jobs
        self.req = {j.job_id: j.requestor for j in jobs}
        self.full = {j.job_id: _terms_mask_any(j.helpers) for j in jobs}
        self.hold: dict[int, dict[int, int]] = {
            j.job_id: {h: 1 << h for h in j.helpers} for j in jobs
        }
        self.load: dict[int, int] = {}
        for j in jobs:
            for h in j.helpers:
                self.load[h] = self.load.get(h, 0) + 1

    def job_done(self, job_id: int) -> bool:
        return self.hold[job_id].get(self.req[job_id]) == self.full[job_id]

    def all_done(self) -> bool:
        return all(self.job_done(j.job_id) for j in self.jobs)

    def apply(self, job_id: int, src: int, dst: int) -> int:
        """Move src's whole holding to dst; returns the mask moved."""
        row = self.hold[job_id]
        mask = row.pop(src)
        self.load[src] -= 1
        if dst in row:
            row[dst] |= mask
        else:
            row[dst] = mask
            self.load[dst] = self.load.get(dst, 0) + 1
        return mask


def _node_class(jobs: list[Job]) -> dict[int, str]:
    """Node -> R/NR/RP classification (paper eqs. 1-3)."""
    helper_sets = [set(j.helpers) for j in jobs]
    r = set.intersection(*helper_sets) if helper_sets else set()
    nr = set.union(*helper_sets) - r if helper_sets else set()
    out: dict[int, str] = {}
    for x in nr:
        out[x] = "NR"
    for x in r:
        out[x] = "R"
    for j in jobs:       # RP wins, as in the object `set_of`
        out[j.requestor] = "RP"
    return out


_PRIORITY = (("R", "R"), ("R", "NR"), ("NR", "RP"), ("NR", "NR"),
             ("R", "RP"), ("NR", "R"))


def msrepair_schedule(jobs: list[Job], *, max_rounds: int = 64) -> Sched:
    """MSRepair (paper Algorithm 2) on bitmask state.

    Identical schedule to the historical object walk, but each priority
    class computes its candidate list *once*: a commit only touches
    holdings at the two nodes it marks busy, so the surviving candidates'
    sort keys (load, job, src, dst), usefulness and payload masks are
    exactly what a recompute would return — one sorted scan per class
    replaces the per-pick O(candidates) rebuild. (Candidate *enumeration*
    order is free here — the sort key is total — unlike
    `random_schedule`, which must preserve it.)
    """
    cls_of = _node_class(jobs)
    state = _MaskState(jobs)
    load = state.load
    rounds: Sched = []
    for _ in range(max_rounds):
        if state.all_done():
            break
        busy: set[int] = set()
        rnd: list[tuple[int, int, int, int]] = []
        for s_cls, d_cls in _PRIORITY:
            cands = []
            for job in jobs:
                job_id = job.job_id
                if state.job_done(job_id):
                    continue
                req = state.req[job_id]
                holders = state.hold[job_id]
                dsts = [d for d in (*holders, req)
                        if cls_of.get(d, "IDLE") == d_cls]
                if not dsts:
                    continue
                for src in holders:
                    if (src in busy or src == req
                            or cls_of.get(src, "IDLE") != s_cls):
                        continue
                    nload = -load[src]
                    cands.extend(
                        (nload, job_id, src, dst) for dst in dsts
                        if dst != src and dst not in busy
                        and (dst == req or dst in holders))
            cands.sort()
            for _, job_id, src, dst in cands:
                if src in busy or dst in busy or state.job_done(job_id):
                    continue
                mask = state.apply(job_id, src, dst)
                rnd.append((src, dst, job_id, mask))
                busy.update((src, dst))
        if not rnd:
            raise RuntimeError("MSRepair stalled — no feasible transfer")
        rounds.append(rnd)
    else:
        raise RuntimeError("MSRepair exceeded max_rounds")
    return rounds


def msrepair_schedule_batch(jobs_list: list[list[Job]],
                            *, max_rounds: int = 64) -> list[Sched]:
    """MSRepair for a whole batch of cases in lockstep array ops.

    One (B, J, N) uint64 holdings tensor carries every case's fragment
    state; each priority class prices all cases' candidates as one
    (B, J, N, N) mask with an integer key encoding the tuple scheduler's
    exact sort order ((-load, job, src, dst) — load frozen at class
    start), and the greedy commit scan picks each case's min-key valid
    candidate per iteration. Schedules are identical to
    `msrepair_schedule` case for case (the parity tests pin this); cases
    that don't fit the array form (node ids >= 64, or more jobs than
    helpers pad) fall back to the tuple scheduler individually.
    """
    B = len(jobs_list)
    out: list[Sched | None] = [None] * B
    ok: list[int] = []
    for i, jobs in enumerate(jobs_list):
        ids = [x for j in jobs for x in (j.requestor, *j.helpers)]
        if all(0 <= x < 64 for x in ids):
            ok.append(i)
        else:
            out[i] = msrepair_schedule(jobs_list[i], max_rounds=max_rounds)
    if not ok:
        return out

    Bk = len(ok)
    J = max(len(jobs_list[i]) for i in ok)
    N = max(x for i in ok for j in jobs_list[i]
            for x in (j.requestor, *j.helpers)) + 1
    hold = np.zeros((Bk, J, N), dtype=np.uint64)
    full = np.zeros((Bk, J), dtype=np.uint64)
    req = np.zeros((Bk, J), dtype=np.int64)
    job_valid = np.zeros((Bk, J), dtype=bool)
    job_ids = np.zeros((Bk, J), dtype=np.int64)
    # node class codes matching the tuple scheduler's R/NR/RP/IDLE
    CLS = {"R": 0, "NR": 1, "RP": 2, "IDLE": 3}
    cls = np.full((Bk, N), CLS["IDLE"], dtype=np.int8)
    for k, i in enumerate(ok):
        jobs = jobs_list[i]
        ncls = _node_class(jobs)
        for node, name in ncls.items():
            cls[k, node] = CLS[name]
        for j, job in enumerate(jobs):
            job_valid[k, j] = True
            job_ids[k, j] = job.job_id
            req[k, j] = job.requestor
            full[k, j] = _terms_mask_any(job.helpers)
            for h in job.helpers:
                hold[k, j, h] = np.uint64(1) << np.uint64(h)

    nodes = np.arange(N)
    not_self = ~np.eye(N, dtype=bool)
    is_req = nodes[None, None, :] == req[:, :, None]         # (B, J, N)
    scheds: list[list[list]] = [[] for _ in range(Bk)]
    bidx = np.arange(Bk)

    def done_jobs():
        at_req = np.take_along_axis(hold, req[:, :, None], axis=2)[:, :, 0]
        return (at_req == full) | ~job_valid

    for _ in range(max_rounds):
        done = done_jobs()
        active = ~done.all(axis=1)
        if not active.any():
            break
        busy = np.zeros((Bk, N), dtype=bool)
        rnd: list[list[list]] = [[] for _ in range(Bk)]
        for s_code, d_code in ((CLS[a], CLS[b]) for a, b in _PRIORITY):
            holds = hold != 0
            load = holds.sum(axis=1).astype(np.int64)        # (B, N)
            live_job = (~done & job_valid)[:, :, None]
            src_ok = (holds & live_job & ~is_req
                      & (cls[:, None, :] == s_code) & ~busy[:, None, :])
            dst_ok = ((holds | is_req) & live_job
                      & (cls[:, None, :] == d_code) & ~busy[:, None, :])
            cand = (src_ok[:, :, :, None] & dst_ok[:, :, None, :]
                    & not_self[None, None, :, :] & active[:, None, None, None])
            if not cand.any():
                continue
            # key encodes the tuple sort (-load[src], job, src, dst):
            # unique per (job, src, dst), so argmin is exactly the scan
            key = ((((J - load)[:, None, :, None] * J
                     + np.arange(J)[None, :, None, None]) * N
                    + nodes[None, None, :, None]) * N
                   + nodes[None, None, None, :])
            big_key = np.iinfo(np.int64).max
            fk = np.where(cand, key, big_key).reshape(Bk, -1)
            fk4 = fk.reshape(Bk, J, N, N)
            while True:
                pick = fk.argmin(axis=1)
                rows = np.nonzero(fk[bidx, pick] < big_key)[0]
                if not rows.size:
                    break
                pick = pick[rows]
                j, rem = np.divmod(pick, N * N)
                s, d = np.divmod(rem, N)
                moved = hold[rows, j, s]
                hold[rows, j, s] = 0
                hold[rows, j, d] |= moved
                busy[rows, s] = True
                busy[rows, d] = True
                for r, jj, ss, dd, mm in zip(rows, j, s, d, moved):
                    rnd[r].append((int(ss), int(dd),
                                   int(job_ids[r, jj]), int(mm)))
                # invalidate: newly-busy nodes, and jobs just completed
                nb = np.zeros((Bk, N), dtype=bool)
                nb[rows, s] = True
                nb[rows, d] = True
                np.copyto(fk4, big_key, where=nb[:, None, :, None])
                np.copyto(fk4, big_key, where=nb[:, None, None, :])
                now_done = np.take_along_axis(
                    hold[rows, j], req[rows, j][:, None], axis=1
                )[:, 0] == full[rows, j]
                if now_done.any():
                    dr = rows[now_done]
                    done[dr, j[now_done]] = True
                    jd = np.zeros((Bk, J), dtype=bool)
                    jd[dr, j[now_done]] = True
                    np.copyto(fk4, big_key, where=jd[:, :, None, None])
        committed = np.array([len(rnd[k]) > 0 for k in range(Bk)])
        if (active & ~committed).any():
            raise RuntimeError("MSRepair stalled — no feasible transfer")
        for k in np.nonzero(committed)[0]:
            scheds[k].append(rnd[k])
    else:
        if (~done_jobs().all(axis=1)).any():
            raise RuntimeError("MSRepair exceeded max_rounds")

    for k, i in enumerate(ok):
        out[i] = scheds[k]
    return out


# Version of the random-baseline schedule semantics. v1 drew every round
# from ONE shared `default_rng(seed)` stream and enumerated candidates in
# holdings-insertion order — draw r's value depended on every earlier
# round, so rounds (and cases) could never be scheduled independently.
# v2 keys each round's rng on the counter `(seed, round)` and enumerates
# candidates in sorted `(job, src, dst)` order: rounds are pure functions
# of `(seed, round, holdings)`, the exact property a lockstep batched
# scheduler (like `msrepair_schedule_batch`) needs. Schedules differ from
# v1 — `tests/test_planner_arrays.py` pins the v2 expectation explicitly.
RANDOM_SCHEDULE_VERSION = 2


def random_schedule(jobs: list[Job], *, seed: int = 0,
                    max_rounds: int = 256) -> Sched:
    """Random-baseline scheduler (v2 — see `RANDOM_SCHEDULE_VERSION`).

    Each round draws from a counter-based rng keyed on `(seed, round)`
    (the per-case seed comes in through `seed`), so a round's draws are
    independent of every other round and case. The candidate list is
    enumerated once per round in sorted `(job, src, dst)` order and
    filtered after each commit — a commit only invalidates candidates
    touching the two newly-busy nodes (and the job it may complete), so
    the filtered list matches a recompute element for element and the
    `rng.integers(len(cands))` draw sequence within the round is
    well-defined.
    """
    state = _MaskState(jobs)
    rounds: Sched = []
    for r in range(max_rounds):
        if state.all_done():
            break
        rng = np.random.default_rng(np.random.SeedSequence([seed, r]))
        busy: set[int] = set()
        rnd: list[tuple[int, int, int, int]] = []
        cands = []
        for job in jobs:
            job_id = job.job_id
            if state.job_done(job_id):
                continue
            req = state.req[job_id]
            holders = state.hold[job_id]
            dsts = (*holders, req)
            cands.extend(
                (job_id, src, dst)
                for src in holders if src != req
                for dst in dsts
                if dst != src and (dst == req or dst in holders))
        cands.sort()
        while cands:
            job_id, src, dst = cands[int(rng.integers(len(cands)))]
            mask = state.apply(job_id, src, dst)
            rnd.append((src, dst, job_id, mask))
            busy.update((src, dst))
            # only the two newly-busy nodes and (possibly) the committed
            # job's done-ness can invalidate surviving candidates
            drop_job = job_id if state.job_done(job_id) else None
            cands = [
                c for c in cands
                if c[1] != src and c[1] != dst and c[2] != src
                and c[2] != dst and c[0] != drop_job
            ]
        if not rnd:
            raise RuntimeError("random scheduler stalled")
        rounds.append(rnd)
    else:
        raise RuntimeError("random scheduler exceeded max_rounds")
    return rounds


# --------------------------------------------------------- PlanArrays exit
def schedule_for_scheme(scheme: str, jobs: list[Job], *,
                        random_seed: int = 0) -> tuple[list[Job], Sched, dict]:
    """Run `scheme`'s tuple scheduler: `(jobs_used, schedule, meta)`."""
    if scheme == "traditional":
        return jobs[:1], traditional_schedule(jobs[0]), \
            {"scheme": "traditional"}
    if scheme in ("ppr", "bmf", "bmf_static"):
        return jobs[:1], ppr_schedule(jobs[0]), {"scheme": "ppr"}
    if scheme == "mppr":
        return jobs, mppr_schedule(jobs), {"scheme": "m-ppr"}
    if scheme == "random":
        return jobs, random_schedule(jobs, seed=random_seed), \
            {"scheme": "random"}
    if scheme == "msrepair":
        return jobs, msrepair_schedule(jobs), {"scheme": "msrepair"}
    raise ValueError(f"unknown scheme {scheme!r}")


def plan_arrays_for_scheme(scheme: str, jobs: list[Job], *,
                           random_seed: int = 0) -> PlanArrays:
    """Plan `scheme` straight into `PlanArrays` (the vectorized engine's
    native input), bypassing object `RepairPlan` construction entirely.
    `decompile` of the result equals `simulator.plan_for_scheme`'s plan.
    Raises `UnsupportedPlanError` when term ids don't fit uint64 masks."""
    jobs, sched, meta = schedule_for_scheme(scheme, jobs,
                                            random_seed=random_seed)
    return plan_arrays_from_schedule(jobs, sched, meta)


def lower_schedules_batch(
    items: list[tuple[list[Job], Sched, dict]],
    *,
    max_recv_per_round=1,      # int, or one int per item (fan-in schemes)
) -> list[PlanArrays | None]:
    """Lower + validate a whole batch of schedules in one array pass.

    The per-case `plan_arrays_from_schedule` + `validate_plan_arrays`
    pair costs mostly numpy-call overhead at these plan sizes; here all
    cases' transfers (and jobs) are lowered through ONE concatenated
    array, each case's `PlanArrays` receiving views of the shared
    buffers, and role exclusivity is checked for the whole batch with
    three bincounts over (case, round, node) keys. Scheduler output is
    all-direct (relays are spliced in later by the in-stepper BMF), so
    the relay role checks are vacuous here; the per-case fragment walk
    runs on the shared python lists. A case that cannot be lowered
    (term ids >= 64) comes back as None; a case that fails validation
    raises the same `ValueError` the per-case path raises.
    """
    from repro_torch.core.engine.arrays import (_case_plan_arrays,
                                                _job_fields, _mask_terms)

    B = len(items)
    out: list[PlanArrays | None] = [None] * B
    ok: list[int] = []
    flats: list[list] = []
    for idx, (jobs, sched, meta) in enumerate(items):
        job_ids = {j.job_id for j in jobs}
        flat = [tr for rnd in sched for tr in rnd]
        if any(tr[3] >> 64 or tr[2] not in job_ids for tr in flat) or any(
                not 0 <= h < 64 for j in jobs for h in j.helpers):
            flats.append(None)
        else:
            ok.append(idx)
            flats.append(flat)
    if not ok:
        return out

    big = [tr for f in flats if f is not None for tr in f]
    tarr = np.array(big, dtype=np.uint64).reshape(len(big), 4)
    ints = tarr[:, :3].astype(np.int32)
    jobs_all = [j for i in ok for j in items[i][0]]
    jf = _job_fields(jobs_all)

    t_off = j_off = 0
    offsets = []
    for i in ok:
        jobs, sched, meta = items[i]
        flat = flats[i]
        nt, nj = len(flat), len(jobs)
        sl, jl = slice(t_off, t_off + nt), slice(j_off, j_off + nj)
        out[i] = _case_plan_arrays(
            jobs, sched, flat, meta,
            {k: v[jl] for k, v in jf.items()},
            ints[sl], tarr[sl, 3],
        )
        offsets.append((i, t_off, nt))
        t_off += nt
        j_off += nj

    # batched role exclusivity: one bincount per role over
    # (case-global round, node) keys; failures re-raise per case
    recv_lims = (max_recv_per_round if isinstance(max_recv_per_round, list)
                 else [max_recv_per_round] * B)
    n_max = max(out[i].num_nodes for i in ok)
    round_id = np.empty(t_off, dtype=np.int64)
    round_lim: list[int] = []
    base = 0
    for i, o, nt in offsets:
        sched = items[i][1]
        num_r = len(sched)
        round_id[o: o + nt] = base + np.repeat(
            np.arange(num_r, dtype=np.int64),
            [len(rnd) for rnd in sched])
        round_lim.extend([recv_lims[i]] * num_r)
        base += num_r
    size = base * n_max
    send_c = np.bincount(round_id * n_max + ints[:, 0], minlength=size)
    recv_c = np.bincount(round_id * n_max + ints[:, 1], minlength=size)
    recv_over = recv_c > np.repeat(np.array(round_lim, dtype=np.int64),
                                   n_max)
    if ((send_c > 1).any() or recv_over.any()
            or ((send_c > 0) & (recv_c > 0)).any()):
        from repro_torch.core.engine.arrays import validate_plan_arrays

        for i in ok:   # slow path: find the culprit, raise its error
            validate_plan_arrays(out[i], max_recv_per_round=recv_lims[i])

    # fragment walk per case over the shared python lists
    srcs = ints[:, 0].tolist()
    dsts = ints[:, 1].tolist()
    terms = tarr[:, 3].tolist()
    for i, o, nt in offsets:
        pa = out[i]
        jobs = items[i][0]
        hold = [{h: 1 << h for h in j.helpers} for j in jobs]
        jidx = pa.t_job_idx.tolist()
        for k in range(nt):
            j, s, d, sent = jidx[k], srcs[o + k], dsts[o + k], terms[o + k]
            row = hold[j]
            held = row.get(s, 0)
            if held == 0 or held != sent:
                raise ValueError(
                    f"transfer {s}->{d} (job {int(pa.t_job[k])}) sends "
                    f"terms not matching src holding "
                    f"(held={sorted(_mask_terms(held))}, "
                    f"sent={sorted(_mask_terms(sent))})")
            row[s] = 0
            have = row.get(d, 0)
            if have & sent:
                raise ValueError(
                    f"duplicate terms arriving at node {d}: "
                    f"{sorted(_mask_terms(have & sent))}")
            row[d] = have | sent
        for j, job in enumerate(jobs):
            if hold[j].get(job.requestor, 0) != _terms_mask_any(job.helpers):
                raise ValueError("plan does not complete all jobs")
    return out
