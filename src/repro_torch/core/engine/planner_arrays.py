"""Tuple schedulers of the array-native planner layer (scalar part).

`msrepair_schedule` / `random_schedule` / `ppr_schedule` /
`traditional_schedule` implement the round planners on term bitmasks
(plain Python ints, so node ids >= 64 still work) and
`(src, dst, job, mask)` tuples — no `Transfer`/`Round`/`FragmentState`
allocation on the hot path. MSRepair's per-pick candidate recomputation
collapses to one sorted scan per priority class: a commit only mutates
holdings at nodes that just became busy, so the remaining candidates' keys,
order and usefulness are unchanged (the random scheduler's within-round
draw sequence survives the same way — filtering the snapshot equals
recomputing it; across rounds its rng is counter-keyed on `(seed, round)`,
see `RANDOM_SCHEDULE_VERSION`). `repro_torch.core.msrepair` is a thin
object facade over these.

The reference's batched half of this module (`find_min_time_paths_batch`,
`optimize_round_batch`, `msrepair_schedule_batch`, `lower_schedules_batch`,
`plan_arrays_for_scheme`) needs the `PlanArrays` IR and is not ported yet.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core.plan import Job

# one transfer tuple: (src, dst, job_id, terms_mask)
Sched = list[list[tuple[int, int, int, int]]]


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
    """PPR binomial-tree reduction (`repro.core.ppr.ppr_rounds` twin):
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


# Version of the random-baseline schedule semantics. v1 drew every round
# from ONE shared `default_rng(seed)` stream and enumerated candidates in
# holdings-insertion order — draw r's value depended on every earlier
# round, so rounds (and cases) could never be scheduled independently.
# v2 keys each round's rng on the counter `(seed, round)` and enumerates
# candidates in sorted `(job, src, dst)` order: rounds are pure functions
# of `(seed, round, holdings)`, the exact property a lockstep batched
# scheduler (like the reference's `msrepair_schedule_batch`) needs.
# Schedules differ from v1; the reference's planner-array tests pin v2.
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
