"""MSRepair (paper Algorithm 2) + multi-node baselines (m-PPR, random).

Multi-node repair with node sets (paper eqs. 1-3):
  RP = failed/requestor nodes, R = intersection of all helper sets,
  NR = union of helper sets minus R.
Per round, transfers are chosen greedily scanning the priority classes
  {R,R} > {R,NR} > {NR,RP} > {NR,NR} > {R,RP} > {NR,R}
(sender-set, receiver-set), under one-role-per-node-per-round. A transfer
is *useful* iff the receiver already holds a fragment of the same job (XOR
merge) or is the job's requestor. Tie-break inside a class drains the most-
loaded sender first (nodes holding fragments of several jobs are future
bottlenecks), then lowest (job, src, dst) for determinism — this reproduces
the paper's Table II 3-round schedule for RS(7,4), see tests.

Helper selection follows the paper: maximize |NR| (spread helper sets as
disjointly as the survivor count allows).

Since the array-native planner layer landed, this module is a thin object
facade: the schedulers themselves live in
`repro_torch.core.engine.planner_arrays` (bitmask state, tuple transfers) and
are shared with the vectorized engine's `PlanArrays` path; the functions
here only wrap the tuple schedules back into `Round`/`Transfer` objects.
The facade output is pinned bit-identical to the historical object walk
by the reference package's msrepair and planner-array tests, and the port
is held to the reference by `tests/test_torch_planners.py`.
"""
from __future__ import annotations

from repro_torch.core.engine import planner_arrays as _pa
from repro_torch.core.plan import Job, RepairPlan, Round, Transfer
from repro_torch.core.ppr import ppr_rounds


# ----------------------------------------------------------- helper selection
def select_helpers_multi(
    n: int, k: int, failed: list[int], *, extra_busy: set[int] | None = None
) -> list[tuple[int, ...]]:
    """Pick k helpers per failed node, maximizing |NR| (minimal overlap)."""
    survivors = [x for x in range(n) if x not in failed and x not in (extra_busy or set())]
    if len(survivors) < k:
        raise ValueError("not enough survivors to repair")
    jobs = len(failed)
    picks: list[list[int]] = [[] for _ in range(jobs)]
    # Round-robin over survivors: consecutive jobs take distinct nodes first,
    # so overlap only appears once survivors run out — this maximizes |NR|.
    idx = 0
    for _ in range(k):
        for j in range(jobs):
            # next survivor not already picked by this job
            for step in range(len(survivors)):
                cand = survivors[(idx + step) % len(survivors)]
                if cand not in picks[j]:
                    picks[j].append(cand)
                    idx = (idx + step + 1) % len(survivors)
                    break
            else:
                raise ValueError("helper selection failed")
    return [tuple(sorted(p)) for p in picks]


def node_sets(jobs: list[Job]) -> tuple[set[int], set[int], set[int]]:
    """(R, NR, RP) per paper eqs. (1)-(3)."""
    helper_sets = [set(j.helpers) for j in jobs]
    r: set[int] = set.intersection(*helper_sets) if helper_sets else set()
    nr: set[int] = set.union(*helper_sets) - r if helper_sets else set()
    rp = {j.requestor for j in jobs}
    return r, nr, rp


# ------------------------------------------------------------------ MSRepair
_PRIORITY = _pa._PRIORITY


def _to_rounds(sched: _pa.Sched) -> list[Round]:
    """Wrap a tuple schedule back into the object plan IR."""
    from repro_torch.core.engine.arrays import _mask_terms

    return [
        Round(transfers=[
            Transfer(src=src, dst=dst, job=job_id, terms=_mask_terms(mask))
            for src, dst, job_id, mask in rnd
        ])
        for rnd in sched
    ]


def msrepair_rounds(jobs: list[Job], *, max_rounds: int = 64) -> list[Round]:
    return _to_rounds(_pa.msrepair_schedule(jobs, max_rounds=max_rounds))


def plan_msrepair(jobs: list[Job]) -> RepairPlan:
    return RepairPlan(jobs=jobs, rounds=msrepair_rounds(jobs), meta={"scheme": "msrepair"})


# --------------------------------------------------------------------- m-PPR
def plan_mppr(jobs: list[Job]) -> RepairPlan:
    """m-PPR (Mitra et al.): reconstruction jobs effectively serialize —
    each failed block runs its PPR schedule back-to-back (paper Fig. 5 /
    Table II: 2x2=4 rounds for RS(6,3), 3+3=6 for RS(7,4))."""
    rounds: list[Round] = []
    for job in jobs:
        rounds.extend(ppr_rounds(job))
    return RepairPlan(jobs=jobs, rounds=rounds, meta={"scheme": "m-ppr"})


# -------------------------------------------------------------------- random
def plan_random(jobs: list[Job], *, seed: int = 0, max_rounds: int = 256) -> RepairPlan:
    """Random scheduling baseline: each round greedily packs uniformly-random
    useful transfers (ignoring the priority classes). Round draws come
    from a counter-based rng keyed on `(seed, round)` — see
    `repro_torch.core.engine.planner_arrays.RANDOM_SCHEDULE_VERSION`."""
    rounds = _to_rounds(
        _pa.random_schedule(jobs, seed=seed, max_rounds=max_rounds))
    return RepairPlan(jobs=jobs, rounds=rounds, meta={"scheme": "random"})
