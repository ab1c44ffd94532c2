"""Bytes the repair's two kernels need, counted from a batch's plans.

The counts come from what the plans ask for, not from a kernel's grid,
so a roofline reads the same work whatever implements it: every input
row read once and every output row written once.

* Premultiply (`gf256_scale_bytes`): each job's helper blocks are read
  once and their scaled copies written once.
* Fold (`xor_reduce_groups_words`, one launch a round): per round, the
  sources of its transfers are consumed first (store and forward); then
  each (job, destination) group reads its arriving rows and, when the
  destination still holds a buffer, that row too, and writes the
  destination row once.

A plan is anything with the port's `PlanArrays` fields: `job_helpers`,
`job_helpers_len`, `t_src`, `t_dst`, `t_job_idx` and `round_start`.
"""
from __future__ import annotations

from collections import Counter


def scale_bytes(plans, nbytes: int) -> int:
    rows = sum(int(x) for pa in plans for x in pa.job_helpers_len)
    return 2 * rows * nbytes


def fold_rows(pa) -> list[tuple[int, int]]:
    """(rows read, rows written) of each round of one plan."""
    held = {(j, int(h)) for j in range(len(pa.job_helpers_len))
            for h in pa.job_helpers[j, :int(pa.job_helpers_len[j])]}
    out = []
    for r in range(len(pa.round_start) - 1):
        lo, hi = int(pa.round_start[r]), int(pa.round_start[r + 1])
        jobs = [int(x) for x in pa.t_job_idx[lo:hi]]
        srcs = [(j, int(s)) for j, s in zip(jobs, pa.t_src[lo:hi])]
        dsts = [(j, int(d)) for j, d in zip(jobs, pa.t_dst[lo:hi])]
        held.difference_update(srcs)
        arrivals = Counter(dsts)
        read = sum(arrivals.values()) + sum(dst in held for dst in arrivals)
        held.update(arrivals)
        out.append((read, len(arrivals)))
    return out


def fold_bytes(plans, nbytes: int) -> int:
    return nbytes * sum(read + written for pa in plans
                        for read, written in fold_rows(pa))
