"""PPR — Partial Parallel Repair (Mitra et al., EuroSys'16) round structure.

Single-node repair: helpers h_1..h_k each locally compute c_i (*) B_i; the
partial results combine down a binomial reduction tree rooted at the
requestor r. ceil(log2(k+1)) rounds; each node sends/receives at most once
per round (paper Fig. 4: RS(6,3) -> ts1: D2->D1, P1->D3; ts2: D3->D1).

`traditional` (baseline in Fig. 9): all k helpers stream to r concurrently
in one star round — fan-in contention makes it slow (paper Fig. 2).
"""
from __future__ import annotations

import math

from repro_torch.core.plan import FragmentState, Job, RepairPlan, Round, Transfer


def ppr_rounds(job: Job) -> list[Round]:
    """Binomial-tree reduction over positions [r, h1, ..., hk]."""
    k = len(job.helpers)
    nodes = [job.requestor, *job.helpers]          # position -> node id
    state = FragmentState([job])
    rounds: list[Round] = []
    num_rounds = math.ceil(math.log2(k + 1)) if k > 0 else 0
    for t in range(1, num_rounds + 1):
        stride = 1 << (t - 1)
        rnd = Round()
        for i in range(stride, k + 1, 2 * stride):
            src_pos, dst_pos = i, i - stride
            src, dst = nodes[src_pos], nodes[dst_pos]
            frag = state.fragment_at(job.job_id, src)
            if frag is None:
                continue
            tr = Transfer(src=src, dst=dst, job=job.job_id, terms=frag)
            state.apply(tr)
            rnd.transfers.append(tr)
        if rnd.transfers:
            rounds.append(rnd)
    assert state.job_done(job.job_id), "PPR schedule incomplete"
    return rounds


def plan_ppr(job: Job) -> RepairPlan:
    return RepairPlan(jobs=[job], rounds=ppr_rounds(job), meta={"scheme": "ppr"})


def plan_traditional(job: Job) -> RepairPlan:
    """Star repair: every helper sends its term straight to the requestor."""
    rnd = Round(
        transfers=[
            Transfer(src=h, dst=job.requestor, job=job.job_id, terms=frozenset({h}))
            for h in job.helpers
        ]
    )
    return RepairPlan(jobs=[job], rounds=[rnd], meta={"scheme": "traditional"})
