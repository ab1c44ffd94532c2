"""The comparison that decides `correct`, run once the window has closed.

Every pool stripe's data is made again from the seed and its parity
computed by the plain reference (`reference.py`); the port's pool (its
encode's output) and the restored blocks of a sample of the window's
repairs, drawn from the seed, are compared with them byte for byte.
Each number compared has its limit; all comparisons are exact.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from portbench import inputs, reference
from portbench.traffic import SAMPLE, STRIPES


@dataclasses.dataclass
class Job:
    stripe: int                 # pool stripe
    lost: int                   # lost block position in its codeword
    restored: object            # (nbytes,) uint8 tensor the data plane gave


class Reservoir:
    """A uniform sample, drawn from the seed, of the jobs offered to it."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng(np.random.SeedSequence([seed, SAMPLE]))
        self.jobs: list[Job] = []
        self.offered = 0

    def offer(self, job: Job) -> None:
        if len(self.jobs) < self.size:
            self.jobs.append(job)
        else:
            slot = int(self.rng.integers(self.offered + 1))
            if slot < self.size:
                self.jobs[slot] = job
        self.offered += 1


# each number's upper limit
LIMITS = {
    "restored_bytes_wrong": 0,      # most bytes wrong in a sampled restored block
    "restored_blocks_wrong": 0,     # sampled restored blocks with any byte wrong
    "parity_bytes_wrong": 0,        # bytes of the pool's parity unlike the reference's
    "data_bytes_wrong": 0,          # bytes of the pool's data unlike the inputs
}
# each number's lower limit: a run that checked nothing fails
LEAST = {"restored_blocks_checked": 1}


def compare(pool, jobs: list[Job], n: int, k: int, seed: int,
            lost_most: int) -> dict[str, dict]:
    """Each number compared, beside its limit."""
    wrong = dict.fromkeys(LIMITS, 0)
    for s, codeword in enumerate(pool):
        data = inputs.stripe_data(seed, STRIPES, s, k, codeword.shape[-1],
                                  codeword.device)
        want = list(data) + reference.encode_parity(n, k, data)
        for i in range(k):
            wrong["data_bytes_wrong"] += reference.bytes_differing(codeword[i], want[i])
        for i in range(k, n):
            wrong["parity_bytes_wrong"] += reference.bytes_differing(codeword[i], want[i])
        for job in jobs:
            if job.stripe == s:
                bad = reference.bytes_differing(job.restored, want[job.lost])
                wrong["restored_bytes_wrong"] = max(wrong["restored_bytes_wrong"], bad)
                wrong["restored_blocks_wrong"] += bad > 0
        del data, want
    out = {name: dict(value=int(wrong[name]), limit=limit)
           for name, limit in LIMITS.items()}
    # a stripe never loses more than n - k blocks
    out["blocks_lost_most"] = dict(value=lost_most, limit=n - k)
    out["restored_blocks_checked"] = dict(
        value=len(jobs), limit=LEAST["restored_blocks_checked"], at_least=True)
    return out


def within(check: dict) -> bool:
    if check.get("at_least"):
        return check["value"] >= check["limit"]
    return check["value"] <= check["limit"]
