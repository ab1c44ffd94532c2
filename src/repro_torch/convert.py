"""Carry state from the JAX package's objects into the port's.

The state the two packages share is the stripe bytes, the RS generator
(a pure function of (n, k), rebuilt identically by `ec.rs`) and the repair
plans. `plan_from_reference` reads a reference `RepairPlan` and
`plan_arrays_from_reference` a reference compiled `PlanArrays`, both by
attribute (duck-typed: this module imports nothing of the reference
package).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.engine.arrays import PlanArrays
from repro_torch.core.plan import Job, RepairPlan, Round, Transfer
from repro_torch.device import resolve_device


def plan_from_reference(plan) -> RepairPlan:
    """Rebuild a reference `RepairPlan` (anything with `.jobs`, `.rounds[]
    .transfers[]` and `.meta`) as the port's `RepairPlan`."""
    jobs = [Job(job_id=int(j.job_id), failed_node=int(j.failed_node),
                requestor=int(j.requestor),
                helpers=tuple(int(h) for h in j.helpers))
            for j in plan.jobs]
    rounds = [Round(transfers=[
        Transfer(src=int(t.src), dst=int(t.dst), job=int(t.job),
                 terms=frozenset(int(x) for x in t.terms),
                 path=tuple(int(x) for x in t.path))
        for t in rnd.transfers]) for rnd in plan.rounds]
    return RepairPlan(jobs=jobs, rounds=rounds, meta=dict(plan.meta))


def plan_arrays_from_reference(pa) -> PlanArrays:
    """Rebuild a reference `PlanArrays` as the port's: every field array
    copied (numpy, same dtypes), `num_nodes` and `meta` carried over."""
    fields = {}
    for f in dataclasses.fields(PlanArrays):
        value = getattr(pa, f.name)
        if isinstance(value, np.ndarray):
            value = value.copy()
        elif f.name == "meta":
            value = dict(value)
        else:
            value = int(value)
        fields[f.name] = value
    return PlanArrays(**fields)


def codeword_to_device(np_codeword: np.ndarray, device=None) -> torch.Tensor:
    """(n, nbytes) uint8 numpy stripe -> uint8 tensor on `device`
    (`None` = the card; raises without one)."""
    cw = np.ascontiguousarray(np_codeword, dtype=np.uint8)
    if cw.ndim != 2:
        raise ValueError(f"codeword must be (n, nbytes), got {cw.shape}")
    return torch.from_numpy(cw).to(resolve_device(device))
