"""Carry state from the JAX package's objects into the port's.

The state the two packages share is the stripe bytes, the RS generator
(a pure function of (n, k), rebuilt identically by `ec.rs`) and the repair
plans, and a train state's leaves. `plan_from_reference` reads a
reference `RepairPlan` and `plan_arrays_from_reference` a reference
compiled `PlanArrays`, both by attribute; `state_from_reference` and
`state_to_numpy` carry a train state through host numpy arrays
(duck-typed: this module imports nothing of the reference package).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import tree
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


def state_from_reference(jax_state_as_numpy, device=None) -> dict:
    """A JAX package state as host numpy arrays (nested dicts, e.g.
    `jax.tree.map(np.asarray, state)`) -> the same nested dict of tensors
    on `device` (`None` = the card). bfloat16 arrays (ml_dtypes) carry
    their bits through `uint16` views, so nothing here needs ml_dtypes."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.array(a, order="C")            # a writable copy, 0-d kept
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16)).view(
                torch.bfloat16).to(dev)
        return torch.from_numpy(a).to(dev)

    return tree.map(leaf, jax_state_as_numpy)


def state_to_numpy(state) -> dict:
    """A nested dict of tensors -> host numpy arrays of the same structure;
    a bfloat16 tensor comes back as its bits in a `uint16` array
    (`.view(ml_dtypes.bfloat16)` on the caller's side restores the type)."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.uint16)
        return t.numpy()

    return tree.map(leaf, state)
