"""Repair-plan IR shared by all schedulers, the optimizer and the simulator.

A repair of failed blocks {f_j} proceeds in *rounds* ("timestamps" in the
paper). Each round holds parallel `Transfer`s; a transfer moves one
chunk-sized payload (RS linear aggregation keeps payloads block-sized) along
`path` — direct (len 2) or store-and-forward relayed through idle nodes
(len > 2, the BMF multi-level forwarding). `terms` records which helper
terms (c_i (*) B_i) are XOR-folded into the payload, enabling symbolic
verification and the real byte data-plane execution (`core/executor.py`).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict


@dataclasses.dataclass
class Transfer:
    src: int
    dst: int
    job: int                       # index into the failed-node list
    terms: frozenset[int]          # helper node ids folded into the payload
    path: tuple[int, ...] = ()     # full route; () or (src, dst) = direct

    def __post_init__(self):
        if not self.path:
            self.path = (self.src, self.dst)
        assert self.path[0] == self.src and self.path[-1] == self.dst
        assert len(set(self.path)) == len(self.path), "cyclic path"

    @property
    def relays(self) -> tuple[int, ...]:
        return self.path[1:-1]


@dataclasses.dataclass
class Round:
    transfers: list[Transfer] = dataclasses.field(default_factory=list)

    def nodes_in_use(self) -> set[int]:
        used: set[int] = set()
        for t in self.transfers:
            used.update(t.path)
        return used


@dataclasses.dataclass
class Job:
    """One failed block: its requestor (replacement node) and helper set."""

    job_id: int
    failed_node: int
    requestor: int
    helpers: tuple[int, ...]

    @property
    def full_terms(self) -> frozenset[int]:
        return frozenset(self.helpers)


@dataclasses.dataclass
class RepairPlan:
    jobs: list[Job]
    rounds: list[Round] = dataclasses.field(default_factory=list)
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def num_rounds(self) -> int:
        return len(self.rounds)

    def all_transfers(self) -> list[Transfer]:
        return [t for r in self.rounds for t in r.transfers]


# --------------------------------------------------------------- verification
class FragmentState:
    """Tracks which (job, node) holds which XOR-folded term sets."""

    def __init__(self, jobs: list[Job]):
        self.jobs = {j.job_id: j for j in jobs}
        # holdings[job][node] = set of terms folded together at that node
        self.holdings: dict[int, dict[int, set[int]]] = defaultdict(dict)
        for j in jobs:
            for h in j.helpers:
                self.holdings[j.job_id][h] = {h}

    def fragment_at(self, job: int, node: int) -> frozenset[int] | None:
        terms = self.holdings[job].get(node)
        return frozenset(terms) if terms else None

    def apply(self, t: Transfer) -> None:
        held = self.holdings[t.job].get(t.src)
        # Fragments are XOR-folded in place: a node holds at most one
        # fragment per job and must forward it whole (you cannot un-XOR).
        if held is None or set(t.terms) != held:
            raise ValueError(
                f"transfer {t} sends terms not matching src holding "
                f"(held={held}, sent={set(t.terms)})"
            )
        del self.holdings[t.job][t.src]
        dst_terms = self.holdings[t.job].setdefault(t.dst, set())
        if dst_terms & set(t.terms):
            raise ValueError(f"duplicate terms arriving at node {t.dst}: {t}")
        dst_terms.update(t.terms)

    def job_done(self, job_id: int) -> bool:
        j = self.jobs[job_id]
        return self.holdings[job_id].get(j.requestor) == set(j.full_terms)

    def all_done(self) -> bool:
        return all(self.job_done(j) for j in self.jobs)


# below this many transfers the object walk beats array compilation; the
# array fast path pays off on large (batched / machine-generated) plans
_FAST_VALIDATE_MIN_TRANSFERS = 64


def validate_plan(plan: RepairPlan, *, max_recv_per_round: int = 1,
                  fast: bool | None = None) -> None:
    """Structural invariants from the paper's constraints.

    * every transfer's payload is actually held at its source,
    * per round, each node plays at most one role (send xor receive xor
      relay) — the paper's one-link-per-node rule (`max_recv_per_round`
      relaxes receiving for fan-in schemes like traditional repair),
    * relays are used at most once per round and are not senders/receivers,
    * after the last round every job's requestor holds the full term set.

    Large plans take the array fast path (whole-plan bincount role checks
    + uint64 term-bitmask bookkeeping, see
    `repro_torch.core.engine.arrays.validate_plan_arrays`); small plans,
    plans that cannot be lowered (helper/term ids >= 64), and `fast=False`
    use the object walk below. Both paths enforce identical invariants.
    Callers that already hold compiled `PlanArrays` should call
    `validate_plan_arrays` directly and skip the re-compile.
    """
    if fast is None:
        fast = (sum(len(r.transfers) for r in plan.rounds)
                >= _FAST_VALIDATE_MIN_TRANSFERS)
    if fast:
        from repro_torch.core.engine.arrays import (UnsupportedPlanError,
                                                    compile_plan,
                                                    validate_plan_arrays)

        try:
            arrays = compile_plan(plan)
        except UnsupportedPlanError:
            pass
        else:
            validate_plan_arrays(arrays, max_recv_per_round=max_recv_per_round)
            return
    state = FragmentState(plan.jobs)
    for rnd in plan.rounds:
        send_count: dict[int, int] = defaultdict(int)
        recv_count: dict[int, int] = defaultdict(int)
        relay_count: dict[int, int] = defaultdict(int)
        for t in rnd.transfers:
            send_count[t.src] += 1
            recv_count[t.dst] += 1
            for rl in t.relays:
                relay_count[rl] += 1
        for node, c in send_count.items():
            if c > 1:
                raise ValueError(f"node {node} sends {c} transfers in one round")
            if relay_count.get(node):
                raise ValueError(f"node {node} both sends and relays")
            if recv_count.get(node):
                raise ValueError(f"node {node} both sends and receives in a round")
        for node, c in recv_count.items():
            if c > max_recv_per_round:
                raise ValueError(f"node {node} receives {c} transfers in one round")
            if relay_count.get(node):
                raise ValueError(f"node {node} both receives and relays")
        for node, c in relay_count.items():
            if c > 1:
                raise ValueError(f"relay node {node} used {c} times in one round")
        for t in rnd.transfers:
            state.apply(t)
    if not state.all_done():
        raise ValueError("plan does not complete all jobs")
