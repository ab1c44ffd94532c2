"""Data-plane execution of repair plans, byte-verified.

The simulator times a plan; this module *runs* it. `execute_plan` walks one
plan serially: every helper holds a real chunk (a uint8 tensor on the
device), premultiplies its Galois coefficient through `ops.gf256_matmul`
(the `gf256_matmul_bytes` CUDA kernel on the card), transfers move buffers
between per-(job, node) stores, and merges XOR through `ops.xor_reduce`
(the `xor_reduce_words` kernel, which reads the held buffer and the
arriving one where they lie: nothing is stacked). Relay nodes only
buffer (the paper: forwarding nodes do not compute). At the end the
requestor's buffer must equal the lost block bit-for-bit.

**Invariant:** plans must be `validate_plan`-clean. The executor implements
store-and-forward faithfully — a source's buffer is consumed when it
sends, so a plan whose transfer sources a node that already forwarded its
fragment (or never held one) is *unexecutable*; it raises `ValueError` on
it rather than moving zeros. `run_scheme` validates every plan it
simulates, so every simulator-produced plan satisfies this by construction.

`bytes_moved` counts the paper's real network cost: a relayed transfer
re-sends the whole chunk on every hop, so a path of length L moves
`(L - 1) * nbytes` bytes (store-and-forward, no computation at relays).

The batched engine (`execute_plans_batch`, one premultiply launch per
batch and one fold launch per round for a whole batch of compiled plans)
lives in `core/engine/dataplane.py` and is re-exported here, with
`BatchExecutionResult` and `identity_block_map`, as in the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.engine.dataplane import (BatchExecutionResult,
                                              execute_plans_batch,
                                              identity_block_map)
from repro_torch.core.plan import RepairPlan
from repro_torch.device import resolve_device
from repro_torch.ec.rs import RSCode
from repro_torch.kernels import ops

__all__ = [
    "BatchExecutionResult",
    "ExecutionResult",
    "execute_plan",
    "execute_plans_batch",
    "identity_block_map",
]


@dataclasses.dataclass
class ExecutionResult:
    reconstructed: dict[int, torch.Tensor]  # job_id -> (nbytes,) uint8 bytes
    verified: bool
    bytes_moved: int


def execute_plan(
    plan: RepairPlan,
    code: RSCode,
    codeword,                              # (n, nbytes) original stripe
    *,
    use_kernel: bool = True,
    block_of: np.ndarray | None = None,
    device=None,
) -> ExecutionResult:
    """Serial walk of one validated plan over real bytes.

    `codeword` is a uint8 numpy array or tensor; it is moved to `device`
    (`None` = the card; raises without one, `"cpu"` runs the plain torch
    versions) and every buffer and result stays there.
    `block_of[node]` maps node ids to codeword block positions (identity
    when None — the simulator convention that node i holds block i); a
    real stripe placement (`ec/stripe.py`) can be passed instead.
    """
    dev = resolve_device(device)
    codeword = torch.as_tensor(codeword, dtype=torch.uint8).to(dev)
    nbytes = codeword.shape[1]
    if block_of is None:
        nodes = [x for j in plan.jobs
                 for x in (j.failed_node, *j.helpers)] + [0]
        block_of = identity_block_map(max(nodes) + 1, code.n)
    block_of = np.asarray(block_of, dtype=np.int64)
    # per-(job, node) payload store
    store: dict[tuple[int, int], torch.Tensor] = {}
    for job in plan.jobs:
        if block_of[job.failed_node] < 0 or any(
                block_of[h] < 0 for h in job.helpers):
            # -1 must not wrap into python negative indexing — that would
            # "repair" the wrong block and self-consistently verify it
            raise ValueError(
                f"job {job.job_id}: a failed/helper node holds no block "
                "under the given placement")
        coeffs = code.repair_coeffs(
            tuple([int(block_of[job.failed_node])]),
            tuple(int(block_of[h]) for h in job.helpers),
        )[0]  # (k,) coefficients, aligned with job.helpers
        for h, c in zip(job.helpers, coeffs):
            block = codeword[int(block_of[h])]
            pre = ops.gf256_matmul(
                np.array([[c]], dtype=np.uint8), block[None, :],
                use_kernel=use_kernel,
            )[0]
            store[(job.job_id, h)] = pre

    bytes_moved = 0
    for ri, rnd in enumerate(plan.rounds):
        arrivals: list[tuple[int, int, torch.Tensor]] = []
        for t in rnd.transfers:
            # store-and-forward: sending consumes the buffer, so a source
            # drained in an earlier round cannot feed this one — only
            # validate_plan-clean plans are executable (module docstring)
            payload = store.pop((t.job, t.src), None)
            if payload is None:
                raise ValueError(
                    f"round {ri}: transfer {t} sources node {t.src} which "
                    f"holds no buffer for job {t.job} (consumed in an "
                    "earlier round?) — execute_plan requires a "
                    "validate_plan-clean plan")
            bytes_moved += nbytes * (len(t.path) - 1)   # relays re-send
            arrivals.append((t.job, t.dst, payload))
        for job_id, dst, payload in arrivals:
            existing = store.get((job_id, dst))
            if existing is None:
                store[(job_id, dst)] = payload
            else:
                store[(job_id, dst)] = ops.xor_reduce(
                    (existing, payload), use_kernel=use_kernel)

    recon: dict[int, torch.Tensor] = {}
    ok = True
    for job in plan.jobs:
        held = store.get((job.job_id, job.requestor))
        if held is None:
            recon[job.job_id] = torch.zeros(nbytes, dtype=torch.uint8,
                                            device=dev)
            ok = False
            continue
        recon[job.job_id] = held
        if not torch.equal(held, codeword[int(block_of[job.failed_node])]):
            ok = False
    return ExecutionResult(reconstructed=recon, verified=ok, bytes_moved=bytes_moved)
