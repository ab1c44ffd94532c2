"""Batched byte data plane: execute compiled `PlanArrays` over real bytes.

This is the array-native twin of `repro_torch.core.executor.execute_plan`
— the module that *runs* a repair plan instead of timing it. Where the
serial walk keeps a dict of per-(job, node) buffers and makes one kernel
call per chunk, this engine lays a whole batch of compiled plans out in
one `(B, S, nbytes)` uint8 buffer on the device (S = jobs x nodes slots;
slot `j * N + v` is node v's buffer for job j; row `b * S + slot` of its
`(B * S, nbytes)` view) and runs:

1. **GF(256) premultiply** (init) — every helper chunk of the batch scaled
   by its repair coefficient in one `kernels.ops.gf256_scale_batch` call
   (one `gf256_scale_bytes` launch), with the coefficients computed
   batched by `RSCode.repair_coeffs_batch` (one lockstep Gauss-Jordan per
   code);
2. per round, **gather + segment-XOR** — one `kernels.ops.xor_reduce_segments`
   call (one `xor_reduce_groups_words` launch) reads the round's payload
   rows straight out of the buffer and folds them per (case, destination)
   group; a destination that already holds a buffer is one more member of
   its group, so the fold is the whole XOR-scatter and the result is
   written back with a plain assignment.

The bytes stay on the device through every round; the host only hands
the card small index tables (`device.host_to_device`, no synchronisation).
The occupancy bookkeeping — which slot holds a buffer — depends on the
plans alone, so it runs on the host in numpy before any byte moves
(`_schedule`): the per-round "source holds no buffer" check costs the
card nothing. A consumed source keeps stale bytes that nothing reads
again (the schedule never names an empty slot), and an empty requestor
slot reports zeros, as the JAX package's zeroed buffer does.

Execution semantics match the serial walk exactly: within a round all
sources are consumed before any arrival lands (store-and-forward
two-phase), fan-in arrivals XOR-fold (XOR is associative and commutative,
so the fold order cannot matter), relays re-send whole buffers
(`bytes_moved` counts `nbytes * (path_len - 1)` per transfer). Like the
serial walk, the engine assumes a `validate_plan`-clean plan; the one
invariant it re-checks is source occupancy — a transfer whose source
buffer was consumed in an earlier round raises `ValueError` instead of
moving zeros.

`block_of` decouples node ids from codeword positions: the simulator
convention (node i holds block i) is the identity default, while a
*placed* stripe (`repro_torch.ec.stripe`) passes its mapping, with the
plans relabeled through the placement by `arrays.relabel_plan_nodes`.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import numpy as np
import torch

from repro_torch.core.engine.arrays import PlanArrays, compile_plan
from repro_torch.core.plan import RepairPlan
from repro_torch.device import host_to_device, resolve_device
from repro_torch.ec.rs import RSCode
from repro_torch.kernels import ops


@dataclasses.dataclass
class BatchExecutionResult:
    """Per-case outcome of one batched data-plane run."""

    reconstructed: list[dict[int, torch.Tensor]]  # per case: job_id -> bytes
    verified: np.ndarray                           # (B,) bool — every job exact
    bytes_moved: np.ndarray                        # (B,) int64
    rounds: int = 0                                # segment folds run

    @property
    def all_verified(self) -> bool:
        return bool(self.verified.all())


def identity_block_map(num_nodes: int, n: int) -> np.ndarray:
    """The simulator's placement: node i holds block i (i < n), -1 after."""
    out = np.full(max(num_nodes, n), -1, dtype=np.int64)
    out[:n] = np.arange(n)
    return out


def _as_plan_arrays(plans) -> list[PlanArrays]:
    return [p if isinstance(p, PlanArrays) else compile_plan(p)
            for p in plans]


def _repair_coeffs(
    pas: list[PlanArrays],
    codes: list[RSCode],
    block_maps: list[np.ndarray],
) -> list[np.ndarray]:
    """(k,)-coefficient rows for every (case, job), batched per code.

    Jobs of all cases sharing one (n, k) code go through a single
    `repair_coeffs_batch` call (one lockstep Gauss-Jordan), and identical
    (failed, helpers) rows within it are deduplicated — a 64-stripe batch
    repairing the same logical failure computes its coefficients once.
    """
    by_code: dict[tuple[int, int], list[tuple[int, int]]] = {}
    for b, (pa, code) in enumerate(zip(pas, codes)):
        for j in range(pa.num_jobs):
            by_code.setdefault((code.n, code.k), []).append((b, j))
    out: list[list] = [[None] * pa.num_jobs for pa in pas]
    for (n, k), rows in by_code.items():
        code = next(c for c in codes if (c.n, c.k) == (n, k))
        failed = np.empty(len(rows), dtype=np.int64)
        helpers = np.empty((len(rows), k), dtype=np.int64)
        for i, (b, j) in enumerate(rows):
            pa, bmap = pas[b], block_maps[b]
            hl = int(pa.job_helpers_len[j])
            if hl != k:
                raise ValueError(
                    f"job {int(pa.job_id[j])} has {hl} helpers, "
                    f"RS({n},{k}) repair needs exactly k")
            hb = bmap[pa.job_helpers[j, :k]]
            fb = bmap[pa.job_failed[j]]
            if fb < 0 or (hb < 0).any():
                raise ValueError(
                    f"job {int(pa.job_id[j])}: a failed/helper node holds "
                    "no block under the given placement")
            failed[i] = fb
            helpers[i] = hb
        uniq, inv = np.unique(
            np.concatenate([failed[:, None], helpers], axis=1),
            axis=0, return_inverse=True)
        coeffs = code.repair_coeffs_batch(uniq[:, 0], uniq[:, 1:])[inv.reshape(-1)]
        for i, (b, j) in enumerate(rows):
            out[b][j] = coeffs[i]
    return [np.stack(rows) if rows else np.zeros((0, 0), np.uint8)
            for rows in out]


@dataclasses.dataclass
class _RoundStep:
    """One round's device work, as rows of the `(B * S, nbytes)` buffer."""

    groups: np.ndarray      # (G, Kmax) int64 rows folded per destination, -1 pads
    dst_rows: np.ndarray    # (G,) int64 destination row of each group


def _schedule(pas: list[PlanArrays], N: int, S: int
              ) -> tuple[np.ndarray, list[_RoundStep], np.ndarray]:
    """The batch's device work, planned on the host before any byte moves.

    Returns the premultiplied helper rows (case, job, helper order), one
    `_RoundStep` per non-empty round, and the final occupancy of the
    `(B * S,)` rows. Per round, the sources must all hold a buffer (else
    `ValueError`, the message of the JAX package); they are consumed, then
    every (case, destination) group is formed from its arrivals in transfer
    order, preceded by the destination's own row when it still holds a
    buffer after the consume. Group keys are unique, so the device writes
    each destination row exactly once.
    """
    pre_rows = [b * S + j * N
                + pa.job_helpers[j, :int(pa.job_helpers_len[j])].astype(np.int64)
                for b, pa in enumerate(pas) for j in range(pa.num_jobs)]
    pre_rows = np.concatenate(pre_rows) if pre_rows else np.zeros(0, np.int64)
    occupied = np.zeros(len(pas) * S, dtype=bool)
    occupied[pre_rows] = True
    fb = np.concatenate([np.full(pa.num_transfers, b, dtype=np.int64)
                         for b, pa in enumerate(pas)])
    fround = np.concatenate([
        np.repeat(np.arange(pa.num_rounds, dtype=np.int64),
                  np.diff(pa.round_start)) for pa in pas])
    fsrc = np.concatenate([pa.t_job_idx.astype(np.int64) * N + pa.t_src
                           for pa in pas])
    fdst = np.concatenate([pa.t_job_idx.astype(np.int64) * N + pa.t_dst
                           for pa in pas])
    steps = []
    for r in range(max((pa.num_rounds for pa in pas), default=0)):
        rows = np.nonzero(fround == r)[0]
        if not rows.size:
            continue
        rb, rsrc, rdst = fb[rows], fsrc[rows], fdst[rows]
        src_rows = rb * S + rsrc
        held = occupied[src_rows]
        if not held.all():
            bad = int(np.nonzero(~held)[0][0])
            raise ValueError(
                f"round {r}: case {int(rb[bad])} transfer sources slot "
                f"(job {int(rsrc[bad]) // N}, node {int(rsrc[bad]) % N}) "
                "which holds no buffer — consumed in an earlier round? "
                "execute_plans_batch requires a validate_plan-clean plan")
        occupied[src_rows] = False                   # two-phase consume
        # fan-in groups per (case, destination slot), transfer order kept
        key = rb * S + rdst
        order = np.argsort(key, kind="stable")
        skey = key[order]
        boundary = np.empty(order.size, dtype=bool)
        boundary[0] = True
        np.not_equal(skey[1:], skey[:-1], out=boundary[1:])
        starts = np.nonzero(boundary)[0]
        counts = np.diff(np.append(starts, order.size))
        dst_rows = skey[starts]
        held_dst = occupied[dst_rows]                # dst still holds a buffer
        groups = np.full((starts.size, int((counts + held_dst).max())), -1,
                         dtype=np.int64)
        groups[held_dst, 0] = dst_rows[held_dst]
        pos = (np.arange(order.size) - np.repeat(starts, counts)
               + np.repeat(held_dst, counts))
        groups[np.repeat(np.arange(starts.size), counts), pos] = src_rows[order]
        occupied[dst_rows] = True
        steps.append(_RoundStep(groups=groups, dst_rows=dst_rows))
    return pre_rows, steps, occupied


def execute_plans_batch(
    plans: Sequence[PlanArrays | RepairPlan],
    codes: RSCode | Sequence[RSCode],
    codewords,
    *,
    block_of: Sequence[np.ndarray | None] | None = None,
    use_kernel: bool = True,
    device=None,
) -> BatchExecutionResult:
    """Execute a batch of repair plans over real bytes and verify them.

    `plans` are `PlanArrays` (or `RepairPlan`s, compiled on entry),
    `codes` one shared or per-case `RSCode`, `codewords` per-case
    `(n, nbytes)` uint8 block stacks, numpy arrays or tensors
    (block-indexed; same nbytes across the batch), moved to `device`
    (`None` = the card, raising without one; `"cpu"` runs the plain torch
    versions). `block_of[b][node]` maps node ids to block positions
    (identity when None — the simulator convention). `use_kernel=False`
    takes the byte-domain plain versions of `ops` instead of the kernels.
    Returns per-case reconstructed bytes (tensors on `device`), a verified
    flag (every job's requestor buffer equals the lost block bit for bit,
    compared on the device) and relay-aware `bytes_moved` — identical to
    running `executor.execute_plan` case by case.
    """
    dev = resolve_device(device)
    pas = _as_plan_arrays(plans)
    B = len(pas)
    if B == 0:
        return BatchExecutionResult([], np.zeros(0, bool),
                                    np.zeros(0, np.int64))
    codes = list(codes) if isinstance(codes, Sequence) else [codes] * B
    cws = [torch.as_tensor(cw, dtype=torch.uint8).to(dev) for cw in codewords]
    if len(codes) != B or len(cws) != B:
        raise ValueError("plans, codes and codewords must align")
    nbytes = cws[0].shape[-1]
    if any(cw.shape[-1] != nbytes for cw in cws):
        raise ValueError("all codewords must share one chunk size")
    N = max(pa.num_nodes for pa in pas)
    block_maps = []
    for b, pa in enumerate(pas):
        bmap = None if block_of is None else block_of[b]
        if bmap is None:
            bmap = identity_block_map(max(N, codes[b].n), codes[b].n)
        else:
            bmap = np.asarray(bmap, dtype=np.int64)
            if bmap.size < N:
                bmap = np.concatenate(
                    [bmap, np.full(N - bmap.size, -1, dtype=np.int64)])
        block_maps.append(bmap)
    S = max(pa.num_jobs for pa in pas) * N

    # ---- host: coefficients, then every round's row tables
    coeffs = _repair_coeffs(pas, codes, block_maps)
    pre_rows, steps, occupied = _schedule(pas, N, S)
    pre_coef = [coeffs[b][j] for b, pa in enumerate(pas)
                for j in range(pa.num_jobs)]
    # per case, the codeword blocks of its helpers, in `pre_rows` order
    pre_blocks = [np.concatenate(
        [block_maps[b][pa.job_helpers[j, :int(pa.job_helpers_len[j])]]
         for j in range(pa.num_jobs)] or [np.zeros(0, np.int64)])
        for b, pa in enumerate(pas)]
    # relays re-send the whole buffer: nbytes per hop of every path
    bytes_moved = np.array([nbytes * int((pa.t_path_len - 1).sum())
                            for pa in pas], dtype=np.int64)

    # ---- device: one buffer, rows padded to whole 32-bit words so the
    # segment fold reads it in place
    width = nbytes + (-nbytes % 4)
    buf = torch.zeros((B * S, width), dtype=torch.uint8, device=dev)
    if pre_rows.size:
        helpers = torch.cat([cws[b][host_to_device(blocks, dev)]
                             for b, blocks in enumerate(pre_blocks)])
        pre = ops.gf256_scale_batch(np.concatenate(pre_coef), helpers,
                                    use_kernel=use_kernel)
        del helpers
        buf[host_to_device(pre_rows, dev), :nbytes] = pre
        del pre
    for step in steps:
        folded = ops.xor_reduce_segments(buf, step.groups,
                                         use_kernel=use_kernel)
        # a plain assignment is the whole XOR-scatter: a held destination is
        # already in its group, and the rows are unique (one write per row)
        buf[host_to_device(step.dst_rows, dev)] = folded

    # ---- verify every job's requestor buffer against the lost block
    recon: list[dict[int, torch.Tensor]] = [dict() for _ in range(B)]
    same = []
    for b, pa in enumerate(pas):
        for j in range(pa.num_jobs):
            row = b * S + j * N + int(pa.job_requestor[j])
            if occupied[row]:
                got = buf[row, :nbytes].clone()
                lost = cws[b][int(block_maps[b][pa.job_failed[j]])]
                same.append((got == lost).all())
            else:
                got = torch.zeros(nbytes, dtype=torch.uint8, device=dev)
                same.append(torch.zeros((), dtype=torch.bool, device=dev))
            recon[b][int(pa.job_id[j])] = got
    verified = np.ones(B, dtype=bool)
    if same:
        ok = torch.stack(same).cpu().numpy()          # one copy to the host
        case_of = np.repeat(np.arange(B), [pa.num_jobs for pa in pas])
        np.logical_and.at(verified, case_of, ok)
    return BatchExecutionResult(reconstructed=recon, verified=verified,
                                bytes_moved=bytes_moved, rounds=len(steps))
