"""AdamW in the reference's exact arithmetic, plus the int8 error-feedback
gradient compressor.

Plain torch, leaf by leaf over nested dicts of tensors (not
`torch.optim.AdamW`): the global-norm clip, the bias corrections from
`step + 1` in fp32, the decay applied to the fp32 param, the result cast
back to the param's dtype; moments kept in `opt_dtype` (fp32, or bf16 to
halve their memory) while the update math runs in fp32. Every function
returns new tensors and leaves its inputs as they were.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate

from repro_torch import tree as _tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = torch.as_tensor(step).float()
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1),
        0.0, 1.0,
    )
    cos = cfg.peak_lr * (
        cfg.min_lr_frac
        + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    )
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params, dtype=torch.float32) -> dict:
    """dtype=bfloat16 halves the moments' memory; the update math still
    runs in fp32."""
    def zeros(p):
        return torch.zeros_like(p, dtype=dtype)

    return {"m": _tree.map(zeros, params), "v": _tree.map(zeros, params)}


def opt_logical(logical_params) -> dict:
    """m/v shard exactly like their parameters."""
    return {"m": logical_params, "v": logical_params}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g.float() ** 2)
                          for g in _tree.leaves(tree)))


def _local_global_norm(grads) -> torch.Tensor:
    """`global_norm` of DTensor leaves from their local shards: each
    rank's sum of squares, divided by the number of ranks that hold the
    same shard, all-reduced over each mesh dim in turn (the same sum in
    another order). A replicated 0-d DTensor."""
    leaves = _tree.leaves(grads)
    mesh = leaves[0].device_mesh
    total = None
    for g in leaves:
        copies = 1
        for dim, place in enumerate(g.placements):
            if place.is_replicate():
                copies *= mesh.size(dim)
        part = torch.sum(g.to_local().float() ** 2) / copies
        total = part if total is None else total + part
    for dim in range(mesh.ndim):          # the sum over every rank
        total = funcol.wait_tensor(funcol.all_reduce(
            total, "sum", mesh.get_group(dim)))
    return DTensor.from_local(torch.sqrt(total), mesh,
                              [Replicate()] * mesh.ndim, run_check=False)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, opt_state, step):
    """Returns (new params, {"m", "v"}, {"grad_norm", "lr"}).

    DTensor leaves (a mesh) are updated shard by shard: the update is
    elementwise, so each rank runs it on its own shards, and only the
    global norm crosses ranks."""
    if isinstance(_tree.leaves(params)[0], DTensor):
        return _adamw_update_local(cfg, params, grads, opt_state, step)
    return _adamw(cfg, params, grads, opt_state, step, global_norm(grads))


def _adamw(cfg: AdamWConfig, params, grads, opt_state, step, gnorm):
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    t = (step + 1).float()
    bc1 = 1 - cfg.b1 ** t
    bc2 = 1 - cfg.b2 ** t

    def upd(p, g, m, v):
        g = g.float() * scale
        m_new = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v_new = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        pf = p.float()
        p_new = pf - lr * (update + cfg.weight_decay * pf)
        return p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)

    out = _tree.map(upd, params, grads, opt_state["m"], opt_state["v"])
    new_params, new_m, new_v = (_pick(out, i) for i in range(3))
    return new_params, {"m": new_m, "v": new_v}, {"grad_norm": gnorm, "lr": lr}


def _adamw_update_local(cfg, params, grads, opt_state, step):
    gnorm = _local_global_norm(grads)
    local = {"p": _tree.map(DTensor.to_local, params),
             "g": _tree.map(lambda g, p: g.redistribute(
                 p.device_mesh, p.placements).to_local(), grads, params),
             "m": _tree.map(DTensor.to_local, opt_state["m"]),
             "v": _tree.map(DTensor.to_local, opt_state["v"])}
    # the step and the norm are replicated scalars: every rank holds them
    new_p, new_opt, info = _adamw(
        cfg, local["p"], local["g"], {"m": local["m"], "v": local["v"]},
        step.to_local() if isinstance(step, DTensor) else step,
        gnorm.to_local())
    info = {"grad_norm": gnorm,
            "lr": DTensor.from_local(info["lr"], gnorm.device_mesh,
                                     gnorm.placements, run_check=False)}

    def wrap(x, like):
        return DTensor.from_local(x, like.device_mesh, like.placements,
                                  run_check=False)

    return (_tree.map(wrap, new_p, params),
            {"m": _tree.map(wrap, new_opt["m"], opt_state["m"]),
             "v": _tree.map(wrap, new_opt["v"], opt_state["v"])}, info)


def _pick(out, i: int):
    """Element i of the tuples at the leaves of `out`."""
    if isinstance(out, dict):
        return {key: _pick(val, i) for key, val in out.items()}
    return out[i]


# ------------------------------------------------- int8 EF gradient compress
def init_ef_state(params):
    return _tree.map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


@torch.no_grad()
def compress_grads(grads, ef_state):
    """Error-feedback int8 quantization: g_q = Q(g + e); e' = (g + e) - g_q.
    The quantization error and its feedback loop are exact, so
    dequantized + residual reproduces g + e."""
    def q(g, e):
        total = g.float() + e
        scale = torch.clamp(torch.max(torch.abs(total)), min=1e-12) / 127.0
        q8 = torch.clamp(torch.round(total / scale), -127, 127).to(torch.int8)
        deq = q8.float() * scale
        return deq.to(g.dtype), total - deq

    out = _tree.map(q, grads, ef_state)
    return _pick(out, 0), _pick(out, 1)
