"""The microbatched, remat'd train step.

TrainState = {"params", "opt": {"m", "v"}, "step"} plus "ef" (the error
feedback) when gradients are compressed: a nested dict of tensors on one
device.

The step is functional, as the reference's is: `train_step(state, batch)`
returns a new state dict of new tensors and leaves `state` as it was, so
a state that is stepped twice, or saved while the next step runs, stays
valid.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import tree
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.sharding import NO_MESH, MeshRules, tree_constrain
from repro_torch.train import optimizer as opt


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: opt.AdamWConfig = opt.AdamWConfig()
    microbatches: int = 1
    remat: bool = True
    attn_chunk: int = 1024
    compress_grads: bool = False
    opt_dtype: str = "float32"      # "bfloat16": half-size m/v


def init_state(generator_or_seed, cfg: ArchConfig, tcfg: TrainConfig,
               device=None) -> dict:
    """A fresh train state on `device` (`None` = the card; raises without
    one). Params are drawn from a `torch.Generator`, or from one seeded
    with the given int on `device`."""
    dev = resolve_device(device)
    gen = generator_or_seed
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(generator_or_seed))
    params = tree.map(lambda p: p.to(dev), M.init_params(gen, cfg))
    od = torch.bfloat16 if tcfg.opt_dtype == "bfloat16" else torch.float32
    state = {
        "params": params,
        "opt": opt.init_opt_state(params, od),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }
    if tcfg.compress_grads:
        state["ef"] = opt.init_ef_state(params)
    return state


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig,
                    rules: MeshRules = NO_MESH):
    """`train_step(state, batch) -> (new_state, metrics)`; `batch` is a
    dict of (B, T) token arrays (numpy or tensors), moved to the state's
    device once."""
    def loss_and_grads(params, batch):
        leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
        loss = M.train_loss(tree.unflatten(params, leaves), cfg, batch,
                            rules=rules, chunk=tcfg.attn_chunk,
                            remat=tcfg.remat)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree.unflatten(params, grads)

    def train_step(state, batch):
        params = state["params"]
        dev = state["step"].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if tcfg.microbatches > 1:
            n = tcfg.microbatches
            parts = {k: v.chunk(n, dim=0) for k, v in batch.items()}
            grads = tree.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            losses = []
            for i in range(n):
                loss, g = loss_and_grads(params, {k: v[i] for k, v in
                                                  parts.items()})
                grads = tree.map(lambda a, gi: a + gi.float() / n, grads, g)
                losses.append(loss)
            loss = torch.stack(losses).mean()
        else:
            loss, grads = loss_and_grads(params, batch)
        grads = tree_constrain(rules, grads, None)

        new_state = dict(state)
        if tcfg.compress_grads:
            grads, new_state["ef"] = opt.compress_grads(grads, state["ef"])
        new_params, new_opt, info = opt.adamw_update(
            tcfg.adamw, params, grads, state["opt"], state["step"])
        new_state.update(params=new_params, opt=new_opt,
                         step=state["step"] + 1)
        return new_state, {"loss": loss, **info}

    return train_step
