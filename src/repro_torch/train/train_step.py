"""The microbatched, remat'd train step.

TrainState = {"params", "opt": {"m", "v"}, "step"} plus "ef" (the error
feedback) when gradients are compressed: a nested dict of tensors on one
device, or of DTensors on a mesh (`state_logical` names their axes).

The step is functional, as the reference's is: `train_step(state, batch)`
returns a new state dict of new tensors and leaves `state` as it was, so
a state that is stepped twice, or saved while the next step runs, stays
valid.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import local_map

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


def state_logical(cfg: ArchConfig, tcfg: TrainConfig, rules: MeshRules):
    lp = M.logical_params(cfg, rules)
    s = {"params": lp, "opt": opt.opt_logical(lp), "step": ()}
    if tcfg.compress_grads:
        s["ef"] = lp
    return s


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig,
                    rules: MeshRules = NO_MESH):
    """`train_step(state, batch) -> (new_state, metrics)`; `batch` is a
    dict of (B, T) token arrays (numpy or tensors), moved to the state's
    device once. On a mesh the state's leaves and the batch are DTensors
    placed by `tree_shardings` (a plain batch is sharded by
    `model.batch_logical`), and the accumulated gradients are pinned to
    the parameters' placements before the update."""
    logical_p = M.logical_params(cfg, rules)
    def loss_and_grads(params, batch):
        leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
        with rules.context():
            loss = M.train_loss(tree.unflatten(params, leaves), cfg, batch,
                                rules=rules, chunk=tcfg.attn_chunk,
                                remat=tcfg.remat)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree.unflatten(params, grads)

    def train_step(state, batch):
        params = state["params"]
        dev = state["step"].device
        batch = {k: _batch_leaf(rules, k, v, dev) for k, v in batch.items()}
        if tcfg.microbatches > 1:
            n = tcfg.microbatches
            parts = {k: _split(k, v, n) for k, v in batch.items()}
            grads = tree.map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                             params)
            losses = []
            for i in range(n):
                loss, g = loss_and_grads(params, {k: v[i] for k, v in
                                                  parts.items()})
                grads = tree.map(lambda a, gi: a + gi.float() / n, grads, g)
                losses.append(loss)
            loss = torch.stack(losses).mean()
        else:
            loss, grads = loss_and_grads(params, batch)
        # pin gradients to the parameter sharding AFTER accumulation: one
        # reduction into the FSDP shards for the whole step
        grads = tree_constrain(rules, grads, logical_p)

        new_state = dict(state)
        if tcfg.compress_grads:
            grads, new_state["ef"] = opt.compress_grads(grads, state["ef"])
        new_params, new_opt, info = opt.adamw_update(
            tcfg.adamw, params, grads, state["opt"], state["step"])
        new_state.update(params=new_params, opt=new_opt,
                         step=state["step"] + 1)
        return new_state, {"loss": loss, **info}

    return train_step


def _batch_leaf(rules: MeshRules, key: str, value, dev) -> torch.Tensor:
    """A batch leaf on the state's device; on a mesh, a plain tensor is
    sharded over its batch axis (a DTensor is taken as placed)."""
    if isinstance(value, DTensor):
        return value
    value = torch.as_tensor(value, device=dev)
    if rules.mesh is None:
        return value
    batch_dim = 1 if key == "pos3" else 0
    logical = tuple("batch" if i == batch_dim else None
                    for i in range(value.ndim))
    return rules.constrain(value, logical)


def _split(key: str, value: torch.Tensor, n: int) -> tuple:
    """`n` microbatches of a batch leaf, split on its batch axis (axis 1
    of `pos3`). A DTensor is split rank by rank: microbatch i is every
    data shard's own i-th slice, so no rows move between ranks (a
    different grouping of rows into microbatches than the whole batch's
    i-th slice; the step's mean loss and summed gradients are the same
    sums in another order)."""
    dim = 1 if key == "pos3" else 0
    if not isinstance(value, DTensor):
        return value.chunk(n, dim=dim)
    place = tuple(value.placements)
    return local_map(lambda t: tuple(t.chunk(n, dim=dim)),
                     out_placements=tuple(place for _ in range(n)),
                     device_mesh=value.device_mesh)(value)
