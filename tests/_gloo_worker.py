"""The ranks of `tests/test_torch_mesh_gloo.py`: each runs the port's
train and decode steps on a (2, 2) ("data", "model") mesh of gloo ranks
on the CPU and rank 0 writes what the test compares.

Imports only torch and the port, so a spawned rank starts quickly.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch import tree
from repro_torch.ft.elastic import reshard_state, shrink_mesh
from repro_torch.launch.mesh import make_test_mesh, rules_for
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.sharding import MeshRules, tree_shardings
from repro_torch.train import train_step as T


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _train(case: dict, rules) -> dict:
    cfg, tcfg = case["cfg"], case["tcfg"]
    state = case["state"]
    sh = tree_shardings(rules, state, T.state_logical(cfg, tcfg, rules))
    placed = reshard_state(state, rules.dmesh, sh)
    new, metrics = T.make_train_step(cfg, tcfg, rules)(placed,
                                                       case["batch"])
    return {"loss": float(_full(metrics["loss"])),
            "grad_norm": float(_full(metrics["grad_norm"])),
            "params": tree.map(lambda x: _full(x).clone(), new["params"]),
            "placed": placed}


def _decode(case: dict, rules) -> dict:
    cfg = case["cfg"]
    params = reshard_state(case["params"], rules.dmesh, tree_shardings(
        rules, case["params"], M.logical_params(cfg, rules, decode=True)))
    cache = dict(case["cache"])
    idx = cache.pop("idx")
    logical = M.cache_logical(cfg, rules)
    logical.pop("idx")
    cache = reshard_state(cache, rules.dmesh,
                          tree_shardings(rules, cache, logical))
    cache["idx"] = idx
    logits, cache = M.decode_step(params, cfg, case["token"], cache,
                                  rules=rules, chunk=case["chunk"])
    return {"logits": _full(logits).clone(),
            "k": _full(cache["k"]).clone(), "v": _full(cache["v"]).clone(),
            "pos": _full(cache["pos"]).clone(),
            "k_shard_dims": [p.dim if p.is_shard() else None
                             for p in cache["k"].placements]}


def _uneven(rules, dim: int, tensor_dim: int) -> list:
    """Placements on `rules.dmesh` that cut tensor dim `tensor_dim` over
    the tensor axis (unevenly where the axis does not divide it) and, with
    `dim` >= 0, shard tensor dim `dim` over the data axis."""
    mesh = rules.dmesh
    out = [Replicate()] * mesh.ndim
    out[mesh.mesh_dim_names.index(rules.tensor)] = Shard(tensor_dim)
    if dim >= 0:
        out[mesh.mesh_dim_names.index("data")] = Shard(dim)
    return out


def _vocab(case: dict, rules) -> dict:
    """An odd vocabulary: the train loss and its gradients with the
    rules' placements (which replicate a vocabulary the tensor axis does
    not divide), then the lookup and the loss on a table and logits whose
    vocabulary is cut unevenly over the tensor axis by hand."""
    cfg = case["cfg"]
    params = reshard_state(case["params"], rules.dmesh, tree_shardings(
        rules, case["params"], M.logical_params(cfg, rules)))
    leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
    batch = {k: rules.constrain(v, ("batch", None))
             for k, v in case["batch"].items()}
    with rules.context():
        loss = M.train_loss(tree.unflatten(params, leaves), cfg, batch,
                            rules=rules, chunk=case["chunk"])
        grads = torch.autograd.grad(loss, leaves)
    out = {"loss": float(_full(loss)),
           "loss_is_dtensor": isinstance(loss, DTensor),
           "grads": [_full(g).clone() for g in grads]}

    table = distribute_tensor(case["table"], rules.dmesh,
                              _uneven(rules, -1, 0)).requires_grad_()
    with rules.context():
        rows = L.embed({"table": table}, case["tokens"], rules)
        (rows * case["rows_cot"]).sum().backward()
    out["table_local_rows"] = table.to_local().shape[0]
    out["rows"] = _full(rows).clone()
    out["table_grad"] = _full(table.grad).clone()

    logits = distribute_tensor(case["logits"], rules.dmesh,
                               _uneven(rules, 0, 2)).requires_grad_()
    with rules.context():
        ce = M.cross_entropy(logits, case["labels"])
        ce.backward()
    out["logits_local_vocab"] = logits.to_local().shape[2]
    out["ce"] = float(_full(ce))
    out["ce_grad"] = _full(logits.grad).clone()
    return out


def _shrink(state, rules, cfg, tcfg) -> dict | None:
    """`reshard_state` of a placed state onto the mesh with one data row
    lost; rank 0 (which stays) returns the gathered leaves."""
    small = shrink_mesh(rules.mesh, 1)
    new_rules = MeshRules(mesh=small, fsdp=rules.fsdp, tensor=rules.tensor)
    sh = tree_shardings(new_rules, state,
                        T.state_logical(cfg, tcfg, new_rules))
    moved = reshard_state(state, new_rules.dmesh, sh)
    ranks = small.mesh.flatten().tolist()
    out = None
    if dist.get_rank() in ranks:
        out = {"ranks": ranks,
               "leaves": tree.map(lambda x: x.full_tensor().clone(), moved)}
    return out


def run(rank: int, world: int, payload: str, out: str, store: str) -> None:
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60))
    try:
        torch.manual_seed(0)
        cases = torch.load(payload, weights_only=False)
        mesh = make_test_mesh(data=2, model=2, device="cpu")
        rules = rules_for(mesh)
        results = {}
        for name, case in cases.items():
            if case["kind"] == "train":
                got = _train(case, rules)
                if case.get("shrink"):
                    got["shrink"] = _shrink(got["placed"], rules,
                                            case["cfg"], case["tcfg"])
                    got["before"] = tree.map(
                        lambda x: x.full_tensor().clone(), got["placed"])
                del got["placed"]
            elif case["kind"] == "vocab":
                got = _vocab(case, rules)
            else:
                got = _decode(case, rules)
            got["mode"] = L.attn_shard_mode(
                case["cfg"], rules, decode=case["kind"] == "decode")
            results[name] = got
        if rank == 0:
            torch.save(results, out + ".tmp")
            os.replace(out + ".tmp", out)
        dist.barrier()
    finally:
        dist.destroy_process_group()
