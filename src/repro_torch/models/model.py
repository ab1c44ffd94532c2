"""Uniform model API over all ten architectures: params and their logical
trees, the LM loss, the serve API (`init_cache`, `cache_logical`,
`decode_step`) and the dry run's input stand-ins (`input_specs`,
`batch_logical`).

Families: the transformer (dense, MoE, sliding window, M-RoPE VLM),
whisper (encoder-decoder), rwkv6 (attention-free RNN) and zamba2 (Mamba2
with a shared attention block). One departure from the reference: rwkv6
and zamba2 have no int8 cache, and `kv_dtype="int8"` raises for them
where the reference would hand back its bf16 state.
"""
from __future__ import annotations

import math

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import rwkv6, transformer, whisper, zamba2
from repro_torch.models.sharding import (NO_MESH, AllReduce, MeshRules,
                                         local_apply, local_extent)


def family_module(cfg: ArchConfig):
    if cfg.is_encoder_decoder:
        return whisper
    if cfg.ssm_kind == "rwkv6":
        return rwkv6
    if cfg.shared_attn_every:
        return zamba2
    return transformer


def init_params(key, cfg: ArchConfig):
    return family_module(cfg).init_params(key, cfg)


def logical_params(cfg: ArchConfig, rules: MeshRules, *, decode: bool = False):
    mod = family_module(cfg)
    if mod is transformer:
        return mod.logical_tree(cfg, rules, decode=decode)
    return mod.logical_tree(cfg, rules)


# ------------------------------------------------------------------- losses
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The mean token loss of (..., V) fp32 logits; on a mesh (DTensor
    logits) `_mesh_cross_entropy`."""
    if isinstance(logits, DTensor):
        return _mesh_cross_entropy(logits, labels)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())
    return torch.mean(logz - gold[..., 0])


def _mesh_cross_entropy(logits: DTensor, labels) -> DTensor:
    """Megatron's vocab-parallel cross-entropy, shard by shard in a
    `local_map` region: no rank holds more of the logits than its own
    (rows, V / tp) shard. DTensor's `logsumexp` over a vocab-sharded dim
    would gather the whole vocabulary, and `gather`'s backward scatters
    into zeros of the global logits' shape.

    Per row: the local max, completed by an all-reduce MAX over the mesh
    dims that shard the vocabulary (out of the graph); the local
    sum(exp(x - m)), completed by an all-reduce SUM, so logz = m + log s;
    the gold logit, gathered where the label falls in the rank's slice
    (its offset is DTensor's, `sharding.local_extent`) and 0 elsewhere,
    completed by an all-reduce SUM. The rows' sum is all-reduced over
    the mesh dims that shard the rows, and the mean is a replicated
    scalar DTensor. The reference's arithmetic, summed in another order."""
    mesh = logits.device_mesh
    vocab = logits.ndim - 1
    lp = tuple(p if p.is_shard() else Replicate() for p in logits.placements)
    rows = tuple(p if p.is_shard() and p.dim < vocab else Replicate()
                 for p in lp)
    vocab_groups = [mesh.get_group(i) for i, p in enumerate(lp)
                    if p.is_shard(vocab)]
    row_groups = [mesh.get_group(i) for i, p in enumerate(rows)
                  if p.is_shard()]
    _, lo = local_extent(logits.shape, mesh, lp, vocab)
    n = math.prod(logits.shape[:-1])
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)

    def loss(x, lab):
        x = x.float()
        with torch.no_grad():
            m = x.amax(dim=-1)
            for group in vocab_groups:
                m = funcol.wait_tensor(funcol.all_reduce(m, "max", group))
        s = torch.exp(x - m[..., None]).sum(dim=-1)
        local = lab.long() - lo
        inside = (local >= 0) & (local < x.shape[-1])
        gold = torch.gather(x, -1, torch.where(inside, local, 0)[..., None])
        gold = torch.where(inside, gold[..., 0], 0.0)
        for group in vocab_groups:
            s = AllReduce.apply(s, group)
            gold = AllReduce.apply(gold, group)
        total = torch.sum(m + torch.log(s) - gold)
        for group in row_groups:
            total = AllReduce.apply(total, group)
        return total / n

    return local_apply(loss, mesh, (logits, labels), (lp, rows),
                       [Replicate()] * mesh.ndim)


def train_loss(params, cfg: ArchConfig, batch: dict, *,
               rules: MeshRules = NO_MESH, chunk: int = 1024,
               remat: bool = True) -> torch.Tensor:
    """Token-level LM loss (teacher-forced for the encoder-decoder) plus
    0.01 x the MoE load-balance aux (0 for other layers)."""
    mod = family_module(cfg)
    if cfg.is_encoder_decoder:
        logits, aux = mod.forward(params, cfg, batch["frames"],
                                  batch["tokens"], rules=rules, chunk=chunk,
                                  remat=remat)
    elif cfg.ssm_kind == "rwkv6":
        logits, aux = mod.forward(params, cfg, batch["tokens"], rules=rules,
                                  remat=remat)
    elif cfg.shared_attn_every:
        logits, aux = mod.forward(params, cfg, batch["tokens"], rules=rules,
                                  attn_chunk=chunk, remat=remat)
    else:
        logits, aux = mod.forward(
            params, cfg, batch["tokens"], rules=rules, chunk=chunk,
            remat=remat, pos3=batch.get("pos3"),
            vision_embeds=batch.get("vision_embeds"))
    loss = cross_entropy(logits, batch["labels"])
    return loss + 0.01 * aux


# ---------------------------------------------------------------- serve API
def _no_int8(cfg: ArchConfig, mod, kv_dtype: str) -> None:
    if kv_dtype != "bf16":
        family = mod.__name__.rsplit(".", 1)[-1]
        raise ValueError(f"{cfg.name}: the {family} family has no "
                         f"{kv_dtype!r} cache (its serve state is kept in "
                         "the params' dtype); use kv_dtype='bf16'")


def _not_whisper(cfg: ArchConfig) -> None:
    if cfg.is_encoder_decoder:
        raise ValueError("whisper serve state is built by serve.prefill")


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               rules: MeshRules = NO_MESH, kv_dtype: str = "bf16",
               device=None):
    """The family's empty serve state on `device` (`None` = the card):
    the KV cache, the rwkv6 state or the zamba2 cache."""
    _not_whisper(cfg)
    mod = family_module(cfg)
    if mod is transformer:
        return mod.init_cache(cfg, batch, max_len, rules, kv_dtype=kv_dtype,
                              device=device)
    _no_int8(cfg, mod, kv_dtype)
    if mod is rwkv6:
        return mod.init_state(cfg, batch, rules, device=device)
    return mod.init_cache(cfg, batch, max_len, rules, device=device)


def cache_logical(cfg: ArchConfig, rules: MeshRules = NO_MESH,
                  kv_dtype: str = "bf16"):
    _not_whisper(cfg)
    mod = family_module(cfg)
    if mod is transformer:
        return mod.cache_logical(cfg, rules, kv_dtype=kv_dtype)
    _no_int8(cfg, mod, kv_dtype)
    if mod is rwkv6:
        return mod.state_logical(cfg)
    return mod.cache_logical(cfg, rules)


def decode_step(params, cfg: ArchConfig, token, cache, *, rules=NO_MESH,
                chunk: int = 4096, pos3=None):
    """One decode step of a decoder-only family (whisper's is
    `serve_step.make_whisper_decode_step`)."""
    mod = family_module(cfg)
    if cfg.is_encoder_decoder:
        raise ValueError("whisper decodes through "
                         "serve.make_whisper_decode_step")
    with rules.context():
        if mod is rwkv6:
            return mod.decode_step(params, cfg, token, cache, rules=rules)
        if mod is zamba2:
            return mod.decode_step(params, cfg, token, cache, rules=rules,
                                   attn_chunk=chunk)
        return mod.decode_step(params, cfg, token, cache, rules=rules,
                               chunk=chunk, pos3=pos3)


# -------------------------------------------------------------- input specs
def input_specs(cfg: ArchConfig, shape: ShapeConfig, *, include_labels=True,
                device="meta") -> dict:
    """Empty stand-ins for every model input of the given shape cell (the
    reference's `ShapeDtypeStruct`s): tensors on the `meta` device by
    default, which hold no memory; under a `FakeTensorMode`, fake tensors
    on `device`. Frontends are stubs: whisper gets frame embeddings,
    qwen2-vl patch embeddings."""
    def sd(dims, dtype):
        return torch.empty(dims, dtype=dtype, device=device)

    b, t = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        if cfg.is_encoder_decoder:
            td = min(cfg.max_decoder_len, t)
            specs = {"frames": sd((b, t, cfg.d_model), torch.bfloat16),
                     "tokens": sd((b, td), torch.int32)}
            if include_labels and shape.kind == "train":
                specs["labels"] = sd((b, td), torch.int32)
            return specs
        specs = {"tokens": sd((b, t), torch.int32)}
        if cfg.mrope:
            specs["pos3"] = sd((3, b, t), torch.int32)
            specs["vision_embeds"] = sd((b, min(256, t), cfg.d_model),
                                        torch.bfloat16)
        if include_labels and shape.kind == "train":
            specs["labels"] = sd((b, t), torch.int32)
        return specs
    # decode: one new token against a seq_len cache
    specs = {"token": sd((b,), torch.int32)}
    if cfg.mrope:
        specs["pos3"] = sd((3, b, 1), torch.int32)
    return specs


def batch_logical(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Logical sharding of the input batch."""
    if shape.kind in ("train", "prefill"):
        if cfg.is_encoder_decoder:
            out = {"frames": ("batch", None, None), "tokens": ("batch", None)}
            if shape.kind == "train":
                out["labels"] = ("batch", None)
            return out
        out = {"tokens": ("batch", None)}
        if cfg.mrope:
            out["pos3"] = (None, "batch", None)
            out["vision_embeds"] = ("batch", None, None)
        if shape.kind == "train":
            out["labels"] = ("batch", None)
        return out
    out = {"token": ("batch",)}
    if cfg.mrope:
        out["pos3"] = (None, "batch", None)
    return out
