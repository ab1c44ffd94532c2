"""Uniform model API over all ten architectures: params and their logical
trees, the LM loss and the serve API (`init_cache`, `cache_logical`,
`decode_step`).

Families: the transformer (dense, MoE, sliding window, M-RoPE VLM),
whisper (encoder-decoder), rwkv6 (attention-free RNN) and zamba2 (Mamba2
with a shared attention block). One departure from the reference: rwkv6
and zamba2 have no int8 cache, and `kv_dtype="int8"` raises for them
where the reference would hand back its bf16 state.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import rwkv6, transformer, whisper, zamba2
from repro_torch.models.sharding import NO_MESH, MeshRules


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
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)


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
    if mod is rwkv6:
        return mod.decode_step(params, cfg, token, cache, rules=rules)
    if mod is zamba2:
        return mod.decode_step(params, cfg, token, cache, rules=rules,
                               attn_chunk=chunk)
    return mod.decode_step(params, cfg, token, cache, rules=rules,
                           chunk=chunk, pos3=pos3)
