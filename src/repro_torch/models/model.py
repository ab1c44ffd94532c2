"""Uniform model API over the transformer family (dense, MoE, sliding
window, M-RoPE VLM): params, the LM loss and the serve API (`init_cache`,
`cache_logical`, `decode_step`).

The other families (whisper, rwkv6, zamba2/mamba2) are not ported yet:
`family_module` raises for them rather than running them through the
transformer.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer
from repro_torch.models.sharding import NO_MESH, MeshRules


def family_module(cfg: ArchConfig):
    if cfg.is_encoder_decoder:
        family = "the encoder-decoder family (whisper)"
    elif cfg.ssm_kind == "rwkv6":
        family = "the rwkv6 family"
    elif cfg.shared_attn_every or cfg.ssm_kind:
        family = "the mamba2/zamba2 family"
    else:
        return transformer
    raise NotImplementedError(
        f"{cfg.name}: {family} is not ported yet (ROADMAP item 17d.2)")


def init_params(key, cfg: ArchConfig):
    return family_module(cfg).init_params(key, cfg)


# ------------------------------------------------------------------- losses
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)


def train_loss(params, cfg: ArchConfig, batch: dict, *,
               rules: MeshRules = NO_MESH, chunk: int = 1024,
               remat: bool = True) -> torch.Tensor:
    """Token-level LM loss plus 0.01 x the MoE load-balance aux (0 for
    dense layers)."""
    mod = family_module(cfg)
    logits, aux = mod.forward(
        params, cfg, batch["tokens"], rules=rules, chunk=chunk, remat=remat,
        pos3=batch.get("pos3"), vision_embeds=batch.get("vision_embeds"))
    loss = cross_entropy(logits, batch["labels"])
    return loss + 0.01 * aux


# ---------------------------------------------------------------- serve API
def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               rules: MeshRules = NO_MESH, kv_dtype: str = "bf16",
               device=None):
    return family_module(cfg).init_cache(cfg, batch, max_len, rules,
                                         kv_dtype=kv_dtype, device=device)


def cache_logical(cfg: ArchConfig, rules: MeshRules = NO_MESH,
                  kv_dtype: str = "bf16"):
    return family_module(cfg).cache_logical(cfg, rules, kv_dtype=kv_dtype)


def decode_step(params, cfg: ArchConfig, token, cache, *, rules=NO_MESH,
                chunk: int = 4096, pos3=None):
    return family_module(cfg).decode_step(params, cfg, token, cache,
                                          rules=rules, chunk=chunk, pos3=pos3)
