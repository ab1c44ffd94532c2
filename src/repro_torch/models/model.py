"""Uniform model API: the dense transformer family and the LM loss.

Families other than the dense decoder (MoE, M-RoPE VLM, whisper, rwkv6,
zamba2/mamba2) are not ported yet: `family_module` raises for them
rather than running them through the dense path.
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
    elif cfg.moe is not None:
        family = "mixture-of-experts layers"
    elif cfg.mrope:
        family = "M-RoPE (qwen2-vl)"
    else:
        return transformer
    raise NotImplementedError(
        f"{cfg.name}: {family} is not ported yet (ROADMAP item 17d)")


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
    """Token-level LM loss; the MoE aux term is kept (0 for dense)."""
    mod = family_module(cfg)
    logits, aux = mod.forward(
        params, cfg, batch["tokens"], rules=rules, chunk=chunk, remat=remat,
        pos3=batch.get("pos3"), vision_embeds=batch.get("vision_embeds"))
    loss = cross_entropy(logits, batch["labels"])
    return loss + 0.01 * aux
