"""Decoder-only transformer, the dense train forward.

Uniform pre-norm residual blocks; each parameter of the layers is stacked
on a leading axis of length `num_layers`, as the reference's `jax.vmap`
stacks it, and `forward` walks the layers in a Python loop (the
reference's `lax.scan`), each layer under `torch.utils.checkpoint` when
`remat` is set. MoE layers, M-RoPE and the KV-cache paths (`prefill`,
`decode_step`, `init_cache`) are not ported yet.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.sharding import NO_MESH, MeshRules


def _dtype(cfg: ArchConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ----------------------------------------------------------------- params
def init_layer(key, cfg: ArchConfig, dtype) -> dict:
    """One layer's params, drawn from the generator `key` on its device."""
    zeros = torch.zeros((cfg.d_model,), dtype=dtype, device=key.device)
    p = {
        "ln1": zeros,
        "attn": L.init_attention(key, cfg, dtype),
        "ln2": zeros.clone(),
    }
    if cfg.moe is not None:
        p["moe"] = L.init_moe(key, cfg, dtype)
    else:
        p["mlp"] = L.init_mlp(key, cfg, dtype)
    return p


def init_params(key, cfg: ArchConfig) -> dict:
    dtype = _dtype(cfg)
    embed = L.init_embed(key, cfg, dtype)
    per_layer = [init_layer(key, cfg, dtype) for _ in range(cfg.num_layers)]
    stacked = tree.map(lambda *xs: torch.stack(xs), *per_layer)
    return {
        "embed": embed,
        "layers": stacked,
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                  device=key.device),
    }


def layer_windows(cfg: ArchConfig) -> torch.Tensor:
    """Per-layer attention window (0 = full/global). gemma3: 5 local : 1
    global — layer i is global iff (i+1) % global_every == 0."""
    idx = torch.arange(cfg.num_layers)
    if cfg.attn_kind == "sliding":
        if cfg.global_every > 0:
            is_global = (idx + 1) % cfg.global_every == 0
            return torch.where(is_global, 0, cfg.sliding_window).to(torch.int32)
        return torch.full((cfg.num_layers,), cfg.sliding_window,
                          dtype=torch.int32)
    return torch.zeros((cfg.num_layers,), dtype=torch.int32)


# ------------------------------------------------------------------- blocks
def _attn_block(lp, x, cfg, *, q_pos, window: int, rules, chunk,
                arange_pos: bool):
    """Pre-norm self-attention with its residual.

    A layer with no window whose `q_pos` is 0..T-1 in every row
    (`arange_pos`) and whose activations are bf16 takes
    `causal_self_attention`, the fused kernel, which rounds the
    probabilities to bf16 before the product with v as the reference
    does; fp32 activations take `chunked_attention`, which rounds them
    the same way (the fused fp32 kernel would not)."""
    if cfg.mrope:
        raise NotImplementedError(
            "M-RoPE (qwen2-vl) is not ported yet (ROADMAP item 17d)")
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = L.attention_qkv(lp["attn"], h, cfg)
    q = L.apply_rope(q, q_pos, cfg.rope_theta)
    k = L.apply_rope(k, q_pos, cfg.rope_theta)
    if arange_pos and window == 0 and q.dtype == torch.bfloat16:
        o = L.causal_self_attention(q, k, v)
    else:
        o = L.chunked_attention(q, k, v, q_pos=q_pos, kv_pos=q_pos,
                                causal=True, window=window, chunk=chunk,
                                rules=rules)
    return x + L.attention_out(lp["attn"], o)


def _ffn_block(lp, x, cfg, rules):
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.moe is not None:
        out, aux = L.moe(lp["moe"], h, cfg, rules)
        return x + out, aux.load_balance_loss
    return x + L.mlp(lp["mlp"], h, cfg), x.new_zeros((), dtype=torch.float32)


# ------------------------------------------------------------------ forward
def forward(
    params,
    cfg: ArchConfig,
    tokens: torch.Tensor,                   # (B, T) int
    *,
    positions: torch.Tensor | None = None,  # (B, T) absolute; default arange
    pos3: torch.Tensor | None = None,
    vision_embeds: torch.Tensor | None = None,
    rules: MeshRules = NO_MESH,
    chunk: int = 1024,
    remat: bool = True,
    collect_cache: bool = False,
    last_only: bool = False,
):
    """Full-sequence forward. Returns (logits fp32, aux_loss)."""
    if pos3 is not None or vision_embeds is not None:
        raise NotImplementedError(
            "M-RoPE and vision inputs are not ported yet (ROADMAP item 17d)")
    if collect_cache:
        raise NotImplementedError(
            "KV-cache collection (prefill) is not ported yet "
            "(ROADMAP item 17g)")
    b, t = tokens.shape
    x = L.embed(params["embed"], tokens)
    arange_pos = positions is None
    q_pos = positions if positions is not None else torch.arange(
        t, dtype=torch.int32, device=tokens.device).expand(b, t)
    windows = layer_windows(cfg).tolist()
    # one unbind per leaf: its backward stacks the layers' gradients once
    paths, stacked = zip(*tree.items(params["layers"]))
    slices = [leaf.unbind(0) for leaf in stacked]

    def body(x, lp, window):
        x = _attn_block(lp, x, cfg, q_pos=q_pos, window=window, rules=rules,
                        chunk=chunk, arange_pos=arange_pos)
        return _ffn_block(lp, x, cfg, rules)

    aux = x.new_zeros((), dtype=torch.float32)
    for i, window in enumerate(windows):
        lp: dict = {}
        for path, leaf in zip(paths, slices):
            node = lp
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = leaf[i]
        if remat:
            x, lb = checkpoint(body, x, lp, window, use_reentrant=False)
        else:
            x, lb = body(x, lp, window)
        aux = aux + lb
    if last_only:
        x = x[:, -1:]
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(params["embed"], x)
    return logits, aux
