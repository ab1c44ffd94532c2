"""Decoder-only transformer covering the dense, MoE, sliding-window
(gemma3) and M-RoPE VLM (qwen2-vl) architectures, with its KV cache.

Uniform pre-norm residual blocks; each parameter of the layers is stacked
on a leading axis of length `num_layers`, as the reference's `jax.vmap`
stacks it, and `forward` / `decode_step` walk the layers in a Python loop
(the reference's `lax.scan`), each layer of `forward` under
`torch.utils.checkpoint` when `remat` is set.

KV caches are (L, B, S, Kv, hd) stacks, int8 with (L, B, S, Kv) float16
scales when `kv_dtype="int8"`. Two departures from the reference, both
for a serving loop on the card: `decode_step` writes the cache's tensors
in place (the returned dict holds them, with `pos` advanced and a new
`idx`), and `idx` is a 0-d int32 tensor on the host, so a step places
its write and its window without waiting for the card.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.sharding import (MeshRules, NO_MESH, assign, host_int,
                                         kv_cache_axes, serving, stack_logical)


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


def logical_layer(cfg: ArchConfig, ep: bool, attn_mode: str = "heads") -> dict:
    t = {
        "ln1": (None,),
        "attn": L.logical_attention(cfg, attn_mode),
        "ln2": (None,),
    }
    if cfg.moe is not None:
        t["moe"] = L.logical_moe(cfg, ep)
    else:
        t["mlp"] = L.logical_mlp(cfg)
    return t


def logical_tree(cfg: ArchConfig, rules: MeshRules, *,
                 decode: bool = False) -> dict:
    ep = False
    if cfg.moe is not None and rules.mesh is not None:
        ep = cfg.moe.num_experts % rules.axis_sizes[rules.tensor] == 0
    mode = L.attn_shard_mode(cfg, rules, decode=decode)
    per_layer = logical_layer(cfg, ep, mode if mode != "seq" else "heads")
    if mode == "seq":
        # whole-layer sequence parallelism: layer weights are fsdp-only
        # (activations carry the tensor axis on T instead)
        per_layer = _drop_tp(per_layer)
    return {
        "embed": L.logical_embed(cfg),
        "layers": stack_logical(per_layer),
        "final_norm": (None,),
    }


def _drop_tp(logical):
    if isinstance(logical, dict):
        return {k: _drop_tp(v) for k, v in logical.items()}
    return tuple(None if a == "tp" else a for a in logical)


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


def layer_windows(cfg: ArchConfig) -> list[int]:
    """Per-layer attention window (0 = full/global). gemma3: 5 local : 1
    global — layer i is global iff (i+1) % global_every == 0. Python
    ints, where the reference gives an array: the layer loop reads them
    on the host (also when a step runs on fake tensors)."""
    if cfg.attn_kind != "sliding":
        return [0] * cfg.num_layers
    ge = cfg.global_every
    return [0 if ge > 0 and (i + 1) % ge == 0 else cfg.sliding_window
            for i in range(cfg.num_layers)]


# ------------------------------------------------------------------- blocks
def _qkv_rope(lp, x, cfg, q_pos, pos3):
    """Pre-norm q, k, v of one layer, rotated: M-RoPE by `pos3` where the
    config has it and `pos3` is given, else RoPE by `q_pos`."""
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = L.attention_qkv(lp["attn"], h, cfg)
    if cfg.mrope and pos3 is not None:
        q = L.apply_mrope(q, pos3, cfg.rope_theta, cfg.mrope_sections)
        k = L.apply_mrope(k, pos3, cfg.rope_theta, cfg.mrope_sections)
    else:
        q = L.apply_rope(q, q_pos, cfg.rope_theta)
        k = L.apply_rope(k, q_pos, cfg.rope_theta)
    return q, k, v


def _attn_block(lp, x, cfg, *, q_pos, window: int, pos3, rules, chunk,
                arange_pos: bool, mode: str = "none"):
    """Pre-norm self-attention with its residual; returns (x, k, v), the
    post-RoPE k and v with their own KV heads (what a cache holds).

    A layer with no window whose `q_pos` is 0..T-1 in every row
    (`arange_pos`) and whose activations are bf16 takes
    `causal_self_attention`, the fused kernel, which rounds the
    probabilities to bf16 before the product with v as the reference
    does; fp32 activations take `chunked_attention`, which rounds them
    the same way (the fused fp32 kernel would not).

    On a mesh q, k and v are constrained to the layout `mode` and each
    rank attends with its own shards (`layers.mesh_attention`)."""
    q, k, v = _qkv_rope(lp, x, cfg, q_pos, pos3)
    fused = arange_pos and window == 0 and q.dtype == torch.bfloat16
    if rules.mesh is not None:
        qspec = L.QSPEC[mode]
        q = rules.constrain(q, qspec)
        k_att, v_att = k, v
        if mode == "seq":
            # queries stay T-sharded; keys/values gather (GQA KV is small)
            k_att = rules.constrain(k, ("batch", None, None, None))
            v_att = rules.constrain(v, ("batch", None, None, None))
        elif mode == "heads_repkv":
            # expand GQA -> MHA so the head axis shards cleanly (grok: 8 kv
            # heads cannot split a 16-way axis; repeated KV shards with Q)
            g = cfg.num_heads // cfg.num_kv_heads
            k_att = rules.constrain(torch.repeat_interleave(k, g, dim=2),
                                    qspec)
            v_att = rules.constrain(torch.repeat_interleave(v, g, dim=2),
                                    qspec)
        else:
            k = k_att = rules.constrain(k, qspec)
            v = v_att = rules.constrain(v, qspec)
        o = L.mesh_attention(rules, mode, q, k_att, v_att, q_pos=q_pos,
                             kv_pos=q_pos, causal=True, window=window,
                             chunk=chunk, fused=fused)
    elif fused:
        o = L.causal_self_attention(q, k, v)
    else:
        o = L.chunked_attention(q, k, v, q_pos=q_pos, kv_pos=q_pos,
                                causal=True, window=window, chunk=chunk,
                                rules=rules)
    return x + L.attention_out(lp["attn"], o), k, v


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
    pos3: torch.Tensor | None = None,       # (3, B, T) for M-RoPE
    vision_embeds: torch.Tensor | None = None,  # (B, Tv, d) stub frontend
    rules: MeshRules = NO_MESH,
    chunk: int = 1024,
    remat: bool = True,
    collect_cache: bool = False,
    last_only: bool = False,
):
    """Full-sequence forward. Returns (logits fp32, aux_loss[, (k_stack,
    v_stack)]): with `collect_cache`, the post-RoPE (L, B, T, Kv, hd) keys
    and values; with `last_only`, the logits of the last position only."""
    b, t = tokens.shape
    x = L.embed(params["embed"], tokens, rules)
    if vision_embeds is not None:
        tv = min(vision_embeds.shape[1], t)
        x = torch.cat([vision_embeds[:, :tv].to(x.dtype), x[:, tv:]], dim=1)
    mode = L.attn_shard_mode(cfg, rules)
    xspec = ("batch", "seq", None) if mode == "seq" else ("batch", None, None)
    x = rules.constrain(x, xspec)
    arange_pos = positions is None
    q_pos = positions if positions is not None else torch.arange(
        t, dtype=torch.int32, device=tokens.device).expand(b, t)
    windows = layer_windows(cfg)
    kv_axes = kv_cache_axes(cfg.num_kv_heads, cfg.hd, rules)[1:]

    def body(x, lp, window):
        x, k, v = _attn_block(lp, x, cfg, q_pos=q_pos, window=window,
                              pos3=pos3, rules=rules, chunk=chunk,
                              arange_pos=arange_pos, mode=mode)
        x, lb = _ffn_block(lp, x, cfg, rules)
        x = rules.constrain(x, xspec)
        if collect_cache:
            # shard the emitted KV (kv heads, else head_dim, else seq)
            k, v = rules.constrain(k, kv_axes), rules.constrain(v, kv_axes)
        return x, lb, k, v

    aux = x.new_zeros((), dtype=torch.float32)
    ks, vs = [], []
    for lp, window in zip(tree.unstack(params["layers"]), windows):
        if remat:
            x, lb, k, v = checkpoint(body, x, lp, window, use_reentrant=False)
        else:
            x, lb, k, v = body(x, lp, window)
        aux = aux + lb
        if collect_cache:
            ks.append(k)
            vs.append(v)
    if mode == "seq":
        x = rules.constrain(x, ("batch", None, None))  # free T for vocab-tp
    if last_only:
        x = x[:, -1:]
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(params["embed"], x)
    if collect_cache:
        return logits, aux, (torch.stack(ks), torch.stack(vs))
    return logits, aux


# -------------------------------------------------------------------- cache
def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               rules: MeshRules = NO_MESH, kv_dtype: str = "bf16",
               device=None) -> dict:
    """An empty cache on `device` (`None` = the card; raises without
    one): k, v (L, B, max_len, Kv, hd) in the params' dtype or int8 with
    float16 scales, `pos` (B, max_len) = -1, `idx` 0 (on the host)."""
    if kv_dtype not in ("bf16", "int8"):
        raise ValueError(f"kv_dtype must be 'bf16' or 'int8', got "
                         f"{kv_dtype!r}")
    dev = resolve_device(device)
    dtype = torch.int8 if kv_dtype == "int8" else _dtype(cfg)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.hd)
    cache = {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
        "pos": torch.full((batch, max_len), -1, dtype=torch.int32,
                          device=dev),
        "idx": torch.zeros((), dtype=torch.int32),
    }
    if kv_dtype == "int8":
        cache["k_scale"] = torch.zeros(shape[:4], dtype=torch.float16,
                                       device=dev)
        cache["v_scale"] = torch.zeros(shape[:4], dtype=torch.float16,
                                       device=dev)
    if rules.mesh is None:
        return cache
    logical = cache_logical(cfg, rules, kv_dtype)
    return {k: v if k == "idx" else rules.constrain(v, logical[k])
            for k, v in cache.items()}


def cache_logical(cfg: ArchConfig, rules: MeshRules = NO_MESH,
                  kv_dtype: str = "bf16") -> dict:
    axes = kv_cache_axes(cfg.num_kv_heads, cfg.hd, rules)
    out = {
        "k": axes,
        "v": axes,
        "pos": ("batch", None),
        "idx": (),
    }
    if kv_dtype == "int8":
        out["k_scale"] = axes[:4]
        out["v_scale"] = axes[:4]
    return out


@serving
def prefill(params, cfg, tokens, max_len: int, *, rules=NO_MESH, chunk=1024,
            pos3=None, vision_embeds=None, kv_dtype: str = "bf16"):
    """Run the full prompt, build the cache on the prompt's device.
    Returns (last_logits (B, V), cache)."""
    b, t = tokens.shape
    if t > max_len:
        raise ValueError(f"a {t}-token prompt does not fit a cache of "
                         f"{max_len}")
    logits, _, (k_stack, v_stack) = forward(
        params, cfg, tokens, rules=rules, chunk=chunk, collect_cache=True,
        pos3=pos3, vision_embeds=vision_embeds, remat=False, last_only=True)
    cache = init_cache(cfg, b, max_len, rules, kv_dtype=kv_dtype,
                       device=tokens.device)
    head = (slice(None), slice(None), slice(0, t))
    if kv_dtype == "int8":
        k_stack, ks = L.quantize_kv(k_stack)
        v_stack, vs = L.quantize_kv(v_stack)
        assign(cache["k_scale"], head, ks)
        assign(cache["v_scale"], head, vs)
    assign(cache["k"], head, k_stack)
    assign(cache["v"], head, v_stack)
    assign(cache["pos"], head[1:], torch.arange(t, dtype=torch.int32,
                                                device=tokens.device))
    cache["idx"] = torch.tensor(t, dtype=torch.int32)
    return logits[:, -1], cache


@serving
def decode_step(params, cfg, token, cache, *, rules=NO_MESH, chunk=4096,
                pos3=None, window_slice: bool = True):
    """One decode step. token: (B,) int. Returns (logits (B, V), cache).

    The step's k and v go to slot `idx` of every layer (the last slot once
    `idx` reaches the cache's length: the reference's
    `dynamic_update_slice` clamps its start, and so does this). For
    sliding-window layers (`window_slice=True`, gemma3), attention reads
    only the last `sliding_window` cache entries, a slice whose start is
    clamped to fit as `dynamic_slice_in_dim` clamps it; global layers read
    the full cache. The reference carries no int8 scales through that
    branch, so an int8 cache with a sliced config raises."""
    b = token.shape[0]
    idx = host_int(cache["idx"])
    max_len = cache["k"].shape[2]
    at = min(idx, max_len - 1)
    w = cfg.sliding_window
    use_slicing = (window_slice and cfg.attn_kind == "sliding"
                   and w < max_len)
    quantized = "k_scale" in cache
    if quantized and use_slicing:
        raise ValueError(
            f"{cfg.name}: the int8 KV cache with window slicing is not "
            "supported (the reference's sliced decode carries no int8 "
            "scales); use kv_dtype='bf16' or window_slice=False")
    x = L.embed(params["embed"], token[:, None], rules)
    q_pos = torch.full((b, 1), idx, dtype=torch.int32, device=x.device)
    kv_pos = cache["pos"]
    assign(kv_pos, (slice(None), at), idx)
    start = min(max(idx - (w - 1), 0), max_len - w)
    windows = layer_windows(cfg)
    mode = L.attn_shard_mode(cfg, rules, decode=True)
    for i, (lp, window) in enumerate(zip(tree.unstack(params["layers"]),
                                         windows)):
        q, k, v = _qkv_rope(lp, x, cfg, q_pos, pos3)
        slot = (i, slice(None), at)
        if quantized:
            k, ksc = L.quantize_kv(k)
            v, vsc = L.quantize_kv(v)
            assign(cache["k_scale"], slot, ksc[:, 0])
            assign(cache["v_scale"], slot, vsc[:, 0])
        assign(cache["k"], slot, k[:, 0])
        assign(cache["v"], slot, v[:, 0])
        k_at, v_at, kv_p = cache["k"][i], cache["v"][i], kv_pos
        ks_at = vs_at = None
        if quantized:
            ks_at, vs_at = cache["k_scale"][i], cache["v_scale"][i]
        if use_slicing and window > 0:
            k_at, v_at = k_at[:, start:start + w], v_at[:, start:start + w]
            kv_p = kv_p[:, start:start + w]
        if rules.mesh is not None:
            o = L.mesh_attention(rules, mode, q, k_at, v_at, q_pos=q_pos,
                                 kv_pos=kv_p, causal=True, window=window,
                                 chunk=chunk, k_scale=ks_at, v_scale=vs_at)
        else:
            o = L.chunked_attention(q, k_at, v_at, q_pos=q_pos, kv_pos=kv_p,
                                    causal=True, window=window, chunk=chunk,
                                    rules=rules, k_scale=ks_at,
                                    v_scale=vs_at)
        x = x + L.attention_out(lp["attn"], o)
        x, _ = _ffn_block(lp, x, cfg, rules)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(params["embed"], x)[:, 0]
    new_cache = dict(cache)
    new_cache["idx"] = torch.tensor(idx + 1, dtype=torch.int32,
                                    device=cache["idx"].device)
    return logits, new_cache
