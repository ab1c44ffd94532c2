"""Zamba2: a Mamba2 backbone with a single *shared* attention block applied
every `shared_attn_every` layers.

The shared block (one set of weights, 13 application points at 81 layers)
takes concat(hidden, initial embedding) fused to width d by a small
per-application adapter (one dense per application point), then runs a
standard attention + MLP block with its own KV cache slot per point.
Layers past the last point (81 = 13 x 6 + 3) run after it.

The cache holds the mamba states ({"ssm", "conv"}, stacked over all
layers), k and v (points, B, S, kv, hd), `pos` and `idx`. As in the
transformer's decode (`models/transformer.py`), a forward with a cache
writes it in place (states, k / v at `idx`, `pos`) and `idx` is a 0-d
int32 tensor on the host; a write at `idx >= max_len` lands in the last
slot, as the reference's `dynamic_update_slice` clamps its start.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba2
from repro_torch.models.sharding import (MeshRules, NO_MESH, assign, host_int,
                                         kv_cache_axes, serving, stack_logical,
                                         tree_constrain)


def _dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def num_shared_points(cfg: ArchConfig) -> int:
    return cfg.num_layers // cfg.shared_attn_every


def init_params(key: torch.Generator, cfg: ArchConfig) -> dict:
    dtype = _dtype(cfg)
    d = cfg.d_model
    npts = num_shared_points(cfg)
    zeros = torch.zeros((d,), dtype=dtype, device=key.device)
    embed = L.init_embed(key, cfg, dtype)
    per_layer = [mamba2.init_layer(key, cfg, dtype)
                 for _ in range(cfg.num_layers)]
    shared = {
        "ln1": zeros,
        "attn": L.init_attention(key, cfg, dtype),
        "ln2": zeros.clone(),
        "mlp": L.init_mlp(key, cfg, dtype),
    }
    adapters = torch.stack([L._dense_init(key, (2 * d, d), 2 * d, dtype)
                            for _ in range(npts)])
    return {
        "embed": embed,
        "layers": tree.map(lambda *xs: torch.stack(xs), *per_layer),
        "shared": shared,
        "adapters": adapters,           # (npts, 2d, d)
        "final_norm": zeros.clone(),
    }


def logical_tree(cfg: ArchConfig, rules: MeshRules) -> dict:
    return {
        "embed": L.logical_embed(cfg),
        "layers": stack_logical(mamba2.logical_layer(cfg)),
        "shared": {
            "ln1": (None,),
            "attn": L.logical_attention(cfg, L.attn_shard_mode(cfg, rules)),
            "ln2": (None,),
            "mlp": L.logical_mlp(cfg),
        },
        "adapters": (None, "d", "tp"),
        "final_norm": (None,),
    }


# -------------------------------------------------------------------- cache
def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               rules: MeshRules = NO_MESH, device=None) -> dict:
    """An empty cache on `device` (`None` = the card; raises without one);
    `idx` 0 on the host."""
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    shape = (num_shared_points(cfg), batch, max_len, cfg.num_kv_heads, cfg.hd)
    axes = kv_cache_axes(cfg.num_kv_heads, cfg.hd, rules)
    return {
        "mamba": mamba2.init_state(cfg, batch, cfg.num_layers, rules, dtype,
                                   device=dev),
        "k": rules.constrain(torch.zeros(shape, dtype=dtype, device=dev),
                             axes),
        "v": rules.constrain(torch.zeros(shape, dtype=dtype, device=dev),
                             axes),
        "pos": rules.constrain(torch.full((batch, max_len), -1,
                                          dtype=torch.int32, device=dev),
                               ("batch", None)),
        "idx": torch.zeros((), dtype=torch.int32),
    }


def cache_logical(cfg: ArchConfig, rules: MeshRules = NO_MESH) -> dict:
    axes = kv_cache_axes(cfg.num_kv_heads, cfg.hd, rules)
    return {
        "mamba": mamba2.state_logical(cfg),
        "k": axes,
        "v": axes,
        "pos": ("batch", None),
        "idx": (),
    }


def _shared_block(params, pt_idx, x, x0, cfg, *, q_pos, cache_k, cache_v,
                  kv_pos, write_at, rules, chunk):
    """Apply the shared attention block at application point `pt_idx`.
    With `cache_k` / `cache_v` ((B, S, kv, hd) views of the cache) the
    segment's keys and values are written at `write_at` and attention
    reads the whole cache; without (train), it is causal self-attention
    at positions 0..T-1, by the fused kernel for bf16 activations."""
    sp = params["shared"]
    adapter = params["adapters"][pt_idx]
    h = L.matmul(torch.cat([x, x0], dim=-1), adapter)
    hn = L.rms_norm(h, sp["ln1"], cfg.norm_eps)
    q, k, v = L.attention_qkv(sp["attn"], hn, cfg)
    q = L.apply_rope(q, q_pos, cfg.rope_theta)
    k = L.apply_rope(k, q_pos, cfg.rope_theta)
    mode = L.attn_shard_mode(cfg, rules)
    if cache_k is not None:
        at = (slice(None), slice(write_at, write_at + k.shape[1]))
        assign(cache_k, at, k)
        assign(cache_v, at, v)
        o = L.attend(rules, mode, q, cache_k, cache_v, q_pos=q_pos,
                     kv_pos=kv_pos, causal=True, chunk=chunk)
    else:
        o = L.attend(rules, mode, q, k, v, q_pos=q_pos, kv_pos=q_pos,
                     causal=True, chunk=chunk,
                     fused=q.dtype == torch.bfloat16)
    h = h + L.attention_out(sp["attn"], o)
    h = h + L.mlp(sp["mlp"], L.rms_norm(h, sp["ln2"], cfg.norm_eps), cfg)
    return x + h


def forward(params, cfg: ArchConfig, tokens, *, cache=None, rules=NO_MESH,
            ssm_chunk: int = 64, attn_chunk: int = 1024, remat: bool = True,
            return_cache: bool = False, last_only: bool = False):
    """Full-sequence forward. Without a cache (train) the mamba states
    start at zero and the shared block attends causally within the
    sequence; with one (or `return_cache`, which builds a fresh cache of
    T positions) the states, k, v and `pos` are written into it in place.
    Returns (logits fp32, cache) with `return_cache`, else (logits, 0).
    With `remat`, each mamba layer runs under `torch.utils.checkpoint`."""
    b, t = tokens.shape
    x = L.embed(params["embed"], tokens, rules)
    x = rules.constrain(x, ("batch", None, None))
    x0 = x
    if cache is None and return_cache:
        cache = init_cache(cfg, b, t, rules, device=tokens.device)
    idx = host_int(cache["idx"]) if cache is not None else 0
    q_pos = idx + torch.arange(t, dtype=torch.int32,
                               device=tokens.device).expand(b, t)
    kv_pos = write_at = None
    if cache is not None:
        max_len = cache["k"].shape[2]
        if t > max_len:
            raise ValueError(f"{t} tokens do not fit a cache of {max_len}")
        write_at = min(idx, max_len - t)
        kv_pos = cache["pos"]
        assign(kv_pos, (slice(None), slice(write_at, write_at + t)), q_pos)
        states = tree.unstack(cache["mamba"])
    else:
        d_in, nheads, n, conv_dim = mamba2.dims(cfg)
        zero = {"ssm": x.new_zeros((b, nheads, mamba2.MAMBA_HEAD_DIM, n),
                                   dtype=torch.float32),
                "conv": x.new_zeros((b, mamba2.CONV_K - 1, conv_dim))}
        zero = tree_constrain(rules, zero, {"ssm": ("batch", "tp", None, None),
                                            "conv": ("batch", None, "tp")})
        states = [zero] * cfg.num_layers
    layers = tree.unstack(params["layers"])

    def mamba_layer(x, lp, st):
        out, st_new = mamba2.block(lp, x, cfg, st, chunk=ssm_chunk,
                                   rules=rules)
        x = rules.constrain(x + out, ("batch", None, None))
        return x, st_new["ssm"], st_new["conv"]

    def mamba_seg(x, lo: int, hi: int):
        for i in range(lo, hi):
            if remat:
                x, ssm, conv = checkpoint(mamba_layer, x, layers[i],
                                          states[i], use_reentrant=False)
            else:
                x, ssm, conv = mamba_layer(x, layers[i], states[i])
            if cache is not None:
                assign(states[i]["ssm"], (...,), ssm)
                assign(states[i]["conv"], (...,), conv)
        return x

    every = cfg.shared_attn_every
    npts = num_shared_points(cfg)
    for p in range(npts):
        x = mamba_seg(x, p * every, (p + 1) * every)
        x = _shared_block(
            params, p, x, x0, cfg, q_pos=q_pos,
            cache_k=None if cache is None else cache["k"][p],
            cache_v=None if cache is None else cache["v"][p],
            kv_pos=kv_pos, write_at=write_at, rules=rules, chunk=attn_chunk)
    x = mamba_seg(x, npts * every, cfg.num_layers)      # trailing layers

    if last_only:
        x = x[:, -1:]
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(params["embed"], x)
    if return_cache:
        new_cache = dict(cache)
        new_cache["idx"] = torch.tensor(idx + t, dtype=torch.int32)
        return logits, new_cache
    return logits, x.new_zeros((), dtype=torch.float32)


@serving
def prefill(params, cfg, tokens, max_len: int, *, rules=NO_MESH,
            ssm_chunk=64, attn_chunk=1024):
    """Run the prompt into a fresh cache of `max_len` positions on the
    prompt's device. Returns (last logits (B, V), cache)."""
    b, t = tokens.shape
    cache = init_cache(cfg, b, max_len, rules, device=tokens.device)
    logits, cache = forward(
        params, cfg, tokens, cache=cache, rules=rules, ssm_chunk=ssm_chunk,
        attn_chunk=attn_chunk, remat=False, return_cache=True, last_only=True)
    return logits[:, -1], cache


@serving
def decode_step(params, cfg, token, cache, *, rules=NO_MESH,
                attn_chunk: int = 4096):
    """One decode step, token: (B,) int, the cache written in place.
    Returns (logits (B, V), cache)."""
    logits, cache = forward(
        params, cfg, token[:, None], cache=cache, rules=rules, ssm_chunk=1,
        attn_chunk=attn_chunk, remat=False, return_cache=True)
    return logits[:, -1], cache
