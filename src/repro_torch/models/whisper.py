"""Whisper-style encoder-decoder backbone (audio frontend stubbed).

The encoder consumes precomputed frame embeddings (B, T_enc, d): the conv
frontend is a stub. Sinusoidal positions, bidirectional self-attention,
plain GELU MLP. The decoder: causal self-attention (cached for decode)
and cross-attention to the encoder memory (K/V computed once at prefill).

The encoder's and the cross-attention's non-causal attention take the
chunked online softmax (`layers.chunked_attention`); the teacher-forced
decoder's causal self-attention at positions 0..T-1 takes the fused
kernel for bf16 activations, as the transformer's train forward does. A
decode with a self cache writes its k, v and `pos` in place (`idx` on
the host); a write at `idx >= max_len` lands in the last slot.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.sharding import (MeshRules, NO_MESH, assign, host_int,
                                         stack_logical)


def _dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def sinusoid(t: int, d: int, device="cpu") -> torch.Tensor:
    pos = torch.arange(t, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def init_plain_mlp(key, cfg, dtype):
    return {
        "wi": L._dense_init(key, (cfg.d_model, cfg.d_ff), cfg.d_model, dtype),
        "wo": L._dense_init(key, (cfg.d_ff, cfg.d_model), cfg.d_ff, dtype),
    }


def logical_plain_mlp():
    return {"wi": ("d", "tp"), "wo": ("tp", "d")}


def plain_mlp(p, x):
    return L.matmul(L.act_fn("gelu")(L.matmul(x, p["wi"])), p["wo"])


def init_enc_layer(key, cfg, dtype):
    zeros = torch.zeros((cfg.d_model,), dtype=dtype, device=key.device)
    return {
        "ln1": zeros,
        "attn": L.init_attention(key, cfg, dtype),
        "ln2": zeros.clone(),
        "mlp": init_plain_mlp(key, cfg, dtype),
    }


def init_dec_layer(key, cfg, dtype):
    zeros = torch.zeros((cfg.d_model,), dtype=dtype, device=key.device)
    return {
        "ln1": zeros,
        "self_attn": L.init_attention(key, cfg, dtype),
        "ln_x": zeros.clone(),
        "cross_attn": L.init_attention(key, cfg, dtype),
        "ln2": zeros.clone(),
        "mlp": init_plain_mlp(key, cfg, dtype),
    }


def init_params(key: torch.Generator, cfg: ArchConfig) -> dict:
    dtype = _dtype(cfg)

    def stacked(layers):
        return tree.map(lambda *xs: torch.stack(xs), *layers)

    embed = L.init_embed(key, cfg, dtype)
    enc = stacked([init_enc_layer(key, cfg, dtype)
                   for _ in range(cfg.encoder_layers)])
    dec = stacked([init_dec_layer(key, cfg, dtype)
                   for _ in range(cfg.num_layers)])
    zeros = torch.zeros((cfg.d_model,), dtype=dtype, device=key.device)
    return {
        "embed": embed,
        "enc_layers": enc,
        "dec_layers": dec,
        "enc_norm": zeros,
        "dec_norm": zeros.clone(),
    }


def logical_tree(cfg: ArchConfig, rules: MeshRules) -> dict:
    mode = L.attn_shard_mode(cfg, rules)
    enc = {"ln1": (None,), "attn": L.logical_attention(cfg, mode),
           "ln2": (None,), "mlp": logical_plain_mlp()}
    dec = {"ln1": (None,), "self_attn": L.logical_attention(cfg, mode),
           "ln_x": (None,), "cross_attn": L.logical_attention(cfg, mode),
           "ln2": (None,), "mlp": logical_plain_mlp()}
    return {
        "embed": L.logical_embed(cfg),
        "enc_layers": stack_logical(enc),
        "dec_layers": stack_logical(dec),
        "enc_norm": (None,), "dec_norm": (None,),
    }


# ------------------------------------------------------------------ encoder
def encode(params, cfg, frames, *, rules=NO_MESH, chunk=1024, remat=True):
    """frames: (B, T_enc, d) stub embeddings -> (B, T_enc, d) memory."""
    b, t, d = frames.shape
    dtype = _dtype(cfg)
    x = frames.to(dtype) + sinusoid(t, d, frames.device).to(dtype)
    x = rules.constrain(x, ("batch", None, None))
    pos = torch.arange(t, dtype=torch.int32, device=frames.device).expand(b, t)
    mode = L.attn_shard_mode(cfg, rules)

    def body(x, lp):
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = L.attention_qkv(lp["attn"], h, cfg)
        o = L.attend(rules, mode, q, k, v, q_pos=pos, kv_pos=pos,
                     causal=False, chunk=chunk)
        x = x + L.attention_out(lp["attn"], o)
        x = x + plain_mlp(lp["mlp"], L.rms_norm(x, lp["ln2"], cfg.norm_eps))
        return rules.constrain(x, ("batch", None, None))

    for lp in tree.unstack(params["enc_layers"]):
        x = checkpoint(body, x, lp, use_reentrant=False) if remat \
            else body(x, lp)
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


# ------------------------------------------------------------------ decoder
def cross_kv(params, cfg, memory, rules=NO_MESH):
    """Cross-attention K/V of every decoder layer from the encoder memory:
    (L, B, T_enc, kv, hd) each."""
    xk, xv = [], []
    for lp in tree.unstack(params["dec_layers"]):
        k = torch.einsum("btd,dhk->bthk", memory, lp["cross_attn"]["wk"])
        v = torch.einsum("btd,dhk->bthk", memory, lp["cross_attn"]["wv"])
        if cfg.qkv_bias:
            k = k + lp["cross_attn"]["bk"]
            v = v + lp["cross_attn"]["bv"]
        xk.append(k)
        xv.append(v)
    xk = rules.constrain(torch.stack(xk), (None, "batch", None, "tp", None))
    xv = rules.constrain(torch.stack(xv), (None, "batch", None, "tp", None))
    return xk, xv


def decode(params, cfg, tokens, memory=None, *, xk=None, xv=None,
           self_cache=None, rules=NO_MESH, chunk=1024, remat=True,
           start_pos=0):
    """Decoder forward. Either `memory` (computes the cross K/V) or
    precomputed (xk, xv). self_cache: {"k", "v", "pos", "idx"} stacked
    (L, ...) for incremental decoding, written in place; None for
    teacher-forced training. Returns (logits, new self cache) with a
    cache, else (logits, 0)."""
    b, t = tokens.shape
    x = L.embed(params["embed"], tokens, rules)
    d = x.shape[-1]
    dev = x.device
    if xk is None:
        xk, xv = cross_kv(params, cfg, memory)
    enc_t = xk.shape[2]
    mem_pos = torch.arange(enc_t, dtype=torch.int32, device=dev).expand(b, enc_t)
    use_cache = self_cache is not None
    idx = host_int(self_cache["idx"]) if use_cache else 0
    q_pos = idx + torch.arange(t, dtype=torch.int32, device=dev).expand(b, t)
    table = sinusoid(cfg.max_decoder_len, d, dev).to(x.dtype)
    x = x + table[torch.clamp(q_pos[0], 0, cfg.max_decoder_len - 1).long()]
    x = rules.constrain(x, ("batch", None, None))
    mode = L.attn_shard_mode(cfg, rules)

    kv_pos = write_at = None
    if use_cache:
        max_len = self_cache["k"].shape[2]
        if t > max_len:
            raise ValueError(f"{t} decoder tokens do not fit a self cache "
                             f"of {max_len}")
        write_at = min(idx, max_len - t)
        kv_pos = self_cache["pos"]
        assign(kv_pos, (slice(None), slice(write_at, write_at + t)), q_pos)

    def body(x, lp, xk_l, xv_l, kc, vc):
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = L.attention_qkv(lp["self_attn"], h, cfg)
        if kc is not None:
            at = (slice(None), slice(write_at, write_at + t))
            assign(kc, at, k)
            assign(vc, at, v)
            o = L.attend(rules, mode, q, kc, vc, q_pos=q_pos, kv_pos=kv_pos,
                         causal=True, chunk=chunk)
        else:
            o = L.attend(rules, mode, q, k, v, q_pos=q_pos, kv_pos=q_pos,
                         causal=True, chunk=chunk,
                         fused=q.dtype == torch.bfloat16)
        x = x + L.attention_out(lp["self_attn"], o)
        hx = L.rms_norm(x, lp["ln_x"], cfg.norm_eps)
        qx = torch.einsum("btd,dhk->bthk", hx, lp["cross_attn"]["wq"])
        if cfg.qkv_bias:
            qx = qx + lp["cross_attn"]["bq"]
        ox = L.attend(rules, mode, qx, xk_l, xv_l, q_pos=q_pos,
                      kv_pos=mem_pos, causal=False, chunk=chunk)
        x = x + L.attention_out(lp["cross_attn"], ox)
        x = x + plain_mlp(lp["mlp"], L.rms_norm(x, lp["ln2"], cfg.norm_eps))
        return rules.constrain(x, ("batch", None, None))

    layers = tree.unstack(params["dec_layers"])
    for i, lp in enumerate(layers):
        kc = self_cache["k"][i] if use_cache else None
        vc = self_cache["v"][i] if use_cache else None
        if remat and not use_cache:
            x = checkpoint(body, x, lp, xk[i], xv[i], None, None,
                           use_reentrant=False)
        else:
            x = body(x, lp, xk[i], xv[i], kc, vc)
    x = L.rms_norm(x, params["dec_norm"], cfg.norm_eps)
    logits = L.unembed(params["embed"], x)
    if use_cache:
        new_cache = dict(self_cache)
        new_cache["idx"] = torch.tensor(idx + t, dtype=torch.int32)
        return logits, new_cache
    return logits, x.new_zeros((), dtype=torch.float32)


def init_self_cache(cfg, batch, max_len, rules=NO_MESH, device=None) -> dict:
    """An empty decoder self cache on `device` (`None` = the card; raises
    without one); `idx` 0 on the host."""
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
        "v": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
        "pos": torch.full((batch, max_len), -1, dtype=torch.int32,
                          device=dev),
        "idx": torch.zeros((), dtype=torch.int32),
    }


def forward(params, cfg, frames, tokens, *, rules=NO_MESH, chunk=1024,
            remat=True):
    """Teacher-forced train forward: (encoder frames, decoder tokens) ->
    (logits, 0)."""
    memory = encode(params, cfg, frames, rules=rules, chunk=chunk,
                    remat=remat)
    return decode(params, cfg, tokens, memory, rules=rules, chunk=chunk,
                  remat=remat)
