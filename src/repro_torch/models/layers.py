"""Shared layer library, the dense parts: RMSNorm, RoPE, GQA attention,
SwiGLU/GeGLU MLP, embeddings.

Params are nested dicts of tensors with the JAX package's names and
shapes. Math runs in fp32 where the reference's does (norms, RoPE,
attention scores, the unembedding's accumulation) and in the params'
dtype elsewhere. `apply_mrope`, `moe` and `quantize_kv` are not ported
yet and raise.

Attention has two routes. Causal bf16 self-attention at positions
0..T-1 with no window (the train forward) calls `causal_self_attention`,
PyTorch's `scaled_dot_product_attention`; every other case (explicit
positions, -1 for invalid slots, a sliding window, fp32 activations)
goes through `chunked_attention`, an online softmax over KV chunks in
plain torch that autograd differentiates. Both round q, k and v to bf16
before the products, as the reference does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.sharding import NO_MESH, MeshRules


# --------------------------------------------------------------------- utils
def _dense_init(key: torch.Generator, shape, in_dim, dtype) -> torch.Tensor:
    """Normal(0, 1/in_dim) drawn in fp32 from `key` on its device."""
    scale = 1.0 / math.sqrt(in_dim)
    x = torch.randn(shape, generator=key, device=key.device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")      # jax.nn.gelu's default


def act_fn(name: str):
    return _gelu if name == "gelu" else F.silu


# ---------------------------------------------------------------------- RoPE
def rope_freqs(hd: int, theta: float, device="cpu") -> torch.Tensor:
    exponent = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, T, H, hd); pos: (B, T) absolute positions."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)               # (hd/2,)
    angles = pos[..., None].float() * freqs               # (B, T, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, pos3, theta, sections):
    raise NotImplementedError(
        "M-RoPE (qwen2-vl) is not ported yet (ROADMAP item 17d)")


# ----------------------------------------------------------------- attention
def _mask_chunk(p_i, q_pos, causal: bool, window: int) -> torch.Tensor:
    """(B,1,1,Tq,chunk) validity mask; p_i: (B,chunk); q_pos: (B,Tq)."""
    kv = p_i[:, None, None, None, :]
    q = q_pos[:, None, None, :, None]
    valid = kv >= 0
    if causal:
        valid = valid & (kv <= q)
    if window > 0:                      # 0 -> full / global layer
        valid = valid & (kv > q - window)
    return valid


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 and widened to fp32: the reference's operand
    cast before a product accumulated in fp32."""
    return x.to(torch.bfloat16).float()


def chunked_attention(
    q: torch.Tensor,               # (B, Tq, H, hd)
    k: torch.Tensor,               # (B, S, Kv, hd)
    v: torch.Tensor,               # (B, S, Kv, hd)
    *,
    q_pos: torch.Tensor,           # (B, Tq) absolute positions
    kv_pos: torch.Tensor,          # (B, S) absolute positions; -1 = invalid
    causal: bool = True,
    window: int = 0,               # 0 = full; >0 = sliding window size
    chunk: int = 1024,
    rules: MeshRules = NO_MESH,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Attention by an online softmax over KV chunks, in the reference's
    arithmetic: q, k, v and the probabilities rounded to bf16, scores and
    sums in fp32, fully masked rows 0. Plain torch, so autograd gives the
    gradients; the running max is held out of the graph (the softmax does
    not depend on it)."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "the int8 KV cache is not ported yet (ROADMAP item 17g)")
    window = int(window)
    b, tq, h, hd = q.shape
    s, kv_heads = k.shape[1], k.shape[2]
    g = h // kv_heads
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad), value=-1)
    scale = 1.0 / math.sqrt(hd)
    qg = _bf16(q.reshape(b, tq, kv_heads, g, hd).permute(0, 2, 3, 1, 4))
    acc = q.new_zeros((b, kv_heads, g, tq, hd), dtype=torch.float32)
    m = q.new_full((b, kv_heads, g, tq), -math.inf, dtype=torch.float32)
    l = q.new_zeros((b, kv_heads, g, tq), dtype=torch.float32)
    for c in range(0, k.shape[1], chunk):
        k_i = _bf16(k[:, c:c + chunk])
        v_i = _bf16(v[:, c:c + chunk])
        valid = _mask_chunk(kv_pos[:, c:c + chunk], q_pos, causal, window)
        sc = torch.einsum("bkgth,bckh->bkgtc", qg, k_i) * scale
        sc = torch.where(valid, sc, -math.inf)
        with torch.no_grad():
            m_new = torch.maximum(m, sc.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        p = torch.where(valid, torch.exp(sc - m_safe[..., None]), 0.0)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgtc,bckh->bkgth", _bf16(p), v_i)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, tq, h, hd)
    return out.to(q.dtype)


def causal_self_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """`chunked_attention` for q, k and v at positions 0..T-1, causal, no
    window: one `scaled_dot_product_attention` call (a fused kernel on the
    card) with grouped KV heads. (B, T, H, hd) q and (B, T, Kv, hd) k, v;
    the operands are rounded to bf16 and the output has q's dtype."""
    dt = q.dtype

    def heads_first(x):
        return x.to(torch.bfloat16).to(dt).transpose(1, 2)

    out = F.scaled_dot_product_attention(
        heads_first(q), heads_first(k), heads_first(v), is_causal=True,
        enable_gqa=True)
    return out.transpose(1, 2)


# --------------------------------------------------------------- GQA module
def init_attention(key, cfg, dtype) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    p = {
        "wq": _dense_init(key, (d, h, hd), d, dtype),
        "wk": _dense_init(key, (d, kv, hd), d, dtype),
        "wv": _dense_init(key, (d, kv, hd), d, dtype),
        "wo": _dense_init(key, (h, hd, d), h * hd, dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), dtype=dtype, device=key.device)
        p["bk"] = torch.zeros((kv, hd), dtype=dtype, device=key.device)
        p["bv"] = torch.zeros((kv, hd), dtype=dtype, device=key.device)
    return p


def attention_qkv(params, x, cfg):
    q = torch.einsum("btd,dhk->bthk", x, params["wq"])
    k = torch.einsum("btd,dhk->bthk", x, params["wk"])
    v = torch.einsum("btd,dhk->bthk", x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return q, k, v


def attention_out(params, o):
    return torch.einsum("bthk,hkd->btd", o, params["wo"])


# ----------------------------------------------------------------------- MLP
def init_mlp(key, cfg, dtype, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wi_gate": _dense_init(key, (d, f), d, dtype),
        "wi_up": _dense_init(key, (d, f), d, dtype),
        "wo": _dense_init(key, (f, d), f, dtype),
    }


def mlp(params, x, cfg):
    gate = torch.einsum("btd,df->btf", x, params["wi_gate"])
    up = torch.einsum("btd,df->btf", x, params["wi_up"])
    return torch.einsum("btf,fd->btd", act_fn(cfg.act)(gate) * up,
                        params["wo"])


# ----------------------------------------------------------------------- MoE
def init_moe(key, cfg, dtype) -> dict:
    raise NotImplementedError(
        "mixture-of-experts layers are not ported yet (ROADMAP item 17d)")


def moe(params, x, cfg, rules: MeshRules = NO_MESH, group_size: int = 2048):
    raise NotImplementedError(
        "mixture-of-experts layers are not ported yet (ROADMAP item 17d)")


# ----------------------------------------------------------------- embedding
def init_embed(key, cfg, dtype) -> dict:
    return {"table": _dense_init(key, (cfg.vocab_size, cfg.d_model),
                                 cfg.d_model, dtype)}


def embed(params, tokens):
    return params["table"][tokens]


def unembed(params, x):
    """(B, T, d) -> (B, T, V) fp32 logits: both operands rounded to bf16,
    the products summed in fp32 (the reference's bf16 einsum with an fp32
    result), not a bf16 matmul, whose output would be rounded to bf16."""
    return _bf16(x) @ _bf16(params["table"]).T


# ------------------------------------------------------------ int8 KV cache
def quantize_kv(x):
    raise NotImplementedError(
        "the int8 KV cache is not ported yet (ROADMAP item 17g)")
