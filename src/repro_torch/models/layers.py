"""Shared layer library: RMSNorm, RoPE/M-RoPE, GQA attention (with the
int8-KV decode path), SwiGLU/GeGLU MLP, GShard-style MoE, embeddings.

Params are nested dicts of tensors with the JAX package's names and
shapes; each init_* has a matching logical_* tree of axis names, in the
off-mesh layout (the others need a device mesh, ROADMAP item 17h). Math
runs in fp32 where the reference's does (norms, RoPE, attention scores,
the MoE router, the unembedding's accumulation) and in the params' dtype
elsewhere.

Attention has two routes. Causal bf16 self-attention at positions
0..T-1 with no window (the train forward) calls `causal_self_attention`,
PyTorch's `scaled_dot_product_attention`; every other case (explicit
positions, -1 for invalid slots, a sliding window, fp32 activations)
goes through `chunked_attention`, an online softmax over KV chunks in
plain torch that autograd differentiates. Both round q, k and v to bf16
before the products, as the reference does.
"""
from __future__ import annotations

import dataclasses
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
    return _rotate(x, angles)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (B, T, H, hd) rotated by fp32 angles (B, T, hd/2), in fp32."""
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, pos3: torch.Tensor, theta: float,
                sections: tuple[int, ...]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE. pos3: (3, B, T) = (temporal, h, w) ids;
    frequency dims split into `sections` (sums to hd/2), each section
    rotated by its own position stream."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"M-RoPE sections {sections} do not sum to "
                         f"hd/2 = {hd // 2}")
    freqs = rope_freqs(hd, theta, x.device)                # (hd/2,)
    sec_ids = torch.repeat_interleave(
        torch.arange(len(sections), device=pos3.device),
        torch.tensor(sections, device=pos3.device))        # (hd/2,) in {0,1,2}
    pos_sel = pos3[sec_ids]                                # (hd/2, B, T)
    angles = pos_sel.permute(1, 2, 0).float() * freqs      # (B, T, hd/2)
    return _rotate(x, angles)


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
    not depend on it).

    `k_scale` / `v_scale` ((B, S, Kv)) make k and v an int8 cache: a
    decode-path feature (Tq = 1). Each chunk is dequantized on its own, as
    a bf16 product of the int8 values and the scales, so the bf16 copy is
    chunk-sized. The last chunk may be short: the reference pads it with
    invalid slots, which add nothing."""
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError("an int8 KV cache needs both k_scale and v_scale")
    window = int(window)
    b, tq, h, hd = q.shape
    if quantized and tq != 1:
        raise ValueError("the int8 KV cache is a decode-path feature "
                         f"(Tq = 1), got Tq = {tq}")
    s, kv_heads = k.shape[1], k.shape[2]
    g = h // kv_heads
    chunk = min(chunk, s)
    scale = 1.0 / math.sqrt(hd)
    qg = _bf16(q.reshape(b, tq, kv_heads, g, hd).permute(0, 2, 3, 1, 4))
    acc = q.new_zeros((b, kv_heads, g, tq, hd), dtype=torch.float32)
    m = q.new_full((b, kv_heads, g, tq), -math.inf, dtype=torch.float32)
    l = q.new_zeros((b, kv_heads, g, tq), dtype=torch.float32)
    for c in range(0, s, chunk):
        k_i, v_i = k[:, c:c + chunk], v[:, c:c + chunk]
        if quantized:
            k_i = k_i.to(torch.bfloat16) * k_scale[:, c:c + chunk, :, None].to(
                torch.bfloat16)
            v_i = v_i.to(torch.bfloat16) * v_scale[:, c:c + chunk, :, None].to(
                torch.bfloat16)
        k_i, v_i = _bf16(k_i), _bf16(v_i)
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


def attn_shard_mode(cfg, rules: MeshRules, *, decode: bool = False) -> str:
    """The attention weights' tensor-shard layout: "none" off-mesh, the
    only case here (`MeshRules` takes no mesh)."""
    return "none"


def _mesh_layout(what: str):
    raise NotImplementedError(f"the {what} layout needs a device mesh "
                              "(ROADMAP item 17h)")


def logical_attention(cfg, mode: str = "heads") -> dict:
    """Heads on the tensor axis (the "heads" and "none" modes); the
    mesh-only "heads_repkv" and "hd" layouts raise."""
    if mode not in ("heads", "none"):
        _mesh_layout(f"{mode!r} attention")
    t = {"wq": ("d", "tp", None), "wk": ("d", "tp", None),
         "wv": ("d", "tp", None), "wo": ("tp", None, "d")}
    if cfg.qkv_bias:
        t |= {"bq": ("tp", None), "bk": ("tp", None), "bv": ("tp", None)}
    return t


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


def logical_mlp(cfg) -> dict:
    return {"wi_gate": ("d", "tp"), "wi_up": ("d", "tp"), "wo": ("tp", "d")}


def mlp(params, x, cfg):
    gate = torch.einsum("btd,df->btf", x, params["wi_gate"])
    up = torch.einsum("btd,df->btf", x, params["wi_up"])
    return torch.einsum("btf,fd->btd", act_fn(cfg.act)(gate) * up,
                        params["wo"])


# ----------------------------------------------------------------------- MoE
def init_moe(key, cfg, dtype) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    return {
        "router": _dense_init(key, (d, e), d, torch.float32),
        "wi_gate": _dense_init(key, (e, d, f), d, dtype),
        "wi_up": _dense_init(key, (e, d, f), d, dtype),
        "wo": _dense_init(key, (e, f, d), f, dtype),
    }


def logical_moe(cfg, ep: bool) -> dict:
    """Tensor-parallel inside each expert; expert parallelism (`ep`) is a
    mesh layout and raises."""
    if ep:
        _mesh_layout("expert-parallel MoE")
    return {"router": ("d", None), "wi_gate": (None, "d", "tp"),
            "wi_up": (None, "d", "tp"), "wo": (None, "tp", "d")}


@dataclasses.dataclass
class MoEAux:
    load_balance_loss: torch.Tensor


def _einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """`torch.einsum` with jnp's type promotion (a bf16 operand meeting an
    fp32 one is widened, where torch would raise)."""
    dt = ops[0].dtype
    for x in ops[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return torch.einsum(eq, *(x.to(dt) for x in ops))


def moe(params, x, cfg, rules: MeshRules = NO_MESH,
        group_size: int = 2048) -> tuple[torch.Tensor, MoEAux]:
    """GShard-style dense-dispatch MoE (the reference's einsum form).

    Tokens are split into groups of `group_size` (one group per sequence
    when it does not divide T), each with its own capacity
    C = min(ceil(G*k*cf/E), G); a (token, slot) past its expert's
    capacity is dropped: its one-hot row over C is all zero, as
    `jax.nn.one_hot` gives for an index >= C. The router runs in fp32,
    the top-k gate values are renormalised, and the aux loss is the
    Switch load balance of the top-1 share."""
    mcfg = cfg.moe
    b_in, t_in, d = x.shape
    g_sz = min(group_size, t_in)
    if t_in % g_sz:
        g_sz = t_in                      # fallback: one group per sequence
    x = x.reshape(b_in * (t_in // g_sz), g_sz, d)
    b, t, _ = x.shape
    e, k = mcfg.num_experts, mcfg.top_k
    cap = min(int(math.ceil(t * k * mcfg.capacity_factor / e)), t)

    logits = torch.einsum("btd,de->bte", x.float(), params["router"].float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)            # (b,t,k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    # position of each (token, slot) in its expert's capacity buffer
    onehot = F.one_hot(gate_idx, e).float()                        # (b,t,k,e)
    flat = onehot.reshape(b, t * k, e)
    pos_in_expert = torch.cumsum(flat, dim=1) - flat               # (b,t*k,e)
    pos = (pos_in_expert * flat).sum(-1).reshape(b, t, k)          # (b,t,k)
    keep = (pos < cap).float()
    cap_onehot = (pos.long()[..., None] == torch.arange(
        cap, device=x.device)).float()                             # (b,t,k,cap)
    dispatch = torch.einsum("btke,btkc,btk->btec", onehot, cap_onehot, keep)
    combine = torch.einsum("btke,btkc,btk,btk->btec", onehot, cap_onehot,
                           keep, gate_vals)

    xb = x.to(torch.bfloat16)
    expert_in = torch.einsum("btec,btd->becd", dispatch.to(torch.bfloat16),
                             xb)                                   # (b,e,cap,d)
    gate_h = _einsum("becd,edf->becf", expert_in, params["wi_gate"])
    up_h = _einsum("becd,edf->becf", expert_in, params["wi_up"])
    h = act_fn(cfg.act)(gate_h) * up_h
    expert_out = _einsum("becf,efd->becd", h, params["wo"])
    out = _einsum("btec,becd->btd", combine.to(torch.bfloat16),
                  expert_out).to(x.dtype)
    out = out.reshape(b_in, t_in, d)

    # switch-style load balance aux: E * sum(frac_tokens_e * frac_prob_e)
    frac_tokens = onehot[:, :, 0, :].mean(dim=(0, 1))              # top-1 share
    frac_probs = probs.mean(dim=(0, 1))
    aux = e * torch.sum(frac_tokens * frac_probs)
    return out, MoEAux(load_balance_loss=aux)


# ----------------------------------------------------------------- embedding
def init_embed(key, cfg, dtype) -> dict:
    return {"table": _dense_init(key, (cfg.vocab_size, cfg.d_model),
                                 cfg.d_model, dtype)}


def logical_embed(cfg) -> dict:
    return {"table": ("tp", "d")}


def embed(params, tokens):
    return params["table"][tokens]


def unembed(params, x):
    """(B, T, d) -> (B, T, V) fp32 logits: both operands rounded to bf16,
    the products summed in fp32 (the reference's bf16 einsum with an fp32
    result), not a bf16 matmul, whose output would be rounded to bf16."""
    return _bf16(x) @ _bf16(params["table"]).T


# ------------------------------------------------------------ int8 KV cache
def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T, Kv, hd) -> (int8 values, (B, T, Kv) float16 scales).

    Per-(token, head) absmax scaling. The values are rounded (half to
    even, as `jnp.round`) against the fp32 scale; the scale is stored as
    float16 after that."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.float16)
