"""Shared layer library: RMSNorm, RoPE/M-RoPE, GQA attention (with the
int8-KV decode path), SwiGLU/GeGLU MLP, GShard-style MoE, embeddings.

Params are nested dicts of tensors with the JAX package's names and
shapes; each init_* has a matching logical_* tree of axis names (see
models/sharding.py) from which a mesh's DTensor placements are built. Math
runs in fp32 where the reference's does (norms, RoPE, attention scores,
the MoE router, the unembedding's accumulation) and in the params' dtype
elsewhere.

Attention has two routes. Causal bf16 self-attention at positions
0..T-1 with no window (the train forward) calls `causal_self_attention`,
PyTorch's `scaled_dot_product_attention`; every other case (explicit
positions, -1 for invalid slots, a sliding window, fp32 activations)
goes through `chunked_attention`, an online softmax over KV chunks in
plain torch with the reference's recompute backward (`_Flash`). Both
round q, k and v to bf16 before the products, as the reference does.

On a mesh (DTensor activations) attention, the attention projections,
2-D products, the embedding and the MoE experts run shard by shard in
`local_map` regions with their collectives written out (`mesh_attention`,
`_mesh_project_in` / `_mesh_project_out`, `sharding.mesh_matmul`,
`_mesh_embed`, `_mesh_experts`); norms, RoPE and the routing stay
DTensor ops.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F

from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models.sharding import (NO_MESH, AllReduce, MeshRules,
                                         local_apply, local_extent,
                                         local_region, mesh_matmul)


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
    sec_ids = torch.tensor([i for i, n in enumerate(sections)
                            for _ in range(n)],
                           device=pos3.device)             # (hd/2,) in {0,1,2}
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
    head_dim: int | None = None,
    score_reduce=None,
) -> torch.Tensor:
    """Attention by an online softmax over KV chunks, in the reference's
    arithmetic: q, k, v and the probabilities rounded to bf16, scores and
    sums in fp32, fully masked rows 0. For Tq > 1 the gradients are the
    reference's recompute backward (`_Flash`); a single query (decode,
    the int8 cache, `score_reduce`) is differentiated by autograd through
    the loop.

    `k_scale` / `v_scale` ((B, S, Kv)) make k and v an int8 cache: a
    decode-path feature (Tq = 1). Each chunk is dequantized on its own, as
    a bf16 product of the int8 values and the scales, so the bf16 copy is
    chunk-sized. The last chunk may be short: the reference pads it with
    invalid slots, which add nothing.

    `head_dim` (the scale's 1/sqrt(head_dim); q's last dim by default) and
    `score_reduce` (applied to each chunk's scores) serve a rank that
    holds a slice of head_dim: its scores are partial sums, completed by
    an all-reduce."""
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
    scale = 1.0 / math.sqrt(head_dim or hd)
    # (B, Kv, G, Tq, hd) in bf16, as the reference's qg: its gradient is
    # rounded to bf16 too
    qg = q.reshape(b, tq, kv_heads, g, hd).permute(0, 2, 3, 1, 4).to(
        torch.bfloat16)
    if tq > 1 and not quantized and score_reduce is None:
        out = _Flash.apply(qg, k, v, kv_pos, q_pos, causal, window, scale,
                           chunk)
    else:
        out, _ = _flash_fwd_scan(qg, k, v, kv_pos, q_pos, causal, window,
                                 scale, chunk, k_scale, v_scale, score_reduce,
                                 need_lse=False)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, tq, h, hd)
    return out.to(q.dtype)


def _flash_fwd_scan(qg, k, v, kv_pos, q_pos, causal: bool, window: int,
                    scale: float, chunk: int, k_scale=None, v_scale=None,
                    score_reduce=None, need_lse: bool = True):
    """The online softmax over KV chunks of `chunk` slots (the last may be
    short). qg: (B, Kv, G, Tq, hd) bf16; k, v: (B, S, Kv, hd), or int8
    with (B, S, Kv) `k_scale` / `v_scale`. Returns (out, lse), fp32
    (B, Kv, G, Tq, hd) and (B, Kv, G, Tq), lse = m + log l (None unless
    `need_lse`). Differentiable by autograd (the running max held out of
    the graph: the softmax does not depend on it)."""
    b, kv_heads, g, tq, hd = qg.shape
    qg = qg.float()
    acc = qg.new_zeros((b, kv_heads, g, tq, hd))
    m = qg.new_full((b, kv_heads, g, tq), -math.inf)
    l = qg.new_zeros((b, kv_heads, g, tq))
    for c in range(0, k.shape[1], chunk):
        k_i, v_i = k[:, c:c + chunk], v[:, c:c + chunk]
        if k_scale is not None:
            k_i = k_i.to(torch.bfloat16) * k_scale[:, c:c + chunk, :, None].to(
                torch.bfloat16)
            v_i = v_i.to(torch.bfloat16) * v_scale[:, c:c + chunk, :, None].to(
                torch.bfloat16)
        k_i, v_i = _bf16(k_i), _bf16(v_i)
        valid = _mask_chunk(kv_pos[:, c:c + chunk], q_pos, causal, window)
        sc = torch.einsum("bkgth,bckh->bkgtc", qg, k_i)
        if score_reduce is not None:
            sc = score_reduce(sc)
        sc = sc * scale
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
    if not need_lse:
        return out, None
    return out, m_safe + torch.log(torch.clamp(l, min=1e-30))


class _Flash(torch.autograd.Function):
    """`_flash_fwd_scan` with the reference's recompute backward
    (`_flash_bwd`): only (qg, k, v, the positions, out, lse) are saved,
    and the backward streams the KV chunks again, recomputing each
    chunk's probabilities from lse. Live memory O(Tq x chunk) in both
    directions, where autograd through the loop keeps every chunk's fp32
    scores, masks and probabilities, O(Tq x S). The positions, `causal`,
    `window`, `scale` and `chunk` are not differentiable."""

    @staticmethod
    def forward(ctx, qg, k, v, kv_pos, q_pos, causal, window, scale, chunk):
        out, lse = _flash_fwd_scan(qg, k, v, kv_pos, q_pos, causal, window,
                                   scale, chunk)
        ctx.save_for_backward(qg, k, v, kv_pos, q_pos, out, lse)
        ctx.args = (causal, window, scale, chunk)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        qg, k, v, kv_pos, q_pos, out, lse = ctx.saved_tensors
        causal, window, scale, chunk = ctx.args
        qf = qg.float()
        do = do.float()
        delta = torch.sum(do * out, dim=-1)                  # (B,Kv,G,Tq)
        dq = torch.zeros_like(qf)
        dk = torch.zeros_like(k, dtype=torch.float32)
        dv = torch.zeros_like(v, dtype=torch.float32)
        for c in range(0, k.shape[1], chunk):
            k_i = _bf16(k[:, c:c + chunk])
            sc = torch.einsum("bkgth,bckh->bkgtc", qf, k_i) * scale
            valid = _mask_chunk(kv_pos[:, c:c + chunk], q_pos, causal, window)
            p = torch.where(valid, torch.exp(sc - lse[..., None]), 0.0)
            dv[:, c:c + chunk] = torch.einsum("bkgtc,bkgth->bckh", p, do)
            dp = torch.einsum("bkgth,bckh->bkgtc", do,
                              v[:, c:c + chunk].float())
            ds = _bf16(p * (dp - delta[..., None]) * scale)
            dq = dq + torch.einsum("bkgtc,bckh->bkgth", ds, k_i)
            dk[:, c:c + chunk] = torch.einsum("bkgtc,bkgth->bckh", ds, qf)
        return (dq.to(qg.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None, None)


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


# The logical axes of q (and of k, v outside the "seq" layout) by layout.
QSPEC = {"heads": ("batch", None, "tp", None),
         "heads_repkv": ("batch", None, "tp", None),
         "hd": ("batch", None, None, "tp"),
         "seq": ("batch", "seq", None, None),
         "none": ("batch", None, None, None)}


def mesh_attention(rules: MeshRules, mode: str, q, k, v, *, q_pos, kv_pos,
                   causal: bool = True, window: int = 0, chunk: int = 1024,
                   k_scale=None, v_scale=None, fused: bool = False):
    """Attention on a mesh: each rank attends with its own shards, in a
    `local_map` region (the online softmax's chunk slices have no DTensor
    sharding rule, and the fused kernel none on the CPU).

    The layouts (`attn_shard_mode`): "heads" / "heads_repkv" shard q, k, v
    on heads (k, v already repeated to q's heads for "heads_repkv"), so
    each rank's heads are a whole attention; "seq" shards q and its
    positions on T with k, v whole, exact with explicit positions (the
    fused causal kernel, which assumes q starts at 0, is not used);
    "hd" shards head_dim, so each chunk's scores are partial sums that
    an all-reduce over the tensor axis completes. `fused` takes
    `causal_self_attention` for the heads layouts."""
    if mode == "none":
        raise NotImplementedError(
            "decode on a mesh whose tensor axis divides neither the KV "
            "heads nor head_dim (a sequence-sharded cache) is not supported")
    qspec = QSPEC[mode]
    kvspec = ("batch", None, None, None) if mode == "seq" else qspec
    args = [(q, qspec), (k, kvspec), (v, kvspec),
            (q_pos, ("batch", "seq") if mode == "seq" else ("batch", None)),
            (kv_pos, ("batch", None))]
    if k_scale is not None:
        args += [(k_scale, kvspec[:3]), (v_scale, kvspec[:3])]
    head_dim = q.shape[-1]
    reduce = None
    if mode == "hd" and rules.spec(qspec, tuple(q.shape))[3] is not None:
        group = rules.dmesh.get_group(rules.tensor)

        def reduce(sc):
            return funcol.wait_tensor(funcol.all_reduce(sc, "sum", group))

    def local(q, k, v, q_pos, kv_pos, *scales):
        if fused and mode != "seq":
            return causal_self_attention(q, k, v)
        ks, vs = scales if scales else (None, None)
        return chunked_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                                 causal=causal, window=window, chunk=chunk,
                                 k_scale=ks, v_scale=vs, head_dim=head_dim,
                                 score_reduce=reduce)

    return local_region(rules, local, args, 0)


def attend(rules: MeshRules, mode: str, q, k, v, *, q_pos, kv_pos,
           causal: bool = True, chunk: int = 1024, fused: bool = False):
    """Attention by the route the arguments allow: on a mesh
    `mesh_attention` in layout `mode`; off-mesh the fused causal kernel
    when `fused` (q, k, v at positions 0..T-1, bf16), else
    `chunked_attention`."""
    if rules.mesh is not None:
        return mesh_attention(rules, mode, q, k, v, q_pos=q_pos,
                              kv_pos=kv_pos, causal=causal, chunk=chunk,
                              fused=fused)
    if fused:
        return causal_self_attention(q, k, v)
    return chunked_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                             causal=causal, chunk=chunk, rules=rules)


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
    """Tensor-shard layout when heads don't divide the tensor axis
    (smollm 15H, gemma 8H, qwen2 12H on a 16-way axis):

    * full-sequence steps (train/prefill) -> "seq": whole-layer sequence
      parallelism (activations T-sharded, layer weights fsdp-only).
    * decode (Tq=1) -> "hd" when head_dim divides: scores are tiny, and
      hd-sharding splits the KV cache + weight reads.
    * "heads_repkv" (grok-1: 48 Q heads shard 16 ways, its 8 KV heads do
      not): KV weights replicate over the tensor axis and the KV heads
      are repeated to MHA per shard.
    * "none" off-mesh.
    """
    if rules.mesh is None:
        return "none"
    ts = rules.axis_sizes[rules.tensor]
    if cfg.num_heads % ts == 0 and cfg.num_kv_heads % ts == 0:
        return "heads"
    if cfg.num_heads % ts == 0 and not decode:
        return "heads_repkv"
    if decode:
        return "hd" if cfg.hd % ts == 0 else "none"
    return "seq"


def logical_attention(cfg, mode: str = "heads") -> dict:
    if mode == "heads_repkv":
        t = {
            "wq": ("d", "tp", None),
            "wk": ("d", None, None),
            "wv": ("d", None, None),
            "wo": ("tp", None, "d"),
        }
        if cfg.qkv_bias:
            t |= {"bq": ("tp", None), "bk": (None, None), "bv": (None, None)}
        return t
    if mode == "hd":
        t = {
            "wq": ("d", None, "tp"),
            "wk": ("d", None, "tp"),
            "wv": ("d", None, "tp"),
            "wo": (None, "tp", "d"),
        }
        bias = {"bq": (None, "tp"), "bk": (None, "tp"), "bv": (None, "tp")}
    else:
        t = {
            "wq": ("d", "tp", None),
            "wk": ("d", "tp", None),
            "wv": ("d", "tp", None),
            "wo": ("tp", None, "d"),
        }
        bias = {"bq": ("tp", None), "bk": ("tp", None), "bv": ("tp", None)}
    if cfg.qkv_bias:
        t |= bias
    return t


def attention_qkv(params, x, cfg):
    if isinstance(x, DTensor):
        q, k, v = (_mesh_project_in(x, params[w]) for w in ("wq", "wk", "wv"))
    else:
        q = torch.einsum("btd,dhk->bthk", x, params["wq"])
        k = torch.einsum("btd,dhk->bthk", x, params["wk"])
        v = torch.einsum("btd,dhk->bthk", x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return q, k, v


def attention_out(params, o):
    if isinstance(o, DTensor):
        return _mesh_project_out(o, params["wo"])
    return torch.einsum("bthk,hkd->btd", o, params["wo"])


# On a mesh the projections run shard by shard (`local_apply`): DTensor's
# einsum flattens (heads, head_dim) into one dim and may shard it where
# heads do not divide the axis (smollm's 15 heads on 16 ranks), which it
# then cannot unflatten. The weight's FSDP axes are gathered first, as
# FSDP gathers them.
def _mesh_project_in(x, w):
    """(B, T, d) x (d, H, hd) -> (B, T, H, hd): x keeps its batch and
    sequence shards, w its head or head_dim shard where x leaves that
    mesh dim free."""
    xp = [Replicate() if not (p.is_shard(0) or p.is_shard(1)) else p
          for p in x.placements]
    wp = [p if (p.is_shard(1) or p.is_shard(2)) and not xp[i].is_shard()
          else Replicate() for i, p in enumerate(w.placements)]
    out = [xp[i] if xp[i].is_shard() else
           Shard(wp[i].dim + 1) if wp[i].is_shard() else Replicate()
           for i in range(len(xp))]
    return local_apply(lambda a, b: torch.einsum("btd,dhk->bthk", a, b),
                       x.device_mesh, (x, w), (xp, wp), out)


def _mesh_project_out(o, w):
    """(B, T, H, hd) x (H, hd, d) -> (B, T, d): w is cut as o's heads or
    head_dim are, and the partial sums over those are all-reduced."""
    mesh = o.device_mesh
    op = [p if p.is_shard() else Replicate() for p in o.placements]
    wp, out, groups = [], [], []
    for i, p in enumerate(op):
        if p.is_shard(2) or p.is_shard(3):
            wp.append(Shard(p.dim - 2))
            out.append(Replicate())
            groups.append(mesh.get_group(i))
        else:
            wp.append(Replicate())
            out.append(p)

    def project(a, b):
        y = torch.einsum("bthk,hkd->btd", a, b)
        for group in groups:
            y = AllReduce.apply(y, group)
        return y

    return local_apply(project, mesh, (o, w), (op, wp), out)


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


def matmul(x, w):
    """`x @ w`; on a mesh shard by shard (`sharding.mesh_matmul`)."""
    return mesh_matmul(x, w) if isinstance(x, DTensor) else x @ w


def mlp(params, x, cfg):
    if isinstance(x, DTensor):
        gate = mesh_matmul(x, params["wi_gate"])
        up = mesh_matmul(x, params["wi_up"])
        return mesh_matmul(act_fn(cfg.act)(gate) * up, params["wo"])
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
    """ep=True: experts sharded over the tensor axis (expert parallelism);
    else tensor-parallel inside each expert (grok-1: 8 experts < 16-way)."""
    if ep:
        return {"router": ("d", None), "wi_gate": ("tp", "d", None),
                "wi_up": ("tp", "d", None), "wo": ("tp", None, "d")}
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

    router = params["router"]
    if isinstance(x, DTensor) or isinstance(router, DTensor):
        # DTensor's einsum flattens (b, t) into a strided layout whose
        # gradient bmm its cost search cannot place on fake tensors
        logits = mesh_matmul(x.float(), router.float())
    else:
        logits = torch.einsum("btd,de->bte", x.float(), router.float())
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
    if rules.mesh is None:
        expert_out = _experts(expert_in, params["wi_gate"], params["wi_up"],
                              params["wo"], cfg.act)
        out = _einsum("btec,becd->btd", combine.to(torch.bfloat16),
                      expert_out)
    else:
        out = _mesh_experts(params, expert_in, combine.to(torch.bfloat16),
                            cfg, rules)
    out = out.to(x.dtype).reshape(b_in, t_in, d)

    # switch-style load balance aux: E * sum(frac_tokens_e * frac_prob_e)
    frac_tokens = onehot[:, :, 0, :].mean(dim=(0, 1))              # top-1 share
    frac_probs = probs.mean(dim=(0, 1))
    aux = e * torch.sum(frac_tokens * frac_probs)
    return out, MoEAux(load_balance_loss=aux)


def _experts(x, wi_gate, wi_up, wo, act: str):
    """(b, e, cap, d) expert inputs through each expert's gated MLP."""
    gate_h = _einsum("becd,edf->becf", x, wi_gate)
    up_h = _einsum("becd,edf->becf", x, wi_up)
    h = act_fn(act)(gate_h) * up_h
    return _einsum("becf,efd->becd", h, wo)


def _mesh_experts(params, expert_in, combine, cfg, rules: MeshRules):
    """`_experts` and the combine on a mesh, each rank on its own shards
    in a `local_map` region (DTensor's einsum rules flatten the sharded
    expert axis into a strided layout they cannot then contract). The
    weights' FSDP axes are gathered first (the all-gather FSDP does).
    With experts on the tensor axis (expert parallelism) each rank
    combines its own experts' outputs, and with d_ff there (grok-1's 8
    experts on a 16-way axis) each rank's experts give partial sums:
    either way the (b, t, d) output is all-reduced over the tensor axis.
    """
    ep = cfg.moe.num_experts % rules.axis_sizes[rules.tensor] == 0
    logical = logical_moe(cfg, ep)
    expert_axes = ("batch", "tp", None, None)       # the reference's pins
    # the weights with their FSDP ("d") axes gathered, as FSDP gathers them
    args = [(expert_in, expert_axes),
            (combine, ("batch", None, "tp", None))] + [
        (params[k], tuple(None if a == "d" else a for a in logical[k]))
        for k in ("wi_gate", "wi_up", "wo")]
    group = rules.dmesh.get_group(rules.tensor)
    partial = (rules.spec(expert_axes, tuple(expert_in.shape))[1]
               or rules.spec(args[4][1], tuple(params["wo"].shape))[1])

    def local(x, comb, wi_gate, wi_up, wo):
        out = _einsum("btec,becd->btd", comb,
                      _experts(x, wi_gate, wi_up, wo, cfg.act))
        return AllReduce.apply(out, group) if partial else out

    tensors = [rules.constrain(t, lg) for t, lg in args]
    placements = [tuple(t.placements) for t in tensors]
    # (b, t, d): sharded as combine's batch, whole on the tensor axis
    out = [p if p.is_shard(0) else Replicate() for p in placements[1]]
    return local_apply(local, rules.dmesh, tensors, placements, out)


# ----------------------------------------------------------------- embedding
def init_embed(key, cfg, dtype) -> dict:
    return {"table": _dense_init(key, (cfg.vocab_size, cfg.d_model),
                                 cfg.d_model, dtype)}


def logical_embed(cfg) -> dict:
    return {"table": ("tp", "d")}


def embed(params, tokens, rules: MeshRules = NO_MESH):
    if rules.mesh is not None:
        return _mesh_embed(params["table"], tokens, rules)
    return params["table"][tokens]


def _mesh_embed(table, tokens, rules: MeshRules):
    """The lookup on a mesh, shard by shard (DTensor's rule for the
    lookup's backward, an accumulating `index_put`, is not on every
    torch version): each rank looks its batch rows up in its slice of
    the vocabulary (the table's FSDP shards gathered), rows outside the
    slice are 0, and the sum over the tensor axis completes them
    (Megatron's vocab-parallel embedding). A slice's offset is DTensor's
    (`sharding.local_extent`): a vocabulary the axis does not divide has
    shorter slices on its last ranks."""
    mesh = rules.dmesh
    tdim = mesh.mesh_dim_names.index(rules.tensor)
    tokens = rules.constrain(tokens, ("batch",) + (None,) * (tokens.ndim - 1))
    tok_p = tuple(tokens.placements)
    tab_p = tuple(p if i == tdim and p.is_shard(0) else Replicate()
                  for i, p in enumerate(table.placements))
    vocab_split = tab_p[tdim].is_shard(0)
    group = mesh.get_group(tdim)
    _, lo = local_extent(table.shape, mesh, tab_p, 0)

    def lookup(tab, tok):
        if not vocab_split:
            return tab[tok]
        local = tok - lo
        inside = (local >= 0) & (local < tab.shape[0])
        rows = tab[torch.where(inside, local, 0)]
        rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
        return AllReduce.apply(rows, group)

    out = [p if p.is_shard(0) else Replicate() for p in tok_p]
    return local_apply(lookup, mesh, (table, tokens), (tab_p, tok_p), out)


def unembed(params, x):
    """(B, T, d) -> (B, T, V) fp32 logits: both operands rounded to bf16,
    the products summed in fp32 (the reference's bf16 einsum with an fp32
    result), not a bf16 matmul, whose output would be rounded to bf16."""
    return matmul(_bf16(x), _bf16(params["table"]).T)


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
