"""RWKV6 "Finch": an attention-free RNN with data-dependent per-channel
decay.

Recurrence per head (K = V = head_dim):
  S_t = diag(w_t) S_{t-1} + k_t^T v_t
  o_t = r_t (S_{t-1} + diag(u (.) k_t)^T v_t)        (u = bonus)
with w_t in (0,1)^K produced data-dependently (LoRA on the shifted input).

Prefill and training use the chunked-parallel form (chunk C): within a
chunk, with cs = cumsum(log w) (negative, decreasing), the intra-chunk
term is a masked product whose weights are exp(cs_{i-1} - cs_j), j < i;
the state carries the chunks. log w is clamped to [-LOG_CLAMP/2, -1e-6]
a step, as the reference's code does (its docstring says -LOG_CLAMP/C).

One departure, in arithmetic only: the reference factors the intra-chunk
weight as exp(cs_{i-1}) exp(-cs_j), and exp(-cs_j) overflows fp32 once a
chunk's summed decay passes 88.7, which random weights at the published
width reach (`scripts/family_tolerances.py --cases decay`; 0 x inf then
gives NaN). The port takes the exponent differences
themselves, each <= 0 where it is used: the same function, equal to the
reference's to fp32 rounding wherever the reference's is finite, and
finite everywhere. Decode is the same code on one token with a chunk
of 1.

The state ({"wkv" (L, B, H, K, K) fp32, "last_tm", "last_cm" (L, B, d)})
passed to a forward that returns it is written in place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.sharding import (MeshRules, NO_MESH, assign,
                                         local_region, serving, stack_logical)

LOG_CLAMP = 40.0  # max total |log-decay| per chunk (exp(40) ~ 2e17, f32-safe)


def _dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _mix_names():
    return ("r", "k", "v", "g", "w")


def init_layer(key: torch.Generator, cfg: ArchConfig, dtype) -> dict:
    """One layer's params from the generator `key`; the decay base `w0`
    and the bonus `u` are fp32 whatever `dtype` is."""
    d = cfg.d_model
    h, hd = cfg.num_heads, cfg.hd
    if h * hd != d:
        raise ValueError("rwkv6 requires num_heads * head_dim == d_model")
    lora = max(32, d // 32)
    dev = key.device

    def full(shape, value, dt=dtype):
        return torch.full(shape, value, dtype=dt, device=dev)

    def dense(shape, in_dim):
        return L._dense_init(key, shape, in_dim, dtype)

    return {
        "ln1": full((d,), 0.0),
        "ln2": full((d,), 0.0),
        "mix": {f"mu_{n}": full((d,), 0.5) for n in _mix_names()},
        "wr": dense((d, d), d),
        "wk": dense((d, d), d),
        "wv": dense((d, d), d),
        "wg": dense((d, d), d),
        "wo": dense((d, d), d),
        # data-dependent decay LoRA: w = exp(-exp(w0 + tanh(x A) B))
        "w0": full((d,), -1.0, torch.float32),
        "wA": dense((d, lora), d),
        "wB": dense((lora, d), lora),
        "u": full((d,), 0.0, torch.float32),
        "head_ln": full((h, hd), 0.0),
        # channel mix
        "cm_mu_k": full((d,), 0.5),
        "cm_mu_r": full((d,), 0.5),
        "cm_wk": dense((d, cfg.d_ff), d),
        "cm_wv": dense((cfg.d_ff, d), cfg.d_ff),
        "cm_wr": dense((d, d), d),
    }


def logical_layer(cfg: ArchConfig) -> dict:
    d2 = ("d", "tp")
    return {
        "ln1": (None,), "ln2": (None,),
        "mix": {f"mu_{n}": (None,) for n in _mix_names()},
        "wr": d2, "wk": d2, "wv": d2, "wg": d2, "wo": ("tp", "d"),
        "w0": (None,), "wA": ("d", None), "wB": (None, "tp"),
        "u": (None,), "head_ln": (None, None),
        "cm_mu_k": (None,), "cm_mu_r": (None,),
        "cm_wk": ("d", "tp"), "cm_wv": ("tp", "d"), "cm_wr": ("d", "tp"),
    }


def init_params(key: torch.Generator, cfg: ArchConfig) -> dict:
    dtype = _dtype(cfg)
    embed = L.init_embed(key, cfg, dtype)
    per_layer = [init_layer(key, cfg, dtype) for _ in range(cfg.num_layers)]
    return {
        "embed": embed,
        "layers": tree.map(lambda *xs: torch.stack(xs), *per_layer),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                  device=key.device),
    }


def logical_tree(cfg: ArchConfig, rules: MeshRules) -> dict:
    return {"embed": L.logical_embed(cfg),
            "layers": stack_logical(logical_layer(cfg)),
            "final_norm": (None,)}


# ------------------------------------------------------------------ wkv core
def _decays(lp, xw, cfg):
    """log w (B, T, d) from the decay LoRA, fp32, clamped."""
    lora = L.matmul(xw.float(), lp["wA"].float())
    dec = lp["w0"] + L.matmul(torch.tanh(lora), lp["wB"].float())
    logw = -torch.exp(dec)                     # < 0
    return torch.clamp(logw, -LOG_CLAMP / 2, -1e-6)


def wkv_chunked(r, k, v, logw, u, state, chunk: int):
    """Chunked-parallel WKV. r,k,v: (B,T,H,K) f32; logw: (B,T,H,K) f32;
    u: (H,K); state: (B,H,K,K). Returns (out (B,T,H,K), new_state)."""
    b, t, h, kk = r.shape
    chunk = min(chunk, t)
    pad = (-t) % chunk
    if pad:
        r, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (r, k, v))
        logw = F.pad(logw, (0, 0, 0, 0, 0, pad), value=-1e-6)
    strict = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    s = state
    outs = []
    for c0 in range(0, r.shape[1], chunk):
        rc, kc, vc, lw = (x[:, c0:c0 + chunk] for x in (r, k, v, logw))
        cs = torch.cumsum(lw, dim=1)            # decreasing, <0
        cs_prev = cs - lw                       # cs_{i-1}
        total = cs[:, -1:]                      # (B,1,H,K)
        r_dec = rc * torch.exp(cs_prev)         # exponent <= 0
        k_inf = kc * torch.exp(total - cs)      # exponent <= 0
        # inter-chunk: r_i C_{i-1} . S
        o_inter = torch.einsum("bchk,bhkv->bchv", r_dec, s)
        # intra-chunk: A_ij = sum_k r_ik k_jk e^{cs_{i-1,k} - cs_jk}, j < i,
        # from the exponent differences themselves (<= 0 where j < i; the
        # rest masked to -inf before the exp), where the reference factors
        # them as (r_i e^{cs_{i-1}}) . (k_j e^{-cs_j}) and e^{-cs_j}
        # overflows once a chunk's decay passes e^88
        expo = torch.where(strict[None, :, :, None, None],
                           cs_prev[:, :, None] - cs[:, None, :], -math.inf)
        a = torch.einsum("bihk,bijhk->bhij", rc,
                         torch.exp(expo) * kc[:, None])
        o_intra = torch.einsum("bhij,bjhv->bihv", a, vc)
        # diagonal bonus term: (r_i . (u (.) k_i)) v_i
        diag = (rc * (kc * u[None, None])).sum(dim=-1)
        o_diag = diag[..., None] * vc
        # state to the end of the chunk
        s = s * torch.exp(total)[:, 0, :, :, None] + torch.einsum(
            "bchk,bchv->bhkv", k_inf, vc)
        outs.append(o_inter + o_intra + o_diag)
    out = torch.cat(outs, dim=1)[:, :t]
    return out, s


# ------------------------------------------------------------------- forward
def _token_shift(x, last):
    """last: (B, d) previous token (zeros at sequence start)."""
    return torch.cat([last[:, None], x[:, :-1]], dim=1)


def _time_mix(lp, x, cfg, state, last_x, *, chunk, rules):
    b, t, d = x.shape
    h, hd = cfg.num_heads, cfg.hd
    prev = _token_shift(x, last_x)
    mixed = {n: x + (prev - x) * lp["mix"][f"mu_{n}"] for n in _mix_names()}
    r = L.matmul(mixed["r"], lp["wr"]).float()
    k = L.matmul(mixed["k"], lp["wk"]).float()
    v = L.matmul(mixed["v"], lp["wv"]).float()
    g = L.matmul(mixed["g"], lp["wg"])
    logw = _decays(lp, mixed["w"], cfg)

    def hsplit(z):
        return z.reshape(b, t, h, hd)

    u = lp["u"].reshape(h, hd)
    if rules.mesh is None:
        out, state = wkv_chunked(hsplit(r), hsplit(k), hsplit(v),
                                 hsplit(logw), u, state, chunk=chunk)
    else:
        # the chunk loop has no DTensor sharding rule: each rank scans its
        # own batch rows and heads (the WKV is independent across both)
        per_head = ("batch", None, "tp", None)
        out, state = local_region(
            rules, lambda r, k, v, w, u, s: wkv_chunked(r, k, v, w, u, s,
                                                        chunk=chunk),
            [(hsplit(r), per_head), (hsplit(k), per_head),
             (hsplit(v), per_head), (hsplit(logw), per_head),
             (u, ("tp", None)), (state, ("batch", "tp", None, None))],
            (0, 5))
    # per-head normalization + gate
    out = L.rms_norm(out.to(_dtype(cfg)), lp["head_ln"][None, None],
                     cfg.norm_eps)
    out = out.reshape(b, t, d) * F.silu(g)
    return L.matmul(out, lp["wo"]), state, x[:, -1]


def _channel_mix(lp, x, cfg, last_x):
    prev = _token_shift(x, last_x)
    xk = x + (prev - x) * lp["cm_mu_k"]
    xr = x + (prev - x) * lp["cm_mu_r"]
    kk = torch.square(F.relu(L.matmul(xk, lp["cm_wk"])))
    vv = L.matmul(kk, lp["cm_wv"])
    rr = torch.sigmoid(L.matmul(xr, lp["cm_wr"]))
    return rr * vv, x[:, -1]


def init_state(cfg: ArchConfig, batch: int, rules: MeshRules = NO_MESH,
               device=None) -> dict:
    """A zero state on `device` (`None` = the card; raises without one)."""
    dev = resolve_device(device)
    h, hd, n = cfg.num_heads, cfg.hd, cfg.num_layers
    return {
        "wkv": rules.constrain(torch.zeros((n, batch, h, hd, hd),
                                           dtype=torch.float32, device=dev),
                               (None, "batch", "tp", None, None)),
        "last_tm": torch.zeros((n, batch, cfg.d_model), dtype=_dtype(cfg),
                               device=dev),
        "last_cm": torch.zeros((n, batch, cfg.d_model), dtype=_dtype(cfg),
                               device=dev),
    }


def state_logical(cfg: ArchConfig) -> dict:
    return {
        "wkv": (None, "batch", "tp", None, None),
        "last_tm": (None, "batch", None),
        "last_cm": (None, "batch", None),
    }


def forward(params, cfg: ArchConfig, tokens, *, state=None, rules=NO_MESH,
            chunk: int = 64, remat: bool = True, return_state: bool = False,
            last_only: bool = False):
    """Full-sequence forward (train / prefill); chunk = the WKV chunk.
    Returns (logits fp32, state) with `return_state` (the given or a
    fresh state, written in place), else (logits, 0). With `remat`, each
    layer runs under `torch.utils.checkpoint`."""
    b, t = tokens.shape
    x = L.embed(params["embed"], tokens, rules)
    x = rules.constrain(x, ("batch", None, None))
    if state is None:
        state = init_state(cfg, b, rules, device=tokens.device)
    layer_states = tree.unstack(state)

    def body(x, lp, st):
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        tm, wkv_new, ltm_new = _time_mix(lp, h, cfg, st["wkv"], st["last_tm"],
                                         chunk=chunk, rules=rules)
        x = x + tm.to(x.dtype)
        h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        cm, lcm_new = _channel_mix(lp, h2, cfg, st["last_cm"])
        x = rules.constrain(x + cm.to(x.dtype), ("batch", None, None))
        return x, wkv_new, ltm_new, lcm_new

    for lp, st in zip(tree.unstack(params["layers"]), layer_states):
        if remat:
            x, wkv, ltm, lcm = checkpoint(body, x, lp, st,
                                          use_reentrant=False)
        else:
            x, wkv, ltm, lcm = body(x, lp, st)
        if return_state:
            assign(st["wkv"], (...,), wkv)
            assign(st["last_tm"], (...,), ltm)
            assign(st["last_cm"], (...,), lcm)
    if last_only:
        x = x[:, -1:]
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(params["embed"], x)
    if return_state:
        return logits, state
    return logits, x.new_zeros((), dtype=torch.float32)


@serving
def prefill(params, cfg, tokens, max_len=None, *, rules=NO_MESH, chunk=64):
    """Run the prompt into a fresh state (`max_len` is not used: the
    state does not grow). Returns (last logits (B, V), state)."""
    logits, state = forward(params, cfg, tokens, rules=rules, chunk=chunk,
                            remat=False, return_state=True, last_only=True)
    return logits[:, -1], state


@serving
def decode_step(params, cfg, token, state, *, rules=NO_MESH):
    """The O(1) recurrence: `forward` on one token with a chunk of 1, the
    state written in place. Returns (logits (B, V), state)."""
    logits, state = forward(params, cfg, token[:, None], state=state,
                            rules=rules, chunk=1, remat=False,
                            return_state=True)
    return logits[:, -1], state
