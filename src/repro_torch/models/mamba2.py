"""Mamba2 (SSD) block: a scalar-per-head decay state-space model.

Per head (P = head dim, N = ssm state):
  h_t = a_t h_{t-1} + (dt_t x_t) (x) B_t          h: (P, N)
  y_t = h_t C_t + D x_t
  a_t = exp(-softplus(dt_raw_t + dt_bias) * exp(A_log))   (scalar/head)
Chunked-parallel prefill (the SSD algorithm): with scalar decays the
intra-chunk pair matrix exp(cs_i - cs_j) (i >= j) is computed directly,
its j > i half masked to -inf before the exp.
Short causal conv (kernel 4) over the x/B/C channels; decode keeps a
rolling conv buffer and the SSM state, and runs T=1 through the same code.

The scan over chunks is a Python loop (the reference's `lax.scan`). The
reference's three-operand einsums are written as two-operand products
with the per-(B, C, H) decay folded into one operand first: the same sums
in another order, and no (B, C, H, P, N) intermediate.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.sharding import NO_MESH, MeshRules, local_region

CONV_K = 4
MAMBA_HEAD_DIM = 64


def dims(cfg: ArchConfig):
    d_in = 2 * cfg.d_model
    nheads = d_in // MAMBA_HEAD_DIM
    n = cfg.ssm_state
    conv_dim = d_in + 2 * n
    return d_in, nheads, n, conv_dim


def init_layer(key: torch.Generator, cfg: ArchConfig, dtype) -> dict:
    """One layer's params, drawn from the generator `key` on its device;
    `A_log`, `dt_bias` and `D` are fp32 whatever `dtype` is."""
    d = cfg.d_model
    d_in, nheads, n, conv_dim = dims(cfg)
    dev = key.device

    def full(shape, value, dt):
        return torch.full(shape, value, dtype=dt, device=dev)

    return {
        "ln": full((d,), 0.0, dtype),
        # in_proj -> [z (d_in), x (d_in), B (n), C (n), dt (nheads)]
        "w_in": L._dense_init(key, (d, 2 * d_in + 2 * n + nheads), d, dtype),
        "conv_w": L._dense_init(key, (CONV_K, conv_dim), CONV_K, dtype),
        "conv_b": full((conv_dim,), 0.0, dtype),
        "A_log": full((nheads,), 0.0, torch.float32),
        "dt_bias": full((nheads,), 0.0, torch.float32),
        "D": full((nheads,), 1.0, torch.float32),
        "out_ln": full((d_in,), 0.0, dtype),
        "w_out": L._dense_init(key, (d_in, d), d_in, dtype),
    }


def logical_layer(cfg: ArchConfig) -> dict:
    return {
        "ln": (None,),
        "w_in": ("d", "tp"),
        "conv_w": (None, "tp"),
        "conv_b": ("tp",),
        "A_log": (None,), "dt_bias": (None,), "D": (None,),
        "out_ln": ("tp",),
        "w_out": ("tp", "d"),
    }


def _split(zxbcdt, cfg):
    d_in, nheads, n, _ = dims(cfg)
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in: d_in + d_in + 2 * n]
    dt = zxbcdt[..., -nheads:]
    return z, xbc, dt


def _conv(xbc, conv_w, conv_b, conv_state):
    """Causal depthwise conv, kernel CONV_K. conv_state: (B, CONV_K-1, C)
    carries the last inputs of the previous segment; returns (out, the
    new state: the last CONV_K-1 inputs)."""
    full = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
    out = torch.zeros_like(xbc)
    t = xbc.shape[1]
    for i in range(CONV_K):
        out = out + full[:, i: i + t] * conv_w[i]
    new_state = full[:, -(CONV_K - 1):]
    return F.silu(out + conv_b), new_state


def ssd_chunked(x, b_t, c_t, dt, lp, state, chunk: int):
    """x: (B,T,H,P) f32; b_t,c_t: (B,T,N); dt: (B,T,H); state: (B,H,P,N).
    Returns (y (B,T,H,P), new state)."""
    bsz, t, h, p = x.shape
    dt_s = F.softplus(dt + lp["dt_bias"])                     # (B,T,H)
    loga = -dt_s * torch.exp(lp["A_log"])                     # <= 0
    dtx = x * dt_s[..., None]
    chunk = min(chunk, t)
    pad = (-t) % chunk
    if pad:
        dtx = F.pad(dtx, (0, 0, 0, 0, 0, pad))
        b_t = F.pad(b_t, (0, 0, 0, pad))
        c_t = F.pad(c_t, (0, 0, 0, pad))
        loga = F.pad(loga, (0, 0, 0, pad))
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))           # j <= i
    s = state
    ys = []
    for c0 in range(0, dtx.shape[1], chunk):
        dx = dtx[:, c0:c0 + chunk]            # (B,C,H,P)
        bb = b_t[:, c0:c0 + chunk]            # (B,C,N)
        cc = c_t[:, c0:c0 + chunk]
        cs = torch.cumsum(loga[:, c0:c0 + chunk], dim=1)   # (B,C,H) decreasing
        # inter: y_i += C_i . (exp(cs_i) h0)
        y_inter = torch.einsum("bcn,bhpn->bchp", cc, s) \
            * torch.exp(cs)[..., None]
        # intra: exp(cs_i - cs_j) (C_i . B_j) dx_j over j <= i. The j > i
        # exponents are positive and overflow once a chunk's decay passes
        # 88; they are masked to -inf before the exp, so they reach neither
        # the output nor the gradient (the reference masks after the exp:
        # the same output, but exp's backward then gives 0 x inf = NaN)
        pair = torch.exp(torch.where(causal[None, :, :, None],
                                     cs[:, :, None, :] - cs[:, None, :, :],
                                     -math.inf))               # (B,i,j,H)
        cb = torch.einsum("bin,bjn->bij", cc, bb)
        y_intra = torch.einsum("bijh,bjhp->bihp", cb[..., None] * pair, dx)
        # state: h_L = exp(cs_L) h0 + sum_j exp(cs_L - cs_j) dx_j (x) B_j
        decay_end = torch.exp(cs[:, -1:, :] - cs)            # (B,C,H)
        s = s * torch.exp(cs[:, -1])[..., None, None] + torch.einsum(
            "bchp,bcn->bhpn", dx * decay_end[..., None], bb)
        ys.append(y_inter + y_intra)
    y = torch.cat(ys, dim=1)[:, :t]
    return y, s


def block(lp, x, cfg, state, *, chunk: int, rules: MeshRules = NO_MESH):
    """One Mamba2 block. state: {"ssm": (B,H,P,N), "conv": (B,K-1,conv_dim)}.
    Returns (out, new_state)."""
    bsz, t, d = x.shape
    d_in, nheads, n, conv_dim = dims(cfg)
    h = L.rms_norm(x, lp["ln"], cfg.norm_eps)
    zxbcdt = L.matmul(h, lp["w_in"])
    z, xbc, dt = _split(zxbcdt, cfg)
    xbc, conv_new = _conv(xbc, lp["conv_w"], lp["conv_b"], state["conv"])
    xin = xbc[..., :d_in].float().reshape(bsz, t, nheads, MAMBA_HEAD_DIM)
    b_t = xbc[..., d_in: d_in + n].float()
    c_t = xbc[..., d_in + n:].float()
    if rules.mesh is None:
        y, ssm_new = ssd_chunked(xin, b_t, c_t, dt.float(), lp, state["ssm"],
                                 chunk)
    else:
        # the chunk loop has no DTensor sharding rule: each rank scans its
        # own batch rows and heads (the scan is independent across both)
        heads = {k: lp[k] for k in ("A_log", "dt_bias")}
        y, ssm_new = local_region(
            rules, lambda x, bt, ct, dt, al, db, s: ssd_chunked(
                x, bt, ct, dt, {"A_log": al, "dt_bias": db}, s, chunk),
            [(xin, ("batch", None, "tp", None)), (b_t, ("batch", None, None)),
             (c_t, ("batch", None, None)), (dt.float(), ("batch", None, "tp")),
             (heads["A_log"], ("tp",)), (heads["dt_bias"], ("tp",)),
             (state["ssm"], ("batch", "tp", None, None))], (0, 6))
    y = y + lp["D"][None, None, :, None] * xin
    y = y.reshape(bsz, t, d_in).to(x.dtype) * F.silu(z)
    y = L.rms_norm(y, lp["out_ln"], cfg.norm_eps)
    out = L.matmul(y, lp["w_out"])
    new_state = {"ssm": ssm_new, "conv": conv_new.to(state["conv"].dtype)}
    return out, new_state


def init_state(cfg: ArchConfig, batch: int, num_layers: int,
               rules: MeshRules = NO_MESH, dtype=torch.bfloat16,
               device=None) -> dict:
    """Zero SSM (fp32) and conv (`dtype`) states for `num_layers` layers,
    on `device` (`None` = the card; raises without one)."""
    d_in, nheads, n, conv_dim = dims(cfg)
    dev = resolve_device(device)
    s = {
        "ssm": torch.zeros((num_layers, batch, nheads, MAMBA_HEAD_DIM, n),
                           dtype=torch.float32, device=dev),
        "conv": torch.zeros((num_layers, batch, CONV_K - 1, conv_dim),
                            dtype=dtype, device=dev),
    }
    s["ssm"] = rules.constrain(s["ssm"], (None, "batch", "tp", None, None))
    s["conv"] = rules.constrain(s["conv"], (None, "batch", None, "tp"))
    return s


def state_logical(cfg: ArchConfig) -> dict:
    return {
        "ssm": (None, "batch", "tp", None, None),
        "conv": (None, "batch", None, "tp"),
    }
