"""The port's dense model, held against repro on the CPU.

Inputs come from numpy seeds; params are the reference's random init,
converted with `convert.state_from_reference`. Tolerances, stated per
test, come from the arithmetic both sides share:

* the chunked attention rounds q, k, v and the probabilities to bf16 as
  the reference does, so it matches to fp32 rounding (1e-5);
* the fused route (`causal_self_attention`) keeps the probabilities in
  the kernel's own precision: 1e-2 on unit-scale inputs, or 2 bf16 ulps
  of the output for bf16 inputs;
* gradients of the chunked route: the port's `_Flash` backward is the
  reference's `_flash_bwd` step for step (the probabilities recomputed
  from the saved logsumexp, ds and k rounded to bf16 for dq, ds and q for
  dk, dq rounded to bf16 as the reference's qg is), so the two agree to
  fp32 rounding: dv within 1e-5, and dq and dk within 1e-5 but where an
  fp32 difference moves a value across a bf16 rounding boundary (dq, and
  each ds element before its products): such an element differs by one
  bf16 ulp, so every element is held within one bf16 ulp of the largest
  (2^-7 x max|g|) and 99 % of them within 1e-5. The fused route's
  gradients are SDPA's, held to the naive fp32 attention and the
  reference at `tests/test_attention.py`'s 0.06;
* whole models: `unembed` rounds its inputs to bf16 on both sides, which
  bounds both tolerances: an fp32 difference of 1e-6 in the final
  activations can round one of them to the neighbouring bf16 value and
  move a logit by ~1e-3. So a `dtype="float32"` variant (attention by the
  chunked route) holds to 2e-3 on logits of magnitude ~4 and 5e-5 on the
  loss; the stock bf16 config to 0.1 on logits (~6 bf16 ulps: every
  layer's output is rounded to bf16 on both sides, in different orders)
  and 5e-3 on the loss.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch import convert, tree
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import transformer as T


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _maxdiff(a, b) -> float:
    return float(np.max(np.abs(_np(a) - _np(b))))


def _qkv(b=2, t=33, h=4, kv=2, hd=16, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32)[None], (b, t)).copy()
    return q, k, v, pos


def naive(q, k, v, q_pos, kv_pos, causal=True, window=0):
    """fp32 attention with explicit masks (tests/test_attention.py's)."""
    b, tq, h, hd = q.shape
    g = h // k.shape[2]
    qf = q.float().reshape(b, tq, k.shape[2], g, hd)
    s = torch.einsum("btkgh,bskh->bkgts", qf, k.float()) / np.sqrt(hd)
    valid = kv_pos[:, None, None, None, :] >= 0
    if causal:
        valid = valid & (kv_pos[:, None, None, None, :]
                         <= q_pos[:, None, None, :, None])
    if window > 0:
        valid = valid & (kv_pos[:, None, None, None, :] > (
            q_pos[:, None, None, :, None] - window))
    p = torch.softmax(torch.where(valid, s, -torch.inf), dim=-1)
    p = torch.nan_to_num(p)
    return torch.einsum("bkgts,bskh->btkgh", p, v.float()).reshape(b, tq, h, hd)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_rms_norm_and_rope(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32) * 0.1
    pos = rng.integers(0, 500, size=(2, 5)).astype(np.int32)
    jx, tx = jnp.asarray(x), _t(x)
    if dtype == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.bfloat16()
    tol = 1e-6 if dtype == np.float32 else 2 ** -7 * 4   # 1 bf16 ulp at |x|<4
    got = L.rms_norm(tx, _t(scale), 1e-6)
    assert got.dtype == tx.dtype
    assert _maxdiff(got, JL.rms_norm(jx, jnp.asarray(scale), 1e-6)) <= tol
    got = L.apply_rope(tx, _t(pos), 10_000.0)
    assert got.dtype == tx.dtype
    assert _maxdiff(got, JL.apply_rope(jx, jnp.asarray(pos), 10_000.0)) \
        <= tol + 1e-5                                    # cos/sin at |angle|<500
    assert _maxdiff(L.rope_freqs(16, 1e6), JL.rope_freqs(16, 1e6)) < 1e-9


@pytest.mark.parametrize("chunk", [4, 8, 33])
@pytest.mark.parametrize("window", [0, 7])
@pytest.mark.parametrize("kv", [1, 2, 4])
def test_chunked_attention_matches_reference(chunk, window, kv):
    q, k, v, pos = _qkv(kv=kv)
    got = L.chunked_attention(_t(q), _t(k), _t(v), q_pos=_t(pos),
                              kv_pos=_t(pos), window=window, chunk=chunk)
    want = JL.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), q_pos=jnp.asarray(pos),
                                kv_pos=jnp.asarray(pos), window=window,
                                chunk=chunk)
    assert _maxdiff(got, want) < 1e-5
    assert _maxdiff(got, naive(_t(q), _t(k), _t(v), _t(pos), _t(pos),
                               window=window)) < 0.03


@pytest.mark.parametrize("kv", [1, 2, 4])
def test_fused_route_matches_reference(kv):
    q, k, v, pos = _qkv(kv=kv)
    want = JL.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), q_pos=jnp.asarray(pos),
                                kv_pos=jnp.asarray(pos), chunk=8)
    got = L.causal_self_attention(_t(q), _t(k), _t(v))
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert _maxdiff(got, want) < 1e-2
    want = JL.chunked_attention(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
        q_pos=jnp.asarray(pos), kv_pos=jnp.asarray(pos), chunk=8)
    got = L.causal_self_attention(*(_t(a).bfloat16() for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    assert _maxdiff(got, want) <= 2 * 2 ** -8 * 2        # 2 ulps at |o| < 2


def _grads_ref(q, k, v, pos, window):
    def f(q, k, v):
        return JL.chunked_attention(
            q, k, v, q_pos=jnp.asarray(pos), kv_pos=jnp.asarray(pos),
            window=window, chunk=8).astype(jnp.float32).sum()
    return jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))


def _grads_port(fn, q, k, v):
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    fn(*leaves).float().sum().backward()
    return [x.grad for x in leaves]


def _close_to_fp32_rounding(got, want, bf16_rounded: bool) -> None:
    """The gradient tolerance of the module docstring."""
    diff = np.abs(_np(got) - _np(want))
    if not bf16_rounded:
        assert diff.max() < 1e-5
        return
    assert diff.max() <= 2 ** -7 * np.abs(_np(want)).max()
    assert np.mean(diff < 1e-5) >= 0.99


@pytest.mark.parametrize("route", ["chunked", "chunked_window", "fused"])
def test_attention_gradients(route):
    q, k, v, pos = _qkv()
    window = 7 if route == "chunked_window" else 0
    if route == "fused":
        fn = L.causal_self_attention
    else:
        def fn(q, k, v):
            return L.chunked_attention(q, k, v, q_pos=_t(pos), kv_pos=_t(pos),
                                       window=window, chunk=8)
    got = _grads_port(fn, q, k, v)
    want = _grads_ref(q, k, v, pos, window)
    exact = _grads_port(lambda q, k, v: naive(q, k, v, _t(pos), _t(pos),
                                              window=window), q, k, v)
    for i, (g, w, e) in enumerate(zip(got, want, exact)):
        assert torch.isfinite(g).all()
        assert _maxdiff(g, e) < 0.06
        if route == "fused":
            assert _maxdiff(g, w) < 0.06
        else:
            _close_to_fp32_rounding(g, w, bf16_rounded=i < 2)


# (T, chunk, kv heads, causal, window, invalid slots): the last chunk is
# short wherever chunk does not divide T
FLASH_CASES = {
    "causal": (33, 8, 2, True, 0, False),
    "windowed": (33, 8, 2, True, 7, False),
    "non_causal": (33, 8, 2, False, 0, False),
    "invalid_slots": (32, 8, 1, True, 0, True),
    "short_last_chunk": (37, 16, 4, False, 5, True),
    "one_chunk": (20, 64, 4, True, 0, False),
}


def _flash_case(name):
    t, chunk, kv, causal, window, invalid = FLASH_CASES[name]
    q, k, v, pos = _qkv(t=t, kv=kv, seed=3)
    kv_pos = pos.copy()
    if invalid:
        kv_pos[:, 5:9] = -1
        kv_pos[1, -3:] = -1
    cot = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)
    return q, k, v, pos, kv_pos, cot, dict(causal=causal, window=window,
                                           chunk=chunk)


@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_gradients_match_reference_backward(name):
    """`_Flash`'s gradients against `jax.grad` of the reference's
    `chunked_attention` (its `_flash_bwd`), under a random cotangent, at
    the module docstring's fp32-rounding tolerance."""
    q, k, v, pos, kv_pos, cot, kw = _flash_case(name)

    def f(q, k, v):
        out = JL.chunked_attention(q, k, v, q_pos=jnp.asarray(pos),
                                   kv_pos=jnp.asarray(kv_pos), **kw)
        return (out.astype(jnp.float32) * jnp.asarray(cot)).sum()

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    got = _grads_port(lambda q, k, v: L.chunked_attention(
        q, k, v, q_pos=_t(pos), kv_pos=_t(kv_pos), **kw) * _t(cot), q, k, v)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and torch.isfinite(g).all()
        _close_to_fp32_rounding(g, w, bf16_rounded=i < 2)


def _flash_inputs(name):
    q, k, v, pos, kv_pos, _, kw = _flash_case(name)
    b, t, h, hd = q.shape
    kvh = k.shape[2]
    qg = _t(q).reshape(b, t, kvh, h // kvh, hd).permute(0, 2, 3, 1, 4).to(
        torch.bfloat16)
    return (qg, _t(k), _t(v), _t(kv_pos), _t(pos), kw["causal"],
            kw["window"], 1.0 / np.sqrt(hd), kw["chunk"])


@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_forward_is_the_loop_unchanged(name):
    """`_Flash`'s forward is the online-softmax loop bit for bit (the one
    autograd differentiates for a single query), and its logsumexp is
    m + log l of the same loop."""
    args = _flash_inputs(name)
    out = L._Flash.apply(*args)
    loop, lse = L._flash_fwd_scan(*args)
    assert torch.equal(out, loop)
    qg, k, _, kv_pos, q_pos, causal, window, scale, _ = args
    sc = torch.einsum("bkgth,bskh->bkgts", qg.float(), L._bf16(k)) * scale
    valid = L._mask_chunk(kv_pos, q_pos, causal, window)
    want = torch.logsumexp(torch.where(valid, sc, -torch.inf), dim=-1)
    rows = torch.isfinite(want)
    assert torch.allclose(lse[rows], want[rows], rtol=0, atol=1e-5)


def test_flash_saves_no_tq_by_s_tensor():
    """What the chunked route saves for backward, counted by
    `saved_tensors_hooks`, is (qg, k, v, the positions, out, lse): it
    grows with Tq + S, not with Tq x S (autograd through the loop saved
    each chunk's fp32 scores, masks and probabilities)."""
    def saved_bytes(t):
        q, k, v, pos = _qkv(b=1, t=t, h=4, kv=2, hd=16)
        leaves = [_t(a).requires_grad_() for a in (q, k, v)]
        sizes = []

        def pack(x):
            sizes.append(x.numel() * x.element_size())
            return x

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
            L.chunked_attention(*leaves, q_pos=_t(pos), kv_pos=_t(pos),
                                chunk=16)
        return sum(sizes)

    b, h, kv, hd = 1, 4, 2, 16

    def expected(t):
        qg = 2 * b * h * t * hd                    # bf16
        k_v = 2 * 4 * b * t * kv * hd              # fp32 inputs, as given
        positions = 2 * 4 * b * t                  # int32
        out, lse = 4 * b * h * t * hd, 4 * b * h * t
        return qg + k_v + positions + out + lse

    for t in (64, 128, 256):
        assert saved_bytes(t) == expected(t)
    assert saved_bytes(256) == 2 * saved_bytes(128)          # linear in T
    assert saved_bytes(256) < 4 * b * h * 256 * 256          # one score tensor


def test_flash_under_checkpoint_and_without_grad():
    """Under `torch.utils.checkpoint(use_reentrant=False)` (the models'
    remat) the gradients are those of the plain call, bit for bit; with
    no input requiring grad (prefill) the output is the same."""
    q, k, v, pos, kv_pos, cot, kw = _flash_case("short_last_chunk")

    def fn(q, k, v):
        return L.chunked_attention(q, k, v, q_pos=_t(pos), kv_pos=_t(kv_pos),
                                   **kw) * _t(cot)

    plain = _grads_port(fn, q, k, v)
    remat = _grads_port(lambda *a: torch.utils.checkpoint.checkpoint(
        fn, *a, use_reentrant=False), q, k, v)
    for a, b in zip(plain, remat):
        assert torch.equal(a, b)
    with torch.inference_mode():
        out = fn(*(_t(a) for a in (q, k, v)))
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    assert torch.equal(out, fn(*leaves).detach())


def test_single_query_and_invalid_positions():
    q, k, v, pos = _qkv(t=32)
    full = L.chunked_attention(_t(q), _t(k), _t(v), q_pos=_t(pos),
                               kv_pos=_t(pos), chunk=8)
    last = L.chunked_attention(_t(q[:, -1:]), _t(k), _t(v),
                               q_pos=_t(pos[:, -1:]), kv_pos=_t(pos), chunk=8)
    assert _maxdiff(last, full[:, -1:]) < 1e-5
    want = JL.chunked_attention(jnp.asarray(q[:, -1:]), jnp.asarray(k),
                                jnp.asarray(v), q_pos=jnp.asarray(pos[:, -1:]),
                                kv_pos=jnp.asarray(pos), chunk=8)
    assert _maxdiff(last, want) < 1e-5
    # slots with pos=-1 contribute nothing
    kv_pos = pos.copy()
    kv_pos[:, 8:] = -1
    o1 = L.chunked_attention(_t(q[:, :1]), _t(k), _t(v),
                             q_pos=_t(pos[:, 15:16]), kv_pos=_t(kv_pos),
                             chunk=8)
    o2 = L.chunked_attention(_t(q[:, :1]), _t(k[:, :8]), _t(v[:, :8]),
                             q_pos=_t(pos[:, 15:16]), kv_pos=_t(pos[:, :8]),
                             chunk=8)
    assert _maxdiff(o1, o2) < 1e-5
    want = JL.chunked_attention(jnp.asarray(q[:, :1]), jnp.asarray(k),
                                jnp.asarray(v), q_pos=jnp.asarray(pos[:, 15:16]),
                                kv_pos=jnp.asarray(kv_pos), chunk=8)
    assert _maxdiff(o1, want) < 1e-5


def test_fully_masked_rows_are_finite():
    q, k, v, pos = _qkv(t=8)
    kv_pos = _t(np.full_like(pos, -1))
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    o = L.chunked_attention(*leaves, q_pos=_t(pos), kv_pos=kv_pos, chunk=4)
    assert torch.isfinite(o).all() and float(o.abs().max()) < 1e-6
    o.sum().backward()
    assert all(torch.isfinite(x.grad).all() for x in leaves)


def _configs(arch, dtype):
    jcfg = jget_arch(arch).reduced()
    cfg = get_arch(arch).reduced()
    if dtype is not None:
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return cfg, jcfg


def _params(jcfg, seed=0):
    jparams = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    return convert.state_from_reference(jax.tree.map(np.asarray, jparams),
                                        "cpu"), jparams


def _tokens(cfg, b=2, t=24, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, t)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, size=(b, t)).astype(np.int32)
    return toks, labels


@pytest.mark.parametrize("arch", ["smollm_360m", "gemma_2b", "qwen2_15b",
                                  "gemma3_4b"])
@pytest.mark.parametrize("dtype", ["float32", None])
def test_forward_and_loss_match_reference(arch, dtype):
    """smollm (GQA), gemma_2b (MQA, GeGLU), qwen2 (qkv bias), gemma3
    (sliding windows: the chunked route)."""
    cfg, jcfg = _configs(arch, dtype)
    params, jparams = _params(jcfg)
    toks, labels = _tokens(cfg)
    logits, _ = JT.forward(jparams, jcfg, jnp.asarray(toks), chunk=8)
    got, aux = T.forward(params, cfg, _t(toks), chunk=8)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    tol_logits, tol_loss = (2e-3, 5e-5) if dtype else (0.1, 5e-3)
    assert _maxdiff(got, logits) < tol_logits
    batch = {"tokens": toks, "labels": labels}
    want = JM.train_loss(jparams, jcfg, {k: jnp.asarray(v) for k, v in
                                         batch.items()}, chunk=8)
    got = M.train_loss(params, cfg, {k: _t(v) for k, v in batch.items()},
                       chunk=8)
    assert abs(float(got) - float(want)) < tol_loss
    # explicit positions take the chunked route; remat changes nothing
    pos = _t(np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24)))
    by_pos, _ = T.forward(params, cfg, _t(toks), chunk=8, positions=pos,
                          remat=False)
    assert _maxdiff(by_pos, logits) < tol_logits


def test_loss_gradients_match_reference():
    cfg, jcfg = _configs("smollm_360m", "float32")
    params, jparams = _params(jcfg)
    toks, labels = _tokens(cfg)
    batch = {"tokens": toks, "labels": labels}
    want = jax.grad(JM.train_loss)(jparams, jcfg, {k: jnp.asarray(v) for k, v
                                                   in batch.items()}, chunk=8)
    leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
    M.train_loss(tree.unflatten(params, leaves), cfg,
                 {k: _t(v) for k, v in batch.items()}, chunk=8).backward()
    for leaf, w in zip(leaves, jax.tree.leaves(want)):
        w = np.asarray(w)
        assert leaf.grad.shape == w.shape
        # bf16-rounded attention operands on both sides: 1 % of the scale
        assert _maxdiff(leaf.grad, w) <= 1e-2 * np.abs(w).max() + 1e-7


@pytest.mark.parametrize("arch", ["smollm_360m", "gemma_2b", "qwen2_15b",
                                  "grok1_314b", "moonlight_16b_a3b",
                                  "qwen2vl_2b"])
def test_init_params_layout_matches_reference(arch):
    cfg, jcfg = _configs(arch, None)
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    params = M.init_params(torch.Generator().manual_seed(0), cfg)
    got = [(p, tuple(x.shape), str(x.dtype).split(".")[1])
           for p, x in tree.items(params)]
    paths = [tuple(k.key for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(jparams)[0]]
    want = [(p, tuple(x.shape), str(x.dtype))
            for p, x in zip(paths, jax.tree.leaves(jparams))]
    assert got == want
    # the same draws from the same seed
    again = M.init_params(torch.Generator().manual_seed(0), cfg)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(params),
                                                 tree.leaves(again)))
    table = params["embed"]["table"].float()
    assert abs(float(table.std()) - 1 / np.sqrt(cfg.d_model)) < 0.01


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_family_and_logical_params_match_reference(arch):
    """`family_module` picks the reference's family for every arch, and
    the params' logical trees (train and decode) equal the reference's
    off-mesh, as do the attention layouts of every mode (the mesh-only
    ones included; on a mesh, `tests/test_torch_sharding.py`)."""
    cfg, jcfg = _configs(arch, None)
    assert M.family_module(cfg).__name__.rsplit(".", 1)[1] == \
        JM.family_module(jcfg).__name__.rsplit(".", 1)[1]
    for decode in (False, True):
        assert M.logical_params(cfg, M.NO_MESH, decode=decode) == \
            JM.logical_params(jcfg, JM.NO_MESH, decode=decode)
    for mode in ("heads", "heads_repkv", "hd", "seq", "none"):
        assert L.logical_attention(cfg, mode) == \
            JL.logical_attention(jcfg, mode)


# ------------------------------------------------------- MoE and M-RoPE
def _moe_inputs(cfg, b, t, seed):
    """x and MoE params from numpy; the router is drawn at 4x the init
    scale so that no two experts tie on a token (an exact tie would let
    `jax.lax.top_k` and `torch.topk` pick different experts)."""
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    p = {"router": rng.standard_normal((d, e)) * 4 / np.sqrt(d),
         "wi_gate": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "wi_up": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "wo": rng.standard_normal((e, f, d)) / np.sqrt(f)}
    return x, {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [
    # (arch, B, T, group_size, capacity_factor): groups that divide T,
    # the one-group fallback, tokens dropped at capacity, decode (T = 1)
    ("grok1_314b", 2, 16, 8, None),
    ("grok1_314b", 2, 12, 8, None),
    ("moonlight_16b_a3b", 2, 16, 16, 1.0),
    ("moonlight_16b_a3b", 3, 1, 2048, 1.25),
    ("moonlight_16b_a3b", 1, 24, 2048, 0.5),
])
def test_moe_matches_reference(case, dtype):
    """Output and load-balance aux. fp32: 1e-5 on the aux (fp32 router
    and means on both sides) and 1e-2 on the output, whose combine
    weights are rounded to bf16 on both sides (a gate value that differs
    in its last fp32 bit may round to the neighbouring bf16 value, 2^-8
    relative); bf16 params: 4 bf16 ulps of the output's magnitude."""
    arch, b, t, group, cf = case
    cfg, jcfg = _configs(arch, None)
    if cf is not None:
        moe_cfg = dataclasses.replace(cfg.moe, capacity_factor=cf,
                                      num_experts=8, top_k=2)
        cfg = dataclasses.replace(cfg, moe=moe_cfg)
        jcfg = dataclasses.replace(jcfg, moe=jcfg.moe.__class__(
            num_experts=8, top_k=2, capacity_factor=cf))
    x, p = _moe_inputs(cfg, b, t, seed=t)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jp = {k: jnp.asarray(v, jnp.float32 if k == "router" else jdt)
          for k, v in p.items()}
    tp = {k: _t(v).to(torch.float32 if k == "router" else tdt)
          for k, v in p.items()}
    want, jaux = JL.moe(jp, jnp.asarray(x, jdt), jcfg, group_size=group)
    got, aux = L.moe(tp, _t(x).to(tdt), cfg, group_size=group)
    assert got.dtype == tdt and got.shape == x.shape
    assert abs(float(aux.load_balance_loss)
               - float(jaux.load_balance_loss)) < 1e-5
    big = float(np.abs(_np(want)).max())
    tol = 1e-2 if dtype == "float32" else 4 * 2.0 ** (np.floor(np.log2(big)) - 7)
    assert _maxdiff(got, want) <= tol


def test_moe_drops_tokens_past_capacity():
    """With capacity 1 a group of 4 tokens routed top-1 to 2 experts keeps
    at most 2 of them; a dropped token's output is exactly 0 (the
    reference's all-zero capacity one-hot row)."""
    cfg, _ = _configs("grok1_314b", "float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=2, top_k=1, capacity_factor=0.5))
    x, p = _moe_inputs(cfg, 1, 4, seed=7)
    out, _ = L.moe({k: _t(v) for k, v in p.items()}, _t(x), cfg,
                   group_size=4)
    zero_rows = int((out.abs().amax(-1) == 0).sum())
    assert zero_rows == 2


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_apply_mrope_matches_reference(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos3 = rng.integers(0, 300, size=(3, 2, 5)).astype(np.int32)
    jx, tx = jnp.asarray(x), _t(x)
    if dtype == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.bfloat16()
    tol = 1e-5 if dtype == np.float32 else 2 ** -7 * 4 + 1e-5
    for sections in ((2, 3, 3), (8, 0, 0), (1, 1, 6)):
        got = L.apply_mrope(tx, _t(pos3), 1e6, sections)
        want = JL.apply_mrope(jx, jnp.asarray(pos3), 1e6, sections)
        assert got.dtype == tx.dtype
        assert _maxdiff(got, want) <= tol
    # one stream everywhere is plain RoPE
    same = np.broadcast_to(pos3[:1], pos3.shape)
    assert _maxdiff(L.apply_mrope(tx, _t(same), 1e6, (2, 3, 3)),
                    L.apply_rope(tx, _t(pos3[0]), 1e6)) == 0.0
    with pytest.raises(ValueError, match="sections"):
        L.apply_mrope(tx, _t(pos3), 1e6, (1, 1, 1))


@pytest.mark.parametrize("arch", ["grok1_314b", "moonlight_16b_a3b",
                                  "qwen2vl_2b"])
@pytest.mark.parametrize("dtype", ["float32", None])
def test_moe_and_vlm_forward_match_reference(arch, dtype):
    """Logits, aux and loss of the MoE and M-RoPE configs (qwen2vl with a
    (t, h, w) grid in pos3 and stub vision embeddings, at the token
    embeddings' scale, over the first 6 positions), at
    `test_forward_and_loss_match_reference`'s tolerances; fp32 MoE logits
    hold to 1e-2 (bf16 combine weights, `test_moe_matches_reference`).
    The aux holds to 1e-5 in fp32 and to the loss's 5e-3 with bf16
    params, whose router inputs are bf16 activations that differ by ulps
    between the packages."""
    cfg, jcfg = _configs(arch, dtype)
    params, jparams = _params(jcfg)
    toks, labels = _tokens(cfg)
    extra = {}
    if cfg.mrope:
        rng = np.random.default_rng(4)
        pos3 = np.broadcast_to(np.arange(24, dtype=np.int32),
                               (3, 2, 24)).copy()
        pos3[1, :, :6] = [0, 0, 0, 1, 1, 1]
        pos3[2, :, :6] = [0, 1, 2, 0, 1, 2]
        extra = {"pos3": pos3, "vision_embeds": (rng.standard_normal(
            (2, 6, cfg.d_model)) / np.sqrt(cfg.d_model)).astype(np.float32)}
    logits, jaux = JT.forward(jparams, jcfg, jnp.asarray(toks), chunk=8,
                              **{k: jnp.asarray(v) for k, v in extra.items()})
    got_logits, aux = T.forward(params, cfg, _t(toks), chunk=8,
                                **{k: _t(v) for k, v in extra.items()})
    tol_logits, tol_loss = (2e-3, 5e-5) if dtype else (0.1, 5e-3)
    if dtype and cfg.moe:
        tol_logits, tol_loss = 1e-2, 5e-4
    assert _maxdiff(got_logits, logits) < tol_logits
    assert abs(float(aux) - float(jaux)) < (1e-5 if dtype else 5e-3)
    if cfg.moe:
        assert float(aux) > 0
    batch = {"tokens": toks, "labels": labels, **extra}
    want = JM.train_loss(jparams, jcfg, {k: jnp.asarray(v) for k, v in
                                         batch.items()}, chunk=8)
    got = M.train_loss(params, cfg, {k: _t(v) for k, v in batch.items()},
                       chunk=8)
    assert abs(float(got) - float(want)) < tol_loss
    if cfg.mrope:
        # the vision embeddings replace the first positions' token embeds
        plain, _ = T.forward(params, cfg, _t(toks), chunk=8,
                             pos3=_t(extra["pos3"]))
        assert _maxdiff(plain, got_logits) > 0.1


@pytest.mark.parametrize("arch", ["grok1_314b", "moonlight_16b_a3b"])
def test_moe_train_step_matches_reference(arch):
    """One train step of a reduced MoE config (the aux term in the loss,
    its gradient through the router), at `tests/test_torch_train.py`'s
    bf16 tolerances: 5e-3 on the loss, 2e-2 on the gradient norm, 1 bf16
    ulp (plus 1e-6) on params; the fp32 router to 1e-4 of its scale."""
    from repro.train import optimizer as jopt
    from repro.train import train_step as jts
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticStream
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import TrainConfig, make_train_step

    cfg, jcfg = _configs(arch, None)
    kw = dict(attn_chunk=16)
    tcfg = TrainConfig(adamw=opt.AdamWConfig(peak_lr=5e-3, warmup_steps=1),
                       **kw)
    jtcfg = jts.TrainConfig(adamw=jopt.AdamWConfig(peak_lr=5e-3,
                                                   warmup_steps=1), **kw)
    jstate = jts.init_state(jax.random.PRNGKey(0), jcfg, jtcfg)
    state = convert.state_from_reference(jax.tree.map(np.asarray, jstate),
                                         "cpu")
    batch = SyntheticStream(cfg, ShapeConfig("t", "train", 32, 4)).batch_at(1)
    new, m = make_train_step(cfg, tcfg)(state, batch)
    jnew, jm = jts.make_train_step(jcfg, jtcfg)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    assert abs(float(m["loss"]) - float(jm["loss"])) < 5e-3
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=2e-2)
    for (path, a), b in zip(tree.items(new["params"]),
                            jax.tree.leaves(jnew["params"])):
        b = np.asarray(jnp.asarray(b, jnp.float32))
        if a.dtype == torch.float32:
            tol = 1e-4 * np.abs(b).max()
        else:
            e = np.floor(np.log2(np.maximum(np.abs(b), 2.0 ** -126)))
            tol = 2.0 ** (e - 7) + 1e-6
        assert (np.abs(_np(a) - b) <= tol).all(), path
