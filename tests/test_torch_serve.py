"""The port's KV-cache serving path (`prefill`, `decode_step`, the int8
cache, window slicing), held against repro on the CPU.

Inputs come from numpy seeds; params and caches are the reference's,
converted with `convert.state_from_reference`. Tolerances:

* the reference's own invariant, decode == teacher-forced forward, at
  its TOL 0.06 (`tests/test_serve_equiv.py`: bf16 params, fp32
  accumulation in another order);
* port against reference, stock bf16 configs: 0.1 on logits (as in
  `tests/test_torch_models.py`: every layer's output is rounded to bf16
  on both sides, in different orders) and 2 + L bf16 ulps of the
  largest cache entry on k and v for L layers (a layer's k or v may round
  to the neighbouring bf16 value, and every layer's inputs carry the
  earlier layers' differences: 2 ulps were seen at L = 2, 4.4 at L = 6);
* port against reference, `dtype="float32"` variants: 1e-5 on logits
  and caches (fp32 rounding), except for MoE layers, whose combine
  weights are rounded to bf16 on both sides: gate values that differ in
  their last fp32 bit may round to neighbouring bf16 values (2^-8
  relative), so MoE logits hold to 1e-2 and caches to 1e-3;
* `quantize_kv` is bit-exact (int8 values and float16 scales). An int8
  cache built from k / v that differ as above may round to other levels,
  so int8 caches are held dequantized (values x scales), to the bf16
  tolerance above plus one quantisation step (the largest scale), and
  the scales to that tolerance / 127 (an absmax that moved by it);
  int8 decode holds to the reference's own 0.6 against the forward pass.
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
from repro_torch.configs import get_arch
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import transformer as T

TOL = 0.06
ARCHS = ["qwen2_15b", "grok1_314b", "gemma3_4b", "gemma_2b", "smollm_360m",
         "moonlight_16b_a3b", "qwen2vl_2b"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _maxdiff(a, b) -> float:
    return float(np.max(np.abs(_np(a) - _np(b))))


def _configs(arch, dtype=None):
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


def _tokens(cfg, b=2, t=12, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(b, t)).astype(np.int32)


def _pos3(cfg, b, t):
    if not cfg.mrope:
        return None
    return np.ascontiguousarray(
        np.broadcast_to(np.arange(t, dtype=np.int32), (3, b, t)))


def _step_pos3(cfg, b, i):
    return np.full((3, b, 1), i, np.int32) if cfg.mrope else None


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _check_cache(cache, jcache, kv_tol):
    assert sorted(cache) == sorted(jcache)
    for key in cache:
        a, b = cache[key], jcache[key]
        assert tuple(a.shape) == tuple(b.shape), key
        assert str(a.dtype).split(".")[1] == str(b.dtype), key
        if key in ("pos", "idx"):
            assert np.array_equal(a.numpy(), np.asarray(b)), key
        elif key in ("k_scale", "v_scale"):
            assert _maxdiff(a, b) <= kv_tol / 127 + 1e-6, key
        elif "k_scale" in cache:                      # int8 values
            sa, sb = _np(cache[key[0] + "_scale"]), _np(jcache[key[0] +
                                                           "_scale"])
            step = float(sb.max())
            assert np.abs(_np(a) * sa[..., None] - _np(b) * sb[..., None]
                          ).max() <= kv_tol + step, key
        else:
            assert _maxdiff(a, b) <= kv_tol, key


def _kv_tol(cfg, jcache):
    if cfg.dtype == "float32":
        return 1e-3 if cfg.moe else 1e-5
    if "k_scale" in jcache:
        big = max(float((np.abs(_np(jcache[k])).max(-1)
                         * _np(jcache[k + "_scale"])).max()) for k in "kv")
    else:
        big = max(float(np.abs(_np(jcache[k])).max()) for k in "kv")
    ulps = 2 + cfg.num_layers                         # bf16 ulps of `big`
    return ulps * 2.0 ** (np.floor(np.log2(big)) - 7)


def _logit_tol(cfg):
    if cfg.dtype == "float32":
        return 1e-2 if cfg.moe else 1e-5
    return 0.1


def _run_both(cfg, jcfg, params, jparams, toks, prompt, max_len, steps,
              kv_dtype="bf16", window_slice=True):
    """Prefill `prompt` tokens, then decode `steps` more, on both sides,
    checking logits and caches after every call; returns the port's and
    the reference's logits of each decode step."""
    b = toks.shape[0]
    pos3 = _pos3(cfg, b, prompt)
    jl, jc = JT.prefill(jparams, jcfg, jnp.asarray(toks[:, :prompt]),
                        max_len=max_len, chunk=8, pos3=_j(pos3),
                        kv_dtype=kv_dtype)
    lg, c = T.prefill(params, cfg, _t(toks[:, :prompt]), max_len=max_len,
                      chunk=8, pos3=_t(pos3), kv_dtype=kv_dtype)
    assert lg.dtype == torch.float32
    assert _maxdiff(lg, jl) < _logit_tol(cfg)
    _check_cache(c, jc, _kv_tol(cfg, jc))
    outs = []
    for i in range(prompt, prompt + steps):
        sp = _step_pos3(cfg, b, i)
        jl, jc = JT.decode_step(jparams, jcfg, jnp.asarray(toks[:, i]), jc,
                                chunk=8, pos3=_j(sp),
                                window_slice=window_slice)
        lg, c = T.decode_step(params, cfg, _t(toks[:, i]), c, chunk=8,
                              pos3=_t(sp), window_slice=window_slice)
        assert _maxdiff(lg, jl) < _logit_tol(cfg), i
        _check_cache(c, jc, _kv_tol(cfg, jc))
        outs.append((lg, jl))
    return outs


@pytest.mark.parametrize("dtype", [None, "float32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype):
    """Logits and every cache leaf after a prefill and two decode steps."""
    cfg, jcfg = _configs(arch, dtype)
    params, jparams = _params(jcfg)
    toks = _tokens(cfg)
    _run_both(cfg, jcfg, params, jparams, toks, prompt=10, max_len=14,
              steps=2)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """`tests/test_serve_equiv.py::test_transformer_decode_matches_forward`
    on the port: prefill T-2 tokens, decode 2, each step's logits against
    the teacher-forced forward at TOL."""
    cfg, jcfg = _configs(arch)
    params, _ = _params(jcfg)
    toks = _tokens(cfg)
    b, t = toks.shape
    pos3 = _pos3(cfg, b, t)
    logits, _ = T.forward(params, cfg, _t(toks), pos3=_t(pos3), chunk=8)
    _, cache = T.prefill(params, cfg, _t(toks[:, :t - 2]), max_len=t + 2,
                         chunk=8,
                         pos3=None if pos3 is None else _t(pos3[:, :, :t - 2]))
    for i in (t - 2, t - 1):
        lg, cache = T.decode_step(params, cfg, _t(toks[:, i]), cache, chunk=8,
                                  pos3=_t(_step_pos3(cfg, b, i)))
        assert _maxdiff(lg, logits[:, i]) < TOL, (arch, i)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_kv_bit_exact(seed, dtype):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, 5, 3, 16)) * 3.0).astype(np.float32)
    # ties at .5 (round half to even), an all-zero head (the 1e-8 floor)
    # and values that sit on the clip
    x[0, 0, 0] = np.arange(16) - 7.5
    x[0, 0, 0, 0] = 127.0
    x[0, 0, 1] = 0.0
    x[1, 4, 2] = np.linspace(-1e-3, 1e-3, 16)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.bfloat16()
    q, s = L.quantize_kv(tx)
    jq, js = JL.quantize_kv(jx)
    assert q.dtype == torch.int8 and s.dtype == torch.float16
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.view(torch.int16).numpy(),
                          np.asarray(js).view(np.int16))
    # the ties went to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2
    assert q[0, 0, 0, 1:8].tolist() == [-6, -6, -4, -4, -2, -2, 0]


def test_int8_chunk_dequant_matches_reference():
    """The Tq = 1 int8 branch of `chunked_attention`: chunks of 8 over a
    27-slot cache (a short last chunk), some slots invalid."""
    rng = np.random.default_rng(3)
    b, s, kv, g, hd = 2, 27, 2, 2, 16
    q = rng.standard_normal((b, 1, kv * g, hd)).astype(np.float32)
    k = rng.integers(-127, 128, (b, s, kv, hd)).astype(np.int8)
    v = rng.integers(-127, 128, (b, s, kv, hd)).astype(np.int8)
    ks = (rng.random((b, s, kv)) * 0.05).astype(np.float16)
    vs = (rng.random((b, s, kv)) * 0.05).astype(np.float16)
    kv_pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    kv_pos[:, 20:] = -1
    q_pos = np.full((b, 1), 19, np.int32)
    for window in (0, 5):
        want = JL.chunked_attention(
            *(jnp.asarray(a) for a in (q, k, v)), q_pos=jnp.asarray(q_pos),
            kv_pos=jnp.asarray(kv_pos), window=window, chunk=8,
            k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        got = L.chunked_attention(
            *(_t(a) for a in (q, k, v)), q_pos=_t(q_pos), kv_pos=_t(kv_pos),
            window=window, chunk=8, k_scale=_t(ks), v_scale=_t(vs))
        assert _maxdiff(got, want) < 1e-5
    with pytest.raises(ValueError, match="decode-path"):
        L.chunked_attention(_t(np.repeat(q, 2, 1)), _t(k), _t(v),
                            q_pos=_t(np.repeat(q_pos, 2, 1)),
                            kv_pos=_t(kv_pos), k_scale=_t(ks), v_scale=_t(vs))


@pytest.mark.parametrize("arch", ["qwen2_15b", "grok1_314b",
                                  "moonlight_16b_a3b"])
def test_int8_decode_matches_reference(arch):
    """The int8 cache through prefill and three decode steps, against the
    reference's, and `tests/test_serve_equiv.py::test_int8_kv_cache_decode`
    on the port (within 0.6 of the forward pass)."""
    cfg, jcfg = _configs(arch)
    params, jparams = _params(jcfg)
    toks = _tokens(cfg, t=16)
    outs = _run_both(cfg, jcfg, params, jparams, toks, prompt=13, max_len=16,
                     steps=3, kv_dtype="int8")
    logits, _ = T.forward(params, cfg, _t(toks), chunk=8)
    assert _maxdiff(outs[0][0], logits[:, 13]) < 0.6
    assert all(torch.isfinite(lg).all() for lg, _ in outs)


def test_sliced_decode_past_the_window():
    """gemma3 (reduced: window 8) with 6 layers, one 5 local : 1 global
    block, so that the global layer reads the full cache: a 12-token
    prompt and 6 decode steps in a 20-slot cache, so the window's start
    moves every step. Against the reference's sliced decode, against the
    port's unsliced decode (the same attention by masks, over other
    chunks: the probabilities are rounded to bf16 against another running
    max, so it holds at TOL) and against the forward pass."""
    cfg, jcfg = _configs("gemma3_4b")
    cfg = dataclasses.replace(cfg, num_layers=6)
    jcfg = dataclasses.replace(jcfg, num_layers=6)
    params, jparams = _params(jcfg)
    toks = _tokens(cfg, t=18)
    outs = _run_both(cfg, jcfg, params, jparams, toks, prompt=12, max_len=20,
                     steps=6)
    _, cache = T.prefill(params, cfg, _t(toks[:, :12]), max_len=20, chunk=8)
    logits, _ = T.forward(params, cfg, _t(toks), chunk=8)
    for i, (lg, _) in zip(range(12, 18), outs):
        full, cache = T.decode_step(params, cfg, _t(toks[:, i]), cache,
                                    chunk=8, window_slice=False)
        assert _maxdiff(lg, full) < TOL, i
        assert _maxdiff(lg, logits[:, i]) < TOL, i


@pytest.mark.parametrize("arch", ["qwen2_15b", "gemma3_4b"])
def test_decode_past_max_len_clamps_like_reference(arch):
    """A decode at idx >= max_len writes the cache's last slot (the
    reference's `dynamic_update_slice` clamps its start), and a window
    slice's start is clamped to fit (`dynamic_slice_in_dim`)."""
    cfg, jcfg = _configs(arch)
    params, jparams = _params(jcfg)
    toks = _tokens(cfg, t=12)
    _run_both(cfg, jcfg, params, jparams, toks, prompt=9, max_len=10,
              steps=3)


def test_int8_with_window_slicing_raises():
    cfg, jcfg = _configs("gemma3_4b")
    params, _ = _params(jcfg)
    toks = _t(_tokens(cfg, t=10))
    _, cache = T.prefill(params, cfg, toks, max_len=12, chunk=8,
                         kv_dtype="int8")
    with pytest.raises(ValueError, match="int8 KV cache with window slicing"):
        T.decode_step(params, cfg, toks[:, -1], cache, chunk=8)
    # unsliced, the int8 cache runs
    lg, _ = T.decode_step(params, cfg, toks[:, -1], cache, chunk=8,
                          window_slice=False)
    assert torch.isfinite(lg).all()


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_and_logical_match_reference(arch, kv_dtype):
    cfg, jcfg = _configs(arch)
    cache = M.init_cache(cfg, 3, 7, kv_dtype=kv_dtype, device="cpu")
    jcache = JM.init_cache(jcfg, 3, 7, kv_dtype=kv_dtype)
    assert sorted(cache) == sorted(jcache)
    for key in cache:
        assert tuple(cache[key].shape) == tuple(jcache[key].shape), key
        assert str(cache[key].dtype).split(".")[1] == \
            str(jcache[key].dtype), key
        assert np.array_equal(_np(cache[key]), _np(jcache[key])), key
    assert M.cache_logical(cfg, kv_dtype=kv_dtype) == JM.cache_logical(
        jcfg, kv_dtype=kv_dtype)
    with pytest.raises(ValueError, match="kv_dtype"):
        M.init_cache(cfg, 1, 4, kv_dtype="fp8", device="cpu")


def test_decode_step_through_model_api():
    cfg, jcfg = _configs("qwen2vl_2b")
    params, jparams = _params(jcfg)
    toks = _tokens(cfg, t=6)
    _, cache = T.prefill(params, cfg, _t(toks[:, :5]), max_len=8, chunk=8,
                         pos3=_t(_pos3(cfg, 2, 5)))
    _, jcache = JT.prefill(jparams, jcfg, jnp.asarray(toks[:, :5]), max_len=8,
                           chunk=8, pos3=_j(_pos3(cfg, 2, 5)))
    sp = _step_pos3(cfg, 2, 5)
    lg, _ = M.decode_step(params, cfg, _t(toks[:, 5]), cache, chunk=8,
                          pos3=_t(sp))
    jl, _ = JM.decode_step(jparams, jcfg, jnp.asarray(toks[:, 5]), jcache,
                           chunk=8, pos3=_j(sp))
    assert _maxdiff(lg, jl) < 0.1


def test_vision_prefill_matches_reference():
    """qwen2-vl with stub vision embeddings over the first 4 positions and
    a (t, h, w) grid in pos3 for them: prefill and one decode step."""
    cfg, jcfg = _configs("qwen2vl_2b", "float32")
    params, jparams = _params(jcfg)
    toks = _tokens(cfg, t=9)
    rng = np.random.default_rng(5)
    vis = rng.standard_normal((2, 4, cfg.d_model)).astype(np.float32)
    pos3 = _pos3(cfg, 2, 8).copy()
    pos3[1, :, :4] = [0, 0, 1, 1]
    pos3[2, :, :4] = [0, 1, 0, 1]
    jl, jc = JT.prefill(jparams, jcfg, jnp.asarray(toks[:, :8]), max_len=10,
                        chunk=8, pos3=_j(pos3), vision_embeds=_j(vis))
    lg, c = T.prefill(params, cfg, _t(toks[:, :8]), max_len=10, chunk=8,
                      pos3=_t(pos3), vision_embeds=_t(vis))
    assert _maxdiff(lg, jl) < 1e-5
    _check_cache(c, jc, 1e-5)
    sp = _step_pos3(cfg, 2, 8)
    jl, _ = JT.decode_step(jparams, jcfg, jnp.asarray(toks[:, 8]), jc, chunk=8,
                           pos3=_j(sp))
    lg, _ = T.decode_step(params, cfg, _t(toks[:, 8]), c, chunk=8,
                          pos3=_t(sp))
    assert _maxdiff(lg, jl) < 1e-5


def test_prefill_longer_than_cache_raises():
    cfg, jcfg = _configs("qwen2_15b")
    params, _ = _params(jcfg)
    with pytest.raises(ValueError, match="does not fit"):
        T.prefill(params, cfg, _t(_tokens(cfg, t=9)), max_len=8)


def test_serving_keeps_no_autograd_graph():
    cfg, jcfg = _configs("smollm_360m", "float32")
    params, _ = _params(jcfg)
    params = tree.map(lambda p: p.requires_grad_(), params)
    lg, cache = T.prefill(params, cfg, _t(_tokens(cfg)), max_len=14, chunk=8)
    assert not lg.requires_grad and lg.grad_fn is None
    lg, cache = T.decode_step(params, cfg, _t(_tokens(cfg)[:, 0]), cache)
    assert not lg.requires_grad
    assert all(not x.requires_grad for x in tree.leaves(cache))
