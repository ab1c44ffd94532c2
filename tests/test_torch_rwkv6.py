"""The port's rwkv6 family, held against repro on the CPU.

Inputs come from numpy seeds; params and states are the reference's,
converted with `convert.state_from_reference` (the fp32 leaves `w0` and
`u` stay fp32). Tolerances:

* `dtype="float32"` variants: 2e-3 on logits and 5e-5 on the loss, the
  bars of `tests/test_torch_models.py` (the only bf16 rounding left in
  an fp32 rwkv6 is `unembed`'s); the WKV core on its own and every state
  leaf to 1e-5 of their scale (fp32 sums in another order: the port
  takes the intra-chunk exponent differences where the reference
  multiplies exponentials, which overflow at strong decays; there the
  port is held to a float64 recurrence); gradients to 1 % of each
  leaf's scale;
* stock bf16 configs: every layer's output and the recurrent state's
  inputs (r, k, v rounded to bf16 before the fp32 scan) are rounded on
  both sides, in other orders, and the state carries each rounding
  forward. On these reduced configs the reference's own bf16 forward
  sits 0.07-0.24 (max abs logit) from an fp32 evaluation of the same
  bf16 weights, and the port's 0.11-0.28, so the transformer's 0.1 on
  logits does not hold between the two (0.08-0.20 measured over five
  seeds). The bf16 forward is held instead to that fp32 evaluation, no
  further from it than twice the reference's distance plus 0.02, and the
  loss to 5e-3; the port's own decode == forward at the reference's TOL
  0.06 (`tests/test_serve_equiv.py`);
* greedy tokens equal to the reference's in fp32 (in bf16 a close call
  may go either way at the noise above).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _family_parity import (JGENERATE, JLOSS, check_gradients,
                            check_init_layout, check_launchers,
                            check_roundtrip, check_two_adamw_steps, configs,
                            maxdiff, params, to_np, to_torch)
from repro.models import model as JM
from repro.models import rwkv6 as JR
from repro_torch.models import model as M
from repro_torch.models import rwkv6 as R
from repro_torch.serve import serve_step

ARCH = "rwkv6_16b"
TOL = 0.06
# the reference's entry points, each compiled once per shape
JFORWARD = jax.jit(JR.forward, static_argnums=(1,), static_argnames=("chunk",))
JPREFILL = jax.jit(JR.prefill, static_argnums=(1,))
JDECODE = jax.jit(JR.decode_step, static_argnums=(1,))
JWKV = jax.jit(JR.wkv_chunked, static_argnums=(6,))


def _tokens(cfg, b=2, t=24, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, t)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, size=(b, t)).astype(np.int32)
    return toks, labels


def _check_state(state, jstate):
    """Every leaf's shape and dtype, and its values to 1e-5 of its scale
    (fp32 models)."""
    assert sorted(state) == sorted(jstate)
    for key in state:
        a, b = state[key], jstate[key]
        assert tuple(a.shape) == tuple(b.shape), key
        assert str(a.dtype).split(".")[1] == str(b.dtype), key
        assert maxdiff(a, b) <= 1e-5 * (float(np.abs(to_np(b)).max())
                                        + 1e-6), key


def test_init_and_logical_trees_match_reference():
    """The init's paths, shapes and dtypes (fp32 `w0` and `u` among bf16
    leaves), and the logical trees of params and state."""
    got = check_init_layout(ARCH)
    assert got["layers"]["w0"].dtype == torch.float32
    assert float(got["layers"]["w0"].max()) == -1.0
    cfg, jcfg = configs(ARCH)
    assert M.cache_logical(cfg) == JM.cache_logical(jcfg)


@pytest.mark.parametrize("dtype", ["float32", None])
def test_forward_and_loss_match_reference(dtype):
    cfg, jcfg = configs(ARCH, dtype)
    port, jparams = params(jcfg)
    toks, labels = _tokens(cfg)
    want, _ = JFORWARD(jparams, jcfg, jnp.asarray(toks), chunk=8)
    got, aux = R.forward(port, cfg, to_torch(toks), chunk=8)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    batch = {"tokens": toks, "labels": labels}
    jloss = JLOSS(jparams, jcfg, {k: jnp.asarray(v) for k, v in
                                  batch.items()})
    loss = M.train_loss(port, cfg, {k: to_torch(v) for k, v in
                                    batch.items()})
    if dtype == "float32":
        assert maxdiff(got, want) < 2e-3
        assert abs(float(loss) - float(jloss)) < 5e-5
        return
    # bf16: both held to an fp32 evaluation of the same bf16 weights
    cfg32, jcfg32 = configs(ARCH, "float32")
    truth, _ = JFORWARD(jax.tree.map(lambda x: x.astype(jnp.float32),
                                     jparams), jcfg32, jnp.asarray(toks),
                        chunk=8)
    assert maxdiff(got, truth) <= 2 * maxdiff(want, truth) + 0.02
    assert maxdiff(got, want) <= 2 * maxdiff(want, truth) + 0.02
    assert abs(float(loss) - float(jloss)) < 5e-3


@pytest.mark.parametrize("chunk", [1, 3, 5, 16])
def test_wkv_chunked_matches_reference(chunk):
    """The WKV core from a nonzero state, at decays from the init's
    range to the clamp's neighbourhood over short chunks."""
    rng = np.random.default_rng(chunk)
    b, t, h, k = 2, 11, 3, 8
    r, kk, v = (rng.standard_normal((b, t, h, k)).astype(np.float32)
                for _ in range(3))
    logw = -np.exp(rng.uniform(-3, 1.5, (b, t, h, k))).astype(np.float32)
    u = rng.standard_normal((h, k)).astype(np.float32)
    s0 = rng.standard_normal((b, h, k, k)).astype(np.float32)
    want, wstate = JWKV(*(jnp.asarray(x) for x in (r, kk, v, logw, u, s0)),
                        chunk)
    got, state = R.wkv_chunked(*(to_torch(x) for x in (r, kk, v, logw, u,
                                                       s0)), chunk)
    assert maxdiff(got, want) <= 1e-5 * float(np.abs(to_np(want)).max())
    assert maxdiff(state, wstate) <= 1e-5 * float(np.abs(to_np(wstate)).max())


def test_wkv_chunked_finite_where_the_reference_overflows():
    """Decays at -15 a step over a chunk of 64: the reference's factor
    exp(-cs) overflows fp32 and its output is not finite; the port's
    equals the plain recurrence S_t = diag(w_t) S_{t-1} + k_t^T v_t,
    o_t = r_t (S_{t-1} + diag(u k_t)^T v_t) in float64, to 2e-4 of its
    scale: the chunk's fp32 cumulative decay reaches -960, where fp32 is
    spaced 6e-5, so each exponent difference and weight carries up to
    ~1e-4 of error (2.4e-5 seen)."""
    rng = np.random.default_rng(9)
    b, t, h, k = 1, 64, 2, 4
    r, kk, v = (rng.standard_normal((b, t, h, k)) for _ in range(3))
    logw = np.full((b, t, h, k), -15.0) + rng.uniform(-1, 1, (b, t, h, k))
    u = rng.standard_normal((h, k))
    s0 = rng.standard_normal((b, h, k, k))
    f32 = [x.astype(np.float32) for x in (r, kk, v, logw, u, s0)]
    want, _ = JWKV(*(jnp.asarray(x) for x in f32), 64)
    assert not np.isfinite(np.asarray(want)).all()
    got, state = R.wkv_chunked(*(to_torch(x) for x in f32), 64)
    s = s0.copy()
    out = np.zeros((b, t, h, k))
    for i in range(t):
        bonus = np.einsum("bhk,bhv->bhkv", u * kk[:, i], v[:, i])
        out[:, i] = np.einsum("bhk,bhkv->bhv", r[:, i], s + bonus)
        s = np.exp(logw[:, i])[..., None] * s + np.einsum(
            "bhk,bhv->bhkv", kk[:, i], v[:, i])
    assert torch.isfinite(got).all()
    assert maxdiff(got, out) <= 2e-4 * np.abs(out).max()
    assert maxdiff(state, s) <= 2e-4 * np.abs(s).max()


@pytest.mark.parametrize("chunk", [1, 3, 8, 12])
def test_chunk_invariance(chunk):
    """`tests/test_serve_equiv.py`'s chunks, in fp32: each against the
    reference at the same chunk and against the port at chunk 4."""
    cfg, jcfg = configs(ARCH, "float32")
    port, jparams = params(jcfg)
    toks, _ = _tokens(cfg, t=12)
    base, _ = R.forward(port, cfg, to_torch(toks), chunk=4)
    got, _ = R.forward(port, cfg, to_torch(toks), chunk=chunk)
    want, _ = JFORWARD(jparams, jcfg, jnp.asarray(toks), chunk=chunk)
    assert maxdiff(got, want) < 2e-3
    assert maxdiff(got, base) < 2e-3


@pytest.mark.parametrize("dtype", ["float32", None])
def test_prefill_and_decode_match_reference(dtype):
    """Logits and every state leaf after a prefill of 8 tokens and each of
    4 decode steps (fp32); in bf16 the port's decode == its forward at
    TOL and the state's dtypes and shapes."""
    cfg, jcfg = configs(ARCH, dtype)
    port, jparams = params(jcfg)
    toks, _ = _tokens(cfg, t=12)
    lg, state = R.prefill(port, cfg, to_torch(toks[:, :8]))
    jl, jstate = JPREFILL(jparams, jcfg, jnp.asarray(toks[:, :8]))
    assert lg.dtype == torch.float32 and tuple(lg.shape) == (2, 256)
    if dtype == "float32":
        assert maxdiff(lg, jl) < 2e-3
        _check_state(state, jstate)
    full, _ = R.forward(port, cfg, to_torch(toks), chunk=8)
    for i in range(8, 12):
        lg, state = R.decode_step(port, cfg, to_torch(toks[:, i]), state)
        jl, jstate = JDECODE(jparams, jcfg, jnp.asarray(toks[:, i]), jstate)
        assert maxdiff(lg, full[:, i]) < TOL, i
        if dtype == "float32":
            assert maxdiff(lg, jl) < 2e-3, i
            _check_state(state, jstate)
    assert [str(state[k].dtype) for k in ("wkv", "last_tm", "last_cm")] == \
        ["torch.float32"] + 2 * [str(lg.new_zeros((), dtype=R._dtype(cfg))
                                     .dtype)]
    check_roundtrip(state)


def test_serve_api_and_int8_raises():
    cfg, jcfg = configs(ARCH)
    state = M.init_cache(cfg, 3, 7, device="cpu")
    jstate = JM.init_cache(jcfg, 3, 7)
    _check_state(state, jstate)
    with pytest.raises(ValueError, match="rwkv6 family has no 'int8'"):
        M.init_cache(cfg, 1, 4, kv_dtype="int8", device="cpu")
    with pytest.raises(ValueError, match="rwkv6 family"):
        M.cache_logical(cfg, kv_dtype="int8")
    port, _ = params(jcfg)
    toks, _ = _tokens(cfg, t=6)
    _, s1 = R.prefill(port, cfg, to_torch(toks[:, :5]))
    lg, _ = M.decode_step(port, cfg, to_torch(toks[:, 5]), s1)
    full, _ = R.forward(port, cfg, to_torch(toks), chunk=8)
    assert maxdiff(lg, full[:, 5]) < TOL
    assert not lg.requires_grad


def test_gradients_match_reference():
    cfg, jcfg = configs(ARCH, "float32")
    port, jparams = params(jcfg)
    toks, labels = _tokens(cfg, t=16)
    check_gradients(cfg, jcfg, port, jparams,
                    {"tokens": toks, "labels": labels}, lambda path: 1e-2)


def test_two_adamw_steps_match_reference():
    """`tests/test_torch_train.py`'s fp32 bars: the loss to 5e-5 and params
    to 1e-4 (3 params with moments near 0 passed 1e-4 after step 2, up to
    1.4e-4: those are held to 2 lr a step)."""
    check_two_adamw_steps(ARCH, loss_tol=5e-5, param_tol=1e-4)


def test_generate_greedy_matches_reference():
    cfg, jcfg = configs(ARCH, "float32")
    port, jparams = params(jcfg)
    toks, _ = _tokens(cfg, t=8)
    want = JGENERATE(jparams, jcfg, {"tokens": jnp.asarray(toks)}, steps=6,
                     chunk=8)
    got = serve_step.generate(port, cfg, {"tokens": toks}, steps=6, chunk=8,
                              device="cpu")
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_launchers_print_the_reference_lines(monkeypatch, capsys, tmp_path):
    check_launchers(ARCH, ["--batch", "2", "--prompt-len", "8",
                           "--gen-tokens", "4"], monkeypatch, capsys,
                    tmp_path)
