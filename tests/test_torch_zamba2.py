"""The port's mamba2 block and zamba2 family, held against repro on the CPU.

Inputs come from numpy seeds; params and caches are the reference's,
converted with `convert.state_from_reference` (the fp32 leaves `A_log`,
`dt_bias` and `D` stay fp32). Tolerances:

* the SSD scan, the short conv and a whole mamba2 block in fp32: 1e-5 of
  their scale (fp32 sums in another order; the three-operand einsums are
  two-operand products here);
* `dtype="float32"` models: the shared attention block rounds q, k, v
  and the probabilities to bf16 on both sides, and fp32 differences of
  1e-6 upstream flip some of those roundings (2^-8 of an operand each),
  as the MoE combine weights do in `tests/test_torch_models.py`: logits
  to 1e-2 and the loss to 5e-4, its MoE bars (1.7e-3 to 5.4e-3 on
  logits and up to 6.2e-5 on the loss measured over five seeds); cache
  leaves to 1e-3 of their scale; gradients to 1 % of each leaf's scale;
* stock bf16 models: as for rwkv6 (`tests/test_torch_rwkv6.py`), the
  SSM state carries each layer's bf16 rounding forward. The reference's
  own bf16 forward sits 0.14-0.42 from an fp32 evaluation of the same
  bf16 weights on these reduced configs (the port's 0.14-0.18), and the
  two differ by 0.11-0.37 over five seeds, so the transformer's 0.1 does
  not hold between them: the bf16 forward is held to the fp32 evaluation,
  no further than twice the reference's distance plus 0.02, the loss to
  1e-2; the port's own decode == forward at the reference's TOL 0.06;
* greedy tokens equal to the reference's in fp32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _family_parity import (JGENERATE, JLOSS, check_gradients,
                            check_init_layout, check_launchers,
                            check_roundtrip, check_two_adamw_steps, configs,
                            maxdiff, params, to_np, to_torch)
from repro.models import mamba2 as JM2
from repro.models import model as JM
from repro.models import zamba2 as JZ
from repro_torch import tree
from repro_torch.configs import get_arch
from repro_torch.models import mamba2 as M2
from repro_torch.models import model as M
from repro_torch.models import zamba2 as Z
from repro_torch.serve import serve_step

ARCH = "zamba2_7b"
TOL = 0.06
# the reference's entry points, each compiled once per shape
JFORWARD = jax.jit(JZ.forward, static_argnums=(1,),
                   static_argnames=("ssm_chunk", "attn_chunk"))
JPREFILL = jax.jit(JZ.prefill, static_argnums=(1,),
                   static_argnames=("max_len", "ssm_chunk", "attn_chunk"))
JDECODE = jax.jit(JZ.decode_step, static_argnums=(1,),
                  static_argnames=("attn_chunk",))
JBLOCK = jax.jit(JM2.block, static_argnums=(2,), static_argnames=("chunk",))


def _tokens(cfg, b=2, t=24, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, t)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, size=(b, t)).astype(np.int32)
    return toks, labels


def _check_cache(cache, jcache, rtol):
    """Every leaf's path, shape and dtype; `pos` and `idx` exactly, the
    rest to `rtol` of its scale."""
    items, jitems = tree.items(cache), tree.items(jcache)
    assert [p for p, _ in items] == [p for p, _ in jitems]
    for (path, a), (_, b) in zip(items, jitems):
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(a.dtype).split(".")[1] == str(b.dtype), path
        if path[-1] in ("pos", "idx"):
            assert np.array_equal(a.numpy(), np.asarray(b)), path
        else:
            scale = float(np.abs(to_np(b)).max()) + 1e-6
            assert maxdiff(a, b) <= rtol * scale, path


# -------------------------------------------------------------------- mamba2
@pytest.mark.parametrize("chunk", [1, 3, 4, 16])
def test_ssd_chunked_matches_reference(chunk):
    """The SSD scan from a nonzero state, chunks that divide T and not."""
    rng = np.random.default_rng(chunk)
    b, t, h, p, n = 2, 11, 3, 8, 5
    x = rng.standard_normal((b, t, h, p)).astype(np.float32)
    bt, ct = (rng.standard_normal((b, t, n)).astype(np.float32)
              for _ in range(2))
    dt = rng.standard_normal((b, t, h)).astype(np.float32)
    lp = {"dt_bias": rng.standard_normal(h).astype(np.float32),
          "A_log": rng.standard_normal(h).astype(np.float32)}
    s0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    want, wstate = JM2.ssd_chunked(
        *(jnp.asarray(a) for a in (x, bt, ct, dt)),
        {k: jnp.asarray(v) for k, v in lp.items()}, jnp.asarray(s0), chunk)
    got, state = M2.ssd_chunked(*(to_torch(a) for a in (x, bt, ct, dt)),
                                {k: to_torch(v) for k, v in lp.items()},
                                to_torch(s0), chunk)
    assert maxdiff(got, want) <= 1e-5 * float(np.abs(to_np(want)).max())
    assert maxdiff(state, wstate) <= 1e-5 * float(np.abs(to_np(wstate)).max())


def test_ssd_gradient_finite_where_the_reference_is_not():
    """A chunk whose summed decay passes 88 (softplus(8) a step over 16
    steps): the j > i pair exponents overflow. The reference masks after
    the exp, and its gradient with respect to dt is not finite (exp's
    backward gives 0 x inf); the port masks the exponents first: the same
    output (1e-5 of its scale), and a gradient equal to the same code's
    in float64 to 1e-5 of its scale."""
    rng = np.random.default_rng(5)
    b, t, h, p, n = 1, 16, 2, 4, 3
    x = rng.standard_normal((b, t, h, p))
    bt, ct = (rng.standard_normal((b, t, n)) for _ in range(2))
    dt = np.full((b, t, h), 8.0) + rng.uniform(-1, 1, (b, t, h))
    lp = {"dt_bias": np.zeros(h), "A_log": np.zeros(h)}
    s0 = np.zeros((b, h, p, n))

    def jloss(dtv):
        y, s = JM2.ssd_chunked(*(jnp.asarray(a, jnp.float32)
                                 for a in (x, bt, ct)), dtv,
                               {k: jnp.asarray(v, jnp.float32)
                                for k, v in lp.items()},
                               jnp.asarray(s0, jnp.float32), 16)
        return (y ** 2).sum() + (s ** 2).sum()

    jgrad = jax.grad(jloss)(jnp.asarray(dt, jnp.float32))
    assert not np.isfinite(np.asarray(jgrad)).all()

    def grad(dtype):
        dtv = to_torch(dt).to(dtype).requires_grad_()
        y, s = M2.ssd_chunked(*(to_torch(a).to(dtype) for a in (x, bt, ct)),
                              dtv, {k: to_torch(v).to(dtype)
                                    for k, v in lp.items()},
                              to_torch(s0).to(dtype), 16)
        ((y ** 2).sum() + (s ** 2).sum()).backward()
        return y, dtv.grad

    y32, g32 = grad(torch.float32)
    _, g64 = grad(torch.float64)
    assert torch.isfinite(g32).all()
    assert maxdiff(g32, g64) <= 1e-5 * float(g64.abs().max())
    want, _ = JM2.ssd_chunked(*(jnp.asarray(a, jnp.float32)
                                for a in (x, bt, ct, dt)),
                              {k: jnp.asarray(v, jnp.float32)
                               for k, v in lp.items()},
                              jnp.asarray(s0, jnp.float32), 16)
    assert maxdiff(y32, want) <= 1e-5 * float(np.abs(to_np(want)).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_rolling_state(dtype):
    """`_conv` against the reference, and over a sequence in one call equal
    to the same sequence in pieces of 1, 2 and 4 with the state carried."""
    rng = np.random.default_rng(3)
    c = 6
    xbc = rng.standard_normal((2, 9, c)).astype(np.float32)
    w = rng.standard_normal((M2.CONV_K, c)).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    s0 = rng.standard_normal((2, M2.CONV_K - 1, c)).astype(np.float32)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tx, tw, tb, ts = (to_torch(a).to(tdt) for a in (xbc, w, bias, s0))
    out, state = M2._conv(tx, tw, tb, ts)
    jout, jstate = JM2._conv(*(jnp.asarray(a, jdt) for a in (xbc, w, bias,
                                                             s0)))
    scale = float(np.abs(to_np(jout)).max())
    tol = 1e-6 * scale if dtype == "float32" else 2 * 2.0 ** -7 * scale
    assert maxdiff(out, jout) <= tol
    assert maxdiff(state, jstate) == 0.0
    pieces, st = [], ts
    for lo, hi in ((0, 1), (1, 3), (3, 7), (7, 8), (8, 9)):
        o, st = M2._conv(tx[:, lo:hi], tw, tb, st)
        pieces.append(o)
    assert maxdiff(torch.cat(pieces, 1), out) <= tol
    assert torch.equal(st, state)


def test_mamba_block_matches_reference():
    cfg, jcfg = configs(ARCH, "float32")
    port, jparams = params(jcfg)
    lp, jlp = (tree.unstack(port["layers"])[1],
               jax.tree.map(lambda a: a[1], jparams["layers"]))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    jst = jax.tree.map(lambda a: a[0], JM2.init_state(jcfg, 2, 1,
                                                      dtype=jnp.float32))
    st = tree.unstack(M2.init_state(cfg, 2, 1, dtype=torch.float32,
                                    device="cpu"))[0]
    st["ssm"] += 0.1                      # a carried state
    jst["ssm"] = jst["ssm"] + 0.1
    want, wst = JBLOCK(jlp, jnp.asarray(x), jcfg, jst, chunk=4)
    got, gst = M2.block(lp, to_torch(x), cfg, st, chunk=4)
    assert maxdiff(got, want) <= 1e-5 * float(np.abs(to_np(want)).max())
    for key in ("ssm", "conv"):
        assert maxdiff(gst[key], wst[key]) <= 1e-5 * float(
            np.abs(to_np(wst[key])).max()), key


# -------------------------------------------------------------------- zamba2
def test_init_and_logical_trees_match_reference():
    """The init's paths, shapes and dtypes (the per-point adapters, fp32
    `A_log` / `dt_bias` / `D` among bf16 leaves) and the logical trees."""
    got = check_init_layout(ARCH)
    cfg, jcfg = configs(ARCH)
    assert Z.num_shared_points(cfg) == 2
    assert got["layers"]["D"].dtype == torch.float32
    assert float(got["layers"]["D"].min()) == 1.0
    assert M.cache_logical(cfg) == JM.cache_logical(jcfg)


def test_full_depth_has_13_points_and_a_tail():
    cfg = get_arch(ARCH)
    assert (cfg.num_layers, Z.num_shared_points(cfg)) == (81, 13)
    assert cfg.num_layers - 13 * cfg.shared_attn_every == 3


@pytest.mark.parametrize("dtype", ["float32", None])
def test_forward_and_loss_match_reference(dtype):
    cfg, jcfg = configs(ARCH, dtype)
    port, jparams = params(jcfg)
    toks, labels = _tokens(cfg)
    want, _ = JFORWARD(jparams, jcfg, jnp.asarray(toks), attn_chunk=8)
    got, aux = Z.forward(port, cfg, to_torch(toks), attn_chunk=8)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    batch = {"tokens": toks, "labels": labels}
    jloss = JLOSS(jparams, jcfg, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, chunk=8)
    loss = M.train_loss(port, cfg, {k: to_torch(v) for k, v in
                                    batch.items()}, chunk=8)
    if dtype == "float32":
        assert maxdiff(got, want) < 1e-2
        assert abs(float(loss) - float(jloss)) < 5e-4
        # a layer count that is not a multiple of the cadence: the tail
        cfg5, jcfg5 = (dataclasses.replace(c, num_layers=5) for c in
                       (cfg, jcfg))
        assert Z.num_shared_points(cfg5) * cfg5.shared_attn_every == 4
        port5, jparams5 = params(jcfg5)
        want, _ = JFORWARD(jparams5, jcfg5, jnp.asarray(toks), attn_chunk=8)
        got, _ = Z.forward(port5, cfg5, to_torch(toks), attn_chunk=8)
        assert maxdiff(got, want) < 1e-2
        return
    cfg32, jcfg32 = configs(ARCH, "float32")
    truth, _ = JFORWARD(jax.tree.map(lambda x: x.astype(jnp.float32),
                                     jparams), jcfg32, jnp.asarray(toks),
                        attn_chunk=8)
    assert maxdiff(got, truth) <= 2 * maxdiff(want, truth) + 0.02
    assert maxdiff(got, want) <= 2 * maxdiff(want, truth) + 0.02
    assert abs(float(loss) - float(jloss)) < 1e-2


def _run_both(cfg, jcfg, port, jparams, toks, prompt, max_len, steps):
    """Prefill `prompt` tokens, then decode `steps` more on both sides,
    checking logits and every cache leaf after each call."""
    jl, jc = JPREFILL(jparams, jcfg, jnp.asarray(toks[:, :prompt]),
                      max_len=max_len, ssm_chunk=4, attn_chunk=8)
    lg, c = Z.prefill(port, cfg, to_torch(toks[:, :prompt]), max_len=max_len,
                      ssm_chunk=4, attn_chunk=8)
    assert lg.dtype == torch.float32
    assert maxdiff(lg, jl) < 1e-2
    _check_cache(c, jc, 1e-3)
    for i in range(prompt, prompt + steps):
        jl, jc = JDECODE(jparams, jcfg, jnp.asarray(toks[:, i]), jc,
                         attn_chunk=8)
        lg, c = Z.decode_step(port, cfg, to_torch(toks[:, i]), c,
                              attn_chunk=8)
        assert maxdiff(lg, jl) < 1e-2, i
        _check_cache(c, jc, 1e-3)
    return c


def test_prefill_decode_and_clamp_match_reference():
    """Logits and every cache leaf (mamba states, k, v, pos, idx) in fp32
    after a prefill of 9 tokens into a cache of 10 and each of 3 decode
    steps, the last two at idx >= max_len: k, v and pos go to the last
    slot, as the reference's `dynamic_update_slice` clamps its start."""
    cfg, jcfg = configs(ARCH, "float32")
    port, jparams = params(jcfg)
    toks, _ = _tokens(cfg, t=12)
    cache = _run_both(cfg, jcfg, port, jparams, toks, prompt=9, max_len=10,
                      steps=3)
    assert cache["pos"][0].tolist() == list(range(9)) + [11]
    assert int(cache["idx"]) == 12 and cache["idx"].device.type == "cpu"
    check_roundtrip(cache)


def test_decode_matches_forward():
    """`tests/test_serve_equiv.py`'s invariant on the port, stock bf16:
    prefill 8 tokens, decode 4, each step's logits against the forward."""
    cfg, jcfg = configs(ARCH)
    port, _ = params(jcfg)
    toks, _ = _tokens(cfg, t=12)
    full, _ = Z.forward(port, cfg, to_torch(toks), ssm_chunk=4, attn_chunk=8)
    _, cache = Z.prefill(port, cfg, to_torch(toks[:, :8]), max_len=14,
                         ssm_chunk=4, attn_chunk=8)
    for i in range(8, 12):
        lg, cache = Z.decode_step(port, cfg, to_torch(toks[:, i]), cache,
                                  attn_chunk=8)
        assert maxdiff(lg, full[:, i]) < TOL, i
    check_roundtrip(cache)


def test_serve_api_and_int8_raises():
    cfg, jcfg = configs(ARCH)
    cache = M.init_cache(cfg, 3, 7, device="cpu")
    jcache = JM.init_cache(jcfg, 3, 7)
    _check_cache(cache, jcache, 0.0)
    with pytest.raises(ValueError, match="zamba2 family has no 'int8'"):
        M.init_cache(cfg, 1, 4, kv_dtype="int8", device="cpu")
    with pytest.raises(ValueError, match="zamba2 family"):
        M.cache_logical(cfg, kv_dtype="int8")
    port, _ = params(jcfg)
    toks, _ = _tokens(cfg, t=6)
    _, c = Z.prefill(port, cfg, to_torch(toks[:, :5]), max_len=6, attn_chunk=8)
    lg, _ = M.decode_step(port, cfg, to_torch(toks[:, 5]), c, chunk=8)
    full, _ = Z.forward(port, cfg, to_torch(toks), attn_chunk=8)
    assert maxdiff(lg, full[:, 5]) < TOL
    assert not lg.requires_grad


def test_gradients_match_reference():
    cfg, jcfg = configs(ARCH, "float32")
    port, jparams = params(jcfg)
    toks, labels = _tokens(cfg, t=16)
    check_gradients(cfg, jcfg, port, jparams,
                    {"tokens": toks, "labels": labels}, lambda path: 1e-2)


def test_two_adamw_steps_match_reference():
    """The loss at this file's fp32 bar (5e-4); params to a tenth of lr
    (5e-4) where the reference's moment is at least a tenth of its leaf's
    largest: with gradients held to 1 % of the leaf's scale, those
    params' update directions agree to a tenth (9.3e-5 seen). 408 params
    (0.2 %), their gradients near the noise of the bf16 roundings inside
    the model, passed 1e-4 after step 2, up to 4.3e-3."""
    check_two_adamw_steps(ARCH, loss_tol=5e-4, param_tol=5e-4)


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
