"""The port's AdamW, gradient compressor and train step, held against
repro on the CPU, and `tests/test_train.py`'s matrix run on the port.

Tolerances: one AdamW step from the same (p, g, m, v) agrees to 1 bf16
ulp on bf16 params (the fp32 update is rounded once; XLA and torch may
differ in the last fp32 bit of `b ** t` or `sqrt` before that rounding)
and to rtol 1e-6 on fp32 moments (2 ulps of fp32 on ~5 ops). When the
global clip engages, the clip factor comes from a sum over every
gradient in each library's own order and may differ in its last bit, so
the moments then agree to 1e-6 of their largest magnitude. A whole
train step of the float32 smollm variant agrees to 5e-5 on the loss (the
bound of `unembed`'s bf16 rounding, `tests/test_torch_models.py`) and
1e-4 on params, and the bf16 stock config to 5e-3 on the loss and 1 bf16
ulp (plus 1e-6) on params: each param moves by about lr from where both
sides start, so gradient differences in the attention's bf16 rounding
(`tests/test_torch_models.py`) reach a param only through Adam's
normalised update.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import convert, tree
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import SyntheticStream
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import (TrainConfig, init_state,
                                          make_train_step)

CFG = get_arch("smollm_360m").reduced()
SHAPE = ShapeConfig("t", "train", 32, 8)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (at least that of 2^-126)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


SHAPES = {"a": (8, 16), "b": {"c": (33,), "d": (2, 3, 4)}}


def _draw(rng, shapes, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _draw(rng, v, scale) for k, v in shapes.items()}
    return (rng.standard_normal(shapes) * scale).astype(np.float32)


def _to(tree_np, dtype_j, dtype_t):
    return (jax.tree.map(lambda a: jnp.asarray(a, dtype_j), tree_np),
            tree.map(lambda a: torch.from_numpy(a).to(dtype_t), tree_np))


@pytest.mark.parametrize("opt_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", [0, 7, 150])
@pytest.mark.parametrize("clipped", [True, False])
def test_adamw_step_matches_reference(opt_dtype, step, clipped):
    rng = np.random.default_rng(step)
    cfg = opt.AdamWConfig(peak_lr=1e-2, warmup_steps=10, decay_steps=100)
    jcfg = jopt.AdamWConfig(peak_lr=1e-2, warmup_steps=10, decay_steps=100)
    jp, p = _to(_draw(rng, SHAPES), jnp.bfloat16, torch.bfloat16)
    # gradients of global norm ~40 engage the clip, of ~0.1 do not
    jg, g = _to(_draw(rng, SHAPES, 3.0 if clipped else 0.01), jnp.bfloat16,
                torch.bfloat16)
    od_j, od_t = ((jnp.float32, torch.float32) if opt_dtype == "float32"
                  else (jnp.bfloat16, torch.bfloat16))
    jm, m = _to(_draw(rng, SHAPES, 0.1), od_j, od_t)
    jv, v = _to(jax.tree.map(np.abs, _draw(rng, SHAPES, 0.1)), od_j, od_t)
    want = jopt.adamw_update(jcfg, jp, jg, {"m": jm, "v": jv},
                             jnp.asarray(step, jnp.int32))
    got = opt.adamw_update(cfg, p, g, {"m": m, "v": v},
                           torch.tensor(step, dtype=torch.int32))
    for name in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(got[2][name]), float(want[2][name]),
                                   rtol=1e-6)
    assert (float(got[2]["grad_norm"]) > 1.0) == clipped
    for a, b in zip(tree.leaves(got[0]), jax.tree.leaves(want[0])):
        assert a.dtype == torch.bfloat16
        b = _np(b)
        assert (np.abs(_np(a) - b) <= _bf16_ulp(b)).all()
    for name in ("m", "v"):
        for a, b in zip(tree.leaves(got[1][name]),
                        jax.tree.leaves(want[1][name])):
            assert a.dtype == od_t
            b = _np(b)
            if opt_dtype == "float32":
                atol = 1e-6 * np.abs(b).max() if clipped else 1e-12
                np.testing.assert_allclose(_np(a), b, rtol=1e-6, atol=atol)
            else:
                assert (np.abs(_np(a) - b) <= _bf16_ulp(b)).all()
    # inputs untouched: the update is functional
    assert np.array_equal(_np(p["a"]), _np(jp["a"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm_keyword_call_matches_reference(dtype):
    """`global_norm(tree=...)`: the reference's parameter name."""
    dt_j, dt_t = ((jnp.float32, torch.float32) if dtype == "float32"
                  else (jnp.bfloat16, torch.bfloat16))
    jg, g = _to(_draw(np.random.default_rng(3), SHAPES), dt_j, dt_t)
    got = opt.global_norm(tree=g)
    want = jopt.global_norm(tree=jg)
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_lr_schedule_matches_reference():
    cfg = opt.AdamWConfig(peak_lr=1e-3, warmup_steps=10, decay_steps=100)
    jcfg = jopt.AdamWConfig(peak_lr=1e-3, warmup_steps=10, decay_steps=100)
    for s in (0, 1, 9, 10, 11, 55, 99, 100, 1000):
        got = float(opt.lr_at(cfg, torch.tensor(s)))
        want = float(jopt.lr_at(jcfg, jnp.asarray(s)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    # tests/test_train.py's schedule checks
    assert float(opt.lr_at(cfg, torch.tensor(0))) == 0.0
    assert abs(float(opt.lr_at(cfg, torch.tensor(10))) - 1e-3) < 1e-9
    assert float(opt.lr_at(cfg, torch.tensor(100))) < 2e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_grads_matches_reference(dtype):
    rng = np.random.default_rng(3)
    dj, dt = ((jnp.float32, torch.float32) if dtype == "float32"
              else (jnp.bfloat16, torch.bfloat16))
    jg, g = _to(_draw(rng, SHAPES), dj, dt)
    je, e = _to(_draw(rng, SHAPES, 0.01), jnp.float32, torch.float32)
    want_g, want_e = jopt.compress_grads(jg, je)
    got_g, got_e = opt.compress_grads(g, e)
    for a, b in zip(tree.leaves(got_g), jax.tree.leaves(want_g)):
        assert a.dtype == dt
        b = _np(b)
        tol = 1e-6 * np.abs(b).max() if dtype == "float32" else _bf16_ulp(b)
        assert (np.abs(_np(a) - b) <= tol).all()
    for a, b in zip(tree.leaves(got_e), jax.tree.leaves(want_e)):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-6)


def test_error_feedback_identity():
    """tests/test_train.py's EF checks, on the port."""
    g = {"w": torch.from_numpy(np.linspace(-1, 1, 64).astype(np.float32))}
    gq, ef2 = opt.compress_grads(g, opt.init_ef_state(g))
    recon = gq["w"].float() + ef2["w"]
    assert float((recon - g["w"]).abs().max()) < 1e-6       # exact identity
    scale = float(g["w"].abs().max()) / 127.0
    assert float((gq["w"] - g["w"]).abs().max()) <= scale + 1e-7


def _states(tcfg, jtcfg, dtype=None):
    cfg, jcfg = CFG, jget_arch("smollm_360m").reduced()
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
    jstate = jts.init_state(jax.random.PRNGKey(0), jcfg, jtcfg)
    state = convert.state_from_reference(jax.tree.map(np.asarray, jstate),
                                         "cpu")
    return cfg, jcfg, state, jstate


@pytest.mark.parametrize("variant", ["float32", "bf16", "bf16_mb2_compress",
                                     "bf16_opt_bf16"])
def test_train_step_matches_reference(variant):
    kw = {}
    if variant == "bf16_mb2_compress":
        kw = dict(microbatches=2, compress_grads=True)
    if variant == "bf16_opt_bf16":
        kw = dict(opt_dtype="bfloat16")
    tcfg = TrainConfig(adamw=opt.AdamWConfig(peak_lr=5e-3, warmup_steps=1),
                       attn_chunk=16, **kw)
    jtcfg = jts.TrainConfig(adamw=jopt.AdamWConfig(peak_lr=5e-3,
                                                   warmup_steps=1),
                            attn_chunk=16, **kw)
    cfg, jcfg, state, jstate = _states(
        tcfg, jtcfg, "float32" if variant == "float32" else None)
    batch = SyntheticStream(cfg, SHAPE).batch_at(1)
    new, m = make_train_step(cfg, tcfg)(state, batch)
    jnew, jm = jts.make_train_step(jcfg, jtcfg)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    loss_tol = 5e-5 if variant == "float32" else 5e-3
    assert abs(float(m["loss"]) - float(jm["loss"])) < loss_tol
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-3 if variant == "float32" else 2e-2)
    assert int(new["step"]) == 1 and new["step"].dtype == torch.int32
    assert set(new) == set(jnew)
    for (path, a), b in zip(tree.items(new["params"]),
                            jax.tree.leaves(jnew["params"])):
        b = _np(b)
        tol = 1e-4 if variant == "float32" else _bf16_ulp(b) + 1e-6
        assert (np.abs(_np(a) - b) <= tol).all(), path
    for a, b in zip(tree.leaves(new["opt"]), jax.tree.leaves(jnew["opt"])):
        assert str(a.dtype).split(".")[1] == str(b.dtype)


def test_step_leaves_its_input_state_valid():
    tcfg = TrainConfig(adamw=opt.AdamWConfig(peak_lr=5e-3, warmup_steps=0),
                       attn_chunk=16, compress_grads=True)
    state = init_state(0, CFG, tcfg, device="cpu")
    before = [x.clone() for x in tree.leaves(state)]
    step = make_train_step(CFG, tcfg)
    batch = SyntheticStream(CFG, SHAPE).batch_at(0)
    a, ma = step(state, batch)
    b, mb = step(state, batch)
    assert all(torch.equal(x, y) for x, y in zip(before, tree.leaves(state)))
    assert float(ma["loss"]) == float(mb["loss"])
    assert all(torch.equal(x, y) for x, y in zip(tree.leaves(a),
                                                 tree.leaves(b)))
    assert not torch.equal(a["params"]["embed"]["table"],
                           state["params"]["embed"]["table"])


def _run(tcfg, steps=25, seed=0):
    state = init_state(seed, CFG, tcfg, device="cpu")
    step = make_train_step(CFG, tcfg)
    stream = SyntheticStream(CFG, SHAPE)
    losses = []
    for i in range(steps):
        state, m = step(state, stream.batch_at(i))
        losses.append(float(m["loss"]))
    return losses, state


def test_loss_decreases():
    tcfg = TrainConfig(adamw=opt.AdamWConfig(peak_lr=1e-2, warmup_steps=5),
                       attn_chunk=16)
    losses, _ = _run(tcfg, steps=30)
    assert losses[-1] < losses[0] - 0.3


def test_microbatch_equivalence():
    t1 = TrainConfig(adamw=opt.AdamWConfig(peak_lr=5e-3, warmup_steps=5),
                     microbatches=1, attn_chunk=16)
    t2 = dataclasses.replace(t1, microbatches=2)
    l1, s1 = _run(t1, steps=8)
    l2, s2 = _run(t2, steps=8)
    assert abs(l1[-1] - l2[-1]) < 0.05
    for a, b in zip(tree.leaves(s1["params"]), tree.leaves(s2["params"])):
        assert float((a.float() - b.float()).abs().max()) < 0.05


def test_compressed_grads_still_learn():
    tcfg = TrainConfig(adamw=opt.AdamWConfig(peak_lr=1e-2, warmup_steps=5),
                       attn_chunk=16, compress_grads=True)
    losses, state = _run(tcfg, steps=30)
    assert losses[-1] < losses[0] - 0.25
    assert state["ef"]["embed"]["table"].dtype == torch.float32


def test_grad_clipping_bounds_update():
    tcfg = TrainConfig(adamw=opt.AdamWConfig(peak_lr=1e-2, warmup_steps=1,
                                             grad_clip=0.1), attn_chunk=16)
    _, state = _run(tcfg, steps=3)
    assert int(state["step"]) == 3


def test_init_state_layout_matches_reference():
    for od in ("float32", "bfloat16"):
        tcfg = TrainConfig(opt_dtype=od, compress_grads=True)
        jtcfg = jts.TrainConfig(opt_dtype=od, compress_grads=True)
        state = init_state(torch.Generator().manual_seed(0), CFG, tcfg,
                           device="cpu")
        jstate = jts.init_state(jax.random.PRNGKey(0),
                                jget_arch("smollm_360m").reduced(), jtcfg)
        got = [(p, tuple(x.shape), str(x.dtype).split(".")[1])
               for p, x in tree.items(state)]
        want = [(tuple(k.key for k in path), tuple(x.shape), str(x.dtype))
                for path, x in jax.tree_util.tree_flatten_with_path(jstate)[0]]
        assert got == want


def test_device_none_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_state(0, CFG, TrainConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.state_from_reference({"w": np.zeros(3, np.float32)})
