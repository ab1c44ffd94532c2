"""The port's whisper family (encoder, cross K/V, cached decoder), held
against repro on the CPU.

Inputs come from numpy seeds; params and serve states are the
reference's, converted with `convert.state_from_reference`. Tolerances:

* `sinusoid` at the published width (448 x 1024): 3e-4, a few fp32 ulps
  of angles up to 447 rad (`pow` and `sin` of two libraries);
* the encoder and the cross K/V from one memory in fp32: 1e-5 of their
  scale;
* `dtype="float32"` models: the encoder's, the decoder's and the cross
  attention round q, k, v and the probabilities to bf16 on both sides;
  fp32 differences of 1e-6 in the encoder's memory flip some of the
  cross attention's roundings (2^-8 of an operand each), as the MoE
  combine weights do in `tests/test_torch_models.py`: logits to 1e-2
  and the loss to 5e-4, its MoE bars (6e-4 to 6.5e-3 on logits and up
  to 2.2e-4 on the loss measured over five seeds), serve-state leaves to
  1e-3 of their scale, gradients to 1 % of each leaf's scale, except the
  attention's q and k projections: their gradients come only through the
  scores' backward, which the reference's flash VJP rounds to bf16 and
  the port's autograd does not, and sums of those rounded terms cancel
  (2.3 % of the scale measured on the decoder's `wq`): 5 % there;
* stock bf16 models: the transformer's 0.1 on logits and 5e-3 on the
  loss (0.022-0.032 and up to 1.9e-3 measured over five seeds), and
  `tests/test_torch_serve.py`'s 2 + L bf16 ulps of the largest entry on
  the self cache's and the cross K / V for L decoder layers; the port's
  own incremental decode == teacher-forced forward at the reference's
  TOL 0.06 (`tests/test_serve_equiv.py`);
* greedy tokens equal to the reference's in fp32 and bf16.
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
from repro.models import whisper as JW
from repro.serve import serve_step as jserve_step
from repro_torch import tree
from repro_torch.configs import get_arch
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.models import whisper as W
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import SyntheticStream
from repro_torch.serve import serve_step

ARCH = "whisper_medium"
TOL = 0.06
# the reference's entry points, each compiled once per shape
JFORWARD = jax.jit(JW.forward, static_argnums=(1,), static_argnames=("chunk",))
JENCODE = jax.jit(JW.encode, static_argnums=(1,),
                  static_argnames=("chunk", "remat"))


def _batch(cfg, b=2, t=12, frames=20, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "tokens": rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32),
        "frames": rng.standard_normal((b, frames, cfg.d_model)
                                      ).astype(np.float32)}


def _state_tol(cfg, jleaf):
    scale = float(np.abs(to_np(jleaf)).max()) + 1e-6
    if cfg.dtype == "float32":
        return 1e-3 * scale
    return (2 + cfg.num_layers) * 2.0 ** (np.floor(np.log2(scale)) - 7)


def _check_state(cfg, state, jstate):
    """Every leaf's path, shape and dtype; `pos` and `idx` exactly."""
    items, jitems = tree.items(state), tree.items(jstate)
    assert [p for p, _ in items] == [p for p, _ in jitems]
    for (path, a), (_, b) in zip(items, jitems):
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(a.dtype).split(".")[1] == str(b.dtype), path
        if path[-1] in ("pos", "idx"):
            assert np.array_equal(a.numpy(), np.asarray(b)), path
        else:
            assert maxdiff(a, b) <= _state_tol(cfg, b), path


def test_init_and_logical_trees_match_reference():
    check_init_layout(ARCH)


def test_sinusoid_matches_reference():
    got, want = W.sinusoid(448, 1024), JW.sinusoid(448, 1024)
    assert tuple(got.shape) == (448, 1024) and got.dtype == torch.float32
    assert maxdiff(got, want) < 3e-4
    assert maxdiff(W.sinusoid(16, 64), JW.sinusoid(16, 64)) < 1e-6


def test_encode_and_cross_kv_match_reference():
    cfg, jcfg = configs(ARCH, "float32")
    port, jparams = params(jcfg)
    frames = _batch(cfg)["frames"]
    want = JENCODE(jparams, jcfg, jnp.asarray(frames), chunk=8)
    got = W.encode(port, cfg, to_torch(frames), chunk=8)
    assert maxdiff(got, want) <= 1e-5 * float(np.abs(to_np(want)).max())
    mem = np.asarray(want)
    jk, jv = JW.cross_kv(jparams, jcfg, jnp.asarray(mem))
    k, v = W.cross_kv(port, cfg, to_torch(mem))
    assert tuple(k.shape) == (cfg.num_layers, 2, 20, cfg.num_kv_heads, cfg.hd)
    assert maxdiff(k, jk) <= 1e-5 * float(np.abs(to_np(jk)).max())
    assert maxdiff(v, jv) <= 1e-5 * float(np.abs(to_np(jv)).max())


@pytest.mark.parametrize("dtype", ["float32", None])
def test_forward_and_loss_match_reference(dtype):
    cfg, jcfg = configs(ARCH, dtype)
    port, jparams = params(jcfg)
    batch = _batch(cfg)
    want, _ = JFORWARD(jparams, jcfg, jnp.asarray(batch["frames"]),
                       jnp.asarray(batch["tokens"]), chunk=8)
    got, aux = W.forward(port, cfg, to_torch(batch["frames"]),
                         to_torch(batch["tokens"]), chunk=8)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    jloss = JLOSS(jparams, jcfg, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, chunk=8)
    loss = M.train_loss(port, cfg, {k: to_torch(v) for k, v in batch.items()},
                        chunk=8)
    tol_logits, tol_loss = (1e-2, 5e-4) if dtype else (0.1, 5e-3)
    assert maxdiff(got, want) < tol_logits
    assert abs(float(loss) - float(jloss)) < tol_loss


def _serve_both(cfg, jcfg, port, jparams, batch, prompt, steps):
    """Prefill (encode, cross K/V, the prompt into the self cache) and
    `steps` decode steps through both packages' serve steps, each
    stage's logits and every serve-state leaf checked."""
    tol = 1e-2 if cfg.dtype == "float32" else 0.1
    jb = {"frames": jnp.asarray(batch["frames"]),
          "tokens": jnp.asarray(batch["tokens"][:, :prompt])}
    jl, js = jax.jit(jserve_step.make_prefill(jcfg, chunk=8))(jparams, jb)
    lg, s = serve_step.make_prefill(cfg, chunk=8)(
        port, {k: to_torch(v) for k, v in jb.items()})
    assert lg.dtype == torch.float32 and not lg.requires_grad
    assert maxdiff(lg, jl) < tol
    _check_state(cfg, s, js)
    jstep = jax.jit(jserve_step.make_whisper_decode_step(jcfg, chunk=8))
    step = serve_step.make_whisper_decode_step(cfg, chunk=8)
    for i in range(prompt, prompt + steps):
        jl, js = jstep(jparams, jnp.asarray(batch["tokens"][:, i]), js)
        lg, s = step(port, to_torch(batch["tokens"][:, i]), s)
        assert maxdiff(lg, jl) < tol, i
        _check_state(cfg, s, js)
    return s


@pytest.mark.parametrize("dtype", ["float32", None])
def test_prefill_and_decode_match_reference(dtype):
    cfg, jcfg = configs(ARCH, dtype)
    port, jparams = params(jcfg)
    state = _serve_both(cfg, jcfg, port, jparams, _batch(cfg), prompt=8,
                        steps=3)
    assert int(state["self"]["idx"]) == 11
    check_roundtrip(state)


def test_decode_past_max_decoder_len_clamps_like_reference():
    """The reduced decoder holds 16 positions: decodes at idx 16 and 17
    write the self cache's last slot and read position row 15, as the
    reference's `dynamic_update_slice` and `clip` do."""
    cfg, jcfg = configs(ARCH, "float32")
    port, jparams = params(jcfg)
    batch = _batch(cfg, t=18)
    state = _serve_both(cfg, jcfg, port, jparams, batch, prompt=12,
                        steps=6)
    assert state["self"]["pos"][0].tolist() == list(range(15)) + [17]


def test_incremental_decode_matches_forward():
    """`tests/test_serve_equiv.py::test_whisper_incremental_decode` on the
    port: the whole prompt decoded token by token from an empty self
    cache, against the teacher-forced forward."""
    cfg, jcfg = configs(ARCH)
    port, _ = params(jcfg)
    batch = _batch(cfg, t=8, frames=16)
    frames, toks = to_torch(batch["frames"]), to_torch(batch["tokens"])
    logits, _ = W.forward(port, cfg, frames, toks, chunk=8)
    with torch.inference_mode():
        memory = W.encode(port, cfg, frames, chunk=8, remat=False)
        xk, xv = W.cross_kv(port, cfg, memory)
        cache = W.init_self_cache(cfg, 2, 12, device="cpu")
        for i in range(8):
            lg, cache = W.decode(port, cfg, toks[:, i:i + 1], xk=xk, xv=xv,
                                 self_cache=cache, chunk=8, remat=False)
            assert maxdiff(lg[:, 0], logits[:, i]) < TOL, i


def test_serve_api_raises():
    cfg, jcfg = configs(ARCH)
    with pytest.raises(ValueError, match="built by serve.prefill"):
        M.init_cache(cfg, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="built by serve.prefill"):
        M.cache_logical(cfg)
    with pytest.raises(ValueError, match="make_whisper_decode_step"):
        M.decode_step({}, cfg, torch.zeros(2, dtype=torch.int32), {})
    port, _ = params(jcfg)
    batch = _batch(cfg, t=17)
    with pytest.raises(ValueError, match="do not fit"):
        serve_step.make_prefill(cfg, chunk=8)(
            port, {k: to_torch(batch[k]) for k in ("frames", "tokens")})


def test_gradients_match_reference():
    cfg, jcfg = configs(ARCH, "float32")
    port, jparams = params(jcfg)
    check_gradients(cfg, jcfg, port, jparams, _batch(cfg),
                    lambda path: 5e-2 if path[-1] in ("wq", "wk") else 1e-2)


def test_two_adamw_steps_match_reference():
    """The loss at this file's fp32 bar (5e-4), params to a
    tenth of lr (5e-4; 1.3e-4 seen) where the reference's moment is at
    least a tenth of its leaf's largest."""
    cfg, _ = configs(ARCH, "float32")
    frames = SyntheticStream(cfg, ShapeConfig("t", "train", 16, 4)
                             ).batch_at(0)["frames"]
    assert frames.shape == (4, 16, cfg.d_model)
    check_two_adamw_steps(ARCH, loss_tol=5e-4, param_tol=5e-4)


@pytest.mark.parametrize("dtype", ["float32", None])
def test_generate_greedy_matches_reference(dtype):
    cfg, jcfg = configs(ARCH, dtype)
    port, jparams = params(jcfg)
    batch = _batch(cfg, t=8, frames=8)
    batch = {k: batch[k] for k in ("tokens", "frames")}
    want = JGENERATE(jparams, jcfg, {k: jnp.asarray(v) for k, v in
                                     batch.items()}, steps=6, chunk=8)
    got = serve_step.generate(port, cfg, batch, steps=6, chunk=8,
                              device="cpu")
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_launchers_print_the_reference_lines(monkeypatch, capsys, tmp_path):
    """The serve launcher with frames (B, prompt_len, d) and the train
    launcher on the stream's frames."""
    cfg = get_arch(ARCH).reduced()
    frames = serve.prompts(cfg, 2, 8, 0)["frames"]
    assert frames.shape == (2, 8, cfg.d_model) and frames.dtype == np.float32
    check_launchers(ARCH, ["--batch", "2", "--prompt-len", "8",
                           "--gen-tokens", "4"], monkeypatch, capsys,
                    tmp_path)
