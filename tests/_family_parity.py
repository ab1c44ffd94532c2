"""Helpers shared by the parity tests of the port's rwkv6, mamba2/zamba2
and whisper families (`tests/test_torch_{rwkv6,zamba2,whisper}.py`):
conversions, the reference's entry points compiled once per shape, and
the checks each family runs alike (init layout and logical trees,
gradients, two AdamW steps, the launchers' printed lines)."""
import contextlib
import dataclasses
import functools
import io
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.launch.serve as jserve
import repro.launch.train as jtrain
from repro.configs import get_arch as jget_arch
from repro.models import model as JM
from repro.serve import serve_step as jserve_step
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import convert, tree
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import SyntheticStream
from repro_torch.launch import serve, train
from repro_torch.models import model as M
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import TrainConfig, make_train_step

LR = 5e-3
# the reference's entry points, each compiled once per shape (the same
# functions; eager dispatch of their scans costs several times as long)
JINIT = jax.jit(JM.init_params, static_argnums=(1,))
JLOSS = jax.jit(JM.train_loss, static_argnums=(1,), static_argnames=("chunk",))
JGRAD = jax.jit(jax.grad(JM.train_loss), static_argnums=(1,),
                static_argnames=("chunk",))
JGENERATE = jax.jit(jserve_step.generate, static_argnums=(1,),
                    static_argnames=("steps", "chunk", "temperature"))


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def maxdiff(a, b) -> float:
    return float(np.max(np.abs(to_np(a) - to_np(b))))


def to_torch(x):
    return torch.from_numpy(np.array(x))


def configs(arch: str, dtype=None):
    """The reduced (port, reference) configs, `dtype` replaced if given."""
    cfg, jcfg = get_arch(arch).reduced(), jget_arch(arch).reduced()
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
    return cfg, jcfg


@functools.lru_cache(maxsize=None)
def params(jcfg, seed=0):
    """The reference's init and the same params on the port's side, made
    once per (config, seed) in a process: no test writes to them."""
    jparams = JINIT(jax.random.PRNGKey(seed), jcfg)
    return convert.state_from_reference(jax.tree.map(np.asarray, jparams),
                                        "cpu"), jparams


def check_roundtrip(state):
    """A serve state through host numpy and back, bit for bit: fp32 leaves
    as they are, bf16 ones as their `uint16` bits, viewed as bf16 again."""
    host = convert.state_to_numpy(state)
    host = tree.map(lambda a, x: a.view(jnp.bfloat16)
                    if x.dtype == torch.bfloat16 else a, host, state)
    back = convert.state_from_reference(host, "cpu")
    for (path, a), b in zip(tree.items(back), tree.leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b), path


def check_init_layout(arch: str):
    """The port's init has the reference's paths, shapes and dtypes, and
    the params' logical trees equal the reference's; returns the init."""
    cfg, jcfg = configs(arch)
    _, jparams = params(jcfg)
    got_params = M.init_params(torch.Generator().manual_seed(0), cfg)
    got = [(p, tuple(x.shape), str(x.dtype).split(".")[1])
           for p, x in tree.items(got_params)]
    paths = [tuple(k.key for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(jparams)[0]]
    want = [(p, tuple(x.shape), str(x.dtype))
            for p, x in zip(paths, jax.tree.leaves(jparams))]
    assert got == want
    assert M.logical_params(cfg, M.NO_MESH) == JM.logical_params(
        jcfg, JM.NO_MESH)
    return got_params


def check_gradients(cfg, jcfg, port_params, jparams, batch, rtol_of):
    """Each leaf's gradient of `train_loss` (chunk 8) against the
    reference's, to `rtol_of(path)` of the leaf's largest."""
    want = JGRAD(jparams, jcfg, {k: jnp.asarray(v) for k, v in
                                 batch.items()}, chunk=8)
    leaves = [p.detach().requires_grad_() for p in tree.leaves(port_params)]
    M.train_loss(tree.unflatten(port_params, leaves), cfg,
                 {k: to_torch(v) for k, v in batch.items()},
                 chunk=8).backward()
    for leaf, w, (path, _) in zip(leaves, jax.tree.leaves(want),
                                  tree.items(port_params)):
        w = np.asarray(w)
        assert leaf.grad.shape == w.shape, path
        assert maxdiff(leaf.grad, w) <= rtol_of(path) * np.abs(w).max() \
            + 1e-7, path


def check_two_adamw_steps(arch: str, loss_tol: float, param_tol: float):
    """Two fp32 train steps (AdamW, peak lr `LR`), step for step: the loss
    to `loss_tol`, the gradient norm to 1e-3 rtol, params to `param_tol`
    where the reference's first moment is at least a tenth of its leaf's
    largest, and to 2 lr a step elsewhere (Adam divides each moment by
    its own root mean square: a param whose gradient is near its noise
    steps by up to lr in a direction that noise sets)."""
    cfg, jcfg = configs(arch, "float32")
    kw = dict(attn_chunk=16)
    tcfg = TrainConfig(adamw=opt.AdamWConfig(peak_lr=LR, warmup_steps=1),
                       **kw)
    jtcfg = jts.TrainConfig(adamw=jopt.AdamWConfig(peak_lr=LR,
                                                   warmup_steps=1), **kw)
    jstate = jts.init_state(jax.random.PRNGKey(0), jcfg, jtcfg)
    state = convert.state_from_reference(jax.tree.map(np.asarray, jstate),
                                         "cpu")
    stream = SyntheticStream(cfg, ShapeConfig("t", "train", 16, 4))
    step = make_train_step(cfg, tcfg)
    jstep = jax.jit(jts.make_train_step(jcfg, jtcfg))
    for i in range(2):
        batch = stream.batch_at(i)
        state, m = step(state, batch)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                    batch.items()})
        assert abs(float(m["loss"]) - float(jm["loss"])) < loss_tol, i
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-3)
        for (path, a), b, mom in zip(tree.items(state["params"]),
                                     jax.tree.leaves(jstate["params"]),
                                     jax.tree.leaves(jstate["opt"]["m"])):
            diff = np.abs(to_np(a) - to_np(b))
            mom = np.abs(to_np(mom))
            assert (diff[mom >= 0.1 * mom.max()] <= param_tol).all(), \
                (i, path)
            assert diff.max() <= 2 * LR * (i + 1), (i, path)
    assert int(state["step"]) == 2


def masked(text: str) -> list[str]:
    text = text.replace("elastic restart", "restart")
    text = re.sub(r"\d+\.\d+(e[+-]\d+)?", "X", text)
    return [re.sub(r"\[\d+(, \d+)*\]", "[TOKENS]", line)
            for line in text.splitlines()]


def reference_lines(main, argv, monkeypatch) -> str:
    monkeypatch.setattr(sys, "argv", argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main()
    return out.getvalue()


def check_launchers(arch: str, serve_argv: list, monkeypatch, capsys,
                    tmp_path):
    """The serve launcher (`serve_argv`) and a 3-step train launcher
    (a save at step 2) print the reference launchers' lines, numbers and
    tokens masked."""
    argv = ["--arch", arch, *serve_argv]
    monkeypatch.setattr(jserve, "generate", JGENERATE)   # compiled once
    ref = reference_lines(jserve.main, ["serve", *argv], monkeypatch)
    capsys.readouterr()
    _, rec = serve.run([*argv, "--device", "cpu"])
    assert masked(capsys.readouterr().out) == masked(ref)
    args = serve.parse_args(argv)
    assert tuple(rec["tokens"].shape) == (args.batch, args.gen_tokens)
    argv = ["--arch", arch, "--steps", "3", "--ckpt-every", "2",
            "--seq-len", "16", "--batch", "4"]
    ref = reference_lines(jtrain.main, ["train", *argv, "--ckpt-dir",
                                        str(tmp_path / "ref")], monkeypatch)
    capsys.readouterr()
    state, records = train.run([*argv, "--ckpt-dir", str(tmp_path / "port"),
                                "--device", "cpu"])
    assert masked(capsys.readouterr().out) == masked(ref)
    assert int(state["step"]) == 3
    assert all(np.isfinite(r["loss"]) for r in records
               if r["event"] == "step")
