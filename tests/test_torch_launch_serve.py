"""The port's serve launcher, held against repro on the CPU:
`serve_step.generate` (greedy tokens equal to the reference's from the
same params and prompts), `launch/cells.py` (`plan_for` equal for every
arch x shape) and `python -m repro_torch.launch.serve` (the reference's
two `[serve]` lines, numbers masked; the tokens themselves differ, since
the two packages draw params and prompts from different generators)."""
import contextlib
import dataclasses
import io
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as jserve
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_arch as jget_arch
from repro.launch import cells as jcells
from repro.models import model as JM
from repro.serve import serve_step as jserve_step
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, SHAPES, get_arch
from repro_torch.launch import cells, serve
from repro_torch.models import model as M
from repro_torch.serve import serve_step


def _setup(arch, dtype=None, b=2, t=8, seed=0):
    jcfg, cfg = jget_arch(arch).reduced(), get_arch(arch).reduced()
    if dtype:
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
        cfg = dataclasses.replace(cfg, dtype=dtype)
    jparams = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    params = convert.state_from_reference(jax.tree.map(np.asarray, jparams),
                                          "cpu")
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)}
    if cfg.mrope:
        batch["pos3"] = np.ascontiguousarray(
            np.broadcast_to(np.arange(t, dtype=np.int32), (3, b, t)))
    return cfg, jcfg, params, jparams, batch


@pytest.mark.parametrize("dtype", [None, "float32"])
@pytest.mark.parametrize("arch", ["qwen2_15b", "gemma3_4b",
                                  "moonlight_16b_a3b", "qwen2vl_2b"])
def test_generate_greedy_matches_reference(arch, dtype):
    """6 greedy tokens (gemma3: past its reduced window of 8, so the sliced
    decode runs; qwen2vl: the pos3 stream)."""
    cfg, jcfg, params, jparams, batch = _setup(arch, dtype)
    want = jserve_step.generate(jparams, jcfg,
                                {k: jnp.asarray(v) for k, v in batch.items()},
                                steps=6, chunk=8)
    got = serve_step.generate(params, cfg, batch, steps=6, chunk=8,
                              device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 6)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_generate_records_step_times_and_samples():
    cfg, _, params, _, batch = _setup("smollm_360m")
    times: list = []
    serve_step.generate(params, cfg, batch, steps=3, chunk=8, device="cpu",
                        step_times=times)
    assert len(times) == 4 and all(s > 0 for s in times)  # prefill + 3 steps

    def sample(seed):
        return serve_step.generate(
            params, cfg, batch, steps=5, chunk=8, temperature=1.0,
            key=torch.Generator().manual_seed(seed), device="cpu")

    a, b = sample(1), sample(1)
    assert torch.equal(a, b)                   # one generator, one sample
    assert ((a >= 0) & (a < cfg.vocab_size)).all()
    assert not torch.equal(a, sample(2))
    with pytest.raises(ValueError, match="torch.Generator"):
        serve_step.generate(params, cfg, batch, steps=1, temperature=1.0,
                            device="cpu")


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plan_for_matches_reference(arch, shape):
    got = cells.plan_for(get_arch(arch), SHAPES[shape])
    want = jcells.plan_for(jget_arch(arch), JSHAPES[shape])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_cell_tables_match_reference():
    assert cells.TRAIN_MICROBATCHES == jcells.TRAIN_MICROBATCHES
    assert cells.DECODE_CHUNK == jcells.DECODE_CHUNK
    assert cells.INT8_KV == jcells.INT8_KV


def _masked(text: str) -> list[str]:
    text = re.sub(r"\d+\.\d+", "X", text)
    return [re.sub(r"\[\d+(, \d+)*\]", "[TOKENS]", line)
            for line in text.splitlines()]


@pytest.mark.parametrize("argv", [
    [],
    ["--arch", "qwen2vl_2b", "--batch", "2", "--prompt-len", "12",
     "--gen-tokens", "5"],
    ["--arch", "grok1_314b", "--batch", "3", "--gen-tokens", "4",
     "--temperature", "0.7", "--seed", "3"],
])
def test_run_prints_the_reference_lines(argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    ref = io.StringIO()
    with contextlib.redirect_stdout(ref):
        jserve.main()
    capsys.readouterr()
    params, rec = serve.run([*argv, "--device", "cpu"])
    out = capsys.readouterr().out
    assert _masked(out) == _masked(ref.getvalue())
    args = serve.parse_args(argv)
    assert tuple(rec["tokens"].shape) == (args.batch, args.gen_tokens)
    assert len(rec["decode_step_s"]) == args.gen_tokens
    assert rec["prefill_s"] > 0 and rec["peak_memory_bytes"] is None
    assert out.splitlines()[1] == (
        f"[serve] sample: {rec['tokens'][0, :12].tolist()}")
    assert params["embed"]["table"].device.type == "cpu"


def test_run_is_deterministic(capsys):
    argv = ["--device", "cpu", "--batch", "2", "--gen-tokens", "4"]
    _, a = serve.run(argv)
    _, b = serve.run(argv)
    assert torch.equal(a["tokens"], b["tokens"])


def test_device_none_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, _, params, _, batch = _setup("smollm_360m")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.run([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_step.generate(params, cfg, batch, steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_cache(cfg, 1, 4)
