"""Measure, on the CPU, what `chip_smoke.py` phase 9's tolerances rest on.

    python3 scripts/family_tolerances.py [--cases equiv cpu decay]
                                         [--threads 4] [--json PATH]

At the published widths with `d_ff` cut to 1,024 and the vocabulary to
8,192 (the depths and batch of phase 9, random params from a seeded
`torch.Generator`), on the CPU:

* `equiv` (9b): prefill T-k tokens, decode k, each step's largest logit
  difference from the teacher-forced forward: rwkv6_16b (24 layers) and
  zamba2_7b (12 layers), each in bf16 and fp32, B=2, 512 + 8 tokens;
  whisper_medium (24 + 24 layers) in bf16 over 1,500 frames, 4 + 8
  tokens; and rwkv6's forward at the WKV chunk of 16 against 64;
* `cpu` (9c): the fp32 cases' sensitivity to the card's rounding: the
  largest logit change over a prefill and 8 greedy decode steps when
  every param is perturbed by a relative 1e-7 (rwkv6 at 2 layers, zamba2
  at 6, whisper at 2 + 2);
* `decay` (the rwkv6 overflow, ROADMAP queue 3): for each layer of
  rwkv6_16b on a 128-token prompt, the most negative summed log-decay of
  a 64-token chunk, and the channels where it passes -88.7, past which
  exp(-cs) overflows fp32 in the JAX package's factored chunk form.

Prints one JSON line a case; `--json PATH` writes them all. The numbers
are CPU arithmetic, not device times.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import rwkv6, whisper, zamba2  # noqa: E402
from repro_torch.serve import serve_step  # noqa: E402

FP32_EXP_MAX = math.log(torch.finfo(torch.float32).max)      # 88.72


def cut(arch: str, layers: int, dtype: str = "bfloat16"):
    """The published config at `layers` (the encoder's too), `d_ff` 1,024,
    a vocabulary of 8,192 and `dtype`."""
    cfg = get_arch(arch)
    changes = dict(num_layers=layers, d_ff=1024, vocab_size=8192,
                   dtype=dtype)
    if cfg.is_encoder_decoder:
        changes["encoder_layers"] = layers
    return dataclasses.replace(cfg, **changes)


def tokens(cfg, batch: int, length: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, length))
                            .astype(np.int32))


def frames(cfg, batch: int, length: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(
        (batch, length, cfg.d_model)).astype(np.float32))


@torch.inference_mode()
def equiv(arch: str, layers: int, dtype: str, prompt: int, steps: int,
          n_frames: int = 0) -> dict:
    """9b: each decode step's logits against the forward's."""
    cfg = cut(arch, layers, dtype)
    params = M.init_params(torch.Generator().manual_seed(1), cfg)
    toks = tokens(cfg, 2, prompt + steps, 2)
    batch = {"tokens": toks[:, :prompt]}
    chunk = 1024 if cfg.is_encoder_decoder else min(1024, prompt)
    rec = dict(case="equiv", arch=arch, layers=layers, dtype=dtype,
               prompt=prompt, steps=steps)
    tic = time.perf_counter()
    if cfg.is_encoder_decoder:
        batch["frames"] = frames(cfg, 2, n_frames, 3)
        rec["frames"] = n_frames
        full, _ = whisper.forward(params, cfg, batch["frames"], toks,
                                  chunk=chunk, remat=False)
        step = serve_step.make_whisper_decode_step(cfg, chunk=chunk)
    else:
        if cfg.ssm_kind == "rwkv6":
            full, _ = rwkv6.forward(params, cfg, toks, remat=False)
            c16, _ = rwkv6.forward(params, cfg, toks, chunk=16, remat=False)
            rec["chunk_16_vs_64"] = float((c16 - full).abs().max())
        else:
            full, _ = zamba2.forward(params, cfg, toks, attn_chunk=chunk,
                                     remat=False)
        step = serve_step.make_decode_step(cfg, chunk=chunk)
    _, state = serve_step.make_prefill(cfg, chunk=chunk,
                                       max_len=prompt + steps)(params, batch)
    errs = []
    for i in range(prompt, prompt + steps):
        lg, state = step(params, toks[:, i], state)
        errs.append(float((lg - full[:, i]).abs().max()))
    rec.update(step_errs=errs, max_abs_err=max(errs),
               seconds=time.perf_counter() - tic)
    return rec


def cpu_sensitivity(arch: str, layers: int, prompt: int, steps: int,
                    n_frames: int = 0) -> dict:
    """9c: the fp32 logits' change under a 1e-7 relative perturbation of
    every param, over a prefill and `steps` decode steps fed the same
    tokens."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    cfg = cut(arch, layers, "float32")
    params = M.init_params(torch.Generator().manual_seed(4), cfg)
    gen = torch.Generator().manual_seed(9)
    moved = tree.map(lambda x: x * (1 + 1e-7 * torch.randn(
        x.shape, generator=gen)), params)
    batch = {"tokens": tokens(cfg, 2, prompt, 5)}
    if cfg.is_encoder_decoder:
        batch["frames"] = frames(cfg, 2, n_frames, 6)
    tic = time.perf_counter()
    a, fed = chip_smoke.greedy_logits(params, cfg, batch, steps, "bf16")
    b, _ = chip_smoke.greedy_logits(moved, cfg, batch, steps, "bf16",
                                    forced=fed)
    errs = [float((x - y).abs().max()) for x, y in zip(a, b)]
    return dict(case="cpu", arch=arch, layers=layers, dtype="float32",
                prompt=prompt, steps=steps, frames=n_frames or None,
                stage_errs=errs, max_abs_err=max(errs),
                seconds=time.perf_counter() - tic)


@torch.inference_mode()
def decay(length: int = 128, chunk: int = 64) -> dict:
    """rwkv6_16b's most negative summed log-decay over a chunk, layer by
    layer, on a `length`-token prompt (the forward's own decays)."""
    cfg = cut("rwkv6_16b", 24)
    params = M.init_params(torch.Generator().manual_seed(1), cfg)
    toks = tokens(cfg, 1, length, 2)
    x = L.embed(params["embed"], toks)
    state = rwkv6.init_state(cfg, 1, device="cpu")
    per_layer = []
    for lp, st in zip(tree.unstack(params["layers"]), tree.unstack(state)):
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        prev = rwkv6._token_shift(h, st["last_tm"])
        logw = rwkv6._decays(lp, h + (prev - h) * lp["mix"]["mu_w"], cfg)
        sums = torch.stack([logw[:, c:c + chunk].sum(dim=1)
                            for c in range(0, length, chunk)])
        per_layer.append(dict(min_chunk_sum=float(sums.min()),
                              min_step=float(logw.min()),
                              overflowing=int((sums < -FP32_EXP_MAX).sum())))
        tm, _, _ = rwkv6._time_mix(lp, h, cfg, st["wkv"], st["last_tm"],
                                   chunk=chunk, rules=None)
        x = x + tm.to(x.dtype)
        h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        cm, _ = rwkv6._channel_mix(lp, h2, cfg, st["last_cm"])
        x = x + cm.to(x.dtype)
    return dict(case="decay", arch="rwkv6_16b", prompt=length, chunk=chunk,
                exp_limit=FP32_EXP_MAX, layers=per_layer,
                min_chunk_sum=min(r["min_chunk_sum"] for r in per_layer),
                overflowing=sum(r["overflowing"] for r in per_layer))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", nargs="+", default=["equiv", "cpu", "decay"],
                    choices=["equiv", "cpu", "decay"])
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    runs = []
    if "equiv" in args.cases:
        runs += [lambda: equiv("rwkv6_16b", 24, "float32", 512, 8),
                 lambda: equiv("rwkv6_16b", 24, "bfloat16", 512, 8),
                 lambda: equiv("zamba2_7b", 12, "bfloat16", 512, 8),
                 lambda: equiv("zamba2_7b", 12, "float32", 512, 8),
                 lambda: equiv("whisper_medium", 24, "bfloat16", 4, 8,
                               1500)]
    if "cpu" in args.cases:
        runs += [lambda: cpu_sensitivity("rwkv6_16b", 2, 64, 8),
                 lambda: cpu_sensitivity("zamba2_7b", 6, 64, 8),
                 lambda: cpu_sensitivity("whisper_medium", 2, 4, 8, 1500)]
    if "decay" in args.cases:
        runs.append(decay)
    records = []
    for run in runs:
        rec = run()
        print(json.dumps(rec), flush=True)
        records.append(rec)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(records, indent=1))


if __name__ == "__main__":
    main()
