"""Batched serving launcher: prefill a batch of prompts, decode N tokens.

    python -m repro_torch.launch.serve [--arch qwen2_15b] [--full] ...

The JAX package's `launch/serve.py` on one device (the card unless
`--device cpu`): random params and prompts from `--seed`, then
`serve_step.generate`, which prints the reference's two `[serve]` lines.
`run(argv)` also returns the params and a record of the run: the tokens,
the prefill's and each decode step's host seconds (each ended by a
device synchronize), tokens/s and, on the card, peak device memory.
`main()` is the command line.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serve.serve_step import generate


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2_15b")
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="use the reduced config (the default)")
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="use the published config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch path)")
    return ap.parse_args(argv)


def prompts(cfg, batch: int, prompt_len: int, seed: int) -> dict:
    """The serve batch of a command line: uniform random prompt tokens
    from `seed` (numpy); for encoder-decoder configs standard normal
    frame embeddings (B, prompt_len, d) from the same generator, as the
    reference launcher passes; for M-RoPE configs the text positions on
    all three streams."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, size=(batch, prompt_len),
                                  dtype=np.int64).astype(np.int32)}
    if cfg.is_encoder_decoder:
        out["frames"] = rng.standard_normal(
            (batch, prompt_len, cfg.d_model)).astype(np.float32)
    if cfg.mrope:
        pos = np.broadcast_to(np.arange(prompt_len, dtype=np.int32),
                              (3, batch, prompt_len))
        out["pos3"] = np.ascontiguousarray(pos)
    return out


def run(argv=None) -> tuple[dict, dict]:
    """Serve as the command line says; returns (params, record)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = M.init_params(gen, cfg)
    batch = prompts(cfg, args.batch, args.prompt_len, args.seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    times: list[float] = []
    t0 = time.time()
    out = generate(params, cfg, batch, steps=args.gen_tokens,
                   temperature=args.temperature, key=gen,
                   chunk=min(1024, args.prompt_len), device=dev,
                   step_times=times)
    out = out.cpu()
    dt = time.time() - t0
    toks = args.batch * args.gen_tokens
    print(f"[serve] arch={cfg.name} generated {tuple(out.shape)} in "
          f"{dt:.2f}s ({toks / dt:.1f} tok/s)")
    print("[serve] sample:", out[0, :12].tolist())
    record = dict(
        arch=cfg.name, device=str(dev), batch=args.batch,
        prompt_len=args.prompt_len, gen_tokens=args.gen_tokens,
        tokens=out, seconds=dt, tokens_per_s=toks / dt,
        prefill_s=times[0], decode_step_s=times[1:],
        peak_memory_bytes=(torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None))
    return params, record


def main():
    run()


if __name__ == "__main__":
    main()
