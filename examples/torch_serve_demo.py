"""Batched serving: prefill a prompt batch, decode greedily with KV caches
across three model families (transformer / RWKV6 state / zamba2 hybrid).

    PYTHONPATH=src python examples/torch_serve_demo.py [--device cpu]

Params and prompts are drawn on the device from a seeded
`torch.Generator` (so the tokens differ from the JAX package's demo);
the device is the card unless `--device cpu`, and without a card it
raises. Serving runs plain PyTorch: none of the repair kernels.
"""
import argparse
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serve.serve_step import generate


def main(device=None):
    dev = resolve_device(device)
    for arch in ("qwen2_15b", "rwkv6_16b", "zamba2_7b"):
        cfg = get_arch(arch).reduced()
        key = torch.Generator(device=dev).manual_seed(0)
        params = M.init_params(key, cfg)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 24),
                                         generator=key, device=dev,
                                         dtype=torch.int32)}
        t0 = time.time()
        out = generate(params, cfg, batch, steps=16, chunk=16, device=dev)
        dt = time.time() - t0
        print(f"{arch:12s} generated {out.shape[0]}x{out.shape[1]} tokens "
              f"in {dt:5.1f}s — sample: {out[0, :8].tolist()}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs on "
                         "the CPU)")
    main(ap.parse_args().device)
