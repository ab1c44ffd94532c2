"""The benchmark's inputs: each pool stripe's data blocks, from the seed.

Made on the run's device by one seeded generator call a stripe, so that
set-up and the reference after the window get the same bytes, and the
reference never reads the port's copy of them.
"""
from __future__ import annotations

import numpy as np
import torch


def stripe_data(seed: int, stream: int, stripe: int, k: int, nbytes: int,
                device) -> torch.Tensor:
    """(k, nbytes) uint8 data blocks of pool stripe `stripe`."""
    state = np.random.SeedSequence([seed, stream, stripe]).generate_state(
        1, np.uint64)
    gen = torch.Generator(device=device).manual_seed(int(state[0]))
    return torch.randint(0, 256, (k, nbytes), dtype=torch.uint8,
                         generator=gen, device=device)
