"""Erasure-coding substrate: GF(256) arithmetic, RS codes, bit-plane layout."""

from repro_torch.ec import bitplane, gf256, rs, stripe  # noqa: F401
