"""Zamba2-7B — Mamba2 backbone + shared attention block every 6 layers,
ssm_state=64 [arXiv:2411.15242; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2_7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000, head_dim=112,
    ssm_kind="mamba2", ssm_state=64, shared_attn_every=6,
    rope_theta=10_000.0,
)
