"""RWKV6 (Finch) 1.6B — attention-free, data-dependent decay
[arXiv:2404.05892; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6_16b", family="ssm",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=7168, vocab_size=65536, head_dim=64,
    attn_kind="none", ssm_kind="rwkv6",
)
