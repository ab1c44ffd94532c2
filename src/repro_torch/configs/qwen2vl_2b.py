"""Qwen2-VL 2B — qwen2 backbone, M-RoPE, patch frontend stubbed
[arXiv:2409.12191; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2vl_2b", family="vlm",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
    d_ff=8960, vocab_size=151936, head_dim=128, qkv_bias=True,
    mrope=True, mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
)
