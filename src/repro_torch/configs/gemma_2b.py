"""Gemma 2B — GeGLU, head_dim=256, MQA [arXiv:2403.08295; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma_2b", family="dense",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1,
    d_ff=16384, vocab_size=256000, head_dim=256,
    act="gelu", rope_theta=10_000.0,
)
