"""Gemma3 4B — 5:1 local(1024-window):global, 128k ctx [hf:google/gemma-3; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3_4b", family="dense",
    num_layers=34, d_model=2560, num_heads=8, num_kv_heads=4,
    d_ff=10240, vocab_size=262144, head_dim=256,
    act="gelu", attn_kind="sliding", sliding_window=1024, global_every=6,
    rope_theta=1_000_000.0,
)
