"""Moonshot Moonlight-16B-A3B — MoE 64e top-6 [hf:moonshotai/Moonlight-16B-A3B; hf]."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="moonlight_16b_a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=163840, head_dim=128,
    moe=MoEConfig(num_experts=64, top_k=6),
    rope_theta=50_000.0,
)
