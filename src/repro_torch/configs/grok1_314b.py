"""grok-1 314B — MoE 8 experts top-2 [hf:xai-org/grok-1; unverified]."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="grok1_314b", family="moe",
    num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=32768, vocab_size=131072, head_dim=128,
    moe=MoEConfig(num_experts=8, top_k=2),
    rope_theta=10_000.0,
)
