"""SmolLM-360M — llama-arch small [hf:HuggingFaceTB/SmolLM-360M; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm_360m", family="dense",
    num_layers=32, d_model=960, num_heads=15, num_kv_heads=5,
    d_ff=2560, vocab_size=49152, head_dim=64,
    rope_theta=10_000.0,
)
