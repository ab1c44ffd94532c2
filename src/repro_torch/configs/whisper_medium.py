"""Whisper-medium — enc-dec, conv frontend stubbed (precomputed frame
embeddings via input_specs) [arXiv:2212.04356; unverified]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper_medium", family="audio",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=51865, head_dim=64,
    act="gelu", is_encoder_decoder=True, encoder_layers=24,
    max_decoder_len=448,
)
