"""Model zoo: dense/MoE transformers, whisper enc-dec, RWKV6, Mamba2/Zamba2
hybrid, Qwen2-VL backbone. Params are nested dicts of torch tensors with
the JAX package's names and shapes, layers stacked on a leading axis and
walked in a loop; causal bf16 self-attention at positions 0..T-1 is
PyTorch's fused `scaled_dot_product_attention`, all other attention a
chunked online softmax; the WKV and SSD scans are chunked loops in plain
PyTorch."""
from repro_torch.models import sharding, layers  # noqa: I001
from repro_torch.models import mamba2, rwkv6, transformer, whisper, zamba2
from repro_torch.models import model

__all__ = ["layers", "mamba2", "model", "rwkv6", "sharding", "transformer",
           "whisper", "zamba2"]
