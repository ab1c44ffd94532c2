"""Per-(arch x shape) execution plans: microbatching, chunk sizes, remat,
the KV-cache dtype.

The JAX package's plans, copied as they are: they were sized for its
TPU dry-run cells and have not been re-sized for a GPU. They change
scheduling and memory, not a step's semantics or total FLOPs (the int8
KV cache changes decode numerics within its quantisation).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import TrainConfig

# microbatches for train_4k (global_batch=256)
TRAIN_MICROBATCHES = {
    "grok1_314b": 8,
    "moonlight_16b_a3b": 4,
    "zamba2_7b": 8,
    "gemma3_4b": 4,
    "gemma_2b": 2,
    "qwen2_15b": 2,
    "qwen2vl_2b": 2,
    "whisper_medium": 2,
    "rwkv6_16b": 2,
    "smollm_360m": 4,
}

DECODE_CHUNK = {"decode_32k": 4096, "long_500k": 8192}


# int8 KV cache: halves the bf16 caches the JAX package found too large
# for its single-pod TPU mesh at decode_32k (grok-1, moonlight).
# Window-sliced archs (gemma3) keep bf16: their cache win comes from
# slicing, and the sliced decode carries no int8 scales.
INT8_KV = {"grok1_314b", "moonlight_16b_a3b"}


@dataclasses.dataclass(frozen=True)
class CellPlan:
    train: TrainConfig | None = None
    attn_chunk: int = 1024
    decode_chunk: int = 4096
    kv_dtype: str = "bf16"


def plan_for(cfg: ArchConfig, shape: ShapeConfig) -> CellPlan:
    if shape.kind == "train":
        tcfg = TrainConfig(
            adamw=AdamWConfig(),
            microbatches=TRAIN_MICROBATCHES.get(cfg.name, 2),
            remat=True,
            attn_chunk=1024,
            # grok-314B: bf16 m/v halve the optimizer state (the JAX
            # package's fit for its single-pod TPU mesh)
            opt_dtype="bfloat16" if cfg.name == "grok1_314b" else "float32",
        )
        return CellPlan(train=tcfg)
    if shape.kind == "prefill":
        return CellPlan(attn_chunk=1024)
    return CellPlan(
        decode_chunk=DECODE_CHUNK.get(shape.name, 4096),
        kv_dtype="int8" if (cfg.name in INT8_KV
                            and shape.name == "decode_32k") else "bf16",
    )
