"""Architecture & shape configuration registry.

One module per assigned architecture lives next to this file; each exports
`CONFIG: ArchConfig` built from the public spec. `reduced()` returns the
CPU-smoke-test variant of the same family (same code paths, tiny sizes).
"""
from __future__ import annotations

import dataclasses
import importlib


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | audio | ssm | vlm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    qkv_bias: bool = False
    act: str = "silu"              # silu (SwiGLU) | gelu (GeGLU)
    moe: MoEConfig | None = None
    # attention structure
    attn_kind: str = "full"        # full | sliding | none
    sliding_window: int = 1024
    global_every: int = 0          # gemma3: 1 global layer per this many (5:1 -> 6)
    # state-space / hybrid
    ssm_kind: str = ""             # rwkv6 | mamba2
    ssm_state: int = 0
    shared_attn_every: int = 0     # zamba2: shared attn block cadence
    # encoder-decoder
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    max_decoder_len: int = 512     # whisper: decoder text length cap
    # vlm
    mrope: bool = False
    mrope_sections: tuple[int, ...] = (16, 24, 24)
    # misc
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid / mostly-sliding-window)."""
        return self.ssm_kind != "" or (
            self.attn_kind == "sliding" and self.global_every > 0
        ) or self.attn_kind == "sliding"

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        changes: dict = dict(
            num_layers=min(self.num_layers, 4 if self.shared_attn_every else 2),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) or 1,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
        )
        if self.num_kv_heads == self.num_heads:       # MHA stays MHA
            changes["num_kv_heads"] = 4
        if self.num_kv_heads == 1:                    # MQA stays MQA
            changes["num_kv_heads"] = 1
        if self.moe:
            # capacity_factor >= E/top_k -> capacity == seq_len: no token
            # dropping, so decode matches full forward exactly in tests
            changes["moe"] = MoEConfig(num_experts=4, top_k=2, capacity_factor=4.0)
        if self.is_encoder_decoder:
            changes["encoder_layers"] = 2
            changes["max_decoder_len"] = 16
        if self.ssm_kind == "mamba2":
            changes["ssm_state"] = 16
            changes["num_heads"] = 4                  # mamba2 heads
        if self.shared_attn_every:
            changes["shared_attn_every"] = 2
        if self.attn_kind == "sliding":
            changes["sliding_window"] = 8
        if self.mrope:
            changes["mrope_sections"] = (2, 3, 3)   # sums to reduced hd/2
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str                      # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}

ARCH_IDS = (
    "grok1_314b",
    "moonlight_16b_a3b",
    "gemma_2b",
    "smollm_360m",
    "qwen2_15b",
    "gemma3_4b",
    "whisper_medium",
    "rwkv6_16b",
    "qwen2vl_2b",
    "zamba2_7b",
)


def get_arch(arch_id: str) -> ArchConfig:
    arch_id = arch_id.replace("-", "_")
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG


def applicable_shapes(cfg: ArchConfig) -> list[str]:
    """The assigned (arch x shape) cells that actually lower.

    long_500k is restricted to sub-quadratic archs per the assignment
    (pure full-attention archs skip it; see DESIGN.md section 6).
    """
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        out.append("long_500k")
    return out
