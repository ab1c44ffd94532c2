"""Per-architecture configs (assigned pool) + shape registry."""

from repro_torch.configs.base import (  # noqa: F401
    ARCH_IDS,
    SHAPES,
    ArchConfig,
    MoEConfig,
    ShapeConfig,
    applicable_shapes,
    get_arch,
)
