"""Erasure-coded checkpointing: the paper's repair algorithms deployed as
the fault-tolerance layer of the training framework."""

from repro_torch.checkpoint.ec_checkpoint import (  # noqa: F401
    ECCheckpointConfig,
    ECCheckpointer,
    RepairReport,
)
