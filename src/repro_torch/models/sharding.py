"""Logical-axis sharding rules: the single-device half.

The JAX package names every parameter and activation dimension by a
logical axis ("d", "tp", "batch", "seq" or None) and `MeshRules` maps the
names onto a device mesh. This port runs on one device, so only the
no-mesh rules exist here: `NO_MESH` replicates everything, `constrain`
/ `tree_constrain` return their input, and `kv_cache_axes` gives the
no-mesh layout of a KV cache. The models' logical trees name the axes as
the reference's do; the mesh half (`spec`, `sharding`, the tensor-sharded
cache layouts) waits for the multi-device slice (ROADMAP item 17h).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class MeshRules:
    mesh: None = None
    fsdp: tuple[str, ...] = ("data",)
    tensor: str = "model"

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "device meshes are not ported yet (ROADMAP item 17h)")

    def constrain(self, x: torch.Tensor, logical: tuple) -> torch.Tensor:
        """A sharding constraint by logical names: the identity off-mesh."""
        return x


# Default rules: no mesh, everything replicated, constraints no-op.
NO_MESH = MeshRules(mesh=None)


def tree_constrain(rules: MeshRules, tree, logical_tree):
    """Sharding constraints over a whole tree: the identity off-mesh."""
    return tree


def stack_logical(logical_tree: dict) -> dict:
    """A per-layer logical tree with a leading (replicated) layer axis on
    every leaf, as stacked layer params carry."""
    if isinstance(logical_tree, dict):
        return {k: stack_logical(v) for k, v in logical_tree.items()}
    return (None, *logical_tree)


def kv_cache_axes(num_kv_heads: int, head_dim: int, rules: MeshRules):
    """The logical axes of a (L, B, S, kv, hd) KV cache. Off-mesh (the
    only case here) the cache is batch-major and nothing else is named."""
    if rules.mesh is not None:
        raise NotImplementedError(
            "device meshes are not ported yet (ROADMAP item 17h)")
    return (None, "batch", None, None, None)
