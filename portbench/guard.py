"""The run's guard against the JAX package: none of it may be loaded."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def loaded(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot),
    compared whole, is forbidden: `repro_torch` passes, `repro` does not."""
    modules = sys.modules if modules is None else modules
    return sorted(name for name in list(modules)
                  if name.split(".", 1)[0] in FORBIDDEN)
