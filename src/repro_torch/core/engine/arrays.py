"""Term bitmasks of the structure-of-arrays plan IR (scalar part).

The reference's `core/engine/arrays.py` lowers `RepairPlan`s to padded
`PlanArrays` with uint64 term bitmasks — one bit per helper node id. This
port holds only the scalar helpers the object planners use; `PlanArrays`,
`compile_plan`, `decompile`, `splice_path`, `relabel_plan_nodes` and
`validate_plan_arrays` come with the batched engine.

Term (helper) node ids must fit a 64-bit mask (id < 64); `_terms_mask`
raises `UnsupportedPlanError` otherwise.
"""
from __future__ import annotations

_MAX_MASK_NODES = 64


class UnsupportedPlanError(ValueError):
    """The plan cannot be lowered to arrays (helper/term ids >= 64)."""


def _terms_mask(terms) -> int:
    mask = 0
    for t in terms:
        t = int(t)
        if not 0 <= t < _MAX_MASK_NODES:
            raise UnsupportedPlanError(
                f"term node id {t} does not fit a uint64 bitmask"
            )
        mask |= 1 << t
    return mask


def _mask_terms(mask: int) -> frozenset[int]:
    out = []
    m = int(mask)
    while m:
        b = m & -m
        out.append(b.bit_length() - 1)
        m ^= b
    return frozenset(out)
