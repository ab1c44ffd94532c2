"""Array-native repair engine — the scalar parts the object planners need.

* `repro_torch.core.engine.arrays` — term bitmask helpers (`_terms_mask`,
  `_mask_terms`) and `UnsupportedPlanError`;
* `repro_torch.core.engine.planner_arrays` — the tuple schedulers
  (traditional, PPR, m-PPR, MSRepair, random) that `core/msrepair.py`
  wraps back into `Round`/`Transfer` objects.

The compiled `PlanArrays` IR, the batched planners and steppers and the
batched byte data plane of the reference's engine are not ported yet.
"""
from repro_torch.core.engine.arrays import UnsupportedPlanError

__all__ = ["UnsupportedPlanError"]
