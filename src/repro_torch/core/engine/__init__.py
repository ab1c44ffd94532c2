"""Array-native repair engine: compiled plans and the batched byte data plane.

* `repro_torch.core.engine.arrays` — `compile_plan` lowers the object plan
  IR to `PlanArrays` (padded numpy integer arrays + uint64 term bitmasks,
  host metadata), `plan_arrays_from_schedule` builds them straight from
  tuple schedules, `splice_path` mutates a compiled plan in place (the BMF
  replan hook), `relabel_plan_nodes` renames it through a stripe
  placement, `decompile` round-trips exactly, `validate_plan_arrays` is
  the array fast path behind `repro_torch.core.plan.validate_plan`;
* `repro_torch.core.engine.planner_arrays` — the tuple schedulers
  (traditional, PPR, m-PPR, MSRepair, random) that `core/msrepair.py`
  wraps back into `Round`/`Transfer` objects;
* `repro_torch.core.engine.dataplane` — the byte data plane: batches of
  compiled plans executed over real bytes in one `(B, slots, nbytes)`
  buffer on the device (one `gf256_scale_bytes` launch for the whole
  batch's premultiply, one `xor_reduce_groups_words` launch per round),
  byte-identical to the serial walk in `repro_torch.core.executor`.

The JAX package's batched planners, `(B, ...)` steppers and device
stepper (`planner_arrays`' batched half, `vectorized`, `jax_stepper`) are
not ported yet. Unlike the JAX package, `dataplane` is imported eagerly:
it pulls in no JAX.
"""
from repro_torch.core.engine.arrays import (PlanArrays, UnsupportedPlanError,
                                            compile_plan, decompile,
                                            plan_arrays_from_schedule,
                                            relabel_plan_nodes, splice_path,
                                            validate_plan_arrays)
from repro_torch.core.engine.dataplane import (BatchExecutionResult,
                                               execute_plans_batch,
                                               identity_block_map)

__all__ = [
    "PlanArrays",
    "UnsupportedPlanError",
    "compile_plan",
    "decompile",
    "plan_arrays_from_schedule",
    "splice_path",
    "validate_plan_arrays",
    "BatchExecutionResult",
    "execute_plans_batch",
    "identity_block_map",
    "relabel_plan_nodes",
]
