"""Array-native repair engine: compiled plans, planners, batched steppers
and the byte data plane.

* `repro_torch.core.engine.arrays` — `compile_plan` lowers the object plan
  IR to `PlanArrays` (padded numpy integer arrays + uint64 term bitmasks,
  host metadata), `plan_arrays_from_schedule` builds them straight from
  tuple schedules, `splice_path` mutates a compiled plan in place (the BMF
  replan hook), `relabel_plan_nodes` renames it through a stripe
  placement, `decompile` round-trips exactly, `validate_plan_arrays` is
  the array fast path behind `repro_torch.core.plan.validate_plan`;
* `repro_torch.core.engine.planner_arrays` — the array-native planner
  layer (host numpy): batched BMF path search / round optimization over
  `(B, N, N)` bandwidth stacks, the lockstep MSRepair batch scheduler,
  batched lowering, and the tuple schedulers the object planners in
  `repro_torch.core.{msrepair,bmf,ppt}` facade over;
* `repro_torch.core.engine.vectorized` — masked-array event steppers that
  advance a whole `(B, ...)` batch of scenarios at once (numpy, on the
  host), plus `run_scheme_vectorized`, the batched twin of
  `simulator.run_scheme` that `repro_torch.sim.sweep.run_sweep(
  executor="vectorized")` dispatches to;
* `repro_torch.core.engine.device_stepper` — the same event loops as
  torch float64 programs on the card behind `run_sweep(executor="device")`
  (the JAX package's `jax_stepper`); planning and replanning stay on the
  host;
* `repro_torch.core.engine.dataplane` — the byte data plane: batches of
  compiled plans executed over real bytes in one `(B, slots, nbytes)`
  buffer on the device (one `gf256_scale_bytes` launch for the whole
  batch's premultiply, one `xor_reduce_groups_words` launch per round),
  byte-identical to the serial walk in `repro_torch.core.executor`.

`vectorized` is loaded lazily (PEP 562), as in the JAX package: it
imports the simulator, whose planner facades import `planner_arrays` from
this package — eager loading would cycle. `dataplane` pulls in no JAX
here, so it is imported eagerly.
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
    "execute_pipeline_batch",
    "execute_round_batch",
    "run_scheme_vectorized",
    "device_available",
    "BatchExecutionResult",
    "execute_plans_batch",
    "identity_block_map",
    "relabel_plan_nodes",
]

_VECTORIZED = ("execute_pipeline_batch", "execute_round_batch",
               "run_scheme_vectorized")


def __getattr__(name):
    if name in _VECTORIZED:
        from repro_torch.core.engine import vectorized

        return getattr(vectorized, name)
    if name == "device_available":
        from repro_torch.core.engine import device_stepper

        return device_stepper.device_available
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
