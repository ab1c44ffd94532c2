"""Conversions of the plans between formats (the program's outermost
`plan.convert` spans: `lower_schedules_batch`, `decompile` of the
executed plans, and the lowering step's `compile_plan` and
`relabel_plan_nodes`), over the traced batches, in ms a stripe
(`portbench/program_spans.py`)."""
from portbench import program_spans

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER = "planning and lowering"
MOVES = "repair_p95_ms"


def read(run):
    return program_spans.ms_per_stripe(run, "plan.convert")
