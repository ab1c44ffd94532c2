"""The per-round re-optimisation of the plans on the live bandwidth stack
(the program's `plan.replan` spans, one a round, also charged to
`planning_time`), over the traced batches, in ms a stripe
(`portbench/program_spans.py`)."""
from portbench import program_spans

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER = "planning and lowering"
MOVES = "repair_p95_ms"


def read(run):
    return program_spans.ms_per_stripe(run, "plan.replan")
