"""The initial repair search inside planning (the program's `plan.search`
spans: MSRepair's batched schedule, BMF's per-stripe schedules, the
regions `SimResult.planning_time` charges), over the traced batches, in
ms a stripe (`portbench/program_spans.py`)."""
from portbench import program_spans

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER = "planning and lowering"
MOVES = "repair_p95_ms"


def read(run):
    return program_spans.ms_per_stripe(run, "plan.search")
