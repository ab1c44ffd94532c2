"""The data plane's host work before its first device op (the program's
`dataplane.prepare` spans: repair coefficients, the round schedule, the
row tables), over the traced batches, in ms a stripe
(`portbench/program_spans.py`)."""
from portbench import program_spans

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER = "data plane"
MOVES = "repair_GBps"


def read(run):
    return program_spans.ms_per_stripe(run, "dataplane.prepare")
