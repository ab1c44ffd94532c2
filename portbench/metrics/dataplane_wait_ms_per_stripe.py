"""The data plane's read-back of its verify flags, where the host blocks
until the card has done the batch (the program's `dataplane.wait`
spans), over the traced batches, in ms a stripe
(`portbench/program_spans.py`)."""
from portbench import program_spans

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER = "data plane"
MOVES = "repair_GBps"


def read(run):
    return program_spans.ms_per_stripe(run, "dataplane.wait")
