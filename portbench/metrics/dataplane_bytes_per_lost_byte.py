"""Bytes that the data plane's own torch ops read and write on the card
(the program's `dataplane.bytes.*` counts: the helper gathers and their
concatenation, the verify's copies, compares and reductions; the two
kernels, which write the repair buffer's rows in place, are not counted)
per lost byte restored, over the traced batches: a fixed set of draws a
seed, so the count repeats."""
from portbench import program_spans

UNIT, BETTER, SOURCE = "B/B", "lower", "program_counter"
LAYER = "data plane"
MOVES = "repair_GBps"


def read(run):
    nbytes = program_spans.counted(run, "dataplane.bytes.")
    if nbytes is None:
        return None
    return nbytes / sum(b.lost_bytes for b in run.traced.batches)
