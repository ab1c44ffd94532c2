"""Bytes the plans move over the network (the data plane's
`bytes_moved`, each relay hop counted) per lost byte restored, over the
traced batches: a fixed set of draws a seed, so the count repeats."""
UNIT, BETTER, SOURCE = "B/B", "lower", "program_counter"
LAYER = "forwarding"
MOVES = "repair_GBps"


def read(run):
    if run.traced is None:
        return None
    batches = run.traced.batches
    return sum(b.bytes_moved for b in batches) / sum(b.lost_bytes for b in batches)
