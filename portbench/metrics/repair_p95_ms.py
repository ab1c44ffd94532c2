"""95th percentile of the latencies of all the window's repair batches,
each from its draw to its synchronise."""
import numpy as np

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"


def read(run):
    return float(np.percentile([b.latency_s for b in run.batches], 95)) * 1e3
