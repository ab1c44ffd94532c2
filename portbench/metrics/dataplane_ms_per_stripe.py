"""The data plane (step 4, `execute_plans_batch`, through the
synchronise) per stripe, from the benchmark's spans over the window."""
UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER = "data plane"
MOVES = "repair_GBps"


def read(run):
    return (sum(b.dataplane_s for b in run.batches)
            / sum(b.stripes for b in run.batches) * 1e3)
