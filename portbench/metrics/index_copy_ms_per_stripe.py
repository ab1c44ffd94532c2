"""Device time of every operation in the traced batches that is not one
of the port's own kernels (gathers, concatenation, index writes, fills,
clones, comparisons, copies of index tables), per stripe."""
UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER = "data plane"
MOVES = "repair_GBps"


def read(run):
    traced = run.traced
    if traced is None or not traced.profile.ops:
        return None
    own = traced.port_kernels
    seconds = sum(s for name, _, s in traced.profile.ops
                  if not any(k in name for k in own))
    return seconds / sum(b.stripes for b in traced.batches) * 1e3
