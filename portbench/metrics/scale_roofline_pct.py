"""The premultiply kernel's share of its roofline: the least time the
card's memory needs for the bytes the plans ask of it (helper rows read
once, scaled rows written once; `bytecount.scale_bytes`) over the
kernel's profiled device time in the traced batches."""
from portbench import bytecount, timing

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "kernels"
MOVES = "repair_GBps"
KERNEL = "gf256_scale_bytes"


def read(run):
    traced = run.traced
    if traced is None:
        return None
    seconds = sum(s for name, _, s in traced.profile.ops if KERNEL in name)
    if seconds <= 0:
        return None
    nbytes = sum(bytecount.scale_bytes(b.plans, run.nbytes)
                 for b in traced.batches)
    return 100 * timing.least_seconds(nbytes, run.device_name) / seconds
