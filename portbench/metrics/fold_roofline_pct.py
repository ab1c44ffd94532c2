"""The fold kernel's share of its roofline: the least time the card's
memory needs for the bytes the plans ask of it (each round's arriving and
held rows read once, each destination row written once;
`bytecount.fold_bytes`) over the kernel's profiled device time in the
traced batches."""
from portbench import bytecount, timing

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "kernels"
MOVES = "repair_GBps"
KERNEL = "xor_reduce_groups"


def read(run):
    traced = run.traced
    if traced is None:
        return None
    seconds = sum(s for name, _, s in traced.profile.ops if KERNEL in name)
    if seconds <= 0:
        return None
    nbytes = sum(bytecount.fold_bytes(b.plans, run.nbytes)
                 for b in traced.batches)
    return 100 * timing.least_seconds(nbytes, run.device_name) / seconds
