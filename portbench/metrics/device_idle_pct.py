"""The device's idle share of the traced batches' wall: 100 less the
seconds in which some operation ran on it, over the traced window."""
UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER = "device"
MOVES = "repair_GBps"


def read(run):
    traced = run.traced
    if traced is None or not traced.profile.ops:
        return None
    return 100 * (1 - traced.busy_s / traced.window_s)
