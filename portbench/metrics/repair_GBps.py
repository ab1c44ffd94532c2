"""Lost bytes restored per second: every batch of the window, over the
window's whole length (1 GB = 1e9 bytes)."""
UNIT, BETTER, SOURCE = "GB/s", "higher", "host_clock"


def read(run):
    return sum(b.lost_bytes for b in run.batches) / run.window_s / 1e9
