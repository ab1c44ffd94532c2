"""Process start to the first timed batch: imports, the CUDA context, the
kernel library (built on a checkout's first run), the pool of stripes
made and encoded, one warm batch."""
UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(run):
    return run.setup_s
