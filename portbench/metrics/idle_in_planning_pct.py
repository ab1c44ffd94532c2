"""The device's idle share that lies inside planning: idle seconds of the
traced window whose instants fall inside one of the program's `plan` or
`plan.convert` spans, moved onto the profiler's clock
(`portbench/program_spans.py`), over the traced window."""
from portbench import program_spans, trace

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER = "device"
MOVES = "repair_GBps"


def read(run):
    traced = run.traced
    if traced is None or not traced.profile.ops:
        return None
    spans = program_spans.aligned(run)
    if spans is None:
        return None
    lo, hi = traced.profile.span
    idle, t = [], lo
    for a, b in trace.busy_intervals(traced.profile.ops):
        if a > t:
            idle.append((t, min(a, hi)))
        t = max(t, b)
    if t < hi:
        idle.append((t, hi))
    planning = trace.busy_intervals([(s.span.name, s.start, s.end - s.start)
                                     for s in spans
                                     if s.span.name in ("plan", "plan.convert")])
    inside = sum(max(0.0, min(b, q) - max(a, p))
                 for a, b in idle for p, q in planning)
    return 100 * inside / traced.window_s
