"""The program's own spans and counts (`repro_torch.tracing`) over a run's
traced batches, on the profiler's clock.

The program records while torch.profiler does, so a `--trace 1` run's
profiled stretch leaves its spans in `tracing.snapshot()`. Only spans
that lie inside one of `run.traced.batches` are kept, which drops those
of a profiled stretch the harness threw away. A span's times move to the
profiler's clock by its batch's offset: the batch's `draw` stage in
`run.traced.profile.stages` minus its `Batch.start`, the two taken back
to back in `Bench.batch`.

A program without the tracer yields nothing, and each reader then
returns None.
"""
from __future__ import annotations

import bisect
import dataclasses


@dataclasses.dataclass(frozen=True)
class Aligned:
    span: object          # a repro_torch.tracing.Span
    batch: int            # index into run.traced.batches
    start: float          # seconds, on the profiler's clock
    end: float


def _snapshot():
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing.snapshot()


def aligned(run) -> list[Aligned] | None:
    """Every program span inside a traced batch, oldest first; None where
    the run was not traced or the program has no tracer."""
    if run.traced is None:
        return None
    snap = _snapshot()
    if snap is None:
        return None
    batches = run.traced.batches
    draws = sorted(s for name, s, _ in run.traced.profile.stages
                   if name == "draw")
    if len(draws) != len(batches):
        raise RuntimeError(f"{len(draws)} 'draw' stages for "
                           f"{len(batches)} traced batches")
    starts = [b.start for b in batches]
    out = []
    for s in snap[0]:
        lo, hi = s.start_ns * 1e-9, s.end_ns * 1e-9
        i = bisect.bisect_right(starts, lo) - 1
        if i >= 0 and hi <= batches[i].end:
            offset = draws[i] - batches[i].start
            out.append(Aligned(s, i, lo + offset, hi + offset))
    return out


def outermost(spans: list[Aligned], name: str) -> list[Aligned]:
    """The spans called `name` that no other span of that name encloses."""
    by_id = {a.span.id: a.span for a in spans}

    def enclosed(span) -> bool:
        up = by_id.get(span.parent)
        while up is not None and up.name != name:
            up = by_id.get(up.parent)
        return up is not None

    return [a for a in spans if a.span.name == name and not enclosed(a.span)]


def ms_per_stripe(run, name: str) -> float | None:
    """Σ seconds of the outermost spans `name` in the traced batches, in
    ms a stripe."""
    spans = aligned(run)
    if spans is None:
        return None
    seconds = sum(a.span.seconds for a in outermost(spans, name))
    return seconds / sum(b.stripes for b in run.traced.batches) * 1e3


def counted(run, prefix: str) -> int | None:
    """Σ of the counts whose names start with `prefix`, made inside the
    traced batches."""
    spans = aligned(run)
    if spans is None:
        return None
    return sum(n for a in spans for name, n in (a.span.counts or {}).items()
               if name.startswith(prefix))
