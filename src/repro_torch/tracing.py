"""Spans and counters of the repair path: where a batch's planning and
byte work spend their time.

Turning it on
-------------
Tracing is on while `enable()` holds (until `disable()`), and while a
`torch.profiler` session records. Off, `span` hands back one shared no-op
context and `count` returns at once: nothing is allocated and no clock is
read. On, a span records its name, its start and end on
`time.perf_counter_ns()`, its own id, the id of the span it opened inside
(0 for none) and the id of the outermost span of that call tree, so the
spans of one `run_sweep` or one `execute_plans_batch` call share a root
id. Each span also opens a profiler range named `repro_torch.<name>`:
under `torch.profiler` the spans appear in its trace (and in an exported
chrome trace) on the same timeline as the card's kernels. The ranges are
function-scope ranges, shown on the host's rows only; a user annotation
(`torch.profiler.record_function`) would also be laid over the device's
timeline as an event of the device, and be summed with the kernels by
any reader that adds up the device's events.

`snapshot()` returns the spans and counters kept so far without clearing
them; `clear()` clears both. Only the newest `CAPACITY` spans are kept,
so a process that leaves tracing on does not grow without limit.

Spans
-----
* `plan`: one `repro_torch.sim.sweep.run_sweep` call, whole.
* `plan.search`: the initial repair search of the batched engine
  (`msrepair_schedule_batch`, `schedule_for_scheme`, the PPT tree) —
  the regions whose wall time `SimResult.planning_time` charges.
* `plan.replan`: one round's BMF re-optimisation on the live bandwidth
  stack, also charged to `planning_time`.
* `plan.step`: the simulated event stepping of a round, of all rounds at
  once, or of a pipeline batch.
* `plan.convert`: format conversions of plans (`lower_schedules_batch`,
  `arrays.compile_plan`, `arrays.relabel_plan_nodes`, and `decompile` of
  the executed plans back to objects). One may open inside another; the
  outermost covers the time.
* `dataplane`: one `execute_plans_batch` call, whole.
* `dataplane.prepare`: its host work before the first device op: the
  repair coefficients, the round schedule, the row tables.
* `dataplane.wait`: the read-back of the verify flags, where the host
  blocks until the card has done the batch's work.

Counters
--------
`dataplane.bytes.gather` and `.verify`: bytes read and written on the
device by `execute_plans_batch`'s own torch ops (the helper-row gathers
and their concatenation; the verify's row copies and compares), computed
on the host from the tensors' shapes. The premultiply and fold kernels,
which write the buffer's rows in place (it is not zeroed), are not
counted. A count is also kept on the innermost span open when it is made
(`Span.counts`), so the counts of one stretch of work can be told apart.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import functools
import itertools
import threading
import time

import torch

CAPACITY = 65_536
PREFIX = "repro_torch."

_profiler_enabled = torch._C._autograd._profiler_enabled


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    start_ns: int                  # time.perf_counter_ns()
    end_ns: int
    id: int
    parent: int                    # the enclosing span's id, 0 for a root
    root: int                      # the outermost enclosing span's id
    counts: dict[str, int] | None  # counts made while it was innermost

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


_spans: collections.deque[Span] = collections.deque(maxlen=CAPACITY)
_counters: dict[str, int] = {}
_lock = threading.Lock()
_ids = itertools.count(1)
_innermost: contextvars.ContextVar[_Open | None] = contextvars.ContextVar(
    "repro_torch_tracing_innermost", default=None)
_enabled = False
_OFF = contextlib.nullcontext()


class _Open:
    """A span while it is open."""

    __slots__ = ("name", "id", "parent", "root", "counts", "start_ns",
                 "_token", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> _Open:
        outer = _innermost.get()
        self.id = next(_ids)
        self.parent = outer.id if outer is not None else 0
        self.root = outer.root if outer is not None else self.id
        self.counts = None
        self._token = _innermost.set(self)
        self._range = torch._C._profiler._RecordFunctionFast(PREFIX + self.name)
        self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        end_ns = time.perf_counter_ns()
        self._range.__exit__(*exc)
        _innermost.reset(self._token)
        with _lock:
            _spans.append(Span(self.name, self.start_ns, end_ns, self.id,
                               self.parent, self.root, self.counts))


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    """Stop recording, unless a torch.profiler session records."""
    global _enabled
    _enabled = False


def span(name: str):
    """A context manager that records the time spent inside it as `name`."""
    if not (_enabled or _profiler_enabled()):
        return _OFF
    return _Open(name)


def spanned(name: str):
    """Decorator: every call of the function is one span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return traced
    return wrap


def count(name: str, n: int) -> None:
    """Add `n` to the counter `name`."""
    if not (_enabled or _profiler_enabled()):
        return
    top = _innermost.get()
    if top is not None:
        if top.counts is None:
            top.counts = {}
        top.counts[name] = top.counts.get(name, 0) + n
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def snapshot() -> tuple[list[Span], dict[str, int]]:
    """The kept spans, oldest first, and the counters' totals."""
    with _lock:
        return list(_spans), dict(_counters)


def clear() -> None:
    with _lock:
        _spans.clear()
        _counters.clear()
