"""Reduce a torch.profiler window to device time, busy time and gaps.

Host stages are marked with `torch.profiler.record_function` under names
that start with `PREFIX`; the profiler may also show them as device-side
annotations, which are not device work and are left out.
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path

import torch

PREFIX = "portbench."
_GLOBAL = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)\s+)?"
                     r"(?:void\s+)?(\w+)\s*\(")


@dataclasses.dataclass
class Profile:
    ops: list[tuple[str, float, float]]     # device ops: (name, start_s, seconds)
    stages: list[tuple[str, float, float]]  # host stages: (name, start_s, end_s)
    span: tuple[float, float]               # the traced window on the same clock


def port_kernel_names(csrc: Path) -> tuple[str, ...]:
    """The names of the port's own CUDA kernels, read from its sources."""
    names = set()
    for src in sorted(csrc.glob("*.cu")):
        names.update(_GLOBAL.findall(src.read_text()))
    return tuple(sorted(names))


def reduce(prof, window: str) -> Profile:
    """Device ops and host stages of a profiler run; `window` names the
    stage that spans the traced window."""
    ops, stages = [], []
    for ev in prof.events():
        start, end = ev.time_range.start / 1e6, ev.time_range.end / 1e6
        if ev.name.startswith(PREFIX):
            if ev.device_type == torch.autograd.DeviceType.CPU:
                stages.append((ev.name[len(PREFIX):], start, end))
        elif ev.device_type == torch.autograd.DeviceType.CUDA:
            ops.append((ev.name, start, end - start))
    span = next(((s, e) for name, s, e in stages if name == window), None)
    if span is None:
        raise RuntimeError(f"no '{PREFIX}{window}' range in the profile")
    return Profile(ops=ops, stages=stages, span=span)


def busy_intervals(ops) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for _, start, seconds in sorted(ops, key=lambda op: op[1]):
        end = start + seconds
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def busy_seconds(ops) -> float:
    """Seconds in which some operation ran on the device."""
    return sum(b - a for a, b in busy_intervals(ops))


def idle_gaps(profile: Profile) -> list[tuple[str, float]]:
    """Idle stretches of the device inside the window, each named by the
    innermost host stage that holds its midpoint, longest first."""
    lo, hi = profile.span
    gaps, t = [], lo
    for a, b in busy_intervals(profile.ops):
        if a > t:
            gaps.append((t, min(a, hi)))
        t = max(t, b)
    if t < hi:
        gaps.append((t, hi))
    named = []
    for a, b in gaps:
        if b <= a:
            continue
        mid = (a + b) / 2
        holding = [(e - s, name) for name, s, e in profile.stages
                   if s <= mid <= e and (s, e) != profile.span]
        named.append((min(holding)[1] if holding else "other", b - a))
    return sorted(named, key=lambda g: -g[1])


def seconds_by_name(ops) -> dict[str, float]:
    out: dict[str, float] = {}
    for name, _, seconds in ops:
        out[name] = out.get(name, 0.0) + seconds
    return out
