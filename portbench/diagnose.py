"""What a run's `samples` line says about where its time went.

None of this feeds a metric. The keys, beside the window's counts, let
two runs of one cell be compared part by part: whether a run that read
slower lost its time in planning, in the data plane's host side or on
the card, late or early in its window, to the garbage collector or to
the CPU its main thread ran on. The keys are defined in
`portbench/harness.py`'s docstring.
"""
from __future__ import annotations

import ctypes
import gc
import os
import statistics
import time
from collections import Counter

from portbench import timing

try:
    _LIBC = ctypes.CDLL(None)
    _LIBC.sched_getcpu.restype = ctypes.c_int
    _LIBC.sched_getcpu.argtypes = []
except (OSError, AttributeError):
    _LIBC = None


def cpu_list(cpus) -> str:
    """`{0, 1, 2, 3, 8}` -> `0-3,8`, the kernel's own list format."""
    cpus, parts = sorted(cpus), []
    for c in cpus:
        if parts and parts[-1][1] == c - 1:
            parts[-1][1] = c
        else:
            parts.append([c, c])
    return ",".join(f"{a}-{b}" if a != b else f"{a}" for a, b in parts)


def current_cpu() -> int | None:
    """The CPU the calling thread runs on (libc's `sched_getcpu`, the
    number `/proc/thread-self/stat` gives as field 39, without reading a
    file a batch), or None where libc does not say."""
    cpu = _LIBC.sched_getcpu() if _LIBC else -1
    return cpu if cpu >= 0 else None


class Watch:
    """The window's garbage collections and the CPUs it ran on."""

    def __init__(self):
        self.cpus: list[int] = []
        self.collections: list[tuple[int, float]] = []
        self._gc_start = 0.0
        gc.callbacks.append(self._on_gc)

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_start = time.perf_counter()
        else:
            self.collections.append((info["generation"],
                                     time.perf_counter() - self._gc_start))

    def batch_done(self) -> None:
        cpu = current_cpu()
        if cpu is not None:
            self.cpus.append(cpu)

    def close(self, device_type: str) -> dict:
        """Stops watching; the keys that do not come from the batches."""
        gc.callbacks.remove(self._on_gc)
        full = [s for g, s in self.collections if g == 2]
        out = {
            "gc_full": len(full), "gc_full_s": sum(full),
            "gc_young": len(self.collections) - len(full),
            "cpu_affinity": cpu_list(os.sched_getaffinity(0)),
            "cpus_ran_on": {str(c): n for c, n in sorted(Counter(self.cpus).items())},
            "clocks_sm_MHz": None, "temperature_C": None,
        }
        if device_type == "cuda":
            read = timing.nvidia_smi("clocks.sm,temperature.gpu")
            if read:
                clock, temp = (x.strip() for x in read.split(","))
                out["clocks_sm_MHz"] = float(clock.split()[0])
                out["temperature_C"] = float(temp)
        return out


def batches(batches) -> dict:
    """The keys that come from the window's batches."""
    def per_stripe_ms(values):
        return [1e3 * v / b.stripes for v, b in zip(values, batches)]

    plan = per_stripe_ms([b.plan_s for b in batches])
    data = per_stripe_ms([b.dataplane_s for b in batches])
    half = len(batches) // 2
    halves = [part for part in (batches[:half], batches[half:]) if part]
    return {
        "plan_ms_mean": statistics.fmean(plan),
        "plan_ms_median": statistics.median(plan),
        "dataplane_ms_mean": statistics.fmean(data),
        "dataplane_ms_median": statistics.median(data),
        "repair_GBps_halves": [sum(b.lost_bytes for b in part)
                               / (part[-1].end - part[0].start) / 1e9
                               for part in halves],
    }
