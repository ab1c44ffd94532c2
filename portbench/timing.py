"""Peaks of the card and its power limit, for the rooflines.

From the port's `chip_smoke.py`: `nvidia_smi` as it is, and the memory
terms of `peak_rates` and `bound` (both kernels here are bound by
bytes): the published HBM rate of the H100 (NVIDIA's data sheet: SXM
3.35e12 B/s, PCIe 2.0e12 B/s), stated beside the card's power limit.
"""
from __future__ import annotations

import subprocess


def nvidia_smi(query: str) -> str | None:
    """One `nvidia-smi --query-gpu` field of card 0, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if lines else None


def hbm_bytes_per_s(device_name: str) -> float:
    return 2.0e12 if "PCIe" in device_name else 3.35e12


def least_seconds(nbytes: float, device_name: str) -> float:
    """The least time the card's memory could move `nbytes` in."""
    return nbytes / hbm_bytes_per_s(device_name)
