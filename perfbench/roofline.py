"""The card's peaks and a kernel's least time.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
HBM3 at 3.35 TB/s and 67 TFLOP/s of float32 outside the tensor cores. The
least time of a kernel's work is the larger of its bytes over the first and
its float32 operations over the second, with bytes and operations counted
from what the frame's inputs need (perfbench/reference.py `counts`), not
from what the program happens to move.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12


def least_seconds(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_PER_S)


def least_per_step(counts: list, kernel: str) -> float:
    """Least seconds of `kernel`'s work in one step, from per-lane lists of
    per-frame counts: the lanes of a step summed, the frames averaged."""
    n_frames = len(counts[0])
    total = sum(least_seconds(f[f"{kernel}_bytes"], f[f"{kernel}_ops"]) for lane in counts for f in lane)
    return total / n_frames
