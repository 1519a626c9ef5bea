"""Probe 11 (tools/probe11.py) on the card: P5 and P4's rates.

P5, the bf16 product 2048 × 2048 × 2048 with float32 accumulation and a
bf16 output (the script's `mm`, body `mk`), beside `torch.matmul` on the same
bf16 inputs (the script's XLA baseline), in TFLOP/s; P4, x · 1.000001 over
[65536, 512] float32 (134 MB) in 64 CTAs of 1,024 rows (`cp`, body `ck`), in
GB/s, and over [6144, 512] in 6,144 CTAs of one row (`cp2`), in µs per
CTA-step.
"""

from __future__ import annotations

import numpy as np
import torch

from infinitam_tpu_torch.ops.kernels import probes
from infinitam_tpu_torch.probes import timing

M = N = K = 2048
COPY = (65536, 512, 64)  # rows, row length, CTAs
TINY = (6144, 512)  # rows of one-row CTAs, row length


def make_mm(m: int = M, n: int = N, k: int = K, seed: int = 0):
    """(a [m, k], b [k, n]): normal values (float32; `to_bf16` rounds them)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, k)).astype(np.float32), rng.standard_normal((k, n)).astype(np.float32)


def to_bf16(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a).to(device).to(torch.bfloat16)


def make_copy(rows: int, cols: int = 512, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((rows, cols)).astype(np.float32)


def tflops(m: dict, n_flop: float) -> str:
    ms = m["device_ms"]
    return "" if ms is None else f" -> {n_flop / ms / 1e9:.1f} TFLOP/s"


def run(device, small: bool = False) -> list:
    size = 256 if small else M
    a, b = (to_bf16(x, device) for x in make_mm(size, size, size))
    flop = 2.0 * size ** 3
    out = []
    bm, bn, _bk = probes.GEMM_TILE
    m = timing.measure(lambda: probes.gemm_bf16(a, b), device)
    out.append(timing.line(f"P5 matmul {size}^3 bf16 ({-(-size // bm) * -(-size // bn)} CTAs)", m, tflops(m, flop)))
    m = timing.measure(lambda: torch.matmul(a, b), device, repo_only=False)
    out.append(timing.line(f"library torch.matmul {size}^3 bf16", m, tflops(m, flop)))
    rows, cols, ctas = COPY
    rows //= 64 if small else 1
    x = torch.from_numpy(make_copy(rows, cols)).to(device)
    m = timing.measure(lambda: probes.scaled_copy(x, rows // ctas), device)
    out.append(timing.line(f"P4 copy {x.numel() * 4 / 1e6:.0f}MB ({ctas} CTAs)", m, timing.gbps(2 * x.numel() * 4, m)))
    rows, cols = TINY
    rows //= 64 if small else 1
    y = torch.from_numpy(make_copy(rows, cols, seed=1)).to(device)
    m = timing.measure(lambda: probes.scaled_copy(y, 1), device)
    per_step = "" if m["device_ms"] is None else f" -> {m['device_ms'] * 1e3 / rows:.4f} us/CTA-step"
    out.append(timing.line(f"P4 copy {y.numel() * 4 / 1e6:.1f}MB ({rows} one-row CTAs)", m, per_step))
    return out
