"""Probe 12 (tools/probe12.py) on the card: the costs the TPU design rested on.

(0) a tiny add's call time (the dispatch); (a) `torch.take` of 307 k
elements from int32 tables of 1 MB, 8 MB and 134 MB, each beside P1 on the
same inputs; (d) the dense pass x · 1.000001 + 1e-7 over 134 MB float32;
(c) `torch.matmul` 4096³ bf16 (all three the script's XLA baselines, here
the library calls); (b) P4, x · 1.000001 over [49152, 512] float32 (196 MB
of traffic) in 6,144 CTAs of 8 rows, 768 of 64 and 96 of 512 (the script's
`cp`, body `ck`); (b2) P2 without aliasing, row + 1e-9 · tap with the
transposed float32 window tap, NV = 6,144 steps of vba [65536, 512] (the
script's `integ`, body `kern`).
"""

from __future__ import annotations

import numpy as np
import torch

from infinitam_tpu_torch.ops.kernels import probes
from infinitam_tpu_torch.probes import probe10, probe11, timing

S3 = 512
TAKES = ((18, "1MB"), (21, "8MB"), (25, "134MB"))  # log2 of the table's int32 elements
N_TAKE = 307200
COPY_ROWS = 6144 * 8
DECOMPOSITIONS = ((6144, 8), (768, 64), (96, 512))  # CTAs, rows a CTA
FULL, SMALL = (65536, 6144), (512, 64)


def make_copy(rows: int = COPY_ROWS, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((rows, S3)).astype(np.float32)


def integ(fn, vba, depth_t, ptr, wv, wu):
    """The script's `integ` through `fn` (probes.row_update or its plain
    twin): into a fresh output (only the listed rows defined)."""
    return fn(vba, ptr, in_place=False, tap="f32t", img=depth_t, wv=wv, wu=wu, tap_scale=1e-9)


def run(device, small: bool = False) -> list:
    shrink = 64 if small else 1
    out = []
    x0 = torch.zeros((8, 128), device=device)
    out.append(timing.line("dispatch (tiny add)", timing.measure(lambda: x0 + 1.0, device, repo_only=False)))
    rng = np.random.default_rng(0)
    for log_t, name in TAKES:
        n = (1 << log_t) // shrink
        tab = torch.from_numpy(rng.integers(0, n, n, dtype=np.int32)).to(device)
        idx = torch.from_numpy(rng.integers(0, n, N_TAKE // shrink, dtype=np.int32)).to(device)
        idx64 = idx.long()
        out.append(timing.line(f"P1 take {idx.numel() // 1000}k from {name}",
                               timing.measure(lambda: probes.gather(tab, idx), device)))
        out.append(timing.line(f"library torch.take {idx.numel() // 1000}k from {name}",
                               timing.measure(lambda: torch.take(tab, idx64), device, repo_only=False)))
    x = torch.from_numpy(make_copy(65536 // shrink)).to(device)
    m = timing.measure(lambda: x * 1.000001 + 1e-7, device, repo_only=False)
    out.append(timing.line(f"library dense rmw {x.numel() * 4 / 1e6:.0f}MB f32", m, timing.gbps(2 * x.numel() * 4, m)))
    size = 4096 // shrink
    a = torch.from_numpy(rng.standard_normal((size, size)).astype(np.float32)).to(device).to(torch.bfloat16)
    m = timing.measure(lambda: torch.matmul(a, a), device, repo_only=False)
    out.append(timing.line(f"library torch.matmul {size}^3 bf16", m, probe11.tflops(m, 2.0 * size ** 3)))
    y = torch.from_numpy(make_copy(COPY_ROWS // shrink, seed=1)).to(device)
    for _ctas, rows in DECOMPOSITIONS:
        rows_per_cta = max(1, rows // shrink) if small else rows
        m = timing.measure(lambda: probes.scaled_copy(y, rows_per_cta), device)
        n_ctas = y.shape[0] // rows_per_cta
        per_step = "" if m["device_ms"] is None else f", {m['device_ms'] * 1e3 / n_ctas:.4f} us/CTA-step"
        out.append(timing.line(f"P4 copy {2 * y.numel() * 4 / 1e6:.0f}MB grid({n_ctas})x({rows_per_cta},512)", m,
                               timing.gbps(2 * y.numel() * 4, m) + per_step))
    rows, nv = SMALL if small else FULL
    vba, depth_t, ptr, _seq, wv, wu = (torch.from_numpy(a).to(device) for a in probe10.make(rows, nv))
    m = timing.measure(lambda: integ(probes.row_update, vba, depth_t, ptr, wv, wu), device)
    per_step = "" if m["device_ms"] is None else f" -> {m['device_ms'] * 1e3 / nv:.4f} us/CTA-step"
    out.append(timing.line(f"P2 dyn-row integrate {nv} blocks", m, per_step))
    return out
