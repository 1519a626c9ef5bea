"""Probe 2 (tools/probe2.py) on the card: P1's gathers.

Test A: `take` of 256 k indices from a 262 k and a 512 k float32 table
(the script's `callA`, `kA`); test B: `take_along_axis` on axis 0 of a
[1024, 128] float32 table by [8, 128] indices (`callB`, `kB`); tests C
and D: `take` from a 2 M int8 and a 262 k int32 table (zeros, as the script
has them); test E: the library call `torch.take` on test A's first inputs
(the script's XLA baseline).
"""

from __future__ import annotations

import numpy as np
import torch

from infinitam_tpu_torch.ops.kernels import probes
from infinitam_tpu_torch.probes import timing

N_IDX = 256 * 1024
# (name, table elements, table dtype, index range)
TAKES = (
    ("P1 take 256k from 262k-f32 table", 262144, np.float32, 262144),
    ("P1 take 256k from 512k-f32 table", 512 * 1024, np.float32, 512 * 1024),
    ("P1 take 256k from 2M-int8 table", 1 << 21, np.int8, 512 * 1024),
    ("P1 take 256k from 262k-i32 table", 262144, np.int32, 262144),
)
ALONG = (1024, 128, 8)  # test B: table rows, columns, index rows


def make_take(n_tab: int, dtype, n_range: int, n_idx: int = N_IDX, seed: int = 0):
    """(table, indices): a normal float32 table, or zeros of an integer
    type as the script's tests C and D; int32 indices below n_range."""
    rng = np.random.default_rng(seed)
    tab = rng.standard_normal(n_tab).astype(np.float32) if dtype == np.float32 else np.zeros(n_tab, dtype)
    return tab, rng.integers(0, n_range, n_idx, dtype=np.int32)


def make_along(rows: int = ALONG[0], cols: int = ALONG[1], idx_rows: int = ALONG[2], seed: int = 0):
    """(table [rows, cols] float32, indices [idx_rows, cols] int32 < rows)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, cols)).astype(np.float32),
            rng.integers(0, rows, (idx_rows, cols), dtype=np.int32))


def run(device, small: bool = False) -> list:
    scale = 64 if small else 1
    out, first = [], None
    for name, n_tab, dtype, n_range in TAKES:
        tab, idx = (torch.from_numpy(a).to(device)
                    for a in make_take(n_tab // scale, dtype, n_range // scale, N_IDX // scale))
        first = first or (tab, idx)
        m = timing.measure(lambda: probes.gather(tab, idx), device)
        out.append(timing.line(name, m, timing.gbps(idx.numel() * (4 + tab.element_size()), m)))
    tab, idx = (torch.from_numpy(a).to(device) for a in make_along())
    out.append(timing.line("P1 take_along_axis ax0 [1024,128] by [8,128]",
                           timing.measure(lambda: probes.gather(tab, idx, axis=0), device)))
    tab, idx = first[0], first[1].long()
    out.append(timing.line("library torch.take 256k from 262k table",
                           timing.measure(lambda: torch.take(tab, idx), device, repo_only=False)))
    return out
