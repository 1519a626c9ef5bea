"""Probe 6 (tools/probe6.py) on the card.

(a) P1's `take_along_axis` over the script's support matrix of tables
([R, C] ∈ {8, 32, 64, 512, 1024} × {128, 512}; float32, int8, bfloat16; axis
0 and 1), chained K = 32 times with the script's feedback
idx ← (idx + out + k) mod n (`try_dg.call`, body `kern`): per op, the
gather kernel's device time and the chain's call time (gather and
feedback).

(b) The script's XLA menu as the torch ops that compute it, the library
yardsticks: `torch.take` of 307 k elements from tables of 2¹⁸ and 2²⁵ int32
(and of 77 k and 4.8 k from 2²⁵) and of 307 k from 2²⁵ int8, each beside
P1 on the same inputs; a row gather (`index_select`) of 1,024 and 6,144
rows from [65536, 512] int32; a row scatter (`index_copy_`) of 6,144 rows;
`scatter_reduce(amin)` of 307 k values into 4,800; `cumsum` over 1.18 M.
"""

from __future__ import annotations

import numpy as np
import torch

from infinitam_tpu_torch.ops.kernels import probes
from infinitam_tpu_torch.probes import timing

K = 32
# the script's try_dg calls: (R, C, dtype, axis, name)
MATRIX = (
    (8, 128, "float32", 0, "tiny"), (8, 128, "float32", 1, "tiny"), (64, 128, "float32", 0, "med"),
    (512, 128, "float32", 0, "big"), (512, 128, "int8", 0, "big8"), (512, 512, "float32", 0, "wide"),
    (1024, 128, "float32", 0, "huge"), (8, 128, "int8", 1, "tiny8"), (32, 128, "bfloat16", 0, "bf16"),
)
TAKES = ((1 << 18, 307200, "grid"), (1 << 25, 307200, "vol33M"), (1 << 25, 76800, "vol/4px"),
         (1 << 25, 4800, "vol/64px"))
V = 65536  # rows of the row-gather table


def make_dg(rows: int, cols: int, dtype: str, axis: int, seed: int = 0):
    """(table, indices) of a try_dg call: integer values below min(R, 120)
    (float32; `to_table` casts them to `dtype`), int32 indices below the
    axis' length, both [R, C]."""
    rng = np.random.default_rng(seed)
    tab = rng.integers(0, min(rows, 120), (rows, cols)).astype(np.float32)
    return tab, rng.integers(0, rows if axis == 0 else cols, (rows, cols), dtype=np.int32)


def to_table(tab: np.ndarray, dtype: str, device) -> torch.Tensor:
    return torch.from_numpy(tab).to(device).to(getattr(torch, dtype))


def call(tab: torch.Tensor, idx: torch.Tensor, axis: int, k_steps: int = K) -> torch.Tensor:
    """try_dg's `call`: k_steps gathers, each fed back into the indices;
    returns the last indices."""
    n = tab.shape[axis]
    for k in range(k_steps):
        o = probes.gather(tab, idx, axis=axis)
        idx = (idx + o.to(torch.int32) + k) % n
    return idx


def make_take(n_tab: int, n_idx: int, dtype=np.int32, seed: int = 0):
    rng = np.random.default_rng(seed)
    tab = rng.integers(0, n_tab if dtype == np.int32 else 100, n_tab).astype(dtype)
    return tab, rng.integers(0, n_tab, n_idx, dtype=np.int32)


def run(device, small: bool = False) -> list:
    out = []
    for rows, cols, dtype, axis, name in MATRIX:
        tab, idx = make_dg(rows, cols, dtype, axis)
        tab, idx = to_table(tab, dtype, device), torch.from_numpy(idx).to(device)
        m = timing.measure(lambda: call(tab, idx, axis), device, reps=3)
        m = dict(m, device_ms=None if m["device_ms"] is None else m["device_ms"] / K, call_ms=m["call_ms"] / K)
        out.append(timing.line(f"P1 dg {name} [{rows},{cols}] {dtype} axis{axis} (per op)", m))
    shrink = 256 if small else 1
    for n_tab, n_idx, name in TAKES:
        tab, idx = (torch.from_numpy(a).to(device) for a in make_take(n_tab // shrink, n_idx // shrink))
        idx64 = idx.long()
        out.append(timing.line(f"P1 take {n_idx // 1000}k from {name}",
                               timing.measure(lambda: probes.gather(tab, idx), device)))
        out.append(timing.line(f"library torch.take {n_idx // 1000}k from {name}",
                               timing.measure(lambda: torch.take(tab, idx64), device, repo_only=False)))
    tab, idx = (torch.from_numpy(a).to(device) for a in make_take((1 << 25) // shrink, 307200 // shrink, np.int8))
    idx64 = idx.long()
    out.append(timing.line("P1 take 307k int8 from 33M", timing.measure(lambda: probes.gather(tab, idx), device)))
    out.append(timing.line("library torch.take 307k int8 from 33M",
                           timing.measure(lambda: torch.take(tab, idx64), device, repo_only=False)))
    rng = np.random.default_rng(1)
    v = V // shrink
    tab = torch.from_numpy(rng.integers(0, v, (v, 512), dtype=np.int32)).to(device)
    for n_rows in (1024 // shrink, 6144 // shrink):
        rows = torch.from_numpy(rng.integers(0, v, n_rows)).to(device)
        out.append(timing.line(f"library index_select {n_rows}x512 i32 from [{v},512]",
                               timing.measure(lambda: tab.index_select(0, rows), device, repo_only=False)))
    vals = torch.from_numpy(rng.integers(0, v, (rows.numel(), 512), dtype=np.int32)).to(device)
    out.append(timing.line(f"library index_copy_ {rows.numel()}x512 i32 into [{v},512]",
                           timing.measure(lambda: tab.index_copy_(0, rows, vals), device, repo_only=False)))
    img = torch.zeros(4800, device=device)
    sidx = torch.from_numpy(rng.integers(0, 4800, 307200 // shrink)).to(device)
    svals = torch.from_numpy(rng.standard_normal(307200 // shrink).astype(np.float32)).to(device)
    out.append(timing.line(f"library scatter_reduce(amin) {307200 // shrink // 1000}k into 4800",
                           timing.measure(lambda: img.scatter_reduce(0, sidx, svals, "amin"), device,
                                          repo_only=False)))
    mask = torch.from_numpy(rng.integers(0, 2, 0x120000 // shrink, dtype=np.int32)).to(device)
    out.append(timing.line(f"library cumsum {mask.numel() / 1e6:.2f}M",
                           timing.measure(lambda: torch.cumsum(mask, 0), device, repo_only=False)))
    return out
