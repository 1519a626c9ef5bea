"""Probe 13 (tools/probe13.py) on the card: the last primitives of the
VMEM-resident design.

(a, b, d) the raycast skeleton (the script's `rc`, body `rk`): P3 over an
int8 volume [8192, 512], out[t, r] = 1e-6 · Σ_{k<48} f32(vol[pid[t, k],
(17r + t) mod 512]) for r < 128 and 1,200 tiles, with pid [1200, 1, 64]
(48 used); (a2) the window column sums (`wc`, body `wk`): P6, 1,200 tiles of
64×64 windows of a 512×768 float32 image at the tiles' starts, padded to
128 columns; (c) the in-place row stores (`sc`, body `sk`): P2 on int8 rows,
vol[r] += 1 with int8 wrap-around for 4,096 listed rows, once for a row
listed several times (the rows come from `randint`, so they repeat).
"""

from __future__ import annotations

import numpy as np
import torch

from infinitam_tpu_torch.ops.kernels import probes
from infinitam_tpu_torch.probes import timing

NB, S3, NT, KP = 8192, 512, 1200, 48
H2, W2 = 512, 768
NVV = 4096


def make_volume(nb: int = NB, nt: int = NT, seed: int = 0):
    """(vol [nb, 512] int8 in [-100, 100), pid [nt, 1, 64] int32 < nb)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-100, 100, (nb, S3)).astype(np.int8),
            rng.integers(0, nb, (nt, 1, 64), dtype=np.int32))


def make_window(nt: int = NT, seed: int = 0):
    """(img [512, 768] float32, starts [nt, 1, 64] int32 in [0, 400))."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((H2, W2)).astype(np.float32),
            rng.integers(0, 400, (nt, 1, 64), dtype=np.int32))


def make_rows(nb: int = NB, nv: int = NVV, seed: int = 0) -> np.ndarray:
    """rows [nv] int32 < nb, drawn with repeats."""
    return np.random.default_rng(seed).integers(0, nb, nv, dtype=np.int32)


def raycast_skeleton(fn, vol, pid):
    """The script's `rc` through `fn` (probes.page_sum or its plain twin):
    [tiles, 128]."""
    return fn(vol, pid.reshape(pid.shape[0], -1), KP, 128, scale=1e-6, hashed=True)


def window_sums(fn, img, starts):
    """The script's `wc` through `fn` (probes.window_sums or its plain
    twin): [tiles, 128]."""
    return fn(img, starts.reshape(starts.shape[0], -1))


def row_stores(fn, vol, rows):
    """The script's `sc` through `fn` (probes.row_update or its plain twin),
    in place: vol[r] += 1 once a listed row."""
    return fn(vol, rows, gate="first")


def run(device, small: bool = False) -> list:
    nb, nt, nv = (NB // 16, NT // 16, NVV // 16) if small else (NB, NT, NVV)
    vol, pid = (torch.from_numpy(a).to(device) for a in make_volume(nb, nt))
    m = timing.measure(lambda: raycast_skeleton(probes.page_sum, vol, pid), device)
    per = "" if m["device_ms"] is None else f" ({m['device_ms'] * 1e3 / nt:.4f} us/tile)"
    out = [timing.line(f"P3 raycast-skeleton {nt} tiles x {KP} pages", m, per)]
    img, starts = (torch.from_numpy(a).to(device) for a in make_window(nt))
    m = timing.measure(lambda: window_sums(probes.window_sums, img, starts), device)
    per = "" if m["device_ms"] is None else f" ({m['device_ms'] * 1e3 / nt:.4f} us/tile)"
    out.append(timing.line(f"P6 dyn-window-slice {nt} tiles", m, per))
    rows = torch.from_numpy(make_rows(nb, nv)).to(device)
    m = timing.measure(lambda: row_stores(probes.row_update, vol, rows), device)
    per = "" if m["device_ms"] is None else f" ({m['device_ms'] * 1e3 / nv:.4f} us/row)"
    out.append(timing.line(f"P2 inplace dyn-stores {nv} rows (int8 +1)", m, per))
    return out
