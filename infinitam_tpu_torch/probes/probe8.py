"""Probe 8 (tools/probe8.py) on the card: P2 with the script's five bodies.

On vba [4096, 512] (the script's [B, 8, 64]), NV = 256 steps of distinct
rows, windows of the 512×768 depth image (the script's `attempt`, bodies
k1-k5): K1 row · 1.000001 in place and into a fresh output (K1b), K2 the
same (its reshape round trip is a view here), K3 probe 7's bf16 tap without
`valid`, K4 row + 1e-9 · Σwindow, K5 where(ptr[i] ≥ 0, row · 1.000001,
row). The script's OK/FAIL bisect of the TPU compiler becomes: equal to the
plain twin (the copies bit for bit, the taps within 1e-6; the rows a fresh
output leaves unwritten are not compared), with the time.
"""

from __future__ import annotations

import numpy as np
import torch

from infinitam_tpu_torch.ops.kernels import probes
from infinitam_tpu_torch.probes import plain, timing

S3, WIN = 512, 128
FULL, SMALL = (4096, 256), (512, 32)
# name, row_update arguments, tolerance against the plain twin
ATTEMPTS = (
    ("K1 copy dyn-in dyn-out aliased", dict(mul=1.000001), 0.0),
    ("K1b copy no alias", dict(mul=1.000001, in_place=False), 0.0),
    ("K2 reshape roundtrip", dict(mul=1.000001), 0.0),
    ("K3 window tap (bf16)", dict(tap="bf16", tap_scale=1e-3), 1e-6),
    ("K4 window fetch only (sum)", dict(tap="sum", tap_scale=1e-9), 1e-6),
    ("K5 scalar read + where", dict(gate="ptr", mul=1.000001), 0.0),
)


def make(rows: int, nv: int, seed: int = 0):
    """(vba [rows, 512], depth [512, 768], ptr (distinct rows), wv < 4, wu < 6)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, S3)).astype(np.float32),
            rng.standard_normal((512, 768)).astype(np.float32),
            rng.permutation(rows)[:nv].astype(np.int32),
            rng.integers(0, 4, nv, dtype=np.int32), rng.integers(0, 6, nv, dtype=np.int32))


def attempt(fn, vba, depth, ptr, wv, wu, **kw):
    """One attempt's call through `fn` (probes.row_update or its plain twin)."""
    return fn(vba, ptr, img=depth, wv=wv, wu=wu, **kw)


def run(device, small: bool = False) -> list:
    rows, nv = SMALL if small else FULL
    vba, depth, ptr, wv, wu = (torch.from_numpy(a).to(device) for a in make(rows, nv))
    out = []
    for name, kw, tol in ATTEMPTS:
        got = attempt(probes.row_update, vba.clone(), depth, ptr, wv, wu, **kw)
        want = attempt(plain.row_update, vba.clone(), depth, ptr, wv, wu, **kw)
        seen = ptr.long() if not kw.get("in_place", True) else slice(None)
        err = float((got[seen] - want[seen]).abs().max())
        verdict = "OK (equal to the plain twin)" if err <= tol else f"FAIL (max err {err:.2e} > {tol:g})"
        m = timing.measure(lambda: attempt(probes.row_update, vba, depth, ptr, wv, wu, **kw), device)
        out.append(timing.line(f"{name:32s} {verdict}", m))
        out[-1]["ok"] = err <= tol
    return out
