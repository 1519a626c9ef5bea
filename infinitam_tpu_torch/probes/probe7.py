"""Probe 7 (tools/probe7.py) on the card: P2's in-place row update with a
bf16 window tap.

For step i of NV, row vba[ptr[i]] += 1e-3 · tap_k where tap_k =
bf16(depth[wv[i]·128 + dv_k, wu[i]·128 + du_k]), dv_k = (3k + i) mod 128,
du_k = 7·dv_k mod 128, kept only where valid[i] (the script's `run`, body
`kernel`); in place on vba [B, 512]. The script's correctness case (B = 512,
NV = 64) is held to the plain twin (its `oracle`), then the full case
(B = 65,536, NV = 6,144) is timed, and the relayout the TPU paid for
([B, 512] → [B, 8, 64], a view here) is timed as `reshape + 1.0`.
"""

from __future__ import annotations

import numpy as np
import torch

from infinitam_tpu_torch.ops.kernels import probes
from infinitam_tpu_torch.probes import plain, timing

S3, WIN = 512, 128
H, W = 480, 640
NWV, NWU = H // WIN + 1, W // WIN + 1  # the window grid over the padded image
FULL, SMALL = (65536, 6144), (512, 64)


def make(rows: int, nv: int, seed: int = 0):
    """(vba [rows, 512], depth [512, 768], ptr, wv, wu, valid [nv]): ptr a
    prefix of a permutation of the rows (distinct), valid 0 on every
    seventh step from the fourth."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, S3)).astype(np.float32),
            rng.standard_normal((NWV * WIN, NWU * WIN)).astype(np.float32),
            rng.permutation(rows)[:nv].astype(np.int32),
            rng.integers(0, NWV, nv, dtype=np.int32), rng.integers(0, NWU, nv, dtype=np.int32),
            (np.arange(nv) % 7 != 3).astype(np.int32))


def update(fn, vba, depth, ptr, wv, wu, valid):
    """The script's `run` through `fn` (probes.row_update or its plain twin):
    the update in place."""
    return fn(vba, ptr, tap="bf16", img=depth, wv=wv, wu=wu, gate="valid", valid=valid, tap_scale=1e-3)


def run(device, small: bool = False) -> list:
    args = [torch.from_numpy(a).to(device) for a in make(*SMALL)]
    got = update(probes.row_update, args[0].clone(), *args[1:])
    want = update(plain.row_update, args[0].clone(), *args[1:])
    print(f"correctness max err = {float((got - want).abs().max()):.2e}", flush=True)
    rows, nv = SMALL if small else FULL
    args = [torch.from_numpy(a).to(device) for a in make(rows, nv)]
    m = timing.measure(lambda: update(probes.row_update, *args), device)
    out = [timing.line(f"P2 mini-integrate {nv} blocks", m, timing.gbps(2 * nv * S3 * 4, m))]
    v = args[0]
    out.append(timing.line(f"library reshape+add [{rows},512]->[B,8,64]",
                           timing.measure(lambda: v.reshape(rows, 8, 64) + 1.0, device, repo_only=False)))
    return out
