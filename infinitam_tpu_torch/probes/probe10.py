"""Probe 10 (tools/probe10.py) on the card: what a P2 step costs.

The script's `attempt` (body `kern`) over vba [65536, 512] (its
[B, 1, 512]), NV = 6,144 steps: out = (row [+ 1e-3 · tap]) · 1.000001 with
static (row i) or dynamic (row ptr[i]) maps, in place ("alias") or into a
fresh output, with or without the transposed float32 window tap ("matmul",
the script's one-hot product). The window fetch without a tap and the
`arbitrary` dimension semantics have no counterpart on the card (a load is
made where a tap reads; CTAs run in no order anyway): those attempts run
the same kernel as their plain twins. The script's µs per grid step
becomes µs per CTA-step: the device time over NV. The two static-map copies
are also one library call each, timed beside them: rows 0 … NV − 1 of vba
times 1.000001, in place (`mul_`) or into a new tensor (`torch.mul`).
"""

from __future__ import annotations

import numpy as np
import torch

from infinitam_tpu_torch.ops.kernels import probes
from infinitam_tpu_torch.probes import timing

S3 = 512
FULL, SMALL = (65536, 6144), (512, 64)
# the script's attempts: name, (dynamic maps, in place, tap)
ATTEMPTS = (
    ("copy static-in static-out no-alias", (False, False, False)),
    ("copy static-in static-out alias", (False, True, False)),
    ("copy dyn-in dyn-out alias", (True, True, False)),
    ("copy dyn-in dyn-out alias arbitrary", (True, True, False)),
    ("copy dyn-in dyn-out no-alias", (True, False, False)),
    ("copy+window dyn alias", (True, True, False)),
    ("matmul+window dyn alias", (True, True, True)),
    ("matmul+window static no-alias", (False, False, True)),
)

# the library call that computes an attempt, as a function of (vba, NV)
LIBRARY = {
    "copy static-in static-out alias": lambda vba, nv: vba[:nv].mul_(1.000001),
    "copy static-in static-out no-alias": lambda vba, nv: torch.mul(vba[:nv], 1.000001),
}


def make(rows: int, nv: int, seed: int = 0):
    """(vba [rows, 512], depthT [768, 512], ptr (distinct), seq, wv < 4, wu < 6)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, S3)).astype(np.float32),
            rng.standard_normal((768, 512)).astype(np.float32),
            rng.permutation(rows)[:nv].astype(np.int32), np.arange(nv, dtype=np.int32),
            rng.integers(0, 4, nv, dtype=np.int32), rng.integers(0, 6, nv, dtype=np.int32))


def attempt(fn, vba, depth_t, ptr, seq, wv, wu, dynamic: bool, in_place: bool, tap: bool):
    """One attempt through `fn` (probes.row_update or its plain twin)."""
    taps = dict(tap="f32t", img=depth_t, wv=wv, wu=wu, tap_scale=1e-3) if tap else {}
    return fn(vba, ptr if dynamic else seq, in_place=in_place, src_ptr=dynamic, dst_ptr=dynamic, mul=1.000001,
              **taps)


def run(device, small: bool = False) -> list:
    rows, nv = SMALL if small else FULL
    args = [torch.from_numpy(a).to(device) for a in make(rows, nv)]
    out = []
    for name, flags in ATTEMPTS:
        m = timing.measure(lambda: attempt(probes.row_update, *args, *flags), device)
        per_step = "" if m["device_ms"] is None else f"  ({m['device_ms'] * 1e3 / nv:7.4f} us/CTA-step)"
        out.append(timing.line(name, m, per_step))
    for name, library in LIBRARY.items():
        out.append(timing.line(f"library {name}", timing.measure(lambda: library(args[0], nv), device,
                                                                 repo_only=False)))
    return out
