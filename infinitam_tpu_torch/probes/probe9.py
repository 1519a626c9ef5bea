"""Probe 9 (tools/probe9.py) on the card.

The integrate pattern (the script's `run`, body `kernel`): P2 in place on
vba [B, 512] with probe 7's update in float32 through the transposed window
depthT[wu·128 + du, wv·128 + dv] of depthT [768, 512], kept where valid[i];
held to the plain twin (the script's `oracle`) at B = 512, NV = 64, then
timed at B = 65,536, NV = 6,144.

The page accumulator (`run_acc`, body `kacc`): P3, out[t] = Σ_{k<16}
pages[p[16t + k]] for NT = 600 tiles of pages [4096, 512]; held to the plain
twin and timed. (The script's own call passes `scratch_shapes` beside a
`grid_spec`, which jax 0.9 refuses; its body is sound, and this is what it
computes.)
"""

from __future__ import annotations

import numpy as np
import torch

from infinitam_tpu_torch.ops.kernels import probes
from infinitam_tpu_torch.probes import plain, timing

S3, WIN = 512, 128
K = 16  # pages a tile
FULL, SMALL = (65536, 6144), (512, 64)
PAGES = (4096, 600)  # pages, tiles


def make(rows: int, nv: int, seed: int = 0):
    """(vba [rows, 512], depthT [768, 512], ptr (distinct), wv < 4, wu < 6, valid)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, S3)).astype(np.float32),
            rng.standard_normal((768, 512)).astype(np.float32),
            rng.permutation(rows)[:nv].astype(np.int32),
            rng.integers(0, 4, nv, dtype=np.int32), rng.integers(0, 6, nv, dtype=np.int32),
            (np.arange(nv) % 7 != 3).astype(np.int32))


def update(fn, vba, depth_t, ptr, wv, wu, valid):
    """The script's `run` through `fn` (probes.row_update or its plain twin)."""
    return fn(vba, ptr, tap="f32t", img=depth_t, wv=wv, wu=wu, gate="valid", valid=valid, tap_scale=1e-3)


def make_pages(n_pages: int = PAGES[0], n_tiles: int = PAGES[1], seed: int = 0):
    """(pages [n_pages, 512] float32, p [n_tiles · 16] int32)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n_pages, S3)).astype(np.float32),
            rng.integers(0, n_pages, n_tiles * K, dtype=np.int32))


def accumulate(fn, pages, p):
    """The script's `run_acc` through `fn` (probes.page_sum or its plain
    twin): [tiles, 512]."""
    return fn(pages, p.reshape(-1, K), K, S3)


def run(device, small: bool = False) -> list:
    args = [torch.from_numpy(a).to(device) for a in make(*SMALL)]
    got = update(probes.row_update, args[0].clone(), *args[1:])
    want = update(plain.row_update, args[0].clone(), *args[1:])
    print(f"integrate-pattern max err = {float((got - want).abs().max()):.2e}", flush=True)
    rows, nv = SMALL if small else FULL
    args = [torch.from_numpy(a).to(device) for a in make(rows, nv)]
    m = timing.measure(lambda: update(probes.row_update, *args), device)
    out = [timing.line(f"P2 integrate-pattern {nv} blocks", m, timing.gbps(2 * nv * S3 * 4, m))]
    pages, p = (torch.from_numpy(a).to(device) for a in make_pages(*(PAGES if not small else (256, 40))))
    got = accumulate(probes.page_sum, pages, p)
    want = accumulate(plain.page_sum, pages, p)
    print(f"page-accumulator max err = {float((got - want).abs().max()):.2e}", flush=True)
    out.append(timing.line(f"P3 page-accumulator {p.numel() // K}x{K} pages",
                           timing.measure(lambda: accumulate(probes.page_sum, pages, p), device)))
    return out
