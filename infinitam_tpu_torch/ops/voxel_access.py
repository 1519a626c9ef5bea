"""SDF and colour access combinators over a `read(int_pts)` closure.

Counterpart of infinitam_tpu/ops/voxel_access.py (reference:
DeviceAgnostic/ITMRepresentationAccess.h:144-356, readFromSDF_float_*,
readFromSDF_color4u_interpolated).
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import torch

ReadFn = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def read_sdf_uninterpolated(read: ReadFn, pts: torch.Tensor):
    """Nearest-voxel SDF at float voxel coords (ROUND = floor(x + 0.5))."""
    return read(torch.floor(pts + 0.5).to(torch.int32))


@functools.cache
def _corner_offsets(device: torch.device) -> torch.Tensor:
    """The 8 corner offsets [8, 3] int32, corner k = (dx, dy, dz) with
    k = dx + 2·dy + 4·dz, made on `device` (no copy from the host)."""
    k = torch.arange(8, dtype=torch.int32, device=device)
    return torch.stack([k & 1, (k >> 1) & 1, k >> 2], dim=-1)


def read_sdf_interpolated(read: ReadFn, pts: torch.Tensor):
    """Trilinear SDF over the 8 surrounding voxels. Returns (sdf, found),
    found = all 8 taps found. The 8 taps are one read of the stacked
    corners [8, ..., 3], which gives each tap what a read of its own gives,
    with an eighth of the ops."""
    base = torch.floor(pts)
    coeff = pts - base
    ibase = base.to(torch.int32)
    cx, cy, cz = coeff[..., 0], coeff[..., 1], coeff[..., 2]
    offs = _corner_offsets(pts.device).reshape((8,) + (1,) * (pts.dim() - 1) + (3,))
    v, f = read(ibase[None] + offs)
    r00 = (1 - cx) * v[0] + cx * v[1]
    r10 = (1 - cx) * v[2] + cx * v[3]
    r01 = (1 - cx) * v[4] + cx * v[5]
    r11 = (1 - cx) * v[6] + cx * v[7]
    r0 = (1 - cy) * r00 + cy * r10
    r1 = (1 - cy) * r01 + cy * r11
    return (1 - cz) * r0 + cz * r1, f.all(dim=0)


def read_color_interpolated(read_color: Callable[[torch.Tensor], torch.Tensor], pts: torch.Tensor) -> torch.Tensor:
    """Trilinear RGB [..., 3] at float voxel coords over the 8 surrounding
    voxels; `read_color(int_pts)` → [..., 3]."""
    base = torch.floor(pts)
    coeff = (pts - base)[..., None]
    ibase = base.to(torch.int32)
    out = torch.zeros(pts.shape[:-1] + (3,), dtype=torch.float32, device=pts.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (
                    (coeff[..., 0, :] if dx else 1 - coeff[..., 0, :])
                    * (coeff[..., 1, :] if dy else 1 - coeff[..., 1, :])
                    * (coeff[..., 2, :] if dz else 1 - coeff[..., 2, :])
                )
                off = torch.stack([ibase[..., 0] + dx, ibase[..., 1] + dy, ibase[..., 2] + dz], dim=-1)
                out = out + w * read_color(off)
    return out


def compute_normal_from_sdf(read: ReadFn, pts: torch.Tensor) -> torch.Tensor:
    """The SDF's unnormalised gradient at float voxel coords [..., 3] by
    central differences of the trilinear field, n_i = sdf(p + e_i) −
    sdf(p − e_i) (reference computeSingleNormalFromSDF, which shares the
    corner reads of the same sums)."""
    grads = []
    for axis in range(3):
        e = torch.zeros((3,), dtype=pts.dtype, device=pts.device)
        e[axis] = 1.0
        vp, _ = read_sdf_interpolated(read, pts + e)
        vm, _ = read_sdf_interpolated(read, pts - e)
        grads.append(vp - vm)
    return torch.stack(grads, dim=-1)
