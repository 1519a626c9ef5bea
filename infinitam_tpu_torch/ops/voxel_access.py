"""SDF and colour access combinators over a `read(int_pts)` closure.

Counterpart of infinitam_tpu/ops/voxel_access.py (reference:
DeviceAgnostic/ITMRepresentationAccess.h:144-356, readFromSDF_float_*,
readFromSDF_color4u_interpolated).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

ReadFn = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def read_sdf_uninterpolated(read: ReadFn, pts: torch.Tensor):
    """Nearest-voxel SDF at float voxel coords (ROUND = floor(x + 0.5))."""
    return read(torch.floor(pts + 0.5).to(torch.int32))


def read_sdf_interpolated(read: ReadFn, pts: torch.Tensor):
    """Trilinear SDF over the 8 surrounding voxels. Returns (sdf, found),
    found = all 8 taps found."""
    base = torch.floor(pts)
    coeff = pts - base
    ibase = base.to(torch.int32)
    cx, cy, cz = coeff[..., 0], coeff[..., 1], coeff[..., 2]
    v, f = {}, {}
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                off = torch.stack([ibase[..., 0] + dx, ibase[..., 1] + dy, ibase[..., 2] + dz], dim=-1)
                v[dx, dy, dz], f[dx, dy, dz] = read(off)
    r00 = (1 - cx) * v[0, 0, 0] + cx * v[1, 0, 0]
    r10 = (1 - cx) * v[0, 1, 0] + cx * v[1, 1, 0]
    r01 = (1 - cx) * v[0, 0, 1] + cx * v[1, 0, 1]
    r11 = (1 - cx) * v[0, 1, 1] + cx * v[1, 1, 1]
    r0 = (1 - cy) * r00 + cy * r10
    r1 = (1 - cy) * r01 + cy * r11
    sdf = (1 - cz) * r0 + cz * r1
    found = f[0, 0, 0]
    for k in f.values():
        found = found & k
    return sdf, found


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
