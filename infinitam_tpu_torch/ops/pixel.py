"""Bilinear image sampling, plain and hole-aware, over whole sample grids.

Counterpart of infinitam_tpu/ops/pixel.py (reference: ITMPixelUtils.h:11-93).
Images are [H, W] or [H, W, C]; sample coordinates are float tensors of any
matching shape. Vec4 images flag holes with channel 3 ("w") < 0.
"""

from __future__ import annotations

import torch


def _gather2d(img: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor) -> torch.Tensor:
    """img[iy, ix] with clamped indices. img: [H, W, ...]."""
    H, W = img.shape[0], img.shape[1]
    return img[iy.clamp(0, H - 1).long(), ix.clamp(0, W - 1).long()]


def _corners(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = x - x0
    dy = y - y0
    ix, iy = x0.to(torch.int32), y0.to(torch.int32)
    a = _gather2d(img, ix, iy)
    b = _gather2d(img, ix + 1, iy)
    c = _gather2d(img, ix, iy + 1)
    d = _gather2d(img, ix + 1, iy + 1)
    return a, b, c, d, dx, dy


def _blend(a, b, c, d, dx, dy):
    # left-to-right evaluation order of the reference expression
    return a * (1 - dx) * (1 - dy) + b * dx * (1 - dy) + c * (1 - dx) * dy + d * dx * dy


def bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain bilinear interpolation. Returns shape x.shape (+ channels)."""
    a, b, c, d, dx, dy = _corners(img, x, y)
    if img.ndim > 2:
        dx = dx[..., None]
        dy = dy[..., None]
    return _blend(a, b, c, d, dx, dy)


def bilinear_with_holes_vec(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Hole-aware bilinear for [H, W, 4] maps whose w-channel flags validity.

    Returns (value [..., 4], valid bool). Any invalid corner invalidates the
    sample (reference: interpolateBilinear_withHoles, all-four gate)."""
    a, b, c, d, dx, dy = _corners(img, x, y)
    valid = (a[..., 3] >= 0) & (b[..., 3] >= 0) & (c[..., 3] >= 0) & (d[..., 3] >= 0)
    return _blend(a, b, c, d, dx[..., None], dy[..., None]), valid


def bilinear_with_holes_scalar(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Hole-aware bilinear for scalar maps (negative = hole), as the
    reference's interpolateBilinear_withHoles_single: a corner with zero
    weight does not invalidate the sample. Returns (value, −1 where
    invalid; valid bool)."""
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = x - x0
    dy = y - y0
    ix, iy = x0.to(torch.int32), y0.to(torch.int32)
    zero = torch.zeros_like(dx)
    a = _gather2d(img, ix, iy)
    b = torch.where(dx != 0, _gather2d(img, ix + 1, iy), zero)
    c = torch.where(dy != 0, _gather2d(img, ix, iy + 1), zero)
    d = torch.where((dx != 0) & (dy != 0), _gather2d(img, ix + 1, iy + 1), zero)
    valid = (a >= 0) & (b >= 0) & (c >= 0) & (d >= 0)
    return torch.where(valid, _blend(a, b, c, d, dx, dy), torch.full_like(dx, -1.0)), valid


def in_bounds(x: torch.Tensor, y: torch.Tensor, width: int, height: int, margin: int = 0) -> torch.Tensor:
    """Pixel-coordinate bounds check with an optional safety margin."""
    return (x >= margin) & (x < width - 1 - margin) & (y >= margin) & (y < height - 1 - margin)
