"""Image pyramids and gradients (counterpart of infinitam_tpu/ops/pyramid.py;
reference: ITMLowLevelEngine.h filterSubsample, filterSubsampleWithHoles,
gradientX, gradientY)."""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F


def subsample_box(img: torch.Tensor) -> torch.Tensor:
    """Plain 2× box-filter subsample (rgb images). [H, W, ...] → [H/2, W/2, ...]."""
    H, W = img.shape[0], img.shape[1]
    v = img[: H - H % 2, : W - W % 2].reshape(H // 2, 2, W // 2, 2, *img.shape[2:])
    return v.mean(dim=(1, 3))


def subsample_with_holes(img: torch.Tensor) -> torch.Tensor:
    """Hole-aware 2× subsample of a scalar map (values <= 0 are holes).

    Averages the valid pixels of each 2×2 cell; all-invalid cells output 0
    (the reference writes 0.0, not −1, for empty cells)."""
    H, W = img.shape
    v = img[: H - H % 2, : W - W % 2].reshape(H // 2, 2, W // 2, 2)
    good = v > 0.0
    cnt = good.sum(dim=(1, 3))
    s = torch.where(good, v, torch.zeros_like(v)).sum(dim=(1, 3))
    return torch.where(cnt > 0, s / cnt.clamp(min=1), torch.zeros_like(s))


def subsample_with_holes_vec(img: torch.Tensor) -> torch.Tensor:
    """Hole-aware 2× subsample of a [H, W, 4] map (w < 0 = hole): the mean
    of each 2×2 cell's valid pixels; all-invalid cells get w = −1
    (reference filterSubsampleWithHoles, Vector4f)."""
    H, W = img.shape[0], img.shape[1]
    v = img[: H - H % 2, : W - W % 2].reshape(H // 2, 2, W // 2, 2, 4)
    good = v[..., 3] >= 0
    cnt = good.sum(dim=(1, 3))
    s = torch.where(good[..., None], v, torch.zeros_like(v)).sum(dim=(1, 3))
    out = torch.where((cnt > 0)[..., None], s / cnt.clamp(min=1)[..., None], torch.zeros_like(s))
    return torch.cat([out[..., :3], torch.where(cnt > 0, out[..., 3], -1.0)[..., None]], dim=-1)


def build_depth_pyramid(depth: torch.Tensor, n_levels: int) -> List[torch.Tensor]:
    """Fine→coarse hole-aware depth pyramid (level 0 = input)."""
    levels = [depth]
    for _ in range(n_levels - 1):
        levels.append(subsample_with_holes(levels[-1]))
    return levels


def _pad_hw(img: torch.Tensor) -> torch.Tensor:
    """Zero-pad the two leading (image) dimensions by one pixel."""
    return F.pad(img, (0, 0) * (img.dim() - 2) + (1, 1, 1, 1))


def _zero_border(img: torch.Tensor) -> torch.Tensor:
    H, W = img.shape[:2]
    ys = torch.arange(H, device=img.device)[:, None]
    xs = torch.arange(W, device=img.device)[None, :]
    mask = (ys >= 1) & (ys < H - 1) & (xs >= 1) & (xs < W - 1)
    if img.dim() > 2:
        mask = mask[..., None]
    return torch.where(mask, img, torch.zeros_like(img))


def gradient_x(img: torch.Tensor) -> torch.Tensor:
    """Sobel-style horizontal gradient ([−1 0 1] ⊗ [1 2 1]ᵀ)/8 per channel,
    one-pixel border 0. [H, W(, C)] → same shape."""
    p = _pad_hw(img)
    d1 = p[:-2, 2:] - p[:-2, :-2]
    d2 = p[1:-1, 2:] - p[1:-1, :-2]
    d3 = p[2:, 2:] - p[2:, :-2]
    return _zero_border((d1 + 2 * d2 + d3) / 8.0)


def gradient_y(img: torch.Tensor) -> torch.Tensor:
    """Sobel-style vertical gradient, one-pixel border 0."""
    p = _pad_hw(img)
    d1 = p[2:, :-2] - p[:-2, :-2]
    d2 = p[2:, 1:-1] - p[:-2, 1:-1]
    d3 = p[2:, 2:] - p[:-2, 2:]
    return _zero_border((d1 + 2 * d2 + d3) / 8.0)


def build_rgb_pyramid(rgb: torch.Tensor, n_levels: int) -> List[torch.Tensor]:
    """Fine→coarse box-filter pyramid of an rgb image (level 0 = input)."""
    levels = [rgb]
    for _ in range(n_levels - 1):
        levels.append(subsample_box(levels[-1]))
    return levels
