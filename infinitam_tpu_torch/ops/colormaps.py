"""Display colormaps for depth, normal and weight images (counterpart of
infinitam_tpu/ops/colormaps.py; reference: DepthToUchar4, NormalToUchar4,
WeightToUchar4, ITMVisualisationEngine.cpp:19-107). The min/max are device
reductions, so a colormap reads nothing back to the host."""

from __future__ import annotations

import torch


def _base(val: torch.Tensor) -> torch.Tensor:
    """Jet ramp (reference `base`): 0 below −0.75, up to 1 by −0.25, flat to
    0.25, down to 0 by 0.75."""
    up = (val + 0.75) / 0.5
    down = 1.0 - (val - 0.25) / 0.5
    return torch.minimum(up, down).clamp(0.0, 1.0)


def depth_to_uchar4(depth: torch.Tensor) -> torch.Tensor:
    """Rainbow depth [H, W, 4] uint8: valid (> 0) depths normalised over
    their min/max through the jet ramp at offsets (−.5, 0, +.5); invalid
    pixels black."""
    d = depth.to(torch.float32)
    valid = d > 0.0
    lo = torch.where(valid, d, torch.full_like(d, 1e5)).amin()
    hi = torch.where(valid, d, torch.full_like(d, -1e5)).amax()
    span = hi - lo
    scale = torch.where(span != 0.0, 1.0 / torch.where(span != 0.0, span, torch.ones_like(span)), 1.0 / hi)
    t = (d - lo) * scale
    rgba = torch.stack([_base(t - 0.5), _base(t), _base(t + 0.5), torch.ones_like(t)], dim=-1)
    rgba = torch.where(valid[..., None] & (span != 0.0), rgba, torch.zeros_like(rgba))
    return (rgba * 255.0).to(torch.uint8)


def normal_to_uchar4(normals: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Normal map [H, W, 4] uint8: 0.3 + (n + 1)·0.35 a channel. normals
    [H, W, 3], valid [H, W] bool."""
    shade = 0.3 + (normals.to(torch.float32) + 1.0) * 0.35
    rgba = torch.cat([shade, torch.zeros_like(shade[..., :1])], dim=-1)
    rgba = torch.where(valid[..., None], rgba, torch.zeros_like(rgba))
    return (rgba.clamp(0.0, 1.0) * 255.0).to(torch.uint8)


def weight_to_uchar4(weights: torch.Tensor) -> torch.Tensor:
    """Confidence [H, W, 4] uint8: s = min_valid/w·0.8 + 0.2, red 1 − s,
    green s."""
    w = weights.to(torch.float32)
    valid = w > 0.0
    mn = torch.where(valid, w, torch.full_like(w, 1000.0)).amin()
    s = mn / torch.where(valid, w, torch.ones_like(w)) * 0.8 + 0.2
    zero = torch.zeros_like(s)
    rgba = torch.stack([1.0 - s, s, zero, zero], dim=-1)
    rgba = torch.where(valid[..., None], rgba, torch.zeros_like(rgba))
    return (rgba.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
