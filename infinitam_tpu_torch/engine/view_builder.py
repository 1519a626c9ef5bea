"""View building: raw sensor frames → metric-depth View (counterpart of
infinitam_tpu/engine/view_builder.py; reference: ITMViewBuilder UpdateView —
depth conversion, optional 5× bilateral filtering, optional normals and
depth uncertainty for the weighted ICP tracker).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from infinitam_tpu_torch.calib import DISPARITY_KINECT, RGBDCalib
from infinitam_tpu_torch.config import Settings
from infinitam_tpu_torch.ops import view_ops

N_FILTER_PASSES = 5  # the reference's ping-pong passes (ITMViewBuilder_CPU.cpp:66-81)


class View(NamedTuple):
    """Per-frame input (reference: ITMView)."""

    depth: torch.Tensor  # [H, W] metric depth, −1 invalid
    rgb: Optional[torch.Tensor] = None  # [H, W, 3] float 0..1
    depth_normals: Optional[torch.Tensor] = None  # [H, W, 4] (WICP)
    depth_uncertainty: Optional[torch.Tensor] = None  # [H, W] σ_z (WICP)


def _finish_view(depth: torch.Tensor, settings: Settings, calib: RGBDCalib, rgb: Optional[torch.Tensor]) -> View:
    """The filter, the normals and σ_z as the settings ask, and rgb as 0..1."""
    if settings.use_bilateral_filter:
        for _ in range(N_FILTER_PASSES):
            depth = view_ops.bilateral_filter_depth(depth)
    normals = sigma = None
    if settings.model_sensor_noise:
        normals, sigma = view_ops.compute_normals_and_weights(depth, calib.intrinsics_d)
    if rgb is not None and rgb.dtype != torch.float32:
        rgb = rgb.to(torch.float32) / 255.0
    return View(depth=depth, rgb=rgb, depth_normals=normals, depth_uncertainty=sigma)


def build_view(
    raw_depth: torch.Tensor,  # [H, W] raw sensor values (disparity or mm)
    calib: RGBDCalib,
    settings: Settings,
    rgb: Optional[torch.Tensor] = None,  # [H, W, 3] uint8 or float
) -> View:
    """UpdateView: convert one raw frame to metric depth, then filter."""
    d = calib.disparity
    if d.type == DISPARITY_KINECT:
        depth = view_ops.disparity_to_depth(raw_depth, d.a, d.b, calib.intrinsics_d.fx)
    else:
        depth = view_ops.depth_affine_to_float(raw_depth, d.a, d.b)
    return _finish_view(depth, settings, calib, rgb)


def build_view_from_metric_depth(
    depth: torch.Tensor, settings: Settings, calib: RGBDCalib, rgb: Optional[torch.Tensor] = None
) -> View:
    """For sources that already produce metric depth (synthetic, TUM float)."""
    depth = torch.where(depth > 0, depth, torch.full_like(depth, -1.0))
    return _finish_view(depth, settings, calib, rgb)
