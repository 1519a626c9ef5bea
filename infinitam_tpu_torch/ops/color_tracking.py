"""Photometric (colour) tracking: residuals, Jacobians, LM energy.

Counterpart of infinitam_tpu/ops/color_tracking.py (reference:
DeviceAgnostic/ITMColorTracker.h getColorDifferenceSq,
computePerPointGH_rt_Color; ITMColorTracker_CPU.cpp:14-100 F/G sums with the
occlusion rescaling noTotalPoints / countedPoints). Colours are float 0..1.

The point cloud is a pair of [H, W, 4] maps (locations in metres and
colours, w = ±1 validity). Every point of the maps is used:
`trackers.track_color` slices them [::2, ::2] for skipPoints, which selects
the points of the JAX package's skip mask without summing masked zeros.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from infinitam_tpu_torch.ops.pixel import bilinear
from infinitam_tpu_torch.utils import se3


class ColorFG(NamedTuple):
    f: torch.Tensor  # scalar energy (occlusion-rescaled), inf without valid points
    nabla: torch.Tensor  # [6]
    hessian: torch.Tensor  # [6, 6] Gauss-Newton approximation
    num_valid: torch.Tensor  # int32


def _project_points(locations: torch.Tensor, M: torch.Tensor, proj: torch.Tensor, img_size: Tuple[int, int]):
    """World points → (camera points (x, y, z), u, v clamped to the image,
    valid): w > 0, in front of the camera, inside [0, W−1] × [0, H−1]."""
    H, W = img_size
    fx, fy, cx, cy = proj[0], proj[1], proj[2], proj[3]
    p_cam = se3.apply_planes(M, locations[..., 0], locations[..., 1], locations[..., 2])
    z = p_cam[2]
    valid = (locations[..., 3] > 0) & (z > 0)
    zs = torch.where(valid, z, torch.ones_like(z))
    u = fx * p_cam[0] / zs + cx
    v = fy * p_cam[1] / zs + cy
    valid = valid & (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    return p_cam, u.clamp(0, W - 1), v.clamp(0, H - 1), valid


def _masks(locations, colours):
    """(points with a known colour, the same with a location)."""
    known = colours[..., 3] > 0
    return known, known & (locations[..., 3] > 0)


def _energy(per_point: torch.Tensor, valid: torch.Tensor, n_total: torch.Tensor):
    """(f, scale, n_valid): f = Σ_valid per_point · n_total / n_valid, inf
    when no point is valid."""
    n_valid = valid.sum(dtype=torch.int32)
    have = n_valid > 0
    scale = torch.where(have, n_total / n_valid.clamp(min=1), torch.ones((), device=valid.device))
    f_sum = torch.where(valid, per_point, torch.zeros_like(per_point)).sum()
    f = torch.where(have, f_sum * scale, torch.full_like(f_sum, float("inf")))
    return f, scale, n_valid


def color_f(
    locations: torch.Tensor,  # [..., 4] world points (w = ±1)
    colours: torch.Tensor,  # [..., 4] known colours 0..1 (w = ±1)
    rgb: torch.Tensor,  # [H, W, 3] observed image at this level
    proj: torch.Tensor,  # rgb intrinsics at this level
    M: torch.Tensor,  # world→rgb camera pose being evaluated
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Energy F = scale · Σ‖colour_obs − colour_known‖² (reference
    F_oneLevel). Returns (f, num_valid)."""
    known, n_total_mask = _masks(locations, colours)
    _p, u, v, valid = _project_points(locations, M, proj, rgb.shape[:2])
    valid = valid & known
    diff = bilinear(rgb, u, v) - colours[..., :3]
    f, _scale, n_valid = _energy((diff * diff).sum(-1), valid, n_total_mask.sum(dtype=torch.int32))
    return f, n_valid


def color_g(
    locations: torch.Tensor,
    colours: torch.Tensor,
    rgb: torch.Tensor,
    gx: torch.Tensor,  # [H, W, 3] image x-gradient at this level
    gy: torch.Tensor,
    proj: torch.Tensor,
    M: torch.Tensor,
) -> ColorFG:
    """Energy, gradient and Gauss-Newton Hessian (reference
    computePerPointGH_rt_Color / G_oneLevel). Parameter order
    (tx, ty, tz, rx, ry, rz) with the perturbation M' = exp(δ)·M."""
    known, n_total_mask = _masks(locations, colours)
    fx, fy = proj[0], proj[1]
    (x, y, z), u, v, valid = _project_points(locations, M, proj, rgb.shape[:2])
    valid = valid & known

    diff = bilinear(rgb, u, v) - colours[..., :3]  # [..., 3]
    gx_obs = bilinear(gx, u, v)
    gy_obs = bilinear(gy, u, v)
    zs = torch.where(valid, z, torch.ones_like(z))
    inv_z2 = 1.0 / (zs * zs)
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    # d p_cam / d param_i: translation e_i, rotation e_i × p_cam
    dpx = torch.stack([one, zero, zero, zero, z, -y], dim=-1)
    dpy = torch.stack([zero, one, zero, -z, zero, x], dim=-1)
    dpz = torch.stack([zero, zero, one, y, -x, zero], dim=-1)
    du = fx * (zs[..., None] * dpx - dpz * x[..., None]) * inv_z2[..., None]
    dv = fy * (zs[..., None] * dpy - dpz * y[..., None]) * inv_z2[..., None]
    # d colour / d param [N, 6, 3], zero at invalid points
    J = du[..., None] * gx_obs[..., None, :] + dv[..., None] * gy_obs[..., None, :]
    J = torch.where(valid[..., None, None], J, torch.zeros_like(J)).reshape(-1, 6, 3)

    f, scale, n_valid = _energy((diff * diff).sum(-1), valid, n_total_mask.sum(dtype=torch.int32))
    nabla = torch.einsum("nic,nc->i", J, 2.0 * diff.reshape(-1, 3)) * scale
    Jt = J.permute(1, 0, 2).reshape(6, -1)
    hessian = 2.0 * (Jt @ Jt.T) * scale
    return ColorFG(f=f, nabla=nabla, hessian=hessian, num_valid=n_valid)

