"""Ren et al. 2012 SDF-based tracker: exp-SDF energy + MRP rotation LM.

Counterpart of infinitam_tpu/ops/ren_tracking.py (reference
DeviceAgnostic/ITMRenTracker.h:20-109: computePerPixelEnergy
E = 4·e^{−6·dt}/(1+e^{−6·dt})², computeDDT central differences,
computePerPixelJacobian with the MRP ×4 rotation rows;
ITMRenTracker.cpp:106-180: the LM, the delta applied as an MRP rotation
left-multiplied onto invM, f = −Σ E minimised). Plain PyTorch, on whatever
device the volume lies on: the JAX package runs no Pallas kernel here.
"""

from __future__ import annotations

from typing import Tuple

import torch

from infinitam_tpu_torch.ops.voxel_access import ReadFn, read_sdf_interpolated
from infinitam_tpu_torch.utils import se3

DTUNE = 6.0


def mrp_rotation(r: torch.Tensor) -> torch.Tensor:
    """Modified-Rodrigues-parameter rotation matrix (reference
    GetRotationMatrixFromMRP). r: [3] → [3, 3] (row-major)."""
    t1, t2, t3 = r[0], r[1], r[2]
    tsq = t1 * t1 + t2 * t2 + t3 * t3
    tsum = 1.0 - tsq
    R = torch.stack([
        torch.stack([4 * t1 * t1 - 4 * t2 * t2 - 4 * t3 * t3 + tsum * tsum,
                     8 * t1 * t2 - 4 * t3 * tsum,
                     8 * t1 * t3 + 4 * t2 * tsum]),
        torch.stack([8 * t1 * t2 + 4 * t3 * tsum,
                     4 * t2 * t2 - 4 * t1 * t1 - 4 * t3 * t3 + tsum * tsum,
                     8 * t2 * t3 - 4 * t1 * tsum]),
        torch.stack([8 * t1 * t3 - 4 * t2 * tsum,
                     8 * t2 * t3 + 4 * t1 * tsum,
                     4 * t3 * t3 - 4 * t2 * t2 - 4 * t1 * t1 + tsum * tsum]),
    ])
    return R / ((1.0 + tsq) * (1.0 + tsq))


def delta_matrix(step: torch.Tensor) -> torch.Tensor:
    """4×4 increment from the (t, mrp) step (reference GetMFromParam /
    applyDelta): the MRP rotation and the translation column."""
    M = torch.eye(4, dtype=step.dtype, device=step.device)
    M[:3, :3] = mrp_rotation(step[3:])
    M[:3, 3] = step[:3]
    return M


def unproject_view(depth: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """Per-pixel camera-frame points [H, W, 4] with w = ±1 validity
    (reference UnprojectDepthToCam)."""
    H, W = depth.shape
    fx, fy, cx, cy = proj[0], proj[1], proj[2], proj[3]
    valid = depth > 0
    d = torch.where(valid, depth, torch.ones_like(depth))
    xs = torch.arange(W, dtype=torch.float32, device=depth.device)[None, :]
    ys = torch.arange(H, dtype=torch.float32, device=depth.device)[:, None]
    p = torch.stack([d * (xs - cx) / fx, d * (ys - cy) / fy, d], dim=-1)
    return torch.cat([p, torch.where(valid, 1.0, -1.0)[..., None]], dim=-1)


def _to_world(pts_cam: torch.Tensor, inv_M: torch.Tensor) -> torch.Tensor:
    """inv_M applied to each point [..., 3], rounded as the JAX package's
    einsum + add (se3.apply_planes)."""
    return torch.stack(se3.apply_planes(inv_M, pts_cam[..., 0], pts_cam[..., 1], pts_cam[..., 2]), dim=-1)


def energy(read: ReadFn, pts_cam: torch.Tensor, inv_M: torch.Tensor, one_over_voxel: float) -> torch.Tensor:
    """f = −Σ E over the valid points (reference F_oneLevel), through
    trilinear SDF reads, as the JAX package takes them."""
    valid = pts_cam[..., 3] > -1.0
    pv = _to_world(pts_cam, inv_M) * one_over_voxel
    dt, found = read_sdf_interpolated(read, pv)
    expdt = torch.exp(-dt * DTUNE)
    e = 4.0 * expdt / ((expdt + 1.0) ** 2)
    return -torch.where(valid & found & (dt < 1.0), e, torch.zeros_like(e)).sum()


def gradient_hessian(read: ReadFn, pts_cam: torch.Tensor, inv_M: torch.Tensor,
                     one_over_voxel: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(∇f [6], Gauss-Newton Hessian [6, 6]) (reference
    computePerPixelJacobian + G_oneLevel: rows j, H = Σ j jᵀ; with f = −Σ E
    the gradient sums −j), keeping the 1/voxel factor so that translation
    steps are metres, as the JAX package does. The centre and the six ±axis
    samples are one interpolated read over [7, ..., 3] stacked points: each
    element takes the same float ops as seven separate reads."""
    valid = pts_cam[..., 3] > -1.0
    c = _to_world(pts_cam, inv_M)
    pv = c * one_over_voxel
    eye = torch.eye(3, dtype=pv.dtype, device=pv.device)
    # samples: centre, then +x, −x, +y, −y, +z, −z
    offsets = torch.cat([torch.zeros((1, 3), dtype=pv.dtype, device=pv.device),
                         torch.stack([eye, -eye], dim=1).reshape(6, 3)])
    d, f = read_sdf_interpolated(read, pv[None] + offsets.reshape((7,) + (1,) * (pv.dim() - 1) + (3,)))
    dt = d[0]
    ok = valid & f[0] & (dt < 1.0)
    side_ok = f[1:] & (d[1:] < 1.0)
    ddt_ok = ok & side_ok.all(dim=0)
    dDt = torch.stack([(d[1 + 2 * a] - d[2 + 2 * a]) * 0.5 for a in range(3)], dim=-1)

    expdt = torch.exp(-dt * DTUNE)
    deto = expdt + 1.0
    prefix = 4.0 * DTUNE * (2.0 * torch.exp(-dt * 2.0 * DTUNE) / (deto**3) - expdt / (deto**2))
    # dE / d p_world in metres: the central difference is per voxel → ×1/voxel
    g = dDt * (prefix * one_over_voxel)[..., None]
    jx, jy, jz = g[..., 0], g[..., 1], g[..., 2]
    cx_, cy_, cz_ = c[..., 0], c[..., 1], c[..., 2]
    j = torch.stack([jx, jy, jz, 4.0 * (jz * cy_ - jy * cz_), 4.0 * (jx * cz_ - jz * cx_),
                     4.0 * (jy * cx_ - jx * cy_)], dim=-1)
    jm = (j * ddt_ok.to(torch.float32)[..., None]).reshape(-1, 6)
    return -jm.sum(dim=0), jm.T @ jm
