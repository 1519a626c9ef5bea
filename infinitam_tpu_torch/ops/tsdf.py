"""TSDF fusion core — depth and colour running-average voxel updates.

Counterpart of infinitam_tpu/ops/tsdf.py (reference:
DeviceAgnostic/ITMSceneReconstructionEngine.h:10-139,
computeUpdatedVoxelDepthInfo, computeUpdatedVoxelColorInfo,
ComputeUpdatedVoxelInfo<hasColor>). This is the arithmetic of kernel K2's
plain versions (ops/kernels/integrate.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from infinitam_tpu_torch.ops.pixel import bilinear
from infinitam_tpu_torch.utils import se3


def _select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor, into: bool) -> torch.Tensor:
    """where(mask, a, b); with `into`, written into b with no new tensor
    (under torch.vmap, which has no batching rule for `out=`, through a new
    tensor and a copy)."""
    if not into:
        return torch.where(mask, a, b)
    if torch._C._functorch.is_batchedtensor(b):
        return b.copy_(torch.where(mask, a, b))
    return torch.where(mask, a, b, out=b)


class TsdfUpdate(NamedTuple):
    sdf: torch.Tensor
    w_depth: torch.Tensor
    eta: torch.Tensor  # signed surface distance (depth − z); −1 where no ray
    updated: torch.Tensor  # bool: voxel actually touched


def update_voxel_depth(
    old_sdf: torch.Tensor,
    old_w: torch.Tensor,  # int32
    pt_world: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],  # metres, component planes
    M_d: torch.Tensor,  # [4,4] world→depth camera
    proj_d: torch.Tensor,  # (fx, fy, cx, cy)
    depth: torch.Tensor,  # [H, W] metric depth, −1 invalid
    mu: float,
    max_w: int,
    keep: Optional[torch.Tensor] = None,  # bool: voxels left as they are
    into: bool = False,
) -> TsdfUpdate:
    """Project each voxel centre into the depth image and fold min(1, η/μ)
    into the running average with weight 1 (capped at max_w); voxels more
    than μ behind the surface (η < −μ), and those in `keep`, are untouched.
    With `into` the new sdf and weights are written into old_sdf and old_w.

    The camera transform rounds as the JAX package's einsum does
    (se3.apply_planes), and the CUDA kernel repeats every operation in the
    same order without multiply-add contraction, so kernel, this function
    and the JAX package agree bit for bit."""
    H, W = depth.shape
    fx, fy, cx, cy = proj_d[0], proj_d[1], proj_d[2], proj_d[3]
    pc = se3.apply_planes(M_d, *pt_world)
    z = pc[2]
    valid = z > 0
    zs = torch.where(valid, z, torch.ones_like(z))
    u = fx * pc[0] / zs + cx
    v = fy * pc[1] / zs + cy
    # reference bounds: 1 <= u <= W-2 (a 1 px margin)
    valid = valid & (u >= 1) & (u <= W - 2) & (v >= 1) & (v <= H - 2)

    ui = (u + 0.5).to(torch.int32).clamp(0, W - 1)
    vi = (v + 0.5).to(torch.int32).clamp(0, H - 1)
    depth_measure = depth.reshape(-1)[(vi * W + ui).long()]
    valid = valid & (depth_measure > 0.0)

    eta = depth_measure - z
    do_update = valid & (eta >= -mu)
    if keep is not None:
        do_update = do_update & ~keep
    new_f = torch.clamp(eta / mu, max=1.0)
    merged_f = (old_w * old_sdf + new_f) / (old_w + 1)
    merged_w = torch.clamp(old_w + 1, max=max_w)
    return TsdfUpdate(
        sdf=_select(do_update, merged_f, old_sdf, into),
        w_depth=_select(do_update, merged_w, old_w, into),
        eta=torch.where(valid, eta, torch.full_like(eta, -1.0)),
        updated=do_update,
    )


def update_voxel_color(
    old_clr: torch.Tensor,  # [..., 3] float 0..1
    old_wc: torch.Tensor,  # int32
    pt_world: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],  # metres, component planes
    M_rgb: torch.Tensor,  # [4,4] world→rgb camera
    proj_rgb: torch.Tensor,  # (fx, fy, cx, cy) of the rgb camera
    rgb: torch.Tensor,  # [H, W, 3] float 0..1
    eta: torch.Tensor,  # update_voxel_depth's eta (−1 where no ray)
    mu: float,
    max_w: int,
    depth_updated: torch.Tensor,  # bool
    into: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Colour running average of the voxels near the surface (|η/μ| ≤ 0.25
    and η ≤ μ, among those the depth update touched): project into the rgb
    image, take a bilinear tap inside the 1 px margin, fold it in with
    weight 1 (capped at max_w). Returns (clr, wc), with `into` written into
    old_clr and old_wc."""
    H, W = rgb.shape[:2]
    fx, fy, cx, cy = proj_rgb[0], proj_rgb[1], proj_rgb[2], proj_rgb[3]
    gate = depth_updated & ~((eta > mu) | (torch.abs(eta / mu) > 0.25))
    pc = se3.apply_planes(M_rgb, *pt_world)
    z = torch.where(pc[2] == 0, torch.full_like(pc[2], 1e-6), pc[2])
    u = fx * pc[0] / z + cx
    v = fy * pc[1] / z + cy
    gate = gate & (u >= 1) & (u <= W - 2) & (v >= 1) & (v <= H - 2)
    measure = bilinear(rgb, u, v)
    new_c = (old_clr * old_wc[..., None] + measure) / (old_wc + 1)[..., None]
    new_wc = torch.clamp(old_wc + 1, max=max_w)
    return _select(gate[..., None], new_c, old_clr, into), _select(gate, new_wc, old_wc, into)


def integrate_dense(
    vol_sdf: torch.Tensor,
    vol_w: torch.Tensor,
    pt_world: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    M_d: torch.Tensor,
    proj_d: torch.Tensor,
    depth: torch.Tensor,
    mu: float,
    max_w: int,
    stop_at_max_w: bool = False,
    vol_clr: Optional[torch.Tensor] = None,
    vol_wc: Optional[torch.Tensor] = None,
    M_rgb: Optional[torch.Tensor] = None,
    proj_rgb: Optional[torch.Tensor] = None,
    rgb: Optional[torch.Tensor] = None,
    into: bool = False,
):
    """One fused elementwise pass over a set of voxels: the depth update,
    then with `vol_clr` the colour update. Voxels at max_w keep depth and
    colour when `stop_at_max_w`. Returns (sdf, w, clr, wc), the last two
    None without colour; with `into` they are vol_sdf, vol_w, vol_clr and
    vol_wc, written in place (no new tensor of their size)."""
    frozen = vol_w >= max_w if stop_at_max_w else None
    upd = update_voxel_depth(vol_sdf, vol_w, pt_world, M_d, proj_d, depth, mu, max_w, keep=frozen, into=into)
    if vol_clr is None:
        return upd.sdf, upd.w_depth, None, None
    clr, wc = update_voxel_color(vol_clr, vol_wc, pt_world, M_rgb, proj_rgb, rgb, upd.eta, mu, max_w, upd.updated,
                                 into=into)
    return upd.sdf, upd.w_depth, clr, wc
