"""Raycasting: sphere-traced TSDF surface extraction + ICP map synthesis.

Counterpart of infinitam_tpu/ops/raycast.py (reference:
DeviceAgnostic/ITMVisualisationEngine.h:92-409 castRay, computeNormalAndAngle,
processPixelICP, drawPixelGrey / Normal / Colour), with the JAX package's
coarse-pass range refinement. `pixel_rays` + `raycast_rays`
(`generic_raycast`) over a reader are the plain version of kernel K3 and its
reader variants K3h and K3d (ops/kernels/raycast.py): the kernel builds and
marches one ray per thread; this version marches the whole ray bundle in
lock step and stops when no ray is active, which reads a flag back to the
host once per step. It is the CPU path and the card's reference, never the
main path on the card. `forward_project` / `forward_render` are the JAX
package's incremental raycast over the same march, wired into no frame step
of either package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from infinitam_tpu_torch.ops.hashing import compact_by_mask, scatter_drop
from infinitam_tpu_torch.ops.voxel_access import (
    ReadFn,
    read_color_interpolated,
    read_sdf_interpolated,
    read_sdf_uninterpolated,
)
from infinitam_tpu_torch.utils import se3


class RaycastResult(NamedTuple):
    # [H, W, 4]: xyz = hit position in voxel units (world grid frame),
    # w = 1 found / 0 miss
    points: torch.Tensor
    # [H, W] int32: each ray's march steps (voxel reads before the
    # refinement); the plain march counts them, kernel K3 does not
    steps: Optional[torch.Tensor] = None


def pixel_rays(
    inv_M: torch.Tensor,
    proj: torch.Tensor,
    img_size: Tuple[int, int],
    one_over_voxel_size: float,
    zmin: torch.Tensor,
    zmax: torch.Tensor,
):
    """Per-pixel rays in voxel units: (pt_start [H,W,3], ray_dir [H,W,3]
    unit, len_start [H,W], len_end [H,W])."""
    H, W = img_size
    dev = zmin.device
    fx, fy, cx, cy = proj[0], proj[1], proj[2], proj[3]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    dx = (xs - cx) / fx
    dy = (ys - cy) / fy

    def to_world_voxels(z):
        pw = se3.apply_planes(inv_M, dx * z, dy * z, z)
        return torch.stack([c * one_over_voxel_size for c in pw], dim=-1)

    def length(z):
        return norm3(dx * z, dy * z, z) * one_over_voxel_size

    pt_start = to_world_voxels(zmin)
    pt_end = to_world_voxels(zmax)
    ray_dir = pt_end - pt_start
    norm = norm3(*ray_dir.unbind(-1)).clamp(min=1e-12)
    return pt_start, ray_dir / norm[..., None], length(zmin), length(zmax)


def norm3(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """√(x² + y² + z²) of float32 planes, rounded as the JAX package's
    `jnp.linalg.norm` rounds it on the CPU: the FMA chain
    fma(z, z, fma(y, y, x·x)), then a correctly rounded square root. Each
    fused step and the root run in float64 and round back to float32 (torch's
    float32 `sqrt` on the CPU is not correctly rounded); kernel K3 computes
    the same with `__fmaf_rn` and `sqrtf`, so both round alike."""

    def fma(a, b, c):
        return (a.double() * b.double() + c.double()).float()

    return torch.sqrt(fma(z, z, fma(y, y, x * x)).double()).float()


def raycast_rays(
    read: ReadFn,
    pt_start: torch.Tensor,  # [..., 3] voxel units
    ray_dir: torch.Tensor,  # [..., 3] unit
    len_start: torch.Tensor,  # [...]
    len_end: torch.Tensor,  # [...]
    step_scale: float,  # mu / voxel_size
    block_size: int = 8,
    active_init: Optional[torch.Tensor] = None,  # [...] bool: rays to march (None: all)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sphere tracing along ray bundles → ([..., 4] position in voxel units
    and w = hit flag, [...] int32 march steps of each ray), the JAX oracle's
    march: step max(sdf·step_scale, 1) in allocated space, a DDA step to the
    current block's exit (clamped to [0.5, block]) through empty space, stop
    at the first sdf ≤ 0 or past len_end; then one secant step and two
    trilinear refinement steps. A ray outside `active_init` takes no step
    and misses."""
    shape = len_start.shape
    pt = pt_start
    total = len_start
    sdf = torch.ones(shape, dtype=torch.float32, device=pt.device)
    active = torch.ones(shape, dtype=torch.bool, device=pt.device) if active_init is None else active_init
    steps = torch.zeros(shape, dtype=torch.int32, device=pt.device)
    tiny = ray_dir.abs() < 1e-9
    safe_dir = torch.where(tiny, torch.full_like(ray_dir, 1e-9), ray_dir)
    up = (ray_dir > 0).to(torch.float32)
    while bool(active.any()):
        steps += active
        s, found = read_sdf_uninterpolated(read, pt)
        hit = found & (s <= 0.0)
        nxt_bound = (torch.floor(pt / block_size) + up) * block_size
        t_axis = torch.where(tiny, torch.full_like(pt, 1e9), (nxt_bound - pt) / safe_dir)
        t_exit = t_axis.amin(dim=-1)
        empty_step = torch.clamp(t_exit + 0.01, 0.5, float(block_size))
        step = torch.where(found, torch.clamp(s * step_scale, min=1.0), empty_step)
        advance = active & ~hit
        pt = torch.where(advance[..., None], pt + step[..., None] * ray_dir, pt)
        total = torch.where(advance, total + step, total)
        sdf = torch.where(active, s, sdf)
        active = advance & (total < len_end)

    found_surface = sdf <= 0.0
    p = pt + (sdf * step_scale)[..., None] * ray_dir
    r1, _ = read_sdf_interpolated(read, p)
    p = p + (r1 * step_scale)[..., None] * ray_dir
    r2, _ = read_sdf_interpolated(read, p)
    p = p + (r2 * step_scale)[..., None] * ray_dir
    points = torch.cat(
        [torch.where(found_surface[..., None], p, pt), found_surface.to(torch.float32)[..., None]], dim=-1
    )
    return points, steps


def generic_raycast(
    read: ReadFn,
    inv_M: torch.Tensor,  # [4,4] camera→world
    proj: torch.Tensor,
    img_size: Tuple[int, int],
    one_over_voxel_size: float,
    mu: float,
    zmin: torch.Tensor,  # [H, W] metres
    zmax: torch.Tensor,
    block_size: int = 8,
) -> RaycastResult:
    """Full-image raycast (reference genericRaycast_device)."""
    pt_start, ray_dir, len_start, len_end = pixel_rays(inv_M, proj, img_size, one_over_voxel_size, zmin, zmax)
    points, steps = raycast_rays(read, pt_start, ray_dir, len_start, len_end, mu * one_over_voxel_size, block_size)
    return RaycastResult(points=points, steps=steps)


def refine_ranges_from_coarse(
    points_coarse: torch.Tensor,  # [Hc, Wc, 4] coarse raycast, voxel units
    M: torch.Tensor,  # [4, 4] world→camera
    voxel_size: float,
    img_size: Tuple[int, int],
    factor: int,
    margin_m: float,
    zmin0: torch.Tensor,  # [H, W] the full-resolution ranges
    zmax0: torch.Tensor,
):
    """Tightened full-resolution ranges from a coarse pass at 1/factor
    resolution (the JAX package's hierarchical raycast, op for op): a pixel
    whose coarse 3×3 neighbourhood is all hits marches over
    [min(z) − margin, max(z) + margin] of that neighbourhood, within its own
    ranges; any other pixel keeps its ranges (silhouette safety). As in the
    JAX package, the neighbourhood wraps around the image border (`roll`)."""
    H, W = img_size
    Hc, Wc = points_coarse.shape[:2]
    dev = points_coarse.device
    found = points_coarse[..., 3] > 0
    pw = points_coarse[..., :3] * voxel_size
    z = se3.apply_planes(M, pw[..., 0], pw[..., 1], pw[..., 2])[2]
    z = torch.where(found, z, torch.zeros_like(z))

    zmin_n = torch.full((Hc, Wc), 1e9, dtype=torch.float32, device=dev)
    zmax_n = torch.full((Hc, Wc), -1e9, dtype=torch.float32, device=dev)
    all_found = torch.ones((Hc, Wc), dtype=torch.bool, device=dev)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            zs = torch.roll(z, shifts=(dy, dx), dims=(0, 1))
            fs = torch.roll(found, shifts=(dy, dx), dims=(0, 1))
            zmin_n = torch.minimum(zmin_n, torch.where(fs, zs, 1e9))
            zmax_n = torch.maximum(zmax_n, torch.where(fs, zs, -1e9))
            all_found = all_found & fs

    rows = (torch.arange(H, device=dev) // factor).clamp(0, Hc - 1)
    cols = (torch.arange(W, device=dev) // factor).clamp(0, Wc - 1)

    def up(a):
        return a[rows][:, cols]

    ok = up(all_found)
    zmin = torch.where(ok, torch.maximum(up(zmin_n) - margin_m, zmin0), zmin0)
    zmax = torch.where(ok, torch.minimum(up(zmax_n) + margin_m, zmax0), zmax0)
    return zmin, zmax


def _normals_planes(px, py, pz, found, voxel_size: float, light_source, use_smoothing: bool = True):
    """Image-space normals from neighbouring raycast points with the
    reference's ±2 px smoothing and ±1 px fallback on jumps. Returns
    (nx, ny, nz, angle, valid)."""
    H, W = px.shape

    def sh(a, dy, dx):
        return torch.roll(a, shifts=(-dy, -dx), dims=(0, 1))

    def diffs(d):
        ok = sh(found, 0, d) & sh(found, 0, -d) & sh(found, d, 0) & sh(found, -d, 0)
        dxs = tuple(sh(c, 0, d) - sh(c, 0, -d) for c in (px, py, pz))
        dys = tuple(sh(c, d, 0) - sh(c, -d, 0) for c in (px, py, pz))
        return dxs, dys, ok

    if use_smoothing:
        (dxx2, dxy2, dxz2), (dyx2, dyy2, dyz2), ok2 = diffs(2)
        len_diff = torch.maximum(dxx2 * dxx2 + dxy2 * dxy2 + dxz2 * dxz2, dyx2 * dyx2 + dyy2 * dyy2 + dyz2 * dyz2)
        jump = len_diff * voxel_size * voxel_size > 0.15 * 0.15
        d1x, d1y, ok1 = diffs(1)
        use1 = ~ok2 | jump
        dxx, dxy, dxz = (torch.where(use1, a, b) for a, b in zip(d1x, (dxx2, dxy2, dxz2)))
        dyx, dyy, dyz = (torch.where(use1, a, b) for a, b in zip(d1y, (dyx2, dyy2, dyz2)))
        ok = torch.where(use1, ok1, ok2)
        border = 3
    else:
        (dxx, dxy, dxz), (dyx, dyy, dyz), ok = diffs(1)
        border = 2

    nx = -(dxy * dyz - dxz * dyy)
    ny = -(dxz * dyx - dxx * dyz)
    nz = -(dxx * dyy - dxy * dyx)
    norm = torch.sqrt(nx * nx + ny * ny + nz * nz)
    inv = 1.0 / norm.clamp(min=1e-12)
    nx, ny, nz = nx * inv, ny * inv, nz * inv
    angle = nx * light_source[0] + ny * light_source[1] + nz * light_source[2]

    xs = torch.arange(W, device=px.device)[None, :]
    ys = torch.arange(H, device=px.device)[:, None]
    in_border = (xs > border - 1) & (xs < W - border) & (ys > border - 1) & (ys < H - border)
    valid = found & ok & (angle > 0) & in_border & (norm > 0)
    return nx, ny, nz, angle, valid


def compute_normals_image_space(points_ray: torch.Tensor, voxel_size: float, light_source, use_smoothing: bool = True):
    """(normals [H,W,3], angle [H,W], valid [H,W]) from a raycast."""
    nx, ny, nz, angle, valid = _normals_planes(
        points_ray[..., 0], points_ray[..., 1], points_ray[..., 2], points_ray[..., 3] > 0,
        voxel_size, light_source, use_smoothing,
    )
    return torch.stack([nx, ny, nz], dim=-1), angle, valid


def make_icp_maps(raycast: RaycastResult, voxel_size: float, inv_M: torch.Tensor):
    """The tracker's target maps (reference renderICP / processPixelICP):
    points in metres and world-frame unit normals, w = 1 valid / −1 invalid."""
    light_source = -inv_M[:3, 2] / torch.linalg.vector_norm(inv_M[:3, 2])
    px, py, pz = raycast.points[..., 0], raycast.points[..., 1], raycast.points[..., 2]
    found = raycast.points[..., 3] > 0
    nx, ny, nz, _angle, valid = _normals_planes(px, py, pz, found, voxel_size, light_source, use_smoothing=True)
    w = torch.where(valid, 1.0, -1.0)
    z = torch.zeros_like(px)
    points_map = torch.stack([torch.where(valid, c * voxel_size, z) for c in (px, py, pz)] + [w], dim=-1)
    normals_map = torch.stack([torch.where(valid, c, z) for c in (nx, ny, nz)] + [w], dim=-1)
    return points_map, normals_map


def _light_source(inv_M: torch.Tensor) -> torch.Tensor:
    return -inv_M[:3, 2] / torch.linalg.vector_norm(inv_M[:3, 2])


def render_grey(raycast: RaycastResult, voxel_size: float, inv_M: torch.Tensor) -> torch.Tensor:
    """Grey-shaded rendering [H, W] uint8 (reference drawPixelGrey:
    0.8·angle + 0.2 with the light at the camera)."""
    _n, angle, valid = compute_normals_image_space(raycast.points, voxel_size, _light_source(inv_M),
                                                   use_smoothing=False)
    shade = torch.where(valid, 0.8 * angle + 0.2, torch.zeros_like(angle))
    return (shade.clamp(0.0, 1.0) * 255.0).to(torch.uint8)


def render_normals(raycast: RaycastResult, voxel_size: float, inv_M: torch.Tensor) -> torch.Tensor:
    """False-colour normals [H, W, 3] uint8 (reference drawPixelNormal)."""
    n, _angle, valid = compute_normals_image_space(raycast.points, voxel_size, _light_source(inv_M),
                                                   use_smoothing=False)
    img = (0.3 + (-n + 1.0) * 0.35) * 255.0
    img = torch.where(valid[..., None], img, torch.zeros_like(img))
    return img.clamp(0, 255).to(torch.uint8)


def render_color(raycast: RaycastResult, read_color) -> torch.Tensor:
    """The volume's colour at the surface [H, W, 3] uint8 (reference
    drawPixelColour)."""
    rgb = read_color_interpolated(read_color, raycast.points[..., :3])
    valid = raycast.points[..., 3] > 0
    img = torch.where(valid[..., None], rgb * 255.0, torch.zeros_like(rgb))
    return img.clamp(0, 255).to(torch.uint8)


def se3_invert(M: torch.Tensor) -> torch.Tensor:
    """utils/se3.py invert, under the JAX module's name."""
    return se3.invert(M)


def forward_project(
    points_map_m: torch.Tensor,  # [H,W,4] metres, w>0 valid (the last raycast · voxel_size)
    M: torch.Tensor,  # [4,4] world→camera of the NEW pose
    proj: torch.Tensor,
    img_size: Tuple[int, int],
    one_over_voxel_size: float,
) -> torch.Tensor:
    """Scatter the last raycast into the new view (reference
    forwardProjectPixel + forwardProject_device): [H, W, 4] voxel-unit
    points with w = 1 where a point landed, 0 where the pixel is missing.
    Where several points land on one pixel, one of them wins, unspecified
    which (as XLA's scatter in the JAX package)."""
    H, W = img_size
    fx, fy, cx, cy = proj[0], proj[1], proj[2], proj[3]
    valid = points_map_m[..., 3] > 0
    pc = torch.einsum("ij,hwj->hwi", M[:3, :3], points_map_m[..., :3]) + M[:3, 3]
    z = torch.where(pc[..., 2] <= 0, torch.ones_like(pc[..., 2]), pc[..., 2])
    u = fx * pc[..., 0] / z + cx
    v = fy * pc[..., 1] / z + cy
    ok = valid & (pc[..., 2] > 0) & (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    ui = (u + 0.5).to(torch.int32).clamp(0, W - 1)
    vi = (v + 0.5).to(torch.int32).clamp(0, H - 1)
    payload = torch.cat([points_map_m[..., :3] * one_over_voxel_size, torch.ones_like(z)[..., None]], dim=-1)
    flat_idx = torch.where(ok, vi * W + ui, H * W)  # out of range drops
    out = scatter_drop(torch.zeros((H * W, 4), dtype=torch.float32, device=points_map_m.device),
                       flat_idx.reshape(-1), payload.reshape(-1, 4))
    return out.reshape(H, W, 4)


def forward_render(
    read: ReadFn,
    prev_points_map_m: torch.Tensor,  # [H,W,4] last raycast, metres, w>0 valid
    M: torch.Tensor,  # [4,4] world→camera, NEW pose
    proj: torch.Tensor,
    img_size: Tuple[int, int],
    one_over_voxel_size: float,
    mu: float,
    zmin: torch.Tensor,
    zmax: torch.Tensor,
    block_size: int = 8,
    missing_cap_fraction: int = 4,
) -> RaycastResult:
    """Incremental raycast (reference ForwardRender_common,
    ITMVisualisationEngine_CUDA.cu:314-380): the last raycast scattered into
    the new view, then a march of only the missing pixels whose expected
    range is not empty, compacted into a bundle of H·W / missing_cap_fraction
    rays (missing pixels beyond it stay holes until the next full raycast).
    The plain march reads `read` (the JAX package's XLA oracle); no kernel
    serves it."""
    H, W = img_size
    dev = zmin.device
    fwd = forward_project(prev_points_map_m, M, proj, img_size, one_over_voxel_size)
    # missing: not forward-projected, with a non-empty range (reference
    # findMissingPoints_device checks minmaximg x < y)
    missing = (fwd[..., 3] <= 0) & (zmax > zmin)
    cap = (H * W) // missing_cap_fraction
    idx, _n = compact_by_mask(missing.reshape(-1), torch.arange(H * W, dtype=torch.int32, device=dev), cap, fill=-1)
    valid = idx >= 0
    idx_c = idx.clamp(0, H * W - 1).long()
    pt_start, ray_dir, len_start, len_end = pixel_rays(se3_invert(M), proj, img_size, one_over_voxel_size, zmin,
                                                       zmax)
    pts, _steps = raycast_rays(read, pt_start.reshape(-1, 3)[idx_c], ray_dir.reshape(-1, 3)[idx_c],
                               len_start.reshape(-1)[idx_c], len_end.reshape(-1)[idx_c], mu * one_over_voxel_size,
                               block_size, active_init=valid)
    out = scatter_drop(fwd.reshape(-1, 4), torch.where(valid, idx_c, H * W), pts)
    return RaycastResult(points=out.reshape(H, W, 4))
