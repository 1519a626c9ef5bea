"""K3: per-pixel raycast of the TSDF through the dense block grid.

Replaces the Pallas kernel infinitam_tpu/ops/pallas/raycast_kernel.py
(`raycast_tiles`). The CUDA kernel (csrc/raycast.cu) runs one thread per
pixel on 16×8 pixel tiles, builds the pixel's ray itself (`pixel_rays`' ops
in its order) and reproduces the JAX package's XLA oracle
(`ops/raycast.py::raycast_rays` over `make_grid_reader`): full int16 sdf,
uninterpolated march with the DDA empty-space step, bounded only by each
ray's own `len_end`, then the secant + two trilinear refinement steps. Its
plain twin is `ops/raycast.py::generic_raycast`. A device bool `enable`
switches the march off without a host read (the approximate raycast), as
K2's `enable` does.
"""

from __future__ import annotations

import ctypes

import torch

from infinitam_tpu_torch.engine import hash_volume as hv
from infinitam_tpu_torch.ops import raycast as rc
from infinitam_tpu_torch.ops.kernels import build


def raycast_grid_plain(vol, grid, grid_params, params, inv_M, proj, img_size, one_over_voxel_size: float,
                       mu: float, zmin, zmax, enable=None, out=None) -> rc.RaycastResult:
    """The plain version: the lock-step march over a grid reader. Where
    `enable` is false the points are those of `out` (zeros without it), as
    the kernel leaves its output."""
    read = hv.make_grid_reader(vol, grid, grid_params, params)
    res = rc.generic_raycast(read, inv_M, proj, img_size, one_over_voxel_size, mu, zmin, zmax,
                             block_size=params.block_size)
    if enable is None:
        return res
    kept = out if out is not None else torch.zeros_like(res.points)
    return res._replace(points=torch.where(enable, res.points, kept))


def raycast_grid_cuda(vol, grid, grid_params, params, inv_M, proj, img_size, one_over_voxel_size: float,
                      mu: float, zmin, zmax, enable=None, out=None) -> rc.RaycastResult:
    """Launch K3 → points [H, W, 4] (into `out` when given); the kernel
    builds each pixel's ray. `enable`: a one-element bool tensor on the
    card, or None (on); while it is false no ray is marched and the points
    keep what the output held (unspecified without `out`)."""
    dev = vol.vox.device
    H, W = img_size
    S = params.block_size
    if S & (S - 1):
        raise ValueError("raycast: block_size must be a power of two")
    gx, gy, gz = grid_params.dims
    ox, oy, oz = grid_params.origin
    grid = grid.reshape(-1)
    if grid.shape[0] != gx * gy * gz:
        raise ValueError("raycast: block grid does not match grid_params.dims")
    if vol.vox.dim() != 2 or vol.vox.shape[1] != params.block_volume:
        raise ValueError("raycast: vox must be [B, S³]")
    if inv_M.shape != (4, 4) or proj.shape != (4,) or zmin.shape != (H, W) or zmax.shape != (H, W):
        raise ValueError("raycast: inv_M must be [4, 4], proj (fx, fy, cx, cy), zmin and zmax [H, W]")
    build.require_dtype("raycast", vol.vox, torch.int32)
    build.require_dtype("raycast", grid, torch.int32)
    for t in (inv_M, proj, zmin, zmax):
        build.require_dtype("raycast", t, torch.float32)
    extra = []
    if enable is not None:
        if enable.numel() != 1:
            raise ValueError("raycast: enable must be one bool")
        build.require_dtype("raycast", enable, torch.bool)
        extra.append(enable)
    if out is None:
        out = torch.empty((H, W, 4), dtype=torch.float32, device=dev)
    elif out.shape != (H, W, 4):
        raise ValueError("raycast: out must be [H, W, 4]")
    build.require_dtype("raycast", out, torch.float32)
    build.require_cuda("raycast", vol.vox, grid, inv_M, proj, zmin, zmax, out, *extra, device=dev)
    err = build.library().itpu_raycast(
        vol.vox.data_ptr(), grid.data_ptr(), gx, gy, gz, ox, oy, oz, S.bit_length() - 1,
        inv_M.data_ptr(), proj.data_ptr(), ctypes.c_float(one_over_voxel_size), zmin.data_ptr(), zmax.data_ptr(),
        H, W, ctypes.c_float(mu * one_over_voxel_size), None if enable is None else enable.data_ptr(),
        out.data_ptr(), build.stream_ptr(),
    )
    build.check("itpu_raycast", err)
    build.count_launch("raycast")
    return rc.RaycastResult(points=out)


def raycast_grid(vol, grid, grid_params, params, inv_M, proj, img_size, one_over_voxel_size: float,
                 mu: float, zmin, zmax, enable=None, out=None) -> rc.RaycastResult:
    """Full-image raycast of `vol` from camera→world `inv_M` between the
    per-pixel ranges zmin..zmax, where the device bool `enable` (None: on)
    is true: the plain version for CPU tensors, kernel K3 for CUDA
    tensors."""
    fn = raycast_grid_plain if vol.vox.device.type == "cpu" else raycast_grid_cuda
    return fn(vol, grid, grid_params, params, inv_M, proj, img_size, one_over_voxel_size, mu, zmin, zmax,
              enable=enable, out=out)
