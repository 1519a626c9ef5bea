"""K3 and its two reader variants: per-pixel raycast of the TSDF.

Replaces the Pallas kernel infinitam_tpu/ops/pallas/raycast_kernel.py
(`raycast_tiles`). The CUDA kernel (csrc/raycast.cu) runs one thread per
pixel on 16×8 pixel tiles, builds the pixel's ray itself (`pixel_rays`' ops
in its order) and reproduces the JAX package's XLA oracle
(`ops/raycast.py::raycast_rays`): uninterpolated march with the DDA
empty-space step, bounded only by each ray's own `len_end`, then the secant
+ two trilinear refinement steps. One template, three readers:

- K3, `raycast_grid`: the hash volume through the dense block grid
  (`make_grid_reader`), the main path;
- K3h, `raycast_hash_probe`: the hash volume through the hash table
  (`make_hash_reader`, `use_block_grid=False`), which finds blocks outside
  the grid's window;
- K3d, `raycast_dense`: the dense voxel array (`volume.make_dense_reader`).

Each has a plain twin, the lock-step march `ops/raycast.py::generic_raycast`
over the same reader, and its own launch counter. A device bool `enable`
switches the march off without a host read (the approximate raycast), as
K2's `enable` does; `out` receives the points.
"""

from __future__ import annotations

import ctypes

import torch

from infinitam_tpu_torch.engine import hash_volume as hv
from infinitam_tpu_torch.engine import volume as vol_mod
from infinitam_tpu_torch.ops import raycast as rc
from infinitam_tpu_torch.ops.kernels import build


def _plain(read, inv_M, proj, img_size, one_over_voxel_size, mu, zmin, zmax, block_size, enable, out):
    """The lock-step march over `read`. Where `enable` is false the points
    are those of `out` (zeros without it), as the kernel leaves its output."""
    res = rc.generic_raycast(read, inv_M, proj, img_size, one_over_voxel_size, mu, zmin, zmax, block_size=block_size)
    if enable is None:
        return res
    kept = out if out is not None else torch.zeros_like(res.points)
    return res._replace(points=torch.where(enable, res.points, kept))


def _launch_args(name, inv_M, proj, img_size, zmin, zmax, enable, out, dev):
    """Checks the arguments every variant shares; returns (out, the tensors
    to check for device and layout)."""
    H, W = img_size
    if inv_M.shape != (4, 4) or proj.shape != (4,) or zmin.shape != (H, W) or zmax.shape != (H, W):
        raise ValueError(f"{name}: inv_M must be [4, 4], proj (fx, fy, cx, cy), zmin and zmax [H, W]")
    for t in (inv_M, proj, zmin, zmax):
        build.require_dtype(name, t, torch.float32)
    tensors = [inv_M, proj, zmin, zmax]
    if enable is not None:
        if enable.numel() != 1:
            raise ValueError(f"{name}: enable must be one bool")
        build.require_dtype(name, enable, torch.bool)
        tensors.append(enable)
    if out is None:
        out = torch.empty((H, W, 4), dtype=torch.float32, device=dev)
    elif out.shape != (H, W, 4):
        raise ValueError(f"{name}: out must be [H, W, 4]")
    build.require_dtype(name, out, torch.float32)
    return out, tensors + [out]


def _block_shift(name, vol, params) -> int:
    S = params.block_size
    if S & (S - 1):
        raise ValueError(f"{name}: block_size must be a power of two")
    if vol.vox.dim() != 2 or vol.vox.shape[1] != params.block_volume:
        raise ValueError(f"{name}: vox must be [B, S³]")
    build.require_dtype(name, vol.vox, torch.int32)
    return S.bit_length() - 1


def raycast_grid_plain(vol, grid, grid_params, params, inv_M, proj, img_size, one_over_voxel_size: float,
                       mu: float, zmin, zmax, enable=None, out=None) -> rc.RaycastResult:
    """The plain version of K3: the lock-step march over a grid reader."""
    return _plain(hv.make_grid_reader(vol, grid, grid_params, params), inv_M, proj, img_size, one_over_voxel_size,
                  mu, zmin, zmax, params.block_size, enable, out)


def raycast_grid_cuda(vol, grid, grid_params, params, inv_M, proj, img_size, one_over_voxel_size: float,
                      mu: float, zmin, zmax, enable=None, out=None) -> rc.RaycastResult:
    """Launch K3 → points [H, W, 4] (into `out` when given); the kernel
    builds each pixel's ray. `enable`: a one-element bool tensor on the
    card, or None (on); while it is false no ray is marched and the points
    keep what the output held (unspecified without `out`)."""
    dev = vol.vox.device
    H, W = img_size
    shift = _block_shift("raycast", vol, params)
    gx, gy, gz = grid_params.dims
    ox, oy, oz = grid_params.origin
    grid = grid.reshape(-1)
    if grid.shape[0] != gx * gy * gz:
        raise ValueError("raycast: block grid does not match grid_params.dims")
    build.require_dtype("raycast", grid, torch.int32)
    out, tensors = _launch_args("raycast", inv_M, proj, img_size, zmin, zmax, enable, out, dev)
    build.require_cuda("raycast", vol.vox, grid, *tensors, device=dev)
    err = build.library().itpu_raycast(
        vol.vox.data_ptr(), grid.data_ptr(), gx, gy, gz, ox, oy, oz, shift,
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


def raycast_hash_probe_plain(vol, params, inv_M, proj, img_size, one_over_voxel_size: float, mu: float, zmin, zmax,
                             enable=None, out=None) -> rc.RaycastResult:
    """The plain version of K3h: the lock-step march over the hash reader
    (swapped-out blocks are not found)."""
    return _plain(hv.make_hash_reader(vol, params), inv_M, proj, img_size, one_over_voxel_size, mu, zmin, zmax,
                  params.block_size, enable, out)


def raycast_hash_probe_cuda(vol, params, inv_M, proj, img_size, one_over_voxel_size: float, mu: float, zmin, zmax,
                            enable=None, out=None) -> rc.RaycastResult:
    """Launch K3h → points [H, W, 4]: K3 with each block looked up by a walk
    of its hash chain. `enable` and `out` as in raycast_grid_cuda."""
    dev = vol.vox.device
    H, W = img_size
    shift = _block_shift("raycast_hash", vol, params)
    E = params.n_entries
    if vol.entry_pos.shape != (E, 3) or vol.entry_ptr.shape != (E,) or vol.entry_offset.shape != (E,):
        raise ValueError("raycast_hash: entry_pos must be [E, 3], entry_ptr and entry_offset [E]")
    for t in (vol.entry_pos, vol.entry_ptr, vol.entry_offset):
        build.require_dtype("raycast_hash", t, torch.int32)
    out, tensors = _launch_args("raycast_hash", inv_M, proj, img_size, zmin, zmax, enable, out, dev)
    build.require_cuda("raycast_hash", vol.vox, vol.entry_pos, vol.entry_ptr, vol.entry_offset, *tensors, device=dev)
    err = build.library().itpu_raycast_hash(
        vol.vox.data_ptr(), vol.entry_pos.data_ptr(), vol.entry_ptr.data_ptr(), vol.entry_offset.data_ptr(),
        params.n_buckets, params.hash_mask, shift, inv_M.data_ptr(), proj.data_ptr(),
        ctypes.c_float(one_over_voxel_size), zmin.data_ptr(), zmax.data_ptr(), H, W,
        ctypes.c_float(mu * one_over_voxel_size), None if enable is None else enable.data_ptr(), out.data_ptr(),
        build.stream_ptr(),
    )
    build.check("itpu_raycast_hash", err)
    build.count_launch("raycast_hash")
    return rc.RaycastResult(points=out)


def raycast_hash_probe(vol, params, inv_M, proj, img_size, one_over_voxel_size: float, mu: float, zmin, zmax,
                       enable=None, out=None) -> rc.RaycastResult:
    """Full-image raycast of the hash volume through its hash table: the
    plain version for CPU tensors, kernel K3h for CUDA tensors."""
    fn = raycast_hash_probe_plain if vol.vox.device.type == "cpu" else raycast_hash_probe_cuda
    return fn(vol, params, inv_M, proj, img_size, one_over_voxel_size, mu, zmin, zmax, enable=enable, out=out)


def raycast_dense_plain(vol: vol_mod.DenseVolume, plain_params, inv_M, proj, img_size, one_over_voxel_size: float,
                        mu: float, zmin, zmax, enable=None, out=None) -> rc.RaycastResult:
    """The plain version of K3d: the lock-step march over the dense reader,
    empty space outside the array stepping through its virtual 8³ blocks."""
    return _plain(vol_mod.make_dense_reader(vol, plain_params), inv_M, proj, img_size, one_over_voxel_size, mu,
                  zmin, zmax, vol_mod.VIRTUAL_BLOCK, enable, out)


def raycast_dense_cuda(vol: vol_mod.DenseVolume, plain_params, inv_M, proj, img_size, one_over_voxel_size: float,
                       mu: float, zmin, zmax, enable=None, out=None) -> rc.RaycastResult:
    """Launch K3d → points [H, W, 4] over the float32 sdf [Z, Y, X].
    `enable` and `out` as in raycast_grid_cuda."""
    dev = vol.sdf.device
    H, W = img_size
    X, Y, Z = plain_params.size
    ox, oy, oz = plain_params.offset
    if vol.sdf.shape != (Z, Y, X):
        raise ValueError("raycast_dense: sdf must be [Z, Y, X] of plain_params.size")
    build.require_dtype("raycast_dense", vol.sdf, torch.float32)
    out, tensors = _launch_args("raycast_dense", inv_M, proj, img_size, zmin, zmax, enable, out, dev)
    build.require_cuda("raycast_dense", vol.sdf, *tensors, device=dev)
    err = build.library().itpu_raycast_dense(
        vol.sdf.data_ptr(), X, Y, Z, ox, oy, oz, vol_mod.VIRTUAL_BLOCK.bit_length() - 1, inv_M.data_ptr(),
        proj.data_ptr(), ctypes.c_float(one_over_voxel_size), zmin.data_ptr(), zmax.data_ptr(), H, W,
        ctypes.c_float(mu * one_over_voxel_size), None if enable is None else enable.data_ptr(), out.data_ptr(),
        build.stream_ptr(),
    )
    build.check("itpu_raycast_dense", err)
    build.count_launch("raycast_dense")
    return rc.RaycastResult(points=out)


def raycast_dense(vol: vol_mod.DenseVolume, plain_params, inv_M, proj, img_size, one_over_voxel_size: float,
                  mu: float, zmin, zmax, enable=None, out=None) -> rc.RaycastResult:
    """Full-image raycast of the dense voxel array: the plain version for CPU
    tensors, kernel K3d for CUDA tensors."""
    fn = raycast_dense_plain if vol.sdf.device.type == "cpu" else raycast_dense_cuda
    return fn(vol, plain_params, inv_M, proj, img_size, one_over_voxel_size, mu, zmin, zmax, enable=enable, out=out)
