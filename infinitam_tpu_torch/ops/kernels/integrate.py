"""K2: TSDF integration of one depth (+ RGB) frame into the visible voxel blocks.

Replaces the Pallas kernel infinitam_tpu/ops/pallas/integrate_kernel.py
(`integrate_blocks`): `integrate_depth` its depth half, `integrate_rgbd` the
kernel with its colour half. The CUDA kernel (csrc/integrate.cu) runs one
512-thread CTA per visible-list row — the reference's
<<<noVisibleEntries, 8³>>> launch — and rewrites the packed voxels IN PLACE
in `vox` (and `vox_rgb`), as the Pallas kernel aliases them. The plain twins
are the gather → `ops/tsdf.py` update → scatter of the JAX package's XLA
`integrate_into_scene`, also in place.
"""

from __future__ import annotations

import ctypes

import torch

from infinitam_tpu_torch.engine import hash_volume as hv
from infinitam_tpu_torch.ops import tsdf
from infinitam_tpu_torch.ops.kernels import build


def _gather_rows(vox, ptrs, bpos, voxel_size: float, block_size: int):
    """(valid [V], rows [V] long, voxel centres in metres as 3 planes [V, S³]).
    Skipped rows (ptr < 0) are routed to the never-allocated sentinel row,
    which the scatter writes back unchanged, so it needs no filtering."""
    S = block_size
    valid = ptrs >= 0
    rows = torch.where(valid, ptrs, vox.shape[0] - 1).long()
    lin = torch.arange(S**3, dtype=torch.int32, device=vox.device)
    local = (lin % S, (lin // S) % S, lin // (S * S))
    pt = tuple((bpos[:, a : a + 1] * S + local[a][None, :]).to(torch.float32) * voxel_size for a in range(3))
    return valid, rows, pt


def integrate_depth_plain(vox, ptrs, bpos, depth, pose, proj, enable, voxel_size: float, mu: float,
                          max_w: int, stop_at_max_w: bool, block_size: int = 8) -> None:
    """Fuse `depth` into the blocks at VBA rows `ptrs` [V] (−1 = skip) with
    block coords `bpos` [V, 3], in place in `vox` [B, S³]. `enable` (bool
    tensor) switches the whole update off without a host sync."""
    valid, rows, pt = _gather_rows(vox, ptrs, bpos, voxel_size, block_size)
    old = vox[rows]  # [V, S³]
    sdf, w, _clr, _wc = tsdf.integrate_dense(hv.vox_sdf(old), hv.vox_w(old), pt, pose, proj, depth, mu, max_w,
                                             stop_at_max_w)
    vox[rows] = torch.where(valid[:, None] & enable, hv.pack_vox(hv.sdf_to_q(sdf), w), old)


def integrate_depth_cuda(vox, ptrs, bpos, depth, pose, proj, enable, voxel_size: float, mu: float,
                         max_w: int, stop_at_max_w: bool, block_size: int = 8) -> None:
    """Launch K2 without colour (in place in `vox`)."""
    dev = vox.device
    V = _check_rows("integrate", vox, ptrs, bpos, block_size)
    for t, dt in ((depth, torch.float32), (pose, torch.float32), (proj, torch.float32), (enable, torch.bool)):
        build.require_dtype("integrate", t, dt)
    cam = torch.cat([pose[:3].reshape(12), proj.reshape(4)]).contiguous()
    enable = enable.reshape(1).contiguous()
    build.require_cuda("integrate", vox, ptrs, bpos, depth, cam, enable, device=dev)
    h, w = depth.shape
    err = build.library().itpu_integrate_depth(
        vox.data_ptr(), ptrs.data_ptr(), bpos.data_ptr(), V, block_size, depth.data_ptr(), h, w,
        cam.data_ptr(), enable.data_ptr(), ctypes.c_float(voxel_size), ctypes.c_float(mu), max_w,
        int(stop_at_max_w), build.stream_ptr(),
    )
    build.check("itpu_integrate_depth", err)
    build.count_launch("integrate")


def integrate_depth(vox, ptrs, bpos, depth, pose, proj, enable, voxel_size: float, mu: float,
                    max_w: int, stop_at_max_w: bool, block_size: int = 8) -> None:
    """In-place depth fusion: the plain version for CPU tensors, kernel K2
    for CUDA tensors."""
    fn = integrate_depth_plain if vox.device.type == "cpu" else integrate_depth_cuda
    fn(vox, ptrs, bpos, depth, pose, proj, enable, voxel_size, mu, max_w, stop_at_max_w, block_size)


def integrate_rgbd_plain(vox, vox_rgb, ptrs, bpos, depth, rgb, pose, proj, M_rgb, proj_rgb, enable,
                         voxel_size: float, mu: float, max_w: int, stop_at_max_w: bool,
                         block_size: int = 8) -> None:
    """Fuse `depth` and `rgb` [H', W', 3] (float 0..1) into the blocks at VBA
    rows `ptrs` (−1 = skip), in place in `vox` and `vox_rgb` [B, S³]. `pose`
    maps world → depth camera, `M_rgb` world → rgb camera."""
    valid, rows, pt = _gather_rows(vox, ptrs, bpos, voxel_size, block_size)
    old, old_rgb = vox[rows], vox_rgb[rows]
    sdf, w, clr, wc = tsdf.integrate_dense(
        hv.vox_sdf(old), hv.vox_w(old), pt, pose, proj, depth, mu, max_w, stop_at_max_w,
        vol_clr=hv.clr_from_q(hv.rgb_clr_q(old_rgb)), vol_wc=hv.rgb_wc(old_rgb),
        M_rgb=M_rgb, proj_rgb=proj_rgb, rgb=rgb,
    )
    keep = valid[:, None] & enable
    vox[rows] = torch.where(keep, hv.pack_vox(hv.sdf_to_q(sdf), w), old)
    vox_rgb[rows] = torch.where(keep, hv.pack_rgb(hv.clr_to_q(clr), wc), old_rgb)


def integrate_rgbd_cuda(vox, vox_rgb, ptrs, bpos, depth, rgb, pose, proj, M_rgb, proj_rgb, enable,
                        voxel_size: float, mu: float, max_w: int, stop_at_max_w: bool,
                        block_size: int = 8) -> None:
    """Launch K2 with its colour half (in place in `vox` and `vox_rgb`)."""
    dev = vox.device
    V = _check_rows("integrate_color", vox, ptrs, bpos, block_size)
    if vox_rgb.shape != vox.shape:
        raise ValueError("integrate_color: vox_rgb must have the shape of vox")
    if rgb.dim() != 3 or rgb.shape[2] != 3:
        raise ValueError("integrate_color: rgb must be [H, W, 3]")
    for t, dt in ((vox_rgb, torch.int32), (depth, torch.float32), (rgb, torch.float32), (pose, torch.float32),
                  (proj, torch.float32), (M_rgb, torch.float32), (proj_rgb, torch.float32),
                  (enable, torch.bool)):
        build.require_dtype("integrate_color", t, dt)
    cam = torch.cat([pose[:3].reshape(12), proj.reshape(4), M_rgb[:3].reshape(12), proj_rgb.reshape(4)]).contiguous()
    enable = enable.reshape(1).contiguous()
    build.require_cuda("integrate_color", vox, vox_rgb, ptrs, bpos, depth, rgb, cam, enable, device=dev)
    h, w = depth.shape
    rh, rw = rgb.shape[:2]
    err = build.library().itpu_integrate_rgbd(
        vox.data_ptr(), vox_rgb.data_ptr(), ptrs.data_ptr(), bpos.data_ptr(), V, block_size, depth.data_ptr(),
        h, w, rgb.data_ptr(), rh, rw, cam.data_ptr(), enable.data_ptr(), ctypes.c_float(voxel_size),
        ctypes.c_float(mu), max_w, int(stop_at_max_w), build.stream_ptr(),
    )
    build.check("itpu_integrate_rgbd", err)
    build.count_launch("integrate_color")


def integrate_rgbd(vox, vox_rgb, ptrs, bpos, depth, rgb, pose, proj, M_rgb, proj_rgb, enable,
                   voxel_size: float, mu: float, max_w: int, stop_at_max_w: bool, block_size: int = 8) -> None:
    """In-place depth + colour fusion: the plain version for CPU tensors,
    kernel K2 with its colour half for CUDA tensors."""
    fn = integrate_rgbd_plain if vox.device.type == "cpu" else integrate_rgbd_cuda
    fn(vox, vox_rgb, ptrs, bpos, depth, rgb, pose, proj, M_rgb, proj_rgb, enable, voxel_size, mu, max_w,
       stop_at_max_w, block_size)


def _check_rows(name: str, vox, ptrs, bpos, block_size: int) -> int:
    """The row arguments of a K2 launch: vox [B, S³] with S³ ≤ 1024 (one
    thread per voxel), int32 ptrs [V] and bpos [V, 3]. Returns V."""
    S3 = block_size**3
    V = ptrs.shape[0]
    if vox.dim() != 2 or vox.shape[1] != S3 or S3 > 1024:
        raise ValueError(f"{name}: vox must be [B, S³] with S³ ≤ 1024")
    if bpos.shape != (V, 3):
        raise ValueError(f"{name}: bpos must be [V, 3]")
    for t in (vox, ptrs, bpos):
        build.require_dtype(name, t, torch.int32)
    return V
