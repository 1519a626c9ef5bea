"""K2: TSDF integration of one depth (+ RGB) frame into the visible voxel blocks.

Replaces the Pallas kernel infinitam_tpu/ops/pallas/integrate_kernel.py
(`integrate_blocks`): `integrate_depth` its depth half, `integrate_rgbd` the
kernel with its colour half (K2c). Both take the visible list itself — the
entry ids `visible_ids`, of which the first `min(max_rows or V, V)` rows are
fused, and the hash table's `entry_ptr` and `entry_pos` — and rewrite the
packed voxels IN PLACE in `vox` (and `vox_rgb`), as the Pallas kernel
aliases them. The CUDA kernel (csrc/integrate.cu) looks each row up on the
card: a persistent grid whose warps each fuse whole 8³ blocks, so a call is
one launch and no other device op. The plain twins look the rows up with
torch ops and then run the gather → `ops/tsdf.py` update → scatter of the
JAX package's XLA `integrate_into_scene`, also in place.
"""

from __future__ import annotations

import ctypes

import torch

from infinitam_tpu_torch.engine import hash_volume as hv
from infinitam_tpu_torch.ops import tsdf
from infinitam_tpu_torch.ops.kernels import build

BLOCK_SIZE = 8  # the CUDA kernel is written for 8³ blocks (csrc/integrate.cu kS), as the Pallas kernel is


def n_rows(visible_ids, max_rows: int) -> int:
    """How many rows of the visible list a frame fuses: the first
    `max_rows` (settings.max_fused_blocks; 0 = all of them)."""
    V = visible_ids.shape[0]
    return min(max_rows or V, V)


def lookup_rows(visible_ids, entry_ptr, entry_pos, max_rows: int):
    """(VBA rows [n] with −1 for a skipped row, block coords [n, 3]) of the
    fused rows: a row is skipped when its id or its entry's ptr is < 0, as
    the CUDA kernel skips it."""
    ids = visible_ids[: n_rows(visible_ids, max_rows)]
    ids_c = ids.clamp(0, entry_ptr.shape[0] - 1).long()
    ptr = entry_ptr[ids_c]
    return torch.where((ids >= 0) & (ptr >= 0), ptr, -1), entry_pos[ids_c]


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


def integrate_depth_plain(vox, visible_ids, entry_ptr, entry_pos, depth, pose, proj, enable, voxel_size: float,
                          mu: float, max_w: int, stop_at_max_w: bool, block_size: int = 8, max_rows: int = 0) -> None:
    """Fuse `depth` into the blocks of the visible list, in place in `vox`
    [B, S³]. `enable` (bool tensor) switches the whole update off without a
    host sync."""
    ptrs, bpos = lookup_rows(visible_ids, entry_ptr, entry_pos, max_rows)
    valid, rows, pt = _gather_rows(vox, ptrs, bpos, voxel_size, block_size)
    old = vox[rows]  # [V, S³]
    sdf, w, _clr, _wc = tsdf.integrate_dense(hv.vox_sdf(old), hv.vox_w(old), pt, pose, proj, depth, mu, max_w,
                                             stop_at_max_w)
    vox[rows] = torch.where(valid[:, None] & enable, hv.pack_vox(hv.sdf_to_q(sdf), w), old)


def integrate_depth_cuda(vox, visible_ids, entry_ptr, entry_pos, depth, pose, proj, enable, voxel_size: float,
                         mu: float, max_w: int, stop_at_max_w: bool, block_size: int = 8, max_rows: int = 0,
                         n_ctas: int = 0) -> None:
    """Launch K2 without colour (in place in `vox`). `n_ctas` > 0 caps the
    persistent grid (0: as many CTAs as fit on the card)."""
    name = "integrate"
    _check_rows(name, vox, visible_ids, entry_ptr, entry_pos, block_size)
    _check_camera(name, depth, pose, proj, enable)
    build.require_cuda(name, vox, visible_ids, entry_ptr, entry_pos, depth, pose, proj, enable, device=vox.device)
    h, w = depth.shape
    err = build.library().itpu_integrate_depth(
        vox.data_ptr(), visible_ids.data_ptr(), n_rows(visible_ids, max_rows), entry_ptr.data_ptr(),
        entry_pos.data_ptr(), entry_ptr.shape[0], block_size, depth.data_ptr(), h, w, pose.data_ptr(),
        proj.data_ptr(), enable.data_ptr(), ctypes.c_float(voxel_size), ctypes.c_float(mu), max_w,
        int(stop_at_max_w), n_ctas, build.stream_ptr(),
    )
    build.check("itpu_integrate_depth", err)
    build.count_launch(name)


def integrate_depth(vox, visible_ids, entry_ptr, entry_pos, depth, pose, proj, enable, voxel_size: float,
                    mu: float, max_w: int, stop_at_max_w: bool, block_size: int = 8, max_rows: int = 0) -> None:
    """In-place depth fusion: the plain version for CPU tensors, kernel K2
    for CUDA tensors."""
    fn = integrate_depth_plain if vox.device.type == "cpu" else integrate_depth_cuda
    fn(vox, visible_ids, entry_ptr, entry_pos, depth, pose, proj, enable, voxel_size, mu, max_w, stop_at_max_w,
       block_size, max_rows)


def integrate_rgbd_plain(vox, vox_rgb, visible_ids, entry_ptr, entry_pos, depth, rgb, pose, proj, M_rgb, proj_rgb,
                         enable, voxel_size: float, mu: float, max_w: int, stop_at_max_w: bool,
                         block_size: int = 8, max_rows: int = 0) -> None:
    """Fuse `depth` and `rgb` [H', W', 3] (float 0..1) into the blocks of the
    visible list, in place in `vox` and `vox_rgb` [B, S³]. `pose` maps
    world → depth camera, `M_rgb` world → rgb camera."""
    ptrs, bpos = lookup_rows(visible_ids, entry_ptr, entry_pos, max_rows)
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


def integrate_rgbd_cuda(vox, vox_rgb, visible_ids, entry_ptr, entry_pos, depth, rgb, pose, proj, M_rgb, proj_rgb,
                        enable, voxel_size: float, mu: float, max_w: int, stop_at_max_w: bool, block_size: int = 8,
                        max_rows: int = 0, n_ctas: int = 0) -> None:
    """Launch K2 with its colour half (in place in `vox` and `vox_rgb`).
    `n_ctas` as for integrate_depth_cuda."""
    name = "integrate_color"
    _check_rows(name, vox, visible_ids, entry_ptr, entry_pos, block_size)
    _check_camera(name, depth, pose, proj, enable)
    if vox_rgb.shape != vox.shape:
        raise ValueError(f"{name}: vox_rgb must have the shape of vox")
    if rgb.dim() != 3 or rgb.shape[2] != 3:
        raise ValueError(f"{name}: rgb must be [H, W, 3]")
    if M_rgb.shape != (4, 4) or proj_rgb.shape != (4,):
        raise ValueError(f"{name}: M_rgb must be [4, 4] and proj_rgb (fx, fy, cx, cy)")
    build.require_dtype(name, vox_rgb, torch.int32)
    for t in (rgb, M_rgb, proj_rgb):
        build.require_dtype(name, t, torch.float32)
    build.require_cuda(name, vox, vox_rgb, visible_ids, entry_ptr, entry_pos, depth, rgb, pose, proj, M_rgb,
                       proj_rgb, enable, device=vox.device)
    h, w = depth.shape
    rh, rw = rgb.shape[:2]
    err = build.library().itpu_integrate_rgbd(
        vox.data_ptr(), vox_rgb.data_ptr(), visible_ids.data_ptr(), n_rows(visible_ids, max_rows),
        entry_ptr.data_ptr(), entry_pos.data_ptr(), entry_ptr.shape[0], block_size, depth.data_ptr(), h, w,
        rgb.data_ptr(), rh, rw, pose.data_ptr(), proj.data_ptr(), M_rgb.data_ptr(), proj_rgb.data_ptr(),
        enable.data_ptr(), ctypes.c_float(voxel_size), ctypes.c_float(mu), max_w, int(stop_at_max_w), n_ctas,
        build.stream_ptr(),
    )
    build.check("itpu_integrate_rgbd", err)
    build.count_launch(name)


def integrate_rgbd(vox, vox_rgb, visible_ids, entry_ptr, entry_pos, depth, rgb, pose, proj, M_rgb, proj_rgb, enable,
                   voxel_size: float, mu: float, max_w: int, stop_at_max_w: bool, block_size: int = 8,
                   max_rows: int = 0) -> None:
    """In-place depth + colour fusion: the plain version for CPU tensors,
    kernel K2 with its colour half for CUDA tensors."""
    fn = integrate_rgbd_plain if vox.device.type == "cpu" else integrate_rgbd_cuda
    fn(vox, vox_rgb, visible_ids, entry_ptr, entry_pos, depth, rgb, pose, proj, M_rgb, proj_rgb, enable, voxel_size,
       mu, max_w, stop_at_max_w, block_size, max_rows)


def _check_rows(name: str, vox, visible_ids, entry_ptr, entry_pos, block_size: int) -> None:
    """The list arguments of a K2 launch: vox [B, 8³], int32 visible_ids [V],
    entry_ptr [E] and entry_pos [E, 3]."""
    if block_size != BLOCK_SIZE:
        raise ValueError(f"{name}: the CUDA kernel fuses 8³ blocks only, got block_size {block_size}")
    if vox.dim() != 2 or vox.shape[1] != BLOCK_SIZE**3:
        raise ValueError(f"{name}: vox must be [B, 8³]")
    if visible_ids.dim() != 1 or entry_ptr.dim() != 1 or entry_pos.shape != (entry_ptr.shape[0], 3):
        raise ValueError(f"{name}: visible_ids must be [V], entry_ptr [E] and entry_pos [E, 3]")
    for t in (vox, visible_ids, entry_ptr, entry_pos):
        build.require_dtype(name, t, torch.int32)


def _check_camera(name: str, depth, pose, proj, enable) -> None:
    """depth [H, W], pose [4, 4] and proj [4] float32; enable a one-element
    bool tensor. The kernel reads the pose rows from memory, so every tensor
    must be contiguous (build.require_cuda)."""
    if depth.dim() != 2 or pose.shape != (4, 4) or proj.shape != (4,) or enable.numel() != 1:
        raise ValueError(f"{name}: depth must be [H, W], pose [4, 4], proj (fx, fy, cx, cy), enable one bool")
    for t in (depth, pose, proj):
        build.require_dtype(name, t, torch.float32)
    build.require_dtype(name, enable, torch.bool)
