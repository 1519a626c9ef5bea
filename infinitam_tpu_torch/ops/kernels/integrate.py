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

Each launch is a custom op (`itpu::integrate_depth`, `itpu::integrate_rgbd`)
that names `vox` (and `vox_rgb`) as mutated. Under `torch.vmap` its vmap
rule launches the kernel once for all B lanes, the persistent grid split
over the lanes (blockIdx.y the lane: each lane its own volume, list,
entries, frame, pose and enable flag); on the CPU it runs the plain version
lane by lane. A block's update depends on nothing but its own voxels, so a
lane's result is bit-identical to a single-lane launch.

K2d (`integrate_dense`, `itpu::integrate_dense`) is the same depth update
over every voxel of a plain voxel array (engine/volume.py DenseVolume), in
place in its sdf and weight planes: one launch a frame, tiles outside the
camera's frustum culled on the card. Its plain twin is ops/tsdf.py
integrate_dense (whole-array torch ops); its vmap rule makes one launch for
B lanes, as K2's does.
"""

from __future__ import annotations

import ctypes
from typing import Optional

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


# the lane strides' order (csrc/integrate.cu ItpuLanes)
INTEGRATE_LANES = ("vox", "vox_rgb", "ids", "entry_ptr", "entry_pos", "depth", "rgb", "pose", "proj", "M_rgb",
                   "proj_rgb", "enable")


def _launch(n_lanes: int, vox, vox_rgb, visible_ids, entry_ptr, entry_pos, depth, rgb, pose, proj, M_rgb, proj_rgb,
            enable, voxel_size: float, mu: float, max_w: int, stop_at_max_w: bool, block_size: int = 8,
            max_rows: int = 0, n_ctas: int = 0) -> None:
    """One launch of K2 (K2c when `vox_rgb` holds a plane) for `n_lanes`
    lanes, each tensor argument a build.LaneArg in INTEGRATE_LANES order.
    `n_ctas` > 0 caps a lane's persistent grid (0: the CTAs that fit on the
    card, shared out over the lanes)."""
    color = vox_rgb.t is not None
    name = "integrate_color" if color else "integrate"
    v0, ids0, ep0, epos0 = vox.lane(0), visible_ids.lane(0), entry_ptr.lane(0), entry_pos.lane(0)
    d0 = depth.lane(0)
    _check_rows(name, v0, ids0, ep0, epos0, block_size)
    _check_camera(name, d0, pose.lane(0), proj.lane(0), enable.lane(0))
    tensors = [v0, ids0, ep0, epos0, d0, pose.lane(0), proj.lane(0), enable.lane(0)]
    if color:
        vr0, rgb0, M0, pr0 = vox_rgb.lane(0), rgb.lane(0), M_rgb.lane(0), proj_rgb.lane(0)
        if vr0.shape != v0.shape:
            raise ValueError(f"{name}: vox_rgb must have the shape of vox")
        if rgb0.dim() != 3 or rgb0.shape[2] != 3:
            raise ValueError(f"{name}: rgb must be [H, W, 3]")
        if M0.shape != (4, 4) or pr0.shape != (4,):
            raise ValueError(f"{name}: M_rgb must be [4, 4] and proj_rgb (fx, fy, cx, cy)")
        build.require_dtype(name, vr0, torch.int32)
        for t in (rgb0, M0, pr0):
            build.require_dtype(name, t, torch.float32)
        tensors += [vr0, rgb0, M0, pr0]
    build.require_cuda(name, *tensors, device=v0.device)
    h, w = d0.shape
    lanes = [vox, vox_rgb, visible_ids, entry_ptr, entry_pos, depth, rgb, pose, proj, M_rgb, proj_rgb, enable]
    rows = n_rows(ids0, max_rows)
    tail = (ctypes.c_float(voxel_size), ctypes.c_float(mu), max_w, int(stop_at_max_w), n_ctas, n_lanes,
            build.lane_strides(lanes), build.stream_ptr())
    if color:
        rh, rw = rgb0.shape[:2]
        err = build.library().itpu_integrate_rgbd(
            vox.ptr(), vox_rgb.ptr(), visible_ids.ptr(), rows, entry_ptr.ptr(), entry_pos.ptr(), ep0.shape[0],
            block_size, depth.ptr(), h, w, rgb.ptr(), rh, rw, pose.ptr(), proj.ptr(), M_rgb.ptr(), proj_rgb.ptr(),
            enable.ptr(), *tail,
        )
    else:
        err = build.library().itpu_integrate_depth(
            vox.ptr(), visible_ids.ptr(), rows, entry_ptr.ptr(), entry_pos.ptr(), ep0.shape[0], block_size,
            depth.ptr(), h, w, pose.ptr(), proj.ptr(), enable.ptr(), *tail,
        )
    build.check(f"itpu_{'integrate_rgbd' if color else 'integrate_depth'}", err)
    build.count_launch(name)


def integrate_depth_cuda(vox, visible_ids, entry_ptr, entry_pos, depth, pose, proj, enable, voxel_size: float,
                         mu: float, max_w: int, stop_at_max_w: bool, block_size: int = 8, max_rows: int = 0,
                         n_ctas: int = 0) -> None:
    """Launch K2 without colour for one lane (in place in `vox`). `n_ctas`
    > 0 caps the persistent grid (0: as many CTAs as fit on the card)."""
    _launch(1, *build.single(vox, None, visible_ids, entry_ptr, entry_pos, depth, None, pose, proj, None, None,
                             enable), voxel_size, mu, max_w, stop_at_max_w, block_size, max_rows, n_ctas)


@torch.library.custom_op("itpu::integrate_depth", mutates_args=("vox",))
def integrate_depth_op(vox: torch.Tensor, visible_ids: torch.Tensor, entry_ptr: torch.Tensor,
                       entry_pos: torch.Tensor, depth: torch.Tensor, pose: torch.Tensor, proj: torch.Tensor,
                       enable: torch.Tensor, voxel_size: float, mu: float, max_w: int, stop_at_max_w: bool,
                       block_size: int, max_rows: int) -> None:
    """One lane's depth fusion, in place in `vox`: the plain version for CPU
    tensors, K2 for CUDA tensors."""
    fn = integrate_depth_plain if vox.device.type == "cpu" else integrate_depth_cuda
    fn(vox, visible_ids, entry_ptr, entry_pos, depth, pose, proj, enable, voxel_size, mu, max_w, stop_at_max_w,
       block_size, max_rows)


@integrate_depth_op.register_vmap
def _integrate_depth_vmap(info, in_dims, vox, visible_ids, entry_ptr, entry_pos, depth, pose, proj, enable, *fuse):
    """B lanes: one K2 launch on the card; the plain version lane by lane on
    the CPU."""
    lanes, backs = build.vmap_lanes(in_dims[:8], (vox, visible_ids, entry_ptr, entry_pos, depth, pose, proj, enable))
    if vox.device.type == "cpu":
        for b in range(info.batch_size):
            integrate_depth_op(*(a.lane(b) for a in lanes), *fuse)
    else:
        none = build.LaneArg(None)
        v, ids, ep, epos, d, po, pr, en = lanes
        _launch(info.batch_size, v, none, ids, ep, epos, d, none, po, pr, none, none, en, *fuse)
    build.write_back(backs, (0,))
    return None, None


def integrate_depth(vox, visible_ids, entry_ptr, entry_pos, depth, pose, proj, enable, voxel_size: float,
                    mu: float, max_w: int, stop_at_max_w: bool, block_size: int = 8, max_rows: int = 0) -> None:
    """In-place depth fusion: the plain version for CPU tensors, kernel K2
    for CUDA tensors (through `itpu::integrate_depth`, so that `torch.vmap`
    batches it into one launch)."""
    integrate_depth_op(vox, visible_ids, entry_ptr, entry_pos, depth, pose, proj, enable, float(voxel_size),
                       float(mu), int(max_w), bool(stop_at_max_w), int(block_size), int(max_rows))


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
    """Launch K2 with its colour half for one lane (in place in `vox` and
    `vox_rgb`). `n_ctas` as for integrate_depth_cuda."""
    _launch(1, *build.single(vox, vox_rgb, visible_ids, entry_ptr, entry_pos, depth, rgb, pose, proj, M_rgb,
                             proj_rgb, enable), voxel_size, mu, max_w, stop_at_max_w, block_size, max_rows, n_ctas)


@torch.library.custom_op("itpu::integrate_rgbd", mutates_args=("vox", "vox_rgb"))
def integrate_rgbd_op(vox: torch.Tensor, vox_rgb: torch.Tensor, visible_ids: torch.Tensor, entry_ptr: torch.Tensor,
                      entry_pos: torch.Tensor, depth: torch.Tensor, rgb: torch.Tensor, pose: torch.Tensor,
                      proj: torch.Tensor, M_rgb: torch.Tensor, proj_rgb: torch.Tensor, enable: torch.Tensor,
                      voxel_size: float, mu: float, max_w: int, stop_at_max_w: bool, block_size: int,
                      max_rows: int) -> None:
    """One lane's depth + colour fusion, in place in `vox` and `vox_rgb`:
    the plain version for CPU tensors, K2c for CUDA tensors."""
    fn = integrate_rgbd_plain if vox.device.type == "cpu" else integrate_rgbd_cuda
    fn(vox, vox_rgb, visible_ids, entry_ptr, entry_pos, depth, rgb, pose, proj, M_rgb, proj_rgb, enable, voxel_size,
       mu, max_w, stop_at_max_w, block_size, max_rows)


@integrate_rgbd_op.register_vmap
def _integrate_rgbd_vmap(info, in_dims, *args):
    """B lanes: one K2c launch on the card; the plain version lane by lane
    on the CPU."""
    lanes, backs = build.vmap_lanes(in_dims[:12], args[:12])
    if args[0].device.type == "cpu":
        for b in range(info.batch_size):
            integrate_rgbd_op(*(a.lane(b) for a in lanes), *args[12:])
    else:
        _launch(info.batch_size, *lanes, *args[12:])
    build.write_back(backs, (0, 1))
    return None, None


def integrate_rgbd(vox, vox_rgb, visible_ids, entry_ptr, entry_pos, depth, rgb, pose, proj, M_rgb, proj_rgb, enable,
                   voxel_size: float, mu: float, max_w: int, stop_at_max_w: bool, block_size: int = 8,
                   max_rows: int = 0) -> None:
    """In-place depth + colour fusion: the plain version for CPU tensors,
    kernel K2 with its colour half for CUDA tensors (through
    `itpu::integrate_rgbd`, batched by `torch.vmap` into one launch)."""
    integrate_rgbd_op(vox, vox_rgb, visible_ids, entry_ptr, entry_pos, depth, rgb, pose, proj, M_rgb, proj_rgb,
                      enable, float(voxel_size), float(mu), int(max_w), bool(stop_at_max_w), int(block_size),
                      int(max_rows))


# K2d's lane strides' order (csrc/integrate.cu itpu_integrate_dense)
DENSE_LANES = ("sdf", "w", "xs", "ys", "zs", "depth", "pose", "proj")
# a warp's tile of the array (x, y, z), the unit K2d culls and counts
DENSE_TILE = (32, 1, 8)


def dense_tiles(size_xyz) -> int:
    """How many tiles of DENSE_TILE K2d splits one lane's [Z, Y, X] array
    into: the most its `culled` counter can add a lane."""
    X, Y, Z = size_xyz
    tx, ty, tz = DENSE_TILE
    return -(-X // tx) * -(-Y // ty) * -(-Z // tz)


def integrate_dense_plain(sdf, w, xs, ys, zs, depth, pose, proj, voxel_size: float, mu: float, max_w: int,
                          stop_at_max_w: bool, culled=None) -> None:
    """Fuse `depth` into every voxel of the plain array, in place in `sdf`
    [Z, Y, X] (float32) and `w` (int32): ops/tsdf.py integrate_dense over
    the voxel centres xs [X], ys [Y], zs [Z] (engine/volume.py
    voxel_world_coords). It culls nothing, so it leaves `culled` (the
    kernel's tile counter) and `voxel_size` (the cull's margin) unused."""
    pts = (xs.reshape(1, 1, -1), ys.reshape(1, -1, 1), zs.reshape(-1, 1, 1))
    tsdf.integrate_dense(sdf, w, pts, pose, proj, depth, mu, max_w, stop_at_max_w, into=True)


def _launch_dense(n_lanes: int, sdf, w, xs, ys, zs, depth, pose, proj, voxel_size: float, mu: float, max_w: int,
                  stop_at_max_w: bool, culled: Optional[torch.Tensor]) -> None:
    """One launch of K2d for `n_lanes` lanes, each tensor argument a
    build.LaneArg in DENSE_LANES order; `culled` (shared by the lanes, or
    None) adds up the culled tiles."""
    name = "integrate_dense"
    s0, w0, x0, y0, z0, d0, p0, pr0 = (a.lane(0) for a in (sdf, w, xs, ys, zs, depth, pose, proj))
    if s0.dim() != 3 or w0.shape != s0.shape:
        raise ValueError(f"{name}: sdf must be [Z, Y, X] and w of its shape")
    Z, Y, X = s0.shape
    if x0.shape != (X,) or y0.shape != (Y,) or z0.shape != (Z,):
        raise ValueError(f"{name}: xs, ys, zs must be the array's axes [X], [Y], [Z]")
    if d0.dim() != 2 or p0.shape != (4, 4) or pr0.shape != (4,):
        raise ValueError(f"{name}: depth must be [H, W], pose [4, 4], proj (fx, fy, cx, cy)")
    for t in (s0, x0, y0, z0, d0, p0, pr0):
        build.require_dtype(name, t, torch.float32)
    build.require_dtype(name, w0, torch.int32)
    tensors = [s0, w0, x0, y0, z0, d0, p0, pr0]
    if culled is not None:
        if culled.numel() != 1:
            raise ValueError(f"{name}: culled must be one int64 counter")
        build.require_dtype(name, culled, torch.int64)
        tensors.append(culled)
    build.require_cuda(name, *tensors, device=s0.device)
    h, wd = d0.shape
    lanes = [sdf, w, xs, ys, zs, depth, pose, proj]
    err = build.library().itpu_integrate_dense(
        sdf.ptr(), w.ptr(), xs.ptr(), ys.ptr(), zs.ptr(), X, Y, Z, depth.ptr(), h, wd, pose.ptr(), proj.ptr(),
        ctypes.c_float(voxel_size), ctypes.c_float(mu), max_w, int(stop_at_max_w),
        None if culled is None else culled.data_ptr(), n_lanes, build.lane_strides(lanes), build.stream_ptr(),
    )
    build.check("itpu_integrate_dense", err)
    build.count_launch(name)


def integrate_dense_cuda(sdf, w, xs, ys, zs, depth, pose, proj, voxel_size: float, mu: float, max_w: int,
                         stop_at_max_w: bool, culled=None) -> None:
    """Launch K2d for one lane (in place in `sdf` and `w`)."""
    _launch_dense(1, *build.single(sdf, w, xs, ys, zs, depth, pose, proj), voxel_size, mu, max_w, stop_at_max_w,
                  culled)


@torch.library.custom_op("itpu::integrate_dense", mutates_args=("sdf", "w", "culled"))
def integrate_dense_op(sdf: torch.Tensor, w: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor, zs: torch.Tensor,
                       depth: torch.Tensor, pose: torch.Tensor, proj: torch.Tensor, voxel_size: float, mu: float,
                       max_w: int, stop_at_max_w: bool, culled: Optional[torch.Tensor]) -> None:
    """One lane's dense fusion, in place in `sdf` and `w`: the plain version
    for CPU tensors, K2d for CUDA tensors."""
    fn = integrate_dense_plain if sdf.device.type == "cpu" else integrate_dense_cuda
    fn(sdf, w, xs, ys, zs, depth, pose, proj, voxel_size, mu, max_w, stop_at_max_w, culled)


@integrate_dense_op.register_vmap
def _integrate_dense_vmap(info, in_dims, *args):
    """B lanes: one K2d launch on the card; the plain version lane by lane
    on the CPU. The `culled` counter is shared by the lanes."""
    if in_dims[12] is not None:
        raise ValueError("integrate_dense: the culled counter is shared by the lanes, not batched")
    lanes, backs = build.vmap_lanes(in_dims[:8], args[:8])
    if args[0].device.type == "cpu":
        for b in range(info.batch_size):
            integrate_dense_op(*(a.lane(b) for a in lanes), *args[8:])
    else:
        _launch_dense(info.batch_size, *lanes, *args[8:])
    build.write_back(backs, (0, 1))
    return None, None


def integrate_dense(sdf, w, xs, ys, zs, depth, pose, proj, voxel_size: float, mu: float, max_w: int,
                    stop_at_max_w: bool, culled=None) -> None:
    """In-place fusion of `depth` into every voxel of the plain array: the
    plain version for CPU tensors, kernel K2d for CUDA tensors (through
    `itpu::integrate_dense`, batched by `torch.vmap` into one launch).
    `culled`, an int64 counter on the card, adds up the tiles K2d culled."""
    integrate_dense_op(sdf, w, xs, ys, zs, depth, pose, proj, float(voxel_size), float(mu), int(max_w),
                       bool(stop_at_max_w), culled)


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
