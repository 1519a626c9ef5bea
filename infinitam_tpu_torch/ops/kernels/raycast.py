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

K3d marches with a lookahead (csrc/raycast.cu): two reads in flight a
ray, committed only where they are the lock-step march's; K3h walks a hash
level in one round trip. The lock-step design they replaced launches
through `raycast_hash_probe_lockstep` and `raycast_dense_lockstep`, for
comparisons only: those launches are not counted, and the main path never
makes them. `occupancy` reads a raycast kernel's resident CTAs per SM.

Each launch is a custom op (`itpu::raycast_grid`, `itpu::raycast_hash`,
`itpu::raycast_dense`) that names `out` as mutated. Under `torch.vmap` its
vmap rule launches the kernel once for all B lanes (the tiles × B grid,
blockIdx.z the lane: each lane its own volume, camera, ranges, flag and
output; an input with no batch dim, such as the intrinsics, shared); on the
CPU it runs the plain version lane by lane. A wrapper with no `out` makes
one from the camera pose (`inv_M.new_empty`), so under vmap it has a lane
dim wherever the pose has one.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from infinitam_tpu_torch.config import BlockGridParams, PlainVoxelArrayParams, VoxelBlockHashParams
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


# the lane strides' order (csrc/raycast.cu ItpuRaycastLanes): the
# arguments every variant shares, then its reader's
RAYCAST_LANES = ("inv_M", "proj", "zmin", "zmax", "enable", "out")


def _checked_lanes(name, inv_M, proj, zmin, zmax, enable, out):
    """Checks the arguments every variant shares (build.LaneArgs; `out`
    given); returns lane 0's tensors to check for device and layout."""
    H, W = out.lane(0).shape[:2]
    if (inv_M.lane(0).shape != (4, 4) or proj.lane(0).shape != (4,) or zmin.lane(0).shape != (H, W)
            or zmax.lane(0).shape != (H, W)):
        raise ValueError(f"{name}: inv_M must be [4, 4], proj (fx, fy, cx, cy), zmin and zmax [H, W]")
    if out.lane(0).shape != (H, W, 4):
        raise ValueError(f"{name}: out must be [H, W, 4]")
    tensors = [inv_M.lane(0), proj.lane(0), zmin.lane(0), zmax.lane(0), out.lane(0)]
    for t in tensors:
        build.require_dtype(name, t, torch.float32)
    if enable.t is not None:
        if enable.lane(0).numel() != 1:
            raise ValueError(f"{name}: enable must be one bool")
        build.require_dtype(name, enable.lane(0), torch.bool)
        tensors.append(enable.lane(0))
    return tensors


def _block_shift_of(name, vox: torch.Tensor, block_size: int) -> int:
    S = block_size
    if S & (S - 1):
        raise ValueError(f"{name}: block_size must be a power of two")
    if vox.dim() != 2 or vox.shape[1] != S**3:
        raise ValueError(f"{name}: vox must be [B, S³]")
    build.require_dtype(name, vox, torch.int32)
    return S.bit_length() - 1


def _launch_tail(n_lanes, inv_M, proj, one_over_voxel_size, zmin, zmax, mu, enable, out, readers):
    """The arguments every entry point ends with, from inv_M on."""
    H, W = out.lane(0).shape[:2]
    lanes = [inv_M, proj, zmin, zmax, enable, out, *readers]
    return (inv_M.ptr(), proj.ptr(), ctypes.c_float(one_over_voxel_size), zmin.ptr(), zmax.ptr(), H, W,
            ctypes.c_float(mu * one_over_voxel_size), enable.ptr(), out.ptr(), n_lanes, build.lane_strides(lanes),
            build.stream_ptr())


def _launch_grid(n_lanes, vox, grid, inv_M, proj, zmin, zmax, enable, out, gx: int, gy: int, gz: int, ox: int,
                 oy: int, oz: int, block_size: int, one_over_voxel_size: float, mu: float) -> None:
    """One K3 launch for `n_lanes` lanes (build.LaneArgs) through the block
    grid [gx, gy, gz] at block origin (ox, oy, oz)."""
    shift = _block_shift_of("raycast", vox.lane(0), block_size)
    g0 = grid.lane(0)
    if g0.dim() != 1 or g0.shape[0] != gx * gy * gz:
        raise ValueError("raycast: block grid does not match grid_params.dims")
    build.require_dtype("raycast", g0, torch.int32)
    tensors = _checked_lanes("raycast", inv_M, proj, zmin, zmax, enable, out)
    build.require_cuda("raycast", vox.lane(0), g0, *tensors, device=vox.lane(0).device)
    err = build.library().itpu_raycast(
        vox.ptr(), grid.ptr(), gx, gy, gz, ox, oy, oz, shift,
        *_launch_tail(n_lanes, inv_M, proj, one_over_voxel_size, zmin, zmax, mu, enable, out, (vox, grid)),
    )
    build.check("itpu_raycast", err)
    build.count_launch("raycast")


# occupancy's kernels, as csrc/raycast.cu itpu_raycast_occupancy numbers them
OCCUPANCY_KERNELS = {"raycast": 0, "raycast_hash": 1, "raycast_dense": 2, "raycast_hash_lockstep": 3,
                     "raycast_dense_lockstep": 4}


def occupancy(kernel: str, n_lanes: int = 1) -> tuple:
    """(resident CTAs of 128 threads per SM, the card's SMs) of a raycast
    kernel (a key of OCCUPANCY_KERNELS) launched for `n_lanes` lanes, from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor on the current card."""
    ctas, sms = ctypes.c_int(), ctypes.c_int()
    err = build.library().itpu_raycast_occupancy(OCCUPANCY_KERNELS[kernel], n_lanes, ctypes.byref(ctas),
                                                 ctypes.byref(sms))
    build.check("itpu_raycast_occupancy", err)
    return ctas.value, sms.value


def _launch_hash(n_lanes, vox, entry_pos, entry_ptr, entry_offset, inv_M, proj, zmin, zmax, enable, out,
                 n_buckets: int, hash_mask: int, block_size: int, one_over_voxel_size: float, mu: float,
                 lockstep: bool = False) -> None:
    """One K3h launch for `n_lanes` lanes (build.LaneArgs); in the
    `lockstep` design, not counted."""
    shift = _block_shift_of("raycast_hash", vox.lane(0), block_size)
    ep0, pt0, of0 = entry_pos.lane(0), entry_ptr.lane(0), entry_offset.lane(0)
    E = pt0.shape[0]
    if pt0.dim() != 1 or ep0.shape != (E, 3) or of0.shape != (E,):
        raise ValueError("raycast_hash: entry_pos must be [E, 3], entry_ptr and entry_offset [E]")
    for t in (ep0, pt0, of0):
        build.require_dtype("raycast_hash", t, torch.int32)
    tensors = _checked_lanes("raycast_hash", inv_M, proj, zmin, zmax, enable, out)
    build.require_cuda("raycast_hash", vox.lane(0), ep0, pt0, of0, *tensors, device=vox.lane(0).device)
    args = (vox.ptr(), entry_pos.ptr(), entry_ptr.ptr(), entry_offset.ptr(), n_buckets, hash_mask, shift,
            *_launch_tail(n_lanes, inv_M, proj, one_over_voxel_size, zmin, zmax, mu, enable, out,
                          (vox, entry_pos, entry_ptr, entry_offset)))
    if lockstep:
        build.check("itpu_raycast_hash_lockstep", build.library().itpu_raycast_hash_lockstep(*args))
        return
    build.check("itpu_raycast_hash", build.library().itpu_raycast_hash(*args))
    build.count_launch("raycast_hash")


def _launch_dense(n_lanes, sdf, inv_M, proj, zmin, zmax, enable, out, X: int, Y: int, Z: int, ox: int, oy: int,
                  oz: int, one_over_voxel_size: float, mu: float, lockstep: bool = False) -> None:
    """One K3d launch for `n_lanes` lanes (build.LaneArgs) over the array of
    X × Y × Z voxels at voxel offset (ox, oy, oz); in the `lockstep` design,
    not counted."""
    s0 = sdf.lane(0)
    if s0.shape != (Z, Y, X):
        raise ValueError("raycast_dense: sdf must be [Z, Y, X] of plain_params.size")
    build.require_dtype("raycast_dense", s0, torch.float32)
    tensors = _checked_lanes("raycast_dense", inv_M, proj, zmin, zmax, enable, out)
    build.require_cuda("raycast_dense", s0, *tensors, device=s0.device)
    args = (sdf.ptr(), X, Y, Z, ox, oy, oz, vol_mod.VIRTUAL_BLOCK.bit_length() - 1,
            *_launch_tail(n_lanes, inv_M, proj, one_over_voxel_size, zmin, zmax, mu, enable, out, (sdf,)))
    if lockstep:
        build.check("itpu_raycast_dense_lockstep", build.library().itpu_raycast_dense_lockstep(*args))
        return
    build.check("itpu_raycast_dense", build.library().itpu_raycast_dense(*args))
    build.count_launch("raycast_dense")


def _out(out, inv_M, img_size):
    """The output the kernel writes: `out`, or a new [H, W, 4] made from the
    pose (under vmap it then has the pose's lane dim)."""
    return inv_M.new_empty((*img_size, 4)) if out is None else out


def _vox_volume(vox, entry_pos=None, entry_ptr=None, entry_offset=None) -> hv.HashVolume:
    """A HashVolume holding only what the plain readers read."""
    return hv.HashVolume(entry_pos=entry_pos, entry_ptr=entry_ptr, entry_offset=entry_offset, vox=vox,
                         alloc_list=None, last_free_block=None, excess_list=None, last_free_excess=None)


def _vmap_rule(op, n_tensors: int, launch, *, out_at: int):
    """The vmap rule of a raycast op whose first `n_tensors` arguments are
    tensors (`out` at `out_at` among them): one launch for all lanes on the
    card, the op lane by lane on the CPU."""

    def rule(info, in_dims, *args):
        if in_dims[out_at] is None and any(d is not None for d in in_dims[:n_tensors]):
            raise ValueError(f"{op}: under vmap `out` needs the lane dim of the inputs")
        lanes, backs = build.vmap_lanes(in_dims[:n_tensors], args[:n_tensors])
        if args[0].device.type == "cpu":
            for b in range(info.batch_size):
                op(*(a.lane(b) for a in lanes), *args[n_tensors:])
        else:
            launch(info.batch_size, *lanes, *args[n_tensors:])
        build.write_back(backs, (out_at,))
        return None, None

    return rule


@torch.library.custom_op("itpu::raycast_grid", mutates_args=("out",))
def raycast_grid_op(vox: torch.Tensor, grid: torch.Tensor, inv_M: torch.Tensor, proj: torch.Tensor,
                    zmin: torch.Tensor, zmax: torch.Tensor, enable: Optional[torch.Tensor], out: torch.Tensor,
                    gx: int, gy: int, gz: int, ox: int, oy: int, oz: int, block_size: int,
                    one_over_voxel_size: float, mu: float) -> None:
    """One lane's K3 into `out`: the plain version for CPU tensors, the
    kernel for CUDA tensors."""
    if vox.device.type == "cpu":
        gp = BlockGridParams(dims=(gx, gy, gz), origin=(ox, oy, oz))
        res = raycast_grid_plain(_vox_volume(vox), grid, gp, VoxelBlockHashParams(block_size=block_size), inv_M,
                                 proj, tuple(out.shape[:2]), one_over_voxel_size, mu, zmin, zmax, enable, out)
        out.copy_(res.points)
        return
    _launch_grid(1, *build.single(vox, grid, inv_M, proj, zmin, zmax, enable, out), gx, gy, gz, ox, oy, oz,
                 block_size, one_over_voxel_size, mu)


raycast_grid_op.register_vmap(_vmap_rule(raycast_grid_op, 8, _launch_grid, out_at=7))


@torch.library.custom_op("itpu::raycast_hash", mutates_args=("out",))
def raycast_hash_op(vox: torch.Tensor, entry_pos: torch.Tensor, entry_ptr: torch.Tensor, entry_offset: torch.Tensor,
                    inv_M: torch.Tensor, proj: torch.Tensor, zmin: torch.Tensor, zmax: torch.Tensor,
                    enable: Optional[torch.Tensor], out: torch.Tensor, n_buckets: int, hash_mask: int,
                    block_size: int, one_over_voxel_size: float, mu: float) -> None:
    """One lane's K3h into `out`: the plain version for CPU tensors, the
    kernel for CUDA tensors."""
    if vox.device.type == "cpu":
        params = VoxelBlockHashParams(block_size=block_size, n_buckets=n_buckets)
        res = raycast_hash_probe_plain(_vox_volume(vox, entry_pos, entry_ptr, entry_offset), params, inv_M, proj,
                                       tuple(out.shape[:2]), one_over_voxel_size, mu, zmin, zmax, enable, out)
        out.copy_(res.points)
        return
    _launch_hash(1, *build.single(vox, entry_pos, entry_ptr, entry_offset, inv_M, proj, zmin, zmax, enable, out),
                 n_buckets, hash_mask, block_size, one_over_voxel_size, mu)


raycast_hash_op.register_vmap(_vmap_rule(raycast_hash_op, 10, _launch_hash, out_at=9))


@torch.library.custom_op("itpu::raycast_dense", mutates_args=("out",))
def raycast_dense_op(sdf: torch.Tensor, inv_M: torch.Tensor, proj: torch.Tensor, zmin: torch.Tensor,
                     zmax: torch.Tensor, enable: Optional[torch.Tensor], out: torch.Tensor, sx: int, sy: int,
                     sz: int, ox: int, oy: int, oz: int, one_over_voxel_size: float, mu: float) -> None:
    """One lane's K3d into `out`: the plain version for CPU tensors, the
    kernel for CUDA tensors."""
    if sdf.device.type == "cpu":
        pp = PlainVoxelArrayParams(size=(sx, sy, sz), offset=(ox, oy, oz))
        res = raycast_dense_plain(vol_mod.DenseVolume(sdf=sdf, w_depth=None), pp, inv_M, proj, tuple(out.shape[:2]),
                                  one_over_voxel_size, mu, zmin, zmax, enable, out)
        out.copy_(res.points)
        return
    _launch_dense(1, *build.single(sdf, inv_M, proj, zmin, zmax, enable, out), sx, sy, sz, ox, oy, oz,
                  one_over_voxel_size, mu)


raycast_dense_op.register_vmap(_vmap_rule(raycast_dense_op, 7, _launch_dense, out_at=6))


def raycast_grid_plain(vol, grid, grid_params, params, inv_M, proj, img_size, one_over_voxel_size: float,
                       mu: float, zmin, zmax, enable=None, out=None) -> rc.RaycastResult:
    """The plain version of K3: the lock-step march over a grid reader."""
    return _plain(hv.make_grid_reader(vol, grid, grid_params, params), inv_M, proj, img_size, one_over_voxel_size,
                  mu, zmin, zmax, params.block_size, enable, out)


def raycast_grid_cuda(vol, grid, grid_params, params, inv_M, proj, img_size, one_over_voxel_size: float,
                      mu: float, zmin, zmax, enable=None, out=None) -> rc.RaycastResult:
    """Launch K3 for one lane → points [H, W, 4] (into `out` when given);
    the kernel builds each pixel's ray. `enable`: a one-element bool tensor
    on the card, or None (on); while it is false no ray is marched and the
    points keep what the output held (unspecified without `out`)."""
    out = _out(out, inv_M, img_size)
    _launch_grid(1, *build.single(vol.vox, grid.reshape(-1), inv_M, proj, zmin, zmax, enable, out),
                 *grid_params.dims, *grid_params.origin, params.block_size, one_over_voxel_size, mu)
    return rc.RaycastResult(points=out)

def raycast_grid(vol, grid, grid_params, params, inv_M, proj, img_size, one_over_voxel_size: float,
                 mu: float, zmin, zmax, enable=None, out=None) -> rc.RaycastResult:
    """Full-image raycast of `vol` from camera→world `inv_M` between the
    per-pixel ranges zmin..zmax, where the device bool `enable` (None: on)
    is true, into `out` (made when None): the plain version for CPU
    tensors, kernel K3 for CUDA tensors (through `itpu::raycast_grid`)."""
    out = _out(out, inv_M, img_size)
    raycast_grid_op(vol.vox, grid.reshape(-1), inv_M, proj, zmin, zmax, enable, out, *grid_params.dims,
                    *grid_params.origin, params.block_size, float(one_over_voxel_size), float(mu))
    return rc.RaycastResult(points=out)

def raycast_hash_probe_plain(vol, params, inv_M, proj, img_size, one_over_voxel_size: float, mu: float, zmin, zmax,
                             enable=None, out=None) -> rc.RaycastResult:
    """The plain version of K3h: the lock-step march over the hash reader
    (swapped-out blocks are not found)."""
    return _plain(hv.make_hash_reader(vol, params), inv_M, proj, img_size, one_over_voxel_size, mu, zmin, zmax,
                  params.block_size, enable, out)


def raycast_hash_probe_cuda(vol, params, inv_M, proj, img_size, one_over_voxel_size: float, mu: float, zmin, zmax,
                            enable=None, out=None) -> rc.RaycastResult:
    """Launch K3h for one lane → points [H, W, 4]: K3 with each block looked
    up by a walk of its hash chain. `enable` and `out` as in
    raycast_grid_cuda."""
    out = _out(out, inv_M, img_size)
    _launch_hash(1, *build.single(vol.vox, vol.entry_pos, vol.entry_ptr, vol.entry_offset, inv_M, proj, zmin, zmax,
                                  enable, out), params.n_buckets, params.hash_mask, params.block_size,
                 one_over_voxel_size, mu)
    return rc.RaycastResult(points=out)

def raycast_hash_probe(vol, params, inv_M, proj, img_size, one_over_voxel_size: float, mu: float, zmin, zmax,
                       enable=None, out=None) -> rc.RaycastResult:
    """Full-image raycast of the hash volume through its hash table: the
    plain version for CPU tensors, kernel K3h for CUDA tensors (through
    `itpu::raycast_hash`)."""
    out = _out(out, inv_M, img_size)
    raycast_hash_op(vol.vox, vol.entry_pos, vol.entry_ptr, vol.entry_offset, inv_M, proj, zmin, zmax, enable, out,
                    params.n_buckets, params.hash_mask, params.block_size, float(one_over_voxel_size), float(mu))
    return rc.RaycastResult(points=out)


def _lockstep_lanes(lanes: int, *tensors):
    """LaneArgs of a lock-step launch: with `lanes` B > 0 every tensor holds
    B lanes on dim 0 (None stays absent), else one lane."""
    if not lanes:
        return build.single(*tensors)
    return [build.LaneArg(t) if t is None else build.LaneArg(t, t.stride(0), True) for t in tensors]


def raycast_hash_probe_lockstep(vol, params, inv_M, proj, img_size, one_over_voxel_size: float, mu: float, zmin,
                                zmax, enable=None, out=None, lanes: int = 0) -> rc.RaycastResult:
    """K3h in the lock-step design it replaced (the serial walk of a hash
    level) on CUDA tensors, for comparisons (not counted); the plain version
    on CPU tensors. With `lanes` B > 0 one launch marches B lanes: the
    volume's arrays, inv_M, zmin, zmax, enable and out hold the lanes on dim
    0 (out must be given), proj is shared."""
    if vol.vox.device.type == "cpu":
        return raycast_hash_probe_plain(vol, params, inv_M, proj, img_size, one_over_voxel_size, mu, zmin, zmax,
                                        enable, out)
    out = _out(out, inv_M, img_size)
    la = _lockstep_lanes(lanes, vol.vox, vol.entry_pos, vol.entry_ptr, vol.entry_offset, inv_M, None, zmin, zmax,
                         enable, out)
    la[5] = build.LaneArg(proj)
    _launch_hash(max(lanes, 1), *la, params.n_buckets, params.hash_mask, params.block_size, one_over_voxel_size, mu,
                 lockstep=True)
    return rc.RaycastResult(points=out)


def raycast_dense_lockstep(vol: vol_mod.DenseVolume, plain_params, inv_M, proj, img_size, one_over_voxel_size: float,
                           mu: float, zmin, zmax, enable=None, out=None, lanes: int = 0) -> rc.RaycastResult:
    """K3d in the lock-step design it replaced (LA 1) on CUDA tensors, for
    comparisons (not counted); the plain version on CPU tensors. `lanes` as
    in raycast_hash_probe_lockstep (vol.sdf [B, Z, Y, X])."""
    if vol.sdf.device.type == "cpu":
        return raycast_dense_plain(vol, plain_params, inv_M, proj, img_size, one_over_voxel_size, mu, zmin, zmax,
                                   enable, out)
    out = _out(out, inv_M, img_size)
    la = _lockstep_lanes(lanes, vol.sdf, inv_M, None, zmin, zmax, enable, out)
    la[2] = build.LaneArg(proj)
    _launch_dense(max(lanes, 1), *la, *plain_params.size, *plain_params.offset, one_over_voxel_size, mu,
                  lockstep=True)
    return rc.RaycastResult(points=out)


def raycast_dense_plain(vol: vol_mod.DenseVolume, plain_params, inv_M, proj, img_size, one_over_voxel_size: float,
                        mu: float, zmin, zmax, enable=None, out=None) -> rc.RaycastResult:
    """The plain version of K3d: the lock-step march over the dense reader,
    empty space outside the array stepping through its virtual 8³ blocks."""
    return _plain(vol_mod.make_dense_reader(vol, plain_params), inv_M, proj, img_size, one_over_voxel_size, mu,
                  zmin, zmax, vol_mod.VIRTUAL_BLOCK, enable, out)


def raycast_dense_cuda(vol: vol_mod.DenseVolume, plain_params, inv_M, proj, img_size, one_over_voxel_size: float,
                       mu: float, zmin, zmax, enable=None, out=None) -> rc.RaycastResult:
    """Launch K3d for one lane → points [H, W, 4] over the float32 sdf
    [Z, Y, X]. `enable` and `out` as in raycast_grid_cuda."""
    out = _out(out, inv_M, img_size)
    _launch_dense(1, *build.single(vol.sdf, inv_M, proj, zmin, zmax, enable, out), *plain_params.size,
                  *plain_params.offset, one_over_voxel_size, mu)
    return rc.RaycastResult(points=out)

def raycast_dense(vol: vol_mod.DenseVolume, plain_params, inv_M, proj, img_size, one_over_voxel_size: float,
                  mu: float, zmin, zmax, enable=None, out=None) -> rc.RaycastResult:
    """Full-image raycast of the dense voxel array: the plain version for CPU
    tensors, kernel K3d for CUDA tensors (through `itpu::raycast_dense`)."""
    out = _out(out, inv_M, img_size)
    raycast_dense_op(vol.sdf, inv_M, proj, zmin, zmax, enable, out, *plain_params.size, *plain_params.offset,
                     float(one_over_voxel_size), float(mu))
    return rc.RaycastResult(points=out)
