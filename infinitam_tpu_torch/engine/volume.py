"""World-model state: the dense voxel-array volume and its readers.

Counterpart of infinitam_tpu/engine/volume.py (reference
ITMLib/Objects/ITMPlainVoxelArray.h:21, ITMRepresentationAccess.h:63-80):
the sdf and weight planes of a plain voxel array, indexed [z, y, x] with x
fastest, as the reference's linear index x + y·sx + z·sx·sy. The sdf is
float32 in [−1, 1] (the reference's `ITMVoxel_f`), the weights int32. At the
reference's default 512³ the two planes take 1 GiB on the card.

Reads follow the reference's plain-array `findVoxel`: a voxel inside the
array is found whatever its weight (an empty one reads sdf 1.0), one outside
reads (1.0, not found). Kernel K3d (ops/kernels/raycast.py raycast_dense)
marches over the same rule.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from infinitam_tpu_torch.config import PlainVoxelArrayParams

# edge of the virtual blocks the array is read and meshed in: the raycast
# steps empty space outside the array through them (the JAX package's
# generic_raycast default), and the mesher screens them for fused voxels
VIRTUAL_BLOCK = 8


class DenseVolume(NamedTuple):
    """Plain dense TSDF volume (reference ITMPlainVoxelArray)."""

    sdf: torch.Tensor  # [Z, Y, X] float32, init 1.0
    w_depth: torch.Tensor  # [Z, Y, X] int32, init 0
    clr: Optional[torch.Tensor] = None  # [Z, Y, X, 3] float32 0..1
    w_color: Optional[torch.Tensor] = None  # [Z, Y, X] int32

    @property
    def size_xyz(self) -> Tuple[int, int, int]:
        Z, Y, X = self.sdf.shape
        return (X, Y, Z)


def create_dense(params: PlainVoxelArrayParams, with_color: bool = False,
                 device: torch.device | str = "cuda") -> DenseVolume:
    """A reset volume on `device`, the card unless the caller passes
    device="cpu" (reference ITMSceneReconstructionEngine::ResetScene: sdf
    1.0, weight 0)."""
    X, Y, Z = params.size
    sdf = torch.ones((Z, Y, X), dtype=torch.float32, device=device)
    w = torch.zeros((Z, Y, X), dtype=torch.int32, device=device)
    if with_color:
        return DenseVolume(sdf=sdf, w_depth=w, clr=torch.zeros((Z, Y, X, 3), dtype=torch.float32, device=device),
                           w_color=torch.zeros((Z, Y, X), dtype=torch.int32, device=device))
    return DenseVolume(sdf=sdf, w_depth=w)


def reset_dense(vol: DenseVolume) -> DenseVolume:
    return DenseVolume(
        sdf=torch.ones_like(vol.sdf),
        w_depth=torch.zeros_like(vol.w_depth),
        clr=None if vol.clr is None else torch.zeros_like(vol.clr),
        w_color=None if vol.w_color is None else torch.zeros_like(vol.w_color),
    )


def voxel_world_coords(params: PlainVoxelArrayParams, voxel_size: float, device: torch.device | str = "cuda"):
    """World coordinates (metres) of the voxel centres as three planes that
    broadcast to [Z, Y, X]: x [1, 1, X], y [1, Y, 1], z [Z, 1, 1], each
    (arange + offset) · voxel_size in float32, the values of the JAX
    package's [Z, Y, X, 3] grid (which at 512³ would take 1.5 GiB). This is
    the `pt_world` that ops/tsdf.py update_voxel_depth takes."""
    X, Y, Z = params.size
    ox, oy, oz = params.offset

    def axis(n, o):
        return (torch.arange(n, dtype=torch.float32, device=device) + o) * voxel_size

    return (axis(X, ox).reshape(1, 1, X), axis(Y, oy).reshape(1, Y, 1), axis(Z, oz).reshape(Z, 1, 1))


def _flat_index(params: PlainVoxelArrayParams, pts: torch.Tensor):
    """(flat [z, y, x] index clamped into the array, in bounds) of integer
    global voxel coords [..., 3] (x, y, z)."""
    X, Y, Z = params.size
    ox, oy, oz = params.offset
    px, py, pz = pts[..., 0] - ox, pts[..., 1] - oy, pts[..., 2] - oz
    inb = (px >= 0) & (px < X) & (py >= 0) & (py < Y) & (pz >= 0) & (pz < Z)
    idx = (pz.clamp(0, Z - 1).long() * Y + py.clamp(0, Y - 1)) * X + px.clamp(0, X - 1)
    return idx, inb


def dense_read_sdf(vol: DenseVolume, params: PlainVoxelArrayParams, pts: torch.Tensor):
    """Uninterpolated sdf at integer global voxel coords [..., 3] (x, y, z)
    → (sdf float32, found bool); out of bounds → (1.0, False)."""
    idx, inb = _flat_index(params, pts)
    v = vol.sdf.reshape(-1)[idx]
    return torch.where(inb, v, torch.ones_like(v)), inb


def dense_read_sdf_and_weight(vol: DenseVolume, params: PlainVoxelArrayParams, pts: torch.Tensor):
    """(sdf, weight, found) at integer global voxel coords; out of bounds →
    (1.0, 0, False)."""
    idx, inb = _flat_index(params, pts)
    v = vol.sdf.reshape(-1)[idx]
    w = vol.w_depth.reshape(-1)[idx]
    return torch.where(inb, v, torch.ones_like(v)), torch.where(inb, w, torch.zeros_like(w)), inb


def make_dense_reader(vol: DenseVolume, params: PlainVoxelArrayParams):
    """An `(int_pts) -> (sdf, found)` closure for the access combinators of
    ops/voxel_access.py."""

    def read(pts_int: torch.Tensor):
        return dense_read_sdf(vol, params, pts_int)

    return read


def make_dense_color_reader(vol: DenseVolume, params: PlainVoxelArrayParams):
    """`(int_pts) -> rgb [..., 3]` closure; zeros without colour or out of
    bounds."""

    def read(pts_int: torch.Tensor):
        if vol.clr is None:
            return torch.zeros(pts_int.shape[:-1] + (3,), dtype=torch.float32, device=pts_int.device)
        idx, inb = _flat_index(params, pts_int)
        c = vol.clr.reshape(-1, 3)[idx]
        return torch.where(inb[..., None], c, torch.zeros_like(c))

    return read
