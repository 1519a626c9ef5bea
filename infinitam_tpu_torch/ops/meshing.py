"""Marching-cubes surface extraction from the TSDF.

Counterpart of infinitam_tpu/ops/meshing.py (reference
DeviceAgnostic/ITMMeshingEngine.h:154-233: findPointNeighbors corner order,
buildVertList edge interpolation, the any-corner-missing / sdf == 1 gate;
ITMMeshingEngine_CUDA.cu:17-113: per block × 8³ voxels, atomic triangle
append). The JAX package extracts each chunk of blocks into a buffer of a
fixed number of triangles a block and clips the count, which drops
triangles on a dense map without a word. Here the extraction has two
passes and drops nothing:

1. the count pass reads each voxel's 8 corners, keeps its cube index and
   so its triangle count (`mc_tables.tri_count`), chunk by chunk of blocks;
2. a prefix sum over all voxels gives each voxel its first output slot, and
   one host read gives the total T;
3. the emit pass computes the T triangles in slot order, each from its
   voxel (found by a binary search of the prefix sum), that voxel's stored
   cube index and the same corner reads.

The order is blocks in the given order, then voxels (x + y·S + z·S²), then
the triangle slots 0-4 of each voxel, whatever the chunk size. Like the
JAX package, which runs no Pallas kernel here, this is plain PyTorch on
whatever device the volume lies on.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from infinitam_tpu_torch.ops import mc_tables as mt
from infinitam_tpu_torch.ops.voxel_access import ReadFn

# blocks a chunk of the count pass (2,048 8³ blocks: 1 M voxels); the emit
# pass takes as many triangles a chunk as the count pass takes voxels
CHUNK_BLOCKS = 2048


class _Tables:
    def __init__(self, device: torch.device):
        self.corner_offsets = torch.as_tensor(mt.corner_offsets, device=device)  # [8, 3] int32
        self.corner_offsets_f = self.corner_offsets.to(torch.float32)
        self.edge_corners = torch.as_tensor(mt.edge_corners, device=device).long()  # [12, 2]
        self.tri_table = torch.as_tensor(mt.tri_table, device=device).long()  # [256, 16]
        self.tri_count = torch.as_tensor(mt.tri_count, device=device)  # [256] int32
        self.bits = 1 << torch.arange(8, dtype=torch.int32, device=device)


@functools.cache
def _tables(device: torch.device) -> _Tables:
    """The lookup tables on `device`, copied there once (a host copy each
    call would wait for the card)."""
    return _Tables(device)


def _corner_reads(read: ReadFn, gvox: torch.Tensor):
    """SDF at the 8 cube corners of each voxel, as one read of the stacked
    corners, and whether all 8 were found with sdf ≠ 1 (reference: a missing
    corner or an sdf of 1 skips the voxel). gvox: [..., 3] int32. Returns
    (sdf [..., 8], ok [...])."""
    t = _tables(gvox.device)
    sdf, found = read(gvox[..., None, :] + t.corner_offsets)
    return sdf, (found & (sdf != 1.0)).all(dim=-1)


def cube_index(sdf: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Corner-sign configuration [...] int32 (bit c: corner c inside), 0
    where the voxel is skipped."""
    t = _tables(sdf.device)
    ci = ((sdf < 0).to(torch.int32) * t.bits).sum(dim=-1, dtype=torch.int32)
    return torch.where(ok, ci, torch.zeros_like(ci))


def _edge_vertices(gvox: torch.Tensor, sdf: torch.Tensor) -> torch.Tensor:
    """The interpolated zero crossing on each of the 12 cube edges
    (reference sdfInterp, with its 1e-5 guards) → [..., 12, 3] voxel units."""
    t = _tables(gvox.device)
    corners = gvox[..., None, :].to(torch.float32) + t.corner_offsets_f  # [..., 8, 3]
    e0, e1 = t.edge_corners[:, 0], t.edge_corners[:, 1]
    p1, p2 = corners[..., e0, :], corners[..., e1, :]
    v1, v2 = sdf[..., e0], sdf[..., e1]
    denom = v2 - v1
    flat = denom.abs() < 1e-5
    tt = torch.where(flat, 0.0, (0.0 - v1) / torch.where(flat, 1.0, denom))
    tt = torch.where(v1.abs() < 1e-5, 0.0, torch.where(v2.abs() < 1e-5, 1.0, tt))
    return p1 + tt[..., None] * (p2 - p1)


def triangulate_voxels(read: ReadFn, gvox: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Marching cubes over a set of voxels (any shape [..., 3] int32 global
    voxel coords). Returns (tri_verts [..., 5, 3, 3] float32 in voxel units,
    tri_valid [..., 5] bool), as the JAX package's function."""
    sdf, ok = _corner_reads(read, gvox)
    ci = cube_index(sdf, ok)
    ev = _edge_vertices(gvox, sdf)
    tri = _tables(gvox.device).tri_table[ci.long()][..., :15]  # [..., 15]
    valid = tri.reshape(tri.shape[:-1] + (5, 3))[..., 0] >= 0
    idx = tri.clamp(0, 11)[..., None].expand(tri.shape + (3,))
    return torch.gather(ev, -2, idx).reshape(tri.shape[:-1] + (5, 3, 3)), valid


def _local_voxels(block_size: int, device) -> torch.Tensor:
    """In-block voxel coords [S³, 3] int32 in the order x + y·S + z·S²."""
    S = block_size
    lin = torch.arange(S**3, dtype=torch.int32, device=device)
    return torch.stack([lin % S, (lin // S) % S, lin // (S * S)], dim=-1)


def block_voxels(block_pos: torch.Tensor, block_size: int) -> torch.Tensor:
    """Global voxel coords [C, S³, 3] int32 of blocks [C, 3]."""
    return block_pos[:, None, :] * block_size + _local_voxels(block_size, block_pos.device)[None]


def extract_mesh(read: ReadFn, block_pos: torch.Tensor, block_size: int, voxel_size: float,
                 chunk_blocks: int = CHUNK_BLOCKS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every triangle of the blocks [N, 3] → (triangles [T, 3, 3] float32
    metres, on the blocks' device; the emit pass's count of valid triangle
    slots, a device int64 that equals T when the two passes agree). One host
    read, of T; the chunks read nothing back."""
    dev = block_pos.device
    t = _tables(dev)
    S3 = block_size**3
    n_vox = block_pos.shape[0] * S3
    chunk = chunk_blocks * S3

    # count pass: each voxel's cube index, kept for the emit pass
    cubes = torch.empty(n_vox, dtype=torch.uint8, device=dev)
    for start in range(0, block_pos.shape[0], chunk_blocks):
        gvox = block_voxels(block_pos[start : start + chunk_blocks], block_size)
        cubes[start * S3 : start * S3 + gvox.shape[0] * S3] = cube_index(*_corner_reads(read, gvox)).reshape(-1)
    counts = t.tri_count[cubes.long()]
    ends = torch.cumsum(counts, 0, dtype=torch.int64)  # one past each voxel's last slot
    total = int(counts.sum(dtype=torch.int64))  # the one host read

    # emit pass: triangle k belongs to the voxel whose slot range holds it
    local = _local_voxels(block_size, dev)
    out = torch.empty((total, 3, 3), dtype=torch.float32, device=dev)
    n_valid = torch.zeros((), dtype=torch.int64, device=dev)
    for k0 in range(0, total, chunk):
        k = torch.arange(k0, min(k0 + chunk, total), dtype=torch.int64, device=dev)
        vid = torch.searchsorted(ends, k, right=True)
        slot = k - (ends[vid] - counts[vid])
        gvox = block_pos[vid // S3] * block_size + local[vid % S3]
        sdf, _ok = _corner_reads(read, gvox)
        ev = _edge_vertices(gvox, sdf)  # [n, 12, 3]
        edges = t.tri_table[cubes[vid].long()].gather(1, 3 * slot[:, None] + torch.arange(3, device=dev))
        n_valid += (edges[:, 0] >= 0).sum()
        out[k0 : k0 + k.shape[0]] = torch.gather(ev, 1, edges.clamp(0, 11)[..., None].expand(-1, 3, 3))
    return out * voxel_size, n_valid
