"""Meshing engine: TSDF → triangle mesh + OBJ/STL export.

Counterpart of infinitam_tpu/engine/meshing_engine.py (reference
ITMLib/Engine/ITMMeshingEngine.h + _CUDA.cu, MeshScene over the allocated
blocks; ITMLib/Objects/ITMMesh.h:34-113, WriteOBJ / WriteSTL binary
format), for the voxel-block hash and for the dense voxel array. The
extraction (ops/meshing.py) keeps every triangle: the JAX package's
per-chunk cap, which drops triangles in both of its meshers, is not copied.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from infinitam_tpu_torch.config import Settings
from infinitam_tpu_torch.engine import hash_volume as hv
from infinitam_tpu_torch.engine import volume as vol_mod
from infinitam_tpu_torch.ops import meshing as mops

# one binary STL record: normal, 3 vertices, attribute (50 bytes, packed)
STL_RECORD = np.dtype([("normal", "<f4", (3,)), ("verts", "<f4", (3, 3)), ("attr", "<u2")])


@dataclasses.dataclass
class Mesh:
    """Triangle soup (reference: ITMMesh — Triangle{p0, p1, p2})."""

    triangles: np.ndarray  # [T, 3, 3] float32, metres

    @property
    def n_triangles(self) -> int:
        return len(self.triangles)

    def write_obj(self, path: str) -> None:
        """reference: ITMMesh::WriteOBJ — flat v / f lists. Each coordinate
        with 9 significant digits, which reads back as the same float32."""
        n = self.n_triangles
        with open(path, "w") as f:
            np.savetxt(f, self.triangles.reshape(-1, 3), fmt="v %.9g %.9g %.9g")
            np.savetxt(f, 3 * np.arange(n)[:, None] + np.arange(1, 4), fmt="f %d %d %d")

    def write_stl(self, path: str) -> None:
        """reference: ITMMesh::WriteSTL — binary STL: an 80-byte header, a
        u32 count, then per triangle its unit normal, its 3 vertices and a
        u16 attribute, written as one array. The normal's length is rounded
        as the JAX package's per-triangle `np.linalg.norm` rounds it (numpy's
        float32 `dot`: float32 products summed in float64)."""
        tris = np.ascontiguousarray(self.triangles, dtype=np.float32)
        n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
        sq = (n * n).astype(np.float64)
        norm = np.sqrt(((sq[:, 0] + sq[:, 1]) + sq[:, 2]).astype(np.float32))[:, None]
        rec = np.zeros(len(tris), dtype=STL_RECORD)
        rec["normal"] = np.where(norm > 0, n / np.where(norm > 0, norm, 1), n)
        rec["verts"] = tris
        with open(path, "wb") as f:
            f.write(b"\0" * 80)
            f.write(np.uint32(len(tris)).tobytes())
            f.write(rec.tobytes())


def mesh_scene_hash(vol: hv.HashVolume, settings: Settings, chunk_blocks: int = mops.CHUNK_BLOCKS) -> Mesh:
    """MeshScene for the voxel-block-hash volume: every allocated entry
    (entry_ptr ≥ 0) in entry order, read through the hash, so blocks
    allocated outside the block grid's window are meshed too (reference
    findAllocatedBlocks + meshScene_device). Three host reads in all: the
    number of allocated blocks, the triangle total and the triangles."""
    hp = settings.hashing
    ids = torch.nonzero(vol.entry_ptr >= 0).squeeze(1)
    tris, _n_valid = mops.extract_mesh(hv.make_hash_reader(vol, hp), vol.entry_pos[ids], hp.block_size,
                                       settings.scene.voxel_size, chunk_blocks)
    return Mesh(triangles=tris.cpu().numpy())


def dense_blocks(vol: vol_mod.DenseVolume, params) -> torch.Tensor:
    """The virtual 8³ blocks of the dense array that hold a voxel of weight
    > 0, as global block coords [N, 3] int32 on the volume's device, in the
    JAX package's order (x outermost, then y, then z). The occupancy screen
    runs on the card; the block count is the one host read. Blocks are
    aligned to the global grid and cover the array whole: where an extent or
    the offset is not a multiple of 8, the edge blocks are partial (the JAX
    version needs each extent divisible by 8)."""
    S = vol_mod.VIRTUAL_BLOCK
    Z, Y, X = vol.w_depth.shape
    ox, oy, oz = params.offset
    lead = [o % S for o in (oz, oy, ox)]  # voxels of the first global block before the array
    n = [(l + e + S - 1) // S for l, e in zip(lead, (Z, Y, X))]
    occ = vol.w_depth > 0
    if lead != [0, 0, 0] or [S * k for k in n] != [Z, Y, X]:
        padded = torch.zeros((n[0] * S, n[1] * S, n[2] * S), dtype=torch.bool, device=occ.device)
        padded[lead[0]:lead[0] + Z, lead[1]:lead[1] + Y, lead[2]:lead[2] + X] = occ
        occ = padded
    occ = occ.reshape(n[0], S, n[1], S, n[2], S).any(dim=5).any(dim=3).any(dim=1)  # [bz, by, bx]
    first = torch.tensor([ox // S, oy // S, oz // S], dtype=torch.int64, device=occ.device)
    return (torch.nonzero(occ.permute(2, 1, 0)) + first).to(torch.int32)


def mesh_scene_dense(vol: vol_mod.DenseVolume, settings: Settings) -> Mesh:
    """MeshScene for the dense array, treated as a grid of virtual 8³ blocks:
    the blocks with any fused voxel (dense_blocks, on the card), meshed
    through the dense reader with every triangle kept. Three host reads in
    all: the block count, the triangle total and the triangles."""
    tris, _n_valid = mops.extract_mesh(vol_mod.make_dense_reader(vol, settings.plain),
                                       dense_blocks(vol, settings.plain), vol_mod.VIRTUAL_BLOCK,
                                       settings.scene.voxel_size)
    return Mesh(triangles=tris.cpu().numpy())
