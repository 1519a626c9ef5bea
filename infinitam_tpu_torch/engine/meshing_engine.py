"""Meshing engine: TSDF → triangle mesh + OBJ/STL export.

Counterpart of infinitam_tpu/engine/meshing_engine.py (reference
ITMLib/Engine/ITMMeshingEngine.h + _CUDA.cu, MeshScene over the allocated
blocks; ITMLib/Objects/ITMMesh.h:34-113, WriteOBJ / WriteSTL binary
format). The extraction (ops/meshing.py) keeps every triangle; the
dense-volume mesher comes with the dense volume (ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from infinitam_tpu_torch.config import Settings
from infinitam_tpu_torch.engine import hash_volume as hv
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
