"""Marching-cubes meshing of the port (hash_volume.make_hash_reader,
ops/meshing.py, engine/meshing_engine.py, MainEngine.update_mesh /
save_scene_to_mesh and the CLI's --out-mesh) held to the JAX package on the
CPU, on volumes the JAX package fused from 3 synthetic 60×80 frames: at its
own small settings (tests/test_meshing.py:22-28) and at 1 cm with a block
grid that leaves the far blocks outside its window.

The JAX mesher caps each chunk of 128 blocks at 64 triangles a block and
drops the rest without a counter (ROADMAP Queue 3). The port counts first
and drops nothing: its mesh equals JAX `triangulate_voxels` run uncapped
over the same entries in the same entry order (the same count, vertices
within 1e-6 m), where the JAX package's own `mesh_scene_hash` returns fewer
triangles at 1 cm. Per voxel, the valid mask is equal and the vertices
agree within 1e-4 voxel (XLA may contract the edge interpolation into an
FMA).
"""

import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinitam_tpu.calib import default_calib
from infinitam_tpu.config import BlockGridParams, SceneParams, Settings, TrackingParams, VoxelBlockHashParams
from infinitam_tpu.engine import hash_pipeline as j_hp
from infinitam_tpu.engine import hash_volume as j_hv
from infinitam_tpu.engine import meshing_engine as j_me
from infinitam_tpu.engine.view_builder import View as JView
from infinitam_tpu.io import synth as j_synth
from infinitam_tpu.ops import meshing as j_mops
from infinitam_tpu_torch import convert
from infinitam_tpu_torch.apps import cli
from infinitam_tpu_torch.calib import default_calib as t_default_calib
from infinitam_tpu_torch.engine import hash_volume as t_hv
from infinitam_tpu_torch.engine import meshing_engine as t_me
from infinitam_tpu_torch.engine.main_engine import MainEngine
from infinitam_tpu_torch.ops import mc_tables
from infinitam_tpu_torch.ops import meshing as t_mops
from infinitam_tpu_torch.ops.kernels import build

IMG = (60, 80)
CALIB = default_calib(IMG[1], IMG[0])
PROJ = CALIB.intrinsics_d.vector
# tests/test_meshing.py:22-28
SMALL = Settings(
    scene=SceneParams(voxel_size=0.025, mu=0.1, view_frustum_min=0.3, view_frustum_max=3.0),
    hashing=VoxelBlockHashParams(n_buckets=0x4000, n_excess=0x400, n_blocks=0x1800, max_visible_blocks=0x1000),
    tracking=TrackingParams(n_levels=3, min_valid_points=50),
)
# 1 cm: dense enough that the JAX chunk cap drops triangles; the block grid
# ends at z = 1.28 m, so the far blocks are reachable through the hash only
FINE = SMALL.replace(scene=SceneParams(voxel_size=0.01, mu=0.04, view_frustum_min=0.3, view_frustum_max=3.0),
                     block_grid=BlockGridParams(dims=(64, 64, 16), origin=(-32, -32, 0)), alloc_subsample=2)
CONFIGS = {"small": SMALL, "fine": FINE}

# the tensors here are tiny: one intra-op thread per process keeps torch from
# contending for the cores with the other test workers (tier-1 runs under xdist)
torch.set_num_threads(1)


@pytest.fixture(scope="module", params=list(CONFIGS))
def volume(request):
    """(settings, JAX volume, the same volume in the port, allocated entry
    ids in entry order) after 3 frames fused by the JAX package."""
    settings = CONFIGS[request.param]
    src = j_synth.SyntheticSource(CALIB, n_frames=3, img_size=IMG)
    vol, rs, st = j_hp.create_engine_state(settings, IMG)
    for _ in range(3):
        vol, rs, st, _d = j_hp.process_frame_hash(vol, rs, st, JView(depth=src.get_images()[0]), jnp.asarray(PROJ),
                                                  settings)
    ids = np.nonzero(np.asarray(vol.entry_ptr) >= 0)[0]
    return request.param, settings, vol, convert.from_numpy(t_hv.HashVolume, convert.to_numpy(vol), device="cpu"), ids


def global_voxels(bpos: np.ndarray, S: int = 8) -> np.ndarray:
    lin = np.arange(S**3)
    local = np.stack([lin % S, (lin // S) % S, lin // (S * S)], -1)
    return (bpos[:, None, :] * S + local[None]).astype(np.int32)


def test_tri_count_table_counts_tri_table():
    for c in range(256):
        row = mc_tables.tri_table[c]
        n = mc_tables.tri_count[c]
        assert (row[: 3 * n] >= 0).all() and (row[3 * n :] < 0).all()
    assert mc_tables.tri_count.max() == 5 and mc_tables.tri_count[0] == mc_tables.tri_count[255] == 0


def test_hash_reader_matches_jax(volume):
    name, settings, j_vol, t_vol, ids = volume
    bpos = np.asarray(j_vol.entry_pos)[ids]
    rng = np.random.default_rng(1)
    # voxels of the allocated blocks, their neighbours and the space between
    pts = (bpos[rng.integers(0, len(bpos), 4000)] * 8 + rng.integers(-4, 12, (4000, 3))).astype(np.int32)
    sdf_j, found_j = j_hv.make_hash_reader(j_vol, settings.hashing)(jnp.asarray(pts))
    sdf_t, found_t = t_hv.make_hash_reader(t_vol, settings.hashing)(torch.from_numpy(pts))
    np.testing.assert_array_equal(found_t.numpy(), np.asarray(found_j))
    np.testing.assert_array_equal(sdf_t.numpy(), np.asarray(sdf_j))
    assert 0.2 < found_t.float().mean() < 1.0
    if name == "fine":  # blocks outside the grid's window: found through the hash only
        grid = t_hv.build_block_grid(t_vol, settings.block_grid)
        _s, found_g = t_hv.make_grid_reader(t_vol, grid, settings.block_grid, settings.hashing)(torch.from_numpy(pts))
        assert int((found_t & ~found_g).sum()) > 100


def test_triangulate_voxels_matches_jax(volume):
    _name, settings, j_vol, t_vol, ids = volume
    gvox = global_voxels(np.asarray(j_vol.entry_pos)[ids[:96]])
    v_j, ok_j = (np.asarray(a) for a in j_mops.triangulate_voxels(j_hv.make_hash_reader(j_vol, settings.hashing),
                                                                   jnp.asarray(gvox)))
    v_t, ok_t = t_mops.triangulate_voxels(t_hv.make_hash_reader(t_vol, settings.hashing), torch.from_numpy(gvox))
    np.testing.assert_array_equal(ok_t.numpy(), ok_j)
    assert ok_j.sum() > 100
    np.testing.assert_allclose(v_t.numpy()[ok_j], v_j[ok_j], rtol=0, atol=1e-4)


def uncapped_jax_mesh(settings, j_vol, ids) -> np.ndarray:
    """JAX `triangulate_voxels` over every voxel of the allocated entries in
    entry order, every valid triangle kept, in metres."""
    tri = jax.jit(lambda vol, g: j_mops.triangulate_voxels(j_hv.make_hash_reader(vol, settings.hashing), g))
    verts, valid = tri(j_vol, jnp.asarray(global_voxels(np.asarray(j_vol.entry_pos)[ids])))
    return (np.asarray(verts).reshape(-1, 3, 3) * np.float32(settings.scene.voxel_size))[np.asarray(valid).reshape(-1)]


def test_mesh_has_every_triangle_of_uncapped_jax(volume):
    name, settings, j_vol, t_vol, ids = volume
    ref = uncapped_jax_mesh(settings, j_vol, ids)
    mesh = t_me.mesh_scene_hash(t_vol, settings)
    assert mesh.triangles.dtype == np.float32 and mesh.triangles.shape == ref.shape
    assert mesh.n_triangles > 10000
    np.testing.assert_allclose(mesh.triangles, ref, rtol=0, atol=1e-6)
    capped = j_me.mesh_scene_hash(j_vol, settings).n_triangles
    if name == "fine":  # the JAX package's chunk cap drops triangles here; the port keeps them
        assert capped < mesh.n_triangles, (capped, mesh.n_triangles)
    else:
        assert capped == mesh.n_triangles


def test_mesh_is_independent_of_the_chunk_size(volume):
    _name, settings, _j_vol, t_vol, ids = volume
    read = t_hv.make_hash_reader(t_vol, settings.hashing)
    bpos = t_vol.entry_pos[torch.from_numpy(ids)]
    a, n_a = t_mops.extract_mesh(read, bpos, 8, settings.scene.voxel_size)
    b, n_b = t_mops.extract_mesh(read, bpos, 8, settings.scene.voxel_size, chunk_blocks=97)
    assert torch.equal(a, b)
    assert int(n_a) == int(n_b) == a.shape[0] > 0  # every emitted slot holds a triangle
    empty, n_e = t_mops.extract_mesh(read, bpos[:0], 8, settings.scene.voxel_size)
    assert empty.shape == (0, 3, 3) and int(n_e) == 0


def test_writers_match_jax(volume, tmp_path):
    """STL byte for byte as the JAX writer's; OBJ lines that parse to the
    same floats and faces."""
    _name, settings, _j_vol, t_vol, _ids = volume
    tris = t_me.mesh_scene_hash(t_vol, settings).triangles
    # a degenerate triangle: its zero normal stays zero
    tris = np.concatenate([tris[:500], np.zeros((1, 3, 3), np.float32)])
    paths = {k: str(tmp_path / k) for k in ("j.stl", "t.stl", "j.obj", "t.obj")}
    j_me.Mesh(tris).write_stl(paths["j.stl"])
    t_me.Mesh(tris).write_stl(paths["t.stl"])
    stl = open(paths["t.stl"], "rb").read()
    assert stl == open(paths["j.stl"], "rb").read()
    assert struct.unpack("<I", stl[80:84])[0] == len(tris) and len(stl) == 84 + 50 * len(tris)
    j_me.Mesh(tris).write_obj(paths["j.obj"])
    t_me.Mesh(tris).write_obj(paths["t.obj"])

    def parse(path):
        lines = open(path).read().split("\n")
        v = np.array([[np.float32(x) for x in ln.split()[1:]] for ln in lines if ln.startswith("v ")])
        f = np.array([[int(x) for x in ln.split()[1:]] for ln in lines if ln.startswith("f ")])
        return v, f

    (vj, fj), (vt, ft) = parse(paths["j.obj"]), parse(paths["t.obj"])
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_array_equal(vt, tris.reshape(-1, 3))


def test_engine_and_cli_write_the_mesh(tmp_path, capsys):
    """MainEngine.save_scene_to_mesh (STL and OBJ) and the CLI's --out-mesh
    on the CPU write readable files of the map's triangles, and launch no
    kernel."""
    settings = SMALL
    src = j_synth.SyntheticSource(CALIB, n_frames=2, img_size=IMG)
    eng = MainEngine(settings, t_default_calib(IMG[1], IMG[0]), IMG, device="cpu")
    build.reset_launch_counts()
    for _ in range(2):
        eng.process_frame(metric_depth=np.asarray(src.get_images()[0]))
    mesh = eng.update_mesh()
    assert mesh.n_triangles > 1000
    eng.save_scene_to_mesh(str(tmp_path / "scene.stl"))
    eng.save_scene_to_mesh(str(tmp_path / "scene.OBJ"))
    stl = open(tmp_path / "scene.stl", "rb").read()
    assert len(stl) == 84 + 50 * mesh.n_triangles
    rec = np.frombuffer(stl[84:], dtype=t_me.STL_RECORD)
    np.testing.assert_array_equal(rec["verts"], mesh.triangles)
    obj = open(tmp_path / "scene.OBJ").read().split("\n")
    assert sum(ln.startswith("v ") for ln in obj) == 3 * mesh.n_triangles
    assert sum(ln.startswith("f ") for ln in obj) == mesh.n_triangles
    assert build.launch_counts() == dict.fromkeys(build.KERNELS, 0)

    out_mesh = str(tmp_path / "cli.stl")
    assert cli.main(["--synthetic", "--frames", "2", "--out-mesh", out_mesh, "--width", "80", "--height", "60",
                     "--voxel-size", "0.025", "--mu", "0.1", "--cpu"]) == 0
    out = capsys.readouterr().out
    assert f"mesh saved to {out_mesh}" in out and "processed 2 frames" in out
    n = struct.unpack("<I", open(out_mesh, "rb").read()[80:84])[0]
    assert n > 1000 and os.path.getsize(out_mesh) == 84 + 50 * n
