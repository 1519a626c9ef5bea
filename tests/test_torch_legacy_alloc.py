"""The gridless legacy allocator of the port (hash_pipeline
_allocate_scene_from_depth_legacy, with hash_volume's plan/execute/visible
list helpers and hashing.blocks_on_ray_segment), held to the JAX package on
the CPU.

The settings are tests/test_hash_pipeline.py's compact-vs-legacy ones: a
12×12×12 block grid at (−6, −6, 0), which pushes the far scene onto the
out-of-grid hash probes, 60×80 frames at the true poses.

1. JAX legacy against port legacy over 5 frames, for a volume made without
   `grid_params` and for a render state without its claim plane: the
   allocated and the visible block sets equal every frame (both run the
   same DDA, the same entry-grid taps and the same two-round insert; which
   candidate wins a contended bucket is unspecified in both, so they are
   compared as sets), the overflow count equal.
2. The port's compact allocator against its legacy one, ported from
   tests/test_hash_pipeline.py: sets within 4 blocks a frame (per-frame
   winner election may differ) and equal at the end.
3. A 5-frame `process_frame_hash` replay with a gridless volume and render
   state, JAX against the port: poses within 1e-4 m and 0.01° a frame (the
   ICP sums run in another order), block sets within 4 blocks, every
   silent-cap counter 0, the state without claim planes throughout.
4. plan_allocations + execute_allocations and build_visible_list on random
   candidates against the JAX ones: equal as sets of block coordinates.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinitam_tpu.calib import default_calib
from infinitam_tpu.config import BlockGridParams, SceneParams, Settings, TrackingParams, VoxelBlockHashParams
from infinitam_tpu.engine import hash_pipeline as j_hp
from infinitam_tpu.engine import hash_volume as j_hv
from infinitam_tpu.engine.view_builder import View as JView
from infinitam_tpu.io import synth as j_synth
from infinitam_tpu.ops import hashing as j_hashing
from infinitam_tpu_torch import convert
from infinitam_tpu_torch.engine import hash_pipeline as t_hp
from infinitam_tpu_torch.engine import hash_volume as t_hv
from infinitam_tpu_torch.engine.view_builder import View
from infinitam_tpu_torch.ops import hashing as t_hashing
from infinitam_tpu_torch.ops.kernels import build
from infinitam_tpu_torch.utils import se3 as t_se3

IMG = (60, 80)
SETTINGS = Settings(
    scene=SceneParams(voxel_size=0.025, mu=0.1, view_frustum_min=0.3, view_frustum_max=3.0),
    hashing=VoxelBlockHashParams(n_buckets=0x4000, n_excess=0x400, n_blocks=0x1800, max_visible_blocks=0x1000),
    tracking=TrackingParams(n_levels=3, min_valid_points=50),
    block_grid=BlockGridParams(dims=(12, 12, 12), origin=(-6, -6, 0)),
)
CALIB = default_calib(IMG[1], IMG[0])
PROJ = np.asarray(CALIB.intrinsics_d.vector, dtype=np.float32)
COUNTERS = ("n_alloc_overflow", "n_render_overflow", "n_pool_overflow", "n_too_big_blocks", "n_window_clipped")

# the tensors here are tiny: one intra-op thread per process keeps torch from
# contending for the cores with the other test workers (tier-1 runs under xdist)
torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def frames():
    src = j_synth.SyntheticSource(CALIB, n_frames=5, img_size=IMG)
    out = [src.get_images() for _ in range(5)]
    return [np.asarray(d) for d, _r, _g in out], [np.asarray(g) for _d, _r, g in out]


def alloc_set(vol) -> set:
    d = convert.to_numpy(vol)
    return set(map(tuple, d["entry_pos"][d["entry_ptr"] >= 0].tolist()))


def vis_set(vol, rs) -> set:
    d, r = convert.to_numpy(vol), convert.to_numpy(rs)
    ids = r["visible_ids"]
    return set(map(tuple, d["entry_pos"][ids[ids >= 0]].tolist()))


def gridless(which: str, device=None):
    """(vol, rs) of a fresh map that takes the legacy allocator: `volume`
    made without grid_params (and so a render state without the claim
    plane), or `render_state` without its claim plane beside a gridded
    volume. JAX state without `device`, else the port's."""
    h, gp = SETTINGS.hashing, SETTINGS.block_grid
    vgrid = None if which == "volume" else gp
    if device is None:
        return j_hv.create_hash(h, grid_params=vgrid), j_hv.create_render_state(h, grid_params=None)
    return (t_hv.create_hash(h, grid_params=vgrid, device=device),
            t_hv.create_render_state(h, grid_params=None, device=device))


@pytest.mark.parametrize("which", ["volume", "render_state"])
def test_legacy_allocator_matches_jax(frames, which):
    depths, gts = frames
    vj, rj = gridless(which)
    vt, rt = gridless(which, "cpu")
    assert (vt.entry_grid is None) == (which == "volume") and rt.cell_claim is None
    n_oog = 0
    for depth, gt in zip(depths, gts):
        vj, rj, ovj = j_hp.allocate_scene_from_depth(vj, rj, jnp.asarray(depth), jnp.asarray(gt), jnp.asarray(PROJ),
                                                     SETTINGS)
        vt, rt, ovt = t_hp.allocate_scene_from_depth(vt, rt, T(depth), T(gt), T(PROJ), SETTINGS)
        assert rt.cell_claim is None and rt.epoch is None
        assert alloc_set(vt) == alloc_set(vj)
        assert vis_set(vt, rt) == vis_set(vj, rj)
        assert int(rt.n_visible) == int(rj.n_visible) == len(vis_set(vt, rt))
        assert int(ovt) == int(ovj) == 0
        np.testing.assert_array_equal(rt.visible_type.numpy() > 0, np.asarray(rj.visible_type) > 0)
        pos = np.array(sorted(alloc_set(vt)))
        n_oog = int(((pos < (-6, -6, 0)) | (pos >= (6, 6, 12))).any(axis=1).sum())
    assert len(alloc_set(vt)) > 200 and n_oog > 20  # out-of-grid blocks went through the hash probes
    if which == "render_state":  # the legacy inserts keep the volume's grid caches
        ref = t_hv.refresh_caches(vt, SETTINGS.block_grid)
        assert torch.equal(vt.entry_grid, ref.entry_grid) and torch.equal(vt.block_grid, ref.block_grid)


def test_compact_allocator_matches_legacy_oracle(frames):
    """tests/test_hash_pipeline.py's property test on the port."""
    depths, gts = frames
    vol_c, rs_c, _st = t_hp.create_engine_state(SETTINGS, IMG, device="cpu")
    vol_l, rs_l, _st = t_hp.create_engine_state(SETTINGS, IMG, device="cpu")
    rs_l = rs_l._replace(cell_claim=None, entry_epoch=None, epoch=None)
    for i, (depth, gt) in enumerate(zip(depths, gts)):
        vol_c, rs_c, _ov = t_hp.allocate_scene_from_depth(vol_c, rs_c, T(depth), T(gt), T(PROJ), SETTINGS)
        assert rs_c.cell_claim is not None  # the compact path
        vol_l, rs_l, _ov = t_hp.allocate_scene_from_depth(vol_l, rs_l, T(depth), T(gt), T(PROJ), SETTINGS)
        assert rs_l.cell_claim is None  # the legacy path
        assert len(alloc_set(vol_c) ^ alloc_set(vol_l)) <= 4, i
        assert len(vis_set(vol_c, rs_c) ^ vis_set(vol_l, rs_l)) <= 4, i
        ids = rs_c.visible_ids[rs_c.visible_ids >= 0]
        assert ids.numel() == torch.unique(ids).numel()  # no duplicate visible id
    assert alloc_set(vol_c) == alloc_set(vol_l)
    assert vis_set(vol_c, rs_c) == vis_set(vol_l, rs_l)


def pose_error(P, G):
    P, G = np.asarray(P, np.float64), np.asarray(G, np.float64)
    t = np.linalg.norm(np.linalg.inv(P)[:3, 3] - np.linalg.inv(G)[:3, 3])
    dR = P[:3, :3] @ G[:3, :3].T
    v = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]])
    return t, np.degrees(np.arctan2(0.5 * np.linalg.norm(v), 0.5 * (np.trace(dR) - 1.0)))


def test_gridless_replay_matches_jax(frames):
    depths, _gts = frames
    vj, rj = gridless("volume")
    sj = j_hp.create_tracking_state(IMG)
    vt, rt = gridless("volume", "cpu")
    _v, _r, st = t_hp.create_engine_state(SETTINGS, IMG, device="cpu")
    build.reset_launch_counts()
    for i, depth in enumerate(depths):
        vj, rj, sj, dj = j_hp.process_frame_hash(vj, rj, sj, JView(depth=jnp.asarray(depth)), jnp.asarray(PROJ),
                                                 SETTINGS)
        vt, rt, st, dt = t_hp.process_frame_hash(vt, rt, st, View(depth=T(depth)), T(PROJ), SETTINGS)
        t_err, r_err = pose_error(np.asarray(sj.pose), st.pose.numpy())
        assert t_err < 1e-4 and r_err < 0.01, (i, t_err, r_err)
        assert len(alloc_set(vt) ^ alloc_set(vj)) <= 4 and len(vis_set(vt, rt) ^ vis_set(vj, rj)) <= 4, i
        assert all(int(getattr(dt, k)) == 0 for k in COUNTERS), i
        assert vt.entry_grid is None and rt.cell_claim is None
    assert int(dt.num_valid) > 1000
    assert build.launch_counts() == dict.fromkeys(build.KERNELS, 0)


def test_plan_execute_and_visible_list_match_jax(frames):
    """The legacy helpers on their own: random candidate blocks (some
    repeated, some already allocated) planned and executed into a fused
    volume, then the visible list rebuilt from last frame's."""
    depths, gts = frames
    vj, rj = gridless("volume")
    vj, rj, _ov = j_hp.allocate_scene_from_depth(vj, rj, jnp.asarray(depths[0]), jnp.asarray(gts[0]),
                                                 jnp.asarray(PROJ), SETTINGS)
    vt = convert.from_numpy(t_hv.HashVolume, convert.to_numpy(vj), device="cpu")
    rt = convert.from_numpy(t_hv.RenderStateVH, convert.to_numpy(rj), device="cpu")
    h = SETTINGS.hashing
    rng = np.random.default_rng(7)
    cand = rng.integers(-20, 20, size=(600, 3)).astype(np.int32)
    cand[:100] = np.array(sorted(alloc_set(vt)))[:100]  # already allocated
    cand[500:] = cand[400:500]  # repeated
    ok = rng.random(600) < 0.9
    vt_j = j_hv.set_previous_visible(rj)
    vt_t = t_hv.set_previous_visible(rt)
    np.testing.assert_array_equal(vt_t.numpy(), np.asarray(vt_j))
    pj = j_hv.plan_allocations(vj, vt_j, jnp.asarray(cand), jnp.asarray(ok), h,
                               packed=j_hv.pack_entries(vj))
    pt = t_hv.plan_allocations(vt, vt_t, T(cand), T(ok), h, packed=t_hv.pack_entries(vt))
    np.testing.assert_array_equal(pt.cand_need.numpy(), np.asarray(pj.cand_need))
    np.testing.assert_array_equal(pt.alloc_type.numpy() > 0, np.asarray(pj.alloc_type) > 0)
    vj2, vtyp_j = j_hv.execute_allocations(vj, pj, h)
    vt2, vtyp_t = t_hv.execute_allocations(vt, pt, h)
    assert alloc_set(vt2) == alloc_set(vj2) and len(alloc_set(vt2)) > len(alloc_set(vt)) + 300
    assert int(vt2.last_free_block) == int(vj2.last_free_block)
    pose = t_se3.se3_exp(torch.tensor([0.0, 0.0, 0.0, 0.02, -0.01, 0.0]))
    rs_j = j_hv.build_visible_list(vj2, vtyp_j, jnp.asarray(pose.numpy()), jnp.asarray(PROJ), IMG, 0.025, h,
                                   prev_ids=rj.visible_ids)
    rs_t = t_hv.build_visible_list(vt2, vtyp_t, pose, T(PROJ), IMG, 0.025, h, prev_ids=rt.visible_ids)
    assert vis_set(vt2, rs_t) == vis_set(vj2, rs_j) and int(rs_t.n_visible) == int(rs_j.n_visible) > 100
    full_t = t_hv.build_visible_list(vt2, vtyp_t, pose, T(PROJ), IMG, 0.025, h)
    assert vis_set(vt2, full_t) == vis_set(vt2, rs_t)
    # the [H, W, steps, 3] DDA of the legacy allocator
    inv = np.linalg.inv(gts[1]).astype(np.float32)
    bj, okj = j_hashing.blocks_on_ray_segment(jnp.asarray(depths[1]), jnp.asarray(PROJ), jnp.asarray(inv), 0.1,
                                              0.025, 8, 6, 0.3, 3.0)
    bt, okt = t_hashing.blocks_on_ray_segment(T(depths[1]), T(PROJ), T(inv), 0.1, 0.025, 8, 6, 0.3, 3.0)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    same = (bt.numpy() == np.asarray(bj)).all(-1) | ~okt.numpy()
    assert same.all() and int(okt.sum()) > 5000
