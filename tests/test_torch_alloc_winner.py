"""Which candidate wins a contended hash bucket or grid cell, held to the JAX
package entry for entry on the CPU.

Where several candidates claim one bucket (hash_volume.insert_blocks and the
legacy plan_allocations) or one grid cell (the compact allocator's claim
plane), the port elects the highest candidate index: the writer XLA's
sequential scatter keeps on the CPU in the JAX package. The port's election
is a max-reduction, so it gives that writer on the card too, in every run,
where a plain duplicate-index scatter picks any. forward_project elects the
highest source pixel the same way.

1. insert_blocks, two rounds, on candidate blocks made with numpy from a
   seed that crowd a 64-bucket table (duplicates, many to a bucket, some
   past the excess list): entry_pos, entry_ptr and entry_offset equal the
   JAX package's entry for entry, and each candidate's entry (widx) too.
2. plan_allocations + execute_allocations on the same kind of candidates:
   the planned alloc_type and block_coords and the written entries equal.
3. The compact allocator (allocate_scene_from_depth) on a 60×80 frame into
   tables of 256 and of 4,096 buckets: entries, claim plane and visible
   list equal; the port's count of the blocks no insert round placed
   (FrameDiagnostics.n_alloc_unplaced) is positive in the crowded table
   and 0 in the roomy one.
4. forward_project of points crowded onto few pixels: equal to the JAX
   package's output pixel for pixel.
5. n_alloc_unplaced counts blocks, not candidates: with a grid window over
   half the scene, the out-of-grid candidates repeat their blocks (several
   pixels' rays cross one block), and the count equals the distinct wanted
   blocks (the frame's candidate blocks the hash walk did not find before
   it) that no entry of the table holds after it, found by a scan of the
   table; 0 in the roomy table, for both allocators.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinitam_tpu.calib import default_calib
from infinitam_tpu.config import BlockGridParams, TrackingParams, VoxelBlockHashParams, tiny_test_settings
from infinitam_tpu.engine import hash_pipeline as j_hp
from infinitam_tpu.engine import hash_volume as j_hv
from infinitam_tpu.engine.view_builder import View as JView
from infinitam_tpu.io import synth as j_synth
from infinitam_tpu.ops import raycast as j_rc
from infinitam_tpu_torch import convert
from infinitam_tpu_torch.engine import hash_pipeline as t_hp
from infinitam_tpu_torch.engine import hash_volume as t_hv
from infinitam_tpu_torch.engine.view_builder import View
from infinitam_tpu_torch.ops import hashing as t_hashing
from infinitam_tpu_torch.ops import raycast as t_rc
from infinitam_tpu_torch.utils import se3 as t_se3

torch.set_num_threads(1)

IMG = (60, 80)
CROWDED = VoxelBlockHashParams(n_buckets=0x40, n_excess=0x30, n_blocks=0x100, n_transfer_blocks=0x10,
                               n_global_blocks=0x100, max_visible_blocks=0x100)
ENTRY_FIELDS = ("entry_pos", "entry_ptr", "entry_offset", "alloc_list", "excess_list", "last_free_block",
                "last_free_excess")


def T(a):
    return torch.from_numpy(np.array(a))


def crowded_candidates(seed: int, n: int = 400) -> np.ndarray:
    """Block coordinates in a 12³ cube (many to a bucket of 64), a fifth of
    them repeats of others."""
    rng = np.random.default_rng(seed)
    cand = rng.integers(-6, 6, size=(n, 3)).astype(np.int32)
    rep = rng.choice(n, size=n // 5, replace=False)
    cand[rep] = cand[rng.integers(0, n, size=n // 5)]
    return cand


def assert_entries_equal(vt, vj, fields=ENTRY_FIELDS):
    dt, dj = convert.to_numpy(vt), convert.to_numpy(vj)
    for f in fields:
        np.testing.assert_array_equal(dt[f], np.asarray(dj[f]), err_msg=f)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_insert_blocks_winners_match_jax(seed):
    cand = crowded_candidates(seed)
    valid = np.random.default_rng(seed + 100).random(cand.shape[0]) < 0.9
    vj = j_hv.create_hash(CROWDED)
    vt = t_hv.create_hash(CROWDED, device="cpu")
    E = CROWDED.n_entries
    vt_j = jnp.zeros((E,), jnp.int32)
    vt_t = torch.zeros(E, dtype=torch.int32)
    placed = 0
    for _round in range(2):
        vj, vt_j, wj = j_hv.insert_blocks(vj, vt_j, jnp.asarray(cand), jnp.asarray(valid), CROWDED)
        vt, vt_t, wt = t_hv.insert_blocks(vt, vt_t, T(cand), T(valid), CROWDED)
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
        assert_entries_equal(vt, vj)
        np.testing.assert_array_equal(vt_t.numpy(), np.asarray(vt_j))
        placed += int((wt < E).sum())
    # the table was contended: some buckets had several candidates, and
    # the excess list ran dry before every distinct block was placed
    n_distinct = len(set(map(tuple, cand[valid].tolist())))
    assert 0 < placed < n_distinct


@pytest.mark.parametrize("seed", [3, 4])
def test_plan_and_execute_winners_match_jax(seed):
    cand = crowded_candidates(seed)
    ok = np.random.default_rng(seed + 100).random(cand.shape[0]) < 0.9
    vj = j_hv.create_hash(CROWDED)
    vt = t_hv.create_hash(CROWDED, device="cpu")
    E = CROWDED.n_entries
    pj = j_hv.plan_allocations(vj, jnp.zeros((E,), jnp.int32), jnp.asarray(cand), jnp.asarray(ok), CROWDED)
    pt = t_hv.plan_allocations(vt, torch.zeros(E, dtype=torch.int32), T(cand), T(ok), CROWDED)
    for f in ("alloc_type", "block_coords", "visible_type", "cand_need"):
        np.testing.assert_array_equal(getattr(pt, f).numpy(), np.asarray(getattr(pj, f)), err_msg=f)
    vj2, vtyp_j = j_hv.execute_allocations(vj, pj, CROWDED)
    vt2, vtyp_t = t_hv.execute_allocations(vt, pt, CROWDED)
    assert_entries_equal(vt2, vj2)
    np.testing.assert_array_equal(vtyp_t.numpy(), np.asarray(vtyp_j))
    assert int((pt.alloc_type > 0).sum()) < int(pt.cand_need.sum())  # buckets were contended


def table_settings(n_buckets: int, **kw):
    """tiny_test_settings with a table of `n_buckets` buckets."""
    h = tiny_test_settings().hashing
    return tiny_test_settings().replace(
        tracking=TrackingParams(n_levels=3, min_valid_points=50),
        hashing=VoxelBlockHashParams(n_buckets=n_buckets, n_excess=h.n_excess, n_blocks=h.n_blocks,
                                     n_transfer_blocks=h.n_transfer_blocks, n_global_blocks=h.n_global_blocks,
                                     max_visible_blocks=h.max_visible_blocks), **kw)


@pytest.mark.parametrize("n_buckets", [0x100, 0x1000])
def test_compact_allocator_winners_match_jax(n_buckets):
    settings = table_settings(n_buckets)
    calib = default_calib(IMG[1], IMG[0])
    proj = np.asarray(calib.intrinsics_d.vector, dtype=np.float32)
    src = j_synth.SyntheticSource(calib, n_frames=2, img_size=IMG)
    vj, rj, sj = j_hp.create_engine_state(settings, IMG)
    depth, _r, _g = src.get_images()
    vj, rj, sj, _d = j_hp.process_frame_hash(vj, rj, sj, JView(depth=depth), jnp.asarray(proj), settings)
    vt = convert.from_numpy(t_hv.HashVolume, convert.to_numpy(vj), device="cpu")
    rt = convert.from_numpy(t_hv.RenderStateVH, convert.to_numpy(rj), device="cpu")
    depth, _r, gt = src.get_images()
    vj, rj, _ovj = j_hp.allocate_scene_from_depth(vj, rj, depth, gt, jnp.asarray(proj), settings)
    vt, rt, _ovt, unplaced = t_hp._allocate(vt, rt, T(depth), T(gt), T(proj), settings)
    assert_entries_equal(vt, vj, ENTRY_FIELDS + ("entry_grid", "block_grid"))
    for f in ("visible_ids", "n_visible", "cell_claim", "entry_epoch"):
        np.testing.assert_array_equal(getattr(rt, f).numpy(), np.asarray(getattr(rj, f)), err_msg=f)
    assert int(rt.n_visible) > 100
    assert (int(unplaced) > 0) == (n_buckets == 0x100), int(unplaced)


def test_forward_project_winners_match_jax():
    """Points of a 60×80 map scattered at random onto a 6×8 image: about
    100 to a pixel."""
    rng = np.random.default_rng(5)
    H, W = IMG
    pts = np.concatenate([rng.uniform(-0.4, 0.4, (H, W, 2)), rng.uniform(1.0, 2.0, (H, W, 1)),
                          (rng.random((H, W, 1)) < 0.9)], axis=-1).astype(np.float32)
    M = np.eye(4, dtype=np.float32)
    proj = np.array([10.0, 10.0, 4.0, 3.0], dtype=np.float32)
    out_j = np.asarray(j_rc.forward_project(jnp.asarray(pts), jnp.asarray(M), jnp.asarray(proj), (6, 8), 40.0))
    out_t = t_rc.forward_project(T(pts), T(M), T(proj), (6, 8), 40.0).numpy()
    assert (out_j[..., 3] > 0).all()
    np.testing.assert_array_equal(out_t, out_j)


@pytest.mark.parametrize("allocator", ["compact", "legacy"])
@pytest.mark.parametrize("n_buckets", [0x100, 0x1000])
def test_unplaced_counts_blocks_not_candidates(n_buckets, allocator):
    """A 60×80 frame after a first one, the grid window over x ≥ 0 only (a
    little over half the candidate blocks lie outside it, each the block of
    several candidates)."""
    settings = table_settings(n_buckets, block_grid=BlockGridParams(dims=(32, 64, 64), origin=(0, -32, 0)))
    sp, h = settings.scene, settings.hashing
    calib = default_calib(IMG[1], IMG[0])
    proj = torch.as_tensor(calib.intrinsics_d.vector, dtype=torch.float32)
    src = j_synth.SyntheticSource(calib, n_frames=2, img_size=IMG)
    vol, rs, st = t_hp.create_engine_state(settings, IMG, device="cpu")
    depth, _r, _g = src.get_images()
    vol, rs, st, _d = t_hp.process_frame_hash(vol, rs, st, View(depth=T(depth)), proj, settings)
    if allocator == "legacy":  # a render state without its claim plane takes the legacy allocator
        rs = rs._replace(cell_claim=None)
    depth, _r, gt = src.get_images()
    after, _rs, overflow, unplaced = t_hp._allocate(vol, rs, T(depth), T(gt), proj, settings)
    assert int(overflow) == 0

    # the frame's candidate blocks, as the allocator taps them
    s = settings.alloc_subsample
    args = (T(depth)[::s, ::s], proj / s, t_se3.invert(T(gt)), sp.mu, sp.voxel_size, h.block_size)
    tail = (sp.view_frustum_min, sp.view_frustum_max)
    if allocator == "compact":
        bx, by, bz, ok = t_hashing.blocks_on_ray_segment_planes(*args, t_hp.band_steps(settings), *tail)
        cand = torch.stack([bx.reshape(-1), by.reshape(-1), bz.reshape(-1)], dim=-1)[ok.reshape(-1)]
    else:
        blocks, ok = t_hashing.blocks_on_ray_segment(*args, t_hp.MAX_BAND_STEPS, *tail)
        cand = blocks.reshape(-1, 3)[ok.reshape(-1)]
    blocks = torch.unique(cand, dim=0)
    out = ((cand[:, 0] < 0) | (cand[:, 0] >= 32) | (cand[:, 1] < -32) | (cand[:, 1] >= 32) | (cand[:, 2] < 0)
           | (cand[:, 2] >= 64))
    n_out = torch.unique(cand[out], dim=0).shape[0]
    assert int(out.sum()) > 2 * n_out > blocks.shape[0]  # the out-of-grid blocks repeat
    wanted = ~t_hv.probe(vol, blocks, h, include_swapped=True).found
    held = after.entry_pos[after.entry_ptr >= 0]
    has_entry = (blocks[:, None, :] == held[None]).all(-1).any(-1)
    assert int(unplaced) == int((wanted & ~has_entry).sum())
    assert (int(unplaced) > 0) == (n_buckets == 0x100), int(unplaced)
