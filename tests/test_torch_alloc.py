"""hash_pipeline.allocate_scene_from_depth of the port held to the JAX
package's compact allocator on the CPU, on identical volumes, depth and pose.

The claim election and the insertion's bucket election keep an unspecified
winner among duplicates (in both packages), so which VBA row or hash entry a
block gets may differ: allocated blocks and visible lists are compared as
sets of block coordinates. Inside the working grid every touched cell is
allocated (two insertion rounds), so the sets must be equal. Out-of-grid
candidates insert in one round, so when two new blocks share a hash bucket
in one frame each package keeps one of them: there the counts must be equal
and the sets nearly so.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinitam_tpu.calib import default_calib
from infinitam_tpu.config import BlockGridParams, TrackingParams, tiny_test_settings
from infinitam_tpu.engine import hash_pipeline as j_hp
from infinitam_tpu.engine.view_builder import View as JView
from infinitam_tpu.io import synth as j_synth
from infinitam_tpu_torch import convert
from infinitam_tpu_torch.engine import hash_pipeline as t_hp
from infinitam_tpu_torch.engine import hash_volume as t_hv

IMG = (60, 80)

# the tensors here are tiny: one intra-op thread per process keeps torch from
# contending for the cores with the other test workers (tier-1 runs under xdist)
torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def block_set(vol) -> set:
    d = convert.to_numpy(vol)
    return set(map(tuple, d["entry_pos"][d["entry_ptr"] >= 0].tolist()))


def visible_blocks(vol, rs) -> list:
    d, r = convert.to_numpy(vol), convert.to_numpy(rs)
    ids = r["visible_ids"]
    return sorted(map(tuple, d["entry_pos"][ids[ids >= 0]].tolist()))


def run_both(settings, n_prior, enable=True, only_update_visible=False):
    """Fuse `n_prior` frames with JAX, then allocate frame n_prior in both."""
    calib = default_calib(IMG[1], IMG[0])
    proj = jnp.asarray(calib.intrinsics_d.vector)
    src = j_synth.SyntheticSource(calib, n_frames=n_prior + 1, img_size=IMG)
    vol, rs, st = j_hp.create_engine_state(settings, IMG)
    for _ in range(n_prior):
        depth, _r, _g = src.get_images()
        vol, rs, st, _d = j_hp.process_frame_hash(vol, rs, st, JView(depth=depth), proj, settings)
    depth, _r, gt = src.get_images()
    vt = convert.from_numpy(t_hv.HashVolume, convert.to_numpy(vol), device="cpu")
    rt = convert.from_numpy(t_hv.RenderStateVH, convert.to_numpy(rs), device="cpu")
    out_j = j_hp.allocate_scene_from_depth(vol, rs, depth, gt, proj, settings, only_update_visible, jnp.asarray(enable))
    out_t = t_hp.allocate_scene_from_depth(vt, rt, T(depth), T(gt), T(np.asarray(proj)), settings,
                                           only_update_visible, torch.tensor(enable))
    return out_j, out_t, vol


def settings_for(**kw):
    return tiny_test_settings().replace(tracking=TrackingParams(n_levels=3, min_valid_points=50), **kw)


@pytest.mark.parametrize("n_prior", [0, 2])
def test_allocation_matches_jax_as_block_sets(n_prior):
    (v_j, r_j, o_j), (v_t, r_t, o_t), before = run_both(settings_for(), n_prior)
    assert len(block_set(v_t)) > len(block_set(before))  # the frame allocated
    assert block_set(v_t) == block_set(v_j)
    assert visible_blocks(v_t, r_t) == visible_blocks(v_j, r_j)
    assert int(r_t.n_visible) == int(r_j.n_visible)
    assert int(o_t) == int(o_j) == 0
    assert int(v_t.last_free_block) == int(v_j.last_free_block)
    assert int(r_t.epoch) == int(r_j.epoch)
    # the maintained grids describe the same cells
    np.testing.assert_array_equal(v_t.entry_grid.numpy() >= 0, np.asarray(v_j.entry_grid) >= 0)
    np.testing.assert_array_equal(v_t.block_grid.numpy() >= 0, np.asarray(v_j.block_grid) >= 0)
    np.testing.assert_array_equal(t_hv.build_entry_grid(v_t, settings_for().block_grid).numpy(), v_t.entry_grid.numpy())


@pytest.mark.parametrize("mode", ["diverged", "visibility_only"])
def test_allocation_gates_match_jax(mode):
    kw = dict(enable=False) if mode == "diverged" else dict(only_update_visible=True)
    (v_j, r_j, o_j), (v_t, r_t, o_t), before = run_both(settings_for(), 2, **kw)
    assert block_set(v_t) == block_set(v_j)
    if mode == "diverged":  # a diverged frame allocates nothing
        assert block_set(v_t) == block_set(before)
    assert visible_blocks(v_t, r_t) == visible_blocks(v_j, r_j)
    assert int(r_t.n_visible) == int(r_j.n_visible)
    assert int(o_t) == int(o_j)


def test_out_of_grid_allocation_matches_jax():
    """A working grid that covers only part of the scene: most candidates
    take the hash-probe path."""
    settings = settings_for(block_grid=BlockGridParams(dims=(8, 8, 10), origin=(-4, -4, 0)))
    (v_j, r_j, o_j), (v_t, r_t, o_t), _before = run_both(settings, 2)
    s_j, s_t = block_set(v_j), block_set(v_t)
    grid_hi = np.array([4, 4, 10])
    outside = sum(1 for b in s_t if (np.array(b) < [-4, -4, 0]).any() or (np.array(b) >= grid_hi).any())
    assert outside > 100  # the out-of-grid path did the work
    assert len(s_t) == len(s_j)
    assert len(s_t & s_j) >= 0.97 * len(s_j)
    assert int(o_t) == int(o_j)
    assert int(r_t.n_visible) == int(r_j.n_visible)
    # visible rows are unique entries
    ids = r_t.visible_ids.numpy()
    ids = ids[ids >= 0]
    assert len(np.unique(ids)) == len(ids)
