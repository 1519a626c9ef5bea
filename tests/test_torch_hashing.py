"""ops/hashing.py and engine/hash_volume.py of the port held to the JAX
package on the CPU, plus the state conversion of convert.py.

Integer results (hash indices, compaction, block coords, grids, probes) must
match exactly. Insertion elects an unspecified winner among candidates that
contend for one bucket (a duplicate-index scatter, in both packages), so
inserted volumes are compared as sets of block coordinates, never by row.
"""

import jax
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
from infinitam_tpu.ops import hashing as j_hash
from infinitam_tpu.utils import se3 as j_se3
from infinitam_tpu_torch import convert
from infinitam_tpu_torch.engine import hash_volume as t_hv
from infinitam_tpu_torch.engine import tracking_state as t_ts
from infinitam_tpu_torch.ops import hashing as t_hash

PARAMS = VoxelBlockHashParams(n_buckets=0x400, n_excess=0x100, n_blocks=0x400, max_visible_blocks=0x200)

# the tensors here are tiny: one intra-op thread per process keeps torch from
# contending for the cores with the other test workers (tier-1 runs under xdist)
torch.set_num_threads(1)
GRID = BlockGridParams(dims=(16, 16, 16), origin=(-8, -8, 0))


def T(a):
    return torch.from_numpy(np.array(a))


def block_set(vol) -> set:
    d = convert.to_numpy(vol)
    live = d["entry_ptr"] >= 0
    return set(map(tuple, d["entry_pos"][live].tolist()))


def test_hash_index_matches_jax():
    rng = np.random.default_rng(0)
    pos = rng.integers(-(2**31), 2**31 - 1, (5000, 3), dtype=np.int64).astype(np.int32)
    pos[:100] = rng.integers(-50, 50, (100, 3))
    for mask in (0xFFFFF, 0x3FF):
        np.testing.assert_array_equal(
            t_hash.hash_index(T(pos), mask).numpy(), np.asarray(j_hash.hash_index(jnp.asarray(pos), mask))
        )


def test_compact_by_mask_matches_jax():
    rng = np.random.default_rng(1)
    mask = rng.uniform(size=300) < 0.4
    vals = rng.integers(0, 1000, 300).astype(np.int32)
    for size in (50, 300):  # with and without overflow
        o_j, n_j = j_hash.compact_by_mask(jnp.asarray(mask), jnp.asarray(vals), size, fill=-7)
        o_t, n_t = t_hash.compact_by_mask(T(mask), T(vals), size, fill=-7)
        np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))
        assert int(n_t) == int(n_j)


def test_scatter_drop_matches_jax_at_set_min_max():
    rng = np.random.default_rng(2)
    target = rng.standard_normal(20).astype(np.float32)
    # the port never passes negative indices (drops are routed to len)
    idx = rng.integers(0, 25, 40).astype(np.int32)
    idx_u = np.unique(idx)  # .set with unique indices is deterministic
    vals = rng.standard_normal(idx_u.shape[0]).astype(np.float32)
    np.testing.assert_array_equal(
        t_hash.scatter_drop(T(target), T(idx_u), T(vals)).numpy(),
        np.asarray(jnp.asarray(target).at[idx_u].set(vals, mode="drop")),
    )
    v2 = rng.standard_normal(40).astype(np.float32)
    for red, at in (("amin", "min"), ("amax", "max")):
        np.testing.assert_array_equal(
            t_hash.scatter_drop(T(target), T(idx), T(v2), reduce=red).numpy(),
            np.asarray(getattr(jnp.asarray(target).at[idx], at)(v2, mode="drop")),
        )


def test_point_to_block_matches_jax():
    pts = np.random.default_rng(3).integers(-100, 100, (500, 3)).astype(np.int32)
    b_j, l_j = j_hash.point_to_block(jnp.asarray(pts), 8)
    b_t, l_t = t_hash.point_to_block(T(pts), 8)
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))
    np.testing.assert_array_equal(l_t.numpy(), np.asarray(l_j))


def test_blocks_on_ray_segment_planes_matches_jax():
    calib = default_calib(40, 30)
    depth = np.asarray(j_synth.render_depth(jnp.eye(4), jnp.asarray(calib.intrinsics_d.vector), (30, 40)))
    inv_M = np.asarray(j_se3.invert(j_se3.se3_exp(jnp.array([0.05, -0.02, 0.1, 0.03, -0.1, 0.02], jnp.float32))))
    args = (0.08, 0.02, 8, 4, 0.2, 3.0)
    out_j = j_hash.blocks_on_ray_segment_planes(jnp.asarray(depth), jnp.asarray(calib.intrinsics_d.vector),
                                                jnp.asarray(inv_M), *args)
    out_t = t_hash.blocks_on_ray_segment_planes(T(depth), T(calib.intrinsics_d.vector), T(inv_M), *args)
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert out_t[3].sum() > 1000


def test_packing_helpers_match_jax():
    rng = np.random.default_rng(4)
    sdf = np.concatenate([rng.uniform(-1.2, 1.2, 1000), [0.5 / 32767, -0.5 / 32767, 1.5 / 32767]]).astype(np.float32)
    w = rng.integers(0, 256, sdf.shape[0]).astype(np.int32)
    q_j = np.asarray(j_hv.sdf_to_q(jnp.asarray(sdf)))
    q_t = t_hv.sdf_to_q(T(sdf)).numpy()
    np.testing.assert_array_equal(q_t, q_j)  # round half to even on both sides
    packed = np.asarray(j_hv.pack_vox(jnp.asarray(q_j), jnp.asarray(w)))
    np.testing.assert_array_equal(t_hv.pack_vox(T(q_t), T(w)).numpy(), packed)
    np.testing.assert_array_equal(t_hv.vox_sdf(T(packed)).numpy(), np.asarray(j_hv.vox_sdf(jnp.asarray(packed))))
    np.testing.assert_array_equal(t_hv.vox_w(T(packed)).numpy(), np.asarray(j_hv.vox_w(jnp.asarray(packed))))
    np.testing.assert_array_equal(t_hv.vox_sdf_q(T(packed)).numpy(), np.asarray(j_hv.vox_sdf_q(jnp.asarray(packed))))
    clr = rng.uniform(-0.1, 1.1, (50, 3)).astype(np.float32)
    cq = np.asarray(j_hv.clr_to_q(jnp.asarray(clr)))
    np.testing.assert_array_equal(t_hv.clr_to_q(T(clr)).numpy(), cq)
    np.testing.assert_array_equal(t_hv.clr_from_q(T(cq)).numpy(), np.asarray(j_hv.clr_from_q(jnp.asarray(cq))))
    rgb = np.asarray(j_hv.pack_rgb(jnp.asarray(cq), jnp.asarray(w[:50])))
    np.testing.assert_array_equal(t_hv.pack_rgb(T(cq), T(w[:50])).numpy(), rgb)
    np.testing.assert_array_equal(t_hv.rgb_clr_q(T(rgb)).numpy(), np.asarray(j_hv.rgb_clr_q(jnp.asarray(rgb))))
    np.testing.assert_array_equal(t_hv.rgb_wc(T(rgb)).numpy(), np.asarray(j_hv.rgb_wc(jnp.asarray(rgb))))


def test_created_state_matches_jax():
    pairs = (
        (j_hv.create_hash(PARAMS, grid_params=GRID),
         t_hv.create_hash(PARAMS, grid_params=GRID, device="cpu")),
        (j_hv.create_render_state(PARAMS, grid_params=GRID),
         t_hv.create_render_state(PARAMS, grid_params=GRID, device="cpu")),
    )
    for s_j, s_t in pairs:
        d_j, d_t = convert.to_numpy(s_j), convert.to_numpy(s_t)
        assert d_j.keys() == d_t.keys()
        for k in d_j:
            if d_j[k] is None:
                assert d_t[k] is None, k
                continue
            assert d_t[k].dtype == d_j[k].dtype and d_t[k].shape == d_j[k].shape, k
            np.testing.assert_array_equal(d_t[k], d_j[k], err_msg=k)
    assert t_hv.sentinel_row(PARAMS) == j_hv.sentinel_row(PARAMS)


def random_blocks(n, seed):
    rng = np.random.default_rng(seed)
    b = rng.integers(-10, 10, (n, 3)).astype(np.int32)
    b[:, 2] = np.abs(b[:, 2])
    b[n // 2 :] += 20  # half outside the working grid
    return b


def test_insert_blocks_matches_jax_as_sets():
    blocks = random_blocks(300, 5)
    valid = np.ones(300, bool)
    valid[::7] = False
    vt = np.zeros(PARAMS.n_entries, np.int32)
    v_j = j_hv.create_hash(PARAMS, grid_params=GRID)
    v_t = t_hv.create_hash(PARAMS, grid_params=GRID, device="cpu")
    for _ in range(3):  # contended buckets insert over several rounds
        v_j, _vt, _w = j_hv.insert_blocks(v_j, jnp.asarray(vt), jnp.asarray(blocks), jnp.asarray(valid), PARAMS, GRID)
        v_t, _vt2, _w2 = t_hv.insert_blocks(v_t, T(vt), T(blocks), T(valid), PARAMS, GRID)
    s_j, s_t = block_set(v_j), block_set(v_t)
    assert s_t == s_j
    assert s_t <= set(map(tuple, blocks[valid].tolist())) and len(s_t) > 150
    assert int(v_t.last_free_block) == int(v_j.last_free_block)
    # every inserted block probes as found at its own entry
    pr = t_hv.probe(v_t, T(np.array(sorted(s_t), np.int32)), PARAMS)
    assert bool(pr.found.all())
    # the incrementally maintained caches equal a rebuild from the table
    np.testing.assert_array_equal(v_t.entry_grid.numpy(), t_hv.build_entry_grid(v_t, GRID).numpy())
    np.testing.assert_array_equal(v_t.block_grid.numpy(), t_hv.build_block_grid(v_t, GRID).reshape(-1).numpy())


@pytest.fixture(scope="module")
def jax_volume():
    """A JAX volume after 2 fused synthetic frames (tiny test settings)."""
    img = (60, 80)
    settings = tiny_test_settings().replace(tracking=TrackingParams(n_levels=3, min_valid_points=50))
    calib = default_calib(img[1], img[0])
    src = j_synth.SyntheticSource(calib, n_frames=2, img_size=img)
    proj = jnp.asarray(calib.intrinsics_d.vector)
    vol, rs, st = j_hp.create_engine_state(settings, img)
    for _ in range(2):
        depth, _r, _g = src.get_images()
        vol, rs, st, _d = j_hp.process_frame_hash(vol, rs, st, JView(depth=depth), proj, settings)
    return settings, vol, rs, st, proj, img


def test_grids_reader_and_visibility_match_jax(jax_volume):
    settings, vol_j, _rs, st, proj, img = jax_volume
    gp, params = settings.block_grid, settings.hashing
    vol_t = convert.from_numpy(t_hv.HashVolume, convert.to_numpy(vol_j), device="cpu")
    np.testing.assert_array_equal(t_hv.build_entry_grid(vol_t, gp).numpy(), np.asarray(j_hv.build_entry_grid(vol_j, gp)))
    np.testing.assert_array_equal(
        t_hv.build_block_grid(vol_t, gp).numpy(), np.asarray(j_hv.build_block_grid(vol_j, gp, params))
    )
    grid_t = t_hv.get_block_grid(vol_t, gp)
    np.testing.assert_array_equal(grid_t.numpy(), np.asarray(j_hv.get_block_grid(vol_j, gp, params)))
    rng = np.random.default_rng(6)
    live_pos = np.asarray(vol_j.entry_pos)[np.asarray(vol_j.entry_ptr) >= 0]
    pts = (live_pos[rng.integers(0, len(live_pos), 4000)] * 8 + rng.integers(-4, 12, (4000, 3))).astype(np.int32)
    s_j, f_j = j_hv.make_grid_reader(vol_j, j_hv.get_block_grid(vol_j, gp, params), gp, params)(jnp.asarray(pts))
    s_t, f_t = t_hv.make_grid_reader(vol_t, grid_t, gp, params)(T(pts))
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert 1000 < f_t.sum() < 4000
    # probes of every entry position, swapped-in or not
    live = np.asarray(vol_j.entry_ptr) >= 0
    pos = np.asarray(vol_j.entry_pos)[live]
    pr_j = j_hv.probe(vol_j, jnp.asarray(pos), params)
    pr_t = t_hv.probe(vol_t, T(pos), params)
    for a, b in zip(pr_t, pr_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # visibility of every allocated block from the last pose (same
    # arithmetic; corner offsets may round differently → allow 1 block)
    for enlarged in (False, True):
        v_j = np.asarray(j_hv.check_block_visibility(jnp.asarray(pos), st.pose, proj, img, 0.02, 8, enlarged))
        v_t = t_hv.check_block_visibility(T(pos), T(st.pose), T(proj), img, 0.02, 8, enlarged).numpy()
        assert (v_t != v_j).sum() <= 1 and v_t.sum() > 100


def test_state_conversion_round_trip(jax_volume):
    """JAX state → numpy → port → numpy is the identity for the volume, the
    render state and the tracking state after two fused frames."""
    _settings, vol, rs, st, _proj, _img = jax_volume
    for state, cls in ((vol, t_hv.HashVolume), (rs, t_hv.RenderStateVH), (st, t_ts.TrackingState)):
        d = convert.to_numpy(state)
        back = convert.to_numpy(convert.from_numpy(cls, d, device="cpu"))
        assert back.keys() == d.keys()
        for k, a in d.items():
            if a is None:
                assert back[k] is None
                continue
            assert back[k].dtype == a.dtype and back[k].shape == a.shape, k
            np.testing.assert_array_equal(back[k], a, err_msg=k)
            assert isinstance(getattr(state, k), jax.Array)
    with pytest.raises(KeyError):
        convert.from_numpy(t_hv.HashVolume, {"vox": np.zeros((1, 1), np.int32)}, device="cpu")
