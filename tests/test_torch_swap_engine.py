"""The port's swapping engine held to the JAX package's on the CPU.

One module-scoped replay: MainEngine of both packages with swapping
(tests/test_swapping.py::swap_settings) at 60×80 over 6 synthetic frames,
one frame looking away (the pose turned π about y, its depth rendered
there, the maps marked stale), then frames 3-5 again from frame 3's pose
(maps stale), then flush_swap. Frame for frame: the poses within 1e-4 m and
0.01° (the bar of tests/test_torch_slice.py: ICP sums in another float32
order), the free-block count equal, the resident blocks and the swap states
equal by block coordinate (VBA rows and entry slots are unspecified between
the packages). After the flush: the host store equal by block coordinate,
sdf within 1 int16 step, weights exact. (Returning to frame 0 instead, the
third frame back tracks 0.3° from the truth in both packages and 0.022°
apart, from maps 4e-5 m apart: that frame's ICP amplifies float32 noise.)

Also the swap paths of tests/test_freeview_swap.py on the port: the colour
tracker tracks, and the divergence gate keeps the last good pose.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinitam_tpu.calib import default_calib
from infinitam_tpu.config import SceneParams, Settings, SwappingMode, TrackerType, TrackingParams
from infinitam_tpu.config import VoxelBlockHashParams
from infinitam_tpu.engine.main_engine import MainEngine as JEngine
from infinitam_tpu.io import synth as j_synth
from infinitam_tpu.utils import se3 as j_se3
from infinitam_tpu_torch import convert
from infinitam_tpu_torch.engine.main_engine import MainEngine
from infinitam_tpu_torch.io import synth

IMG = (60, 80)
N_FRAMES, BACK = 6, 3  # frames, the first frame replayed after looking away

# the tensors here are tiny: one intra-op thread per process keeps torch from
# contending for the cores with the other test workers (tier-1 runs under xdist)
torch.set_num_threads(1)


def swap_settings(**kw) -> Settings:
    """tests/test_swapping.py::swap_settings."""
    return Settings(
        scene=SceneParams(voxel_size=0.025, mu=0.1, view_frustum_min=0.3, view_frustum_max=3.0),
        hashing=VoxelBlockHashParams(n_buckets=0x4000, n_excess=0x400, n_blocks=0x1800, n_transfer_blocks=0x200,
                                     max_visible_blocks=0x1000),
        tracking=TrackingParams(n_levels=3, min_valid_points=50),
        swapping_mode=SwappingMode.ENABLED,
        **kw,
    )


def pose_error(P, G):
    """(camera-centre distance in metres, rotation angle in degrees)."""
    P, G = np.asarray(P, np.float64), np.asarray(G, np.float64)
    t = np.linalg.norm(np.linalg.inv(P)[:3, 3] - np.linalg.inv(G)[:3, 3])
    dR = P[:3, :3] @ G[:3, :3].T
    v = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]])
    return t, np.degrees(np.arctan2(0.5 * np.linalg.norm(v), 0.5 * (np.trace(dR) - 1.0)))


def snapshot(eng) -> dict:
    """What the comparison reads of an engine of either package, by block
    coordinate: {coord: ptr} of the allocated entries, {coord: swap state},
    the free-block count, and the VBA."""
    vol = convert.to_numpy(eng.vol)
    states = np.asarray(convert.to_numpy(eng.swap_states))
    alloc = np.nonzero(vol["entry_ptr"] >= -1)[0]
    coords = list(map(tuple, vol["entry_pos"][alloc].tolist()))
    return dict(ptr=dict(zip(coords, vol["entry_ptr"][alloc].tolist())),
                state=dict(zip(coords, states[alloc].tolist())),
                entry=dict(zip(coords, alloc.tolist())),
                free=int(vol["last_free_block"]) + 1, vox=vol["vox"])


def store(eng, snap) -> dict:
    """{coord: (sdf, w)} of the host store's entries with data."""
    gc = eng.global_cache
    return {c: (gc.stored_sdf[e], gc.stored_w[e]) for c, e in snap["entry"].items() if gc.has_stored[e]}


@pytest.fixture(scope="module")
def replay():
    settings = swap_settings()
    calib = default_calib(IMG[1], IMG[0])
    src = j_synth.SyntheticSource(calib, n_frames=N_FRAMES, img_size=IMG)
    frames = [src.get_images() for _ in range(N_FRAMES)]
    depths, gts = [np.asarray(d) for d, _r, _g in frames], [np.asarray(g) for _d, _r, g in frames]
    away = np.asarray(j_se3.se3_exp(jnp.array([0.0, 0.0, 0.0, 0.0, np.pi, 0.0])))
    far = np.asarray(j_synth.render_depth(jnp.asarray(away), jnp.asarray(calib.intrinsics_d.vector), IMG))
    # (depth, pose set before the frame with stale maps, or None)
    steps = [(d, None) for d in depths] + [(far, away)] + [(d, gts[BACK] if i == BACK else None)
                                                          for i, d in enumerate(depths) if i >= BACK]
    engines = (JEngine(settings, calib, IMG), MainEngine(settings, calib, IMG, device="cpu"))
    per_frame = []
    for depth, pose in steps:
        row = []
        for eng in engines:
            if pose is not None:
                eng.set_pose(pose)
                age = jnp.int32(-1) if isinstance(eng, JEngine) else torch.tensor(-1, dtype=torch.int32)
                eng.tracking_state = eng.tracking_state._replace(age=age)
            eng.process_frame(metric_depth=depth)
            row.append((eng.get_pose(), snapshot(eng)))
        per_frame.append(row)
    for eng in engines:
        eng.flush_swap()
    flushed = [snapshot(eng) for eng in engines]
    return per_frame, flushed, [store(eng, s) for eng, s in zip(engines, flushed)], engines


def test_poses_agree_every_frame(replay):
    per_frame = replay[0]
    for i, ((p_j, _sj), (p_t, _st)) in enumerate(per_frame):
        t_err, r_err = pose_error(p_t, p_j)
        assert t_err <= 1e-4 and r_err <= 0.01, f"frame {i}: {t_err:.2e} m, {r_err:.2e} deg"


def test_free_blocks_resident_blocks_and_swap_states_agree(replay):
    per_frame, flushed = replay[0], replay[1]
    rows = [(s_j, s_t) for (_p, s_j), (_q, s_t) in per_frame] + [tuple(flushed)]
    for i, (s_j, s_t) in enumerate(rows):
        assert s_t["free"] == s_j["free"], f"frame {i}"
        assert set(s_t["ptr"]) == set(s_j["ptr"]), f"frame {i}: allocated blocks"
        resident = {c for c, p in s_j["ptr"].items() if p >= 0}
        assert {c for c, p in s_t["ptr"].items() if p >= 0} == resident, f"frame {i}: resident blocks"
        assert s_t["state"] == s_j["state"], f"frame {i}: swap states"


def test_the_replay_exercised_the_host_tier(replay):
    """Blocks went out on the look-away frame, came back and merged their
    stored data; every allocated block is resident or stored after the
    flush."""
    _per_frame, flushed, stores, (_j, eng) = replay
    ex = eng.swap_exchange
    assert ex.n_evicted > 0 and ex.n_merged > 0 and ex.n_listed > ex.n_merged
    assert len(stores[1]) > 0 and int(eng.global_cache.has_stored.sum()) == len(stores[1])
    assert all(p >= 0 or c in stores[1] for c, p in flushed[1]["ptr"].items())


def test_the_host_store_agrees_after_the_flush(replay):
    stores = replay[2]
    assert set(stores[1]) == set(stores[0]) and len(stores[0]) > 0
    for c, (sdf_j, w_j) in stores[0].items():
        sdf_t, w_t = stores[1][c]
        assert np.abs(sdf_t.astype(np.int32) - sdf_j.astype(np.int32)).max() <= 1, c
        np.testing.assert_array_equal(w_t, w_j)


def test_resident_voxels_agree_after_the_flush(replay):
    """The resident blocks' voxels, by block coordinate: weights exact, sdf
    within 1 int16 step on all but 0.1% of the voxels (the integrate step is
    bit-exact, but the poses differ by float32 noise, which moves a voxel's
    projection near a depth edge: a few differ by tens of steps)."""
    s_j, s_t = replay[1]
    rows = [(p, s_t["ptr"][c]) for c, p in s_j["ptr"].items() if p >= 0]
    a = s_j["vox"][[p for p, _q in rows]]
    b = s_t["vox"][[q for _p, q in rows]]
    np.testing.assert_array_equal((a >> 8) & 0xFF, (b >> 8) & 0xFF)
    off = np.abs((a >> 16) - (b >> 16)) > 1
    print(f"{off.sum()} of {off.size} resident voxels differ by more than 1 step")
    assert off.mean() <= 1e-3


IMG_FV = (48, 64)


def small_settings(**kw) -> Settings:
    """tests/test_freeview_swap.py::small_settings."""
    return swap_settings(alloc_subsample=2, **kw)


def test_swap_with_color_tracker_tracks():
    """tests/test_freeview_swap.py::test_swap_with_color_tracker_tracks on
    the port: swapping with colour fusion and the colour tracker."""
    settings = small_settings(tracker_type=TrackerType.COLOR, use_color=True)
    calib = default_calib(IMG_FV[1], IMG_FV[0])
    eng = MainEngine(settings, calib, IMG_FV, device="cpu")
    src = synth.SyntheticSource(calib, n_frames=4, img_size=IMG_FV, with_rgb=True, device="cpu")
    for _ in range(4):
        depth, rgb, gt = src.get_images()
        eng.process_frame(metric_depth=depth, rgb=rgb)
    t_err, _r = pose_error(eng.get_pose(), gt.numpy())
    assert t_err < 0.05, f"swap+color translation error {t_err:.4f} m"


def test_swap_divergence_gate_active():
    """tests/test_freeview_swap.py::test_swap_divergence_gate_active on the
    port: an all-invalid frame keeps the last good pose on the swap path."""
    calib = default_calib(IMG_FV[1], IMG_FV[0])
    eng = MainEngine(small_settings(), calib, IMG_FV, device="cpu")
    src = synth.SyntheticSource(calib, n_frames=3, img_size=IMG_FV, device="cpu")
    for _ in range(3):
        eng.process_frame(metric_depth=src.get_images()[0])
    before = eng.get_pose()
    d = eng.process_frame(metric_depth=np.full(IMG_FV, -1.0, dtype=np.float32))
    assert d["num_valid"] == 0
    assert np.abs(eng.get_pose() - before).max() < 1e-6
