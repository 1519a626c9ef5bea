"""The port's frame loop as a whole, held to the JAX package on the CPU.

1. A 5-frame synthetic replay through JAX `process_frame_hash` and the
   port's, frame for frame from the same depth: the poses must agree to
   1e-4 m and 0.01°, the allocated blocks and visible lists must be equal as
   sets of block coordinates, and every silent-cap counter must stay 0.
   The integrate step is bit-exact (tests/test_torch_integrate.py); the ICP
   sums run in another order, so poses drift apart by float32 noise, which a
   Gauss-Newton iteration that lands on the other side of the convergence
   threshold can amplify to ~1e-5 m (measured: 1.3e-5 m, 0.002° at frame 4).
2. The committed PGM fixture (tests/fixtures/replay) through
   io.sources.ImageFileReader → the port's build_view → frame loop must end
   within 1 cm and 1° of the recorded trajectory, the gate of
   tests/test_file_replay.py.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinitam_tpu.calib import default_calib
from infinitam_tpu.config import SwappingMode, TrackerType, TrackingParams, tiny_test_settings
from infinitam_tpu.engine import hash_pipeline as j_hp
from infinitam_tpu.engine.view_builder import View as JView
from infinitam_tpu.io import synth as j_synth
from infinitam_tpu.io.sources import ImageFileReader
from infinitam_tpu_torch import convert
from infinitam_tpu_torch.engine import hash_pipeline as t_hp
from infinitam_tpu_torch.engine.view_builder import View, build_view

IMG = (60, 80)

# the tensors here are tiny: one intra-op thread per process keeps torch from
# contending for the cores with the other test workers (tier-1 runs under xdist)
torch.set_num_threads(1)
COUNTERS = ("n_alloc_overflow", "n_render_overflow", "n_pool_overflow", "n_too_big_blocks", "n_window_clipped")
FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "replay")


def pose_error(P, G):
    """(camera-centre distance in metres, rotation angle in degrees) between
    two world→camera poses, in float64; the angle from atan2 of the
    antisymmetric part, which float32 rounding of the trace would swamp."""
    P, G = np.asarray(P, np.float64), np.asarray(G, np.float64)
    t = np.linalg.norm(np.linalg.inv(P)[:3, 3] - np.linalg.inv(G)[:3, 3])
    dR = P[:3, :3] @ G[:3, :3].T
    v = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]])
    return t, np.degrees(np.arctan2(0.5 * np.linalg.norm(v), 0.5 * (np.trace(dR) - 1.0)))


def block_set(vol) -> set:
    d = convert.to_numpy(vol)
    return set(map(tuple, d["entry_pos"][d["entry_ptr"] >= 0].tolist()))


def visible_blocks(vol, rs) -> list:
    d, r = convert.to_numpy(vol), convert.to_numpy(rs)
    ids = r["visible_ids"]
    return sorted(map(tuple, d["entry_pos"][ids[ids >= 0]].tolist()))


@pytest.fixture(scope="module")
def replay():
    settings = tiny_test_settings().replace(tracking=TrackingParams(n_levels=3, min_valid_points=50))
    calib = default_calib(IMG[1], IMG[0])
    src = j_synth.SyntheticSource(calib, n_frames=5, img_size=IMG)
    frames = [src.get_images() for _ in range(5)]
    return settings, calib, [np.asarray(d) for d, _r, _g in frames], [np.asarray(g) for _d, _r, g in frames]


def test_five_frame_replay_matches_jax(replay):
    settings, calib, depths, gts = replay
    proj = calib.intrinsics_d.vector
    v_j, r_j, s_j = j_hp.create_engine_state(settings, IMG)
    v_t, r_t, s_t = t_hp.create_engine_state(settings, IMG, device="cpu")
    for i, depth in enumerate(depths):
        v_j, r_j, s_j, d_j = j_hp.process_frame_hash(v_j, r_j, s_j, JView(depth=jnp.asarray(depth)),
                                                     jnp.asarray(proj), settings)
        v_t, r_t, s_t, d_t = t_hp.process_frame_hash(v_t, r_t, s_t, View(depth=torch.from_numpy(depth.copy())),
                                                     torch.from_numpy(proj), settings)
        t_err, r_err = pose_error(s_t.pose.numpy(), s_j.pose)
        assert t_err <= 1e-4 and r_err <= 0.01, f"frame {i}: {t_err:.2e} m, {r_err:.2e} deg"
        assert block_set(v_t) == block_set(v_j), f"frame {i}"
        assert visible_blocks(v_t, r_t) == visible_blocks(v_j, r_j), f"frame {i}"
        assert int(d_t.n_visible) == int(d_j.n_visible)
        assert int(d_t.n_free_blocks) == int(d_j.n_free_blocks)
        assert all(int(getattr(d_t, k)) == 0 == int(getattr(d_j, k)) for k in COUNTERS), f"frame {i}"
        if i > 0:
            assert abs(int(d_t.num_valid) - int(d_j.num_valid)) <= max(3, int(d_j.num_valid) // 500)
            np.testing.assert_allclose(float(d_t.f), float(d_j.f), rtol=1e-2)
    # and both track the ground truth
    assert pose_error(s_t.pose.numpy(), gts[-1])[0] < 0.01


def test_process_sequence_equals_frame_loop(replay):
    settings, calib, depths, _gts = replay
    proj = torch.from_numpy(calib.intrinsics_d.vector)
    # two frames: the second one tracks against the first one's maps
    seq = torch.from_numpy(np.stack(depths[:2]))
    state = t_hp.create_engine_state(settings, IMG, device="cpu")
    _v, _r, st, poses, diags = t_hp.process_sequence_hash(*state, seq, proj, settings)
    v, r, s = t_hp.create_engine_state(settings, IMG, device="cpu")
    for i in range(2):
        v, r, s, d = t_hp.process_frame_hash(v, r, s, View(depth=seq[i]), proj, settings)
        np.testing.assert_array_equal(poses[i].numpy(), s.pose.numpy())
        assert int(diags.n_visible[i]) == int(d.n_visible)
    assert int(diags.num_valid[1]) > 1000
    assert diags.n_alloc_overflow.shape == (2,)
    np.testing.assert_array_equal(st.pose.numpy(), s.pose.numpy())


def test_unported_settings_are_refused(replay):
    """Nothing is refused any more: the read paths beside K3's block grid
    (the coarse raycast pass and the hash-probe raycast) run two frames, and
    the Ren tracker, the approximate raycast and swapping set up."""
    settings, calib, depths, _g = replay
    proj = torch.from_numpy(calib.intrinsics_d.vector)
    for ported in (dict(raycast_coarse_factor=2), dict(use_block_grid=False)):
        s = settings.replace(**ported)
        v, r, st = t_hp.create_engine_state(s, IMG, device="cpu")
        for depth in depths[:2]:
            v, r, st, d = t_hp.process_frame_hash(v, r, st, View(depth=torch.from_numpy(depth.copy())), proj, s)
        assert int(d.num_valid) > 1000 and np.isfinite(st.pose.numpy()).all()
    for good in (dict(tracker_type=TrackerType.REN), dict(use_approximate_raycast=True),
                 dict(swapping_mode=SwappingMode.ENABLED)):
        t_hp.create_engine_state(settings.replace(**good), IMG, device="cpu")


def test_pgm_fixture_replay_tracks():
    src = ImageFileReader(os.path.join(FIX, "calib.txt"), rgb_mask="", depth_mask=os.path.join(FIX, "depth_%04i.pgm"))
    gt = np.load(os.path.join(FIX, "gt_poses.npy"))
    img = (src.calib.intrinsics_d.height, src.calib.intrinsics_d.width)
    settings = tiny_test_settings()
    proj = torch.from_numpy(src.calib.intrinsics_d.vector)
    vol, rs, st = t_hp.create_engine_state(settings, img, device="cpu")
    n = 0
    while src.has_more_images():
        raw, _rgb = src.get_images()
        assert raw.dtype == np.uint16
        view = build_view(torch.from_numpy(raw.astype(np.int32)), src.calib, settings)
        vol, rs, st, diag = t_hp.process_frame_hash(vol, rs, st, view, proj, settings)
        n += 1
    assert n == gt.shape[0] == 10
    t_err, r_err = pose_error(st.pose.numpy(), gt[-1])
    assert t_err < 0.01, f"file replay diverged: {t_err * 1000:.1f} mm"
    assert r_err < 1.0
    assert int(diag.num_valid) > 500
