"""The Ren SDF tracker of the port (ops/ren_tracking.py,
trackers.track_ren and the REN branch of the frame step) held to the JAX
package on the CPU, at the JAX package's own small settings
(tests/test_trackers_extra.py).

Single functions are compared tightly: the MRP rotation to float32
rounding, the energy within 1e-5 relative and ∇ and H within 1e-4 relative
of their largest entry (the same per-pixel terms, summed in another order).
The LM accepts a step when f2 < f, so a near-tie could take another branch
after a summation-order difference; the tracker and the 6-frame replay are
held to 1e-4 m and 0.01° a frame, the bar of tests/test_torch_slice.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinitam_tpu.calib import default_calib
from infinitam_tpu.config import SceneParams, Settings, TrackerType, TrackingParams, VoxelBlockHashParams
from infinitam_tpu.engine import hash_pipeline as j_hp
from infinitam_tpu.engine import hash_volume as j_hv
from infinitam_tpu.engine import trackers as j_tr
from infinitam_tpu.engine.view_builder import View as JView
from infinitam_tpu.io import synth as j_synth
from infinitam_tpu.ops import ren_tracking as j_rt
from infinitam_tpu.utils import se3 as j_se3
from infinitam_tpu_torch import convert
from infinitam_tpu_torch.engine import hash_pipeline as t_hp
from infinitam_tpu_torch.engine import hash_volume as t_hv
from infinitam_tpu_torch.engine import trackers as t_tr
from infinitam_tpu_torch.engine.view_builder import View
from infinitam_tpu_torch.ops import ren_tracking as t_rt
from infinitam_tpu_torch.ops.kernels import build

IMG = (60, 80)
CALIB = default_calib(IMG[1], IMG[0])
PROJ = CALIB.intrinsics_d.vector
TWIST = np.array([0.004, -0.003, 0.004, 0.002, -0.003, 0.002], np.float32)

# the tensors here are tiny: one intra-op thread per process keeps torch from
# contending for the cores with the other test workers (tier-1 runs under xdist)
torch.set_num_threads(1)


def settings_for(tt: TrackerType) -> Settings:
    """tests/test_trackers_extra.py:24-34."""
    return Settings(
        scene=SceneParams(voxel_size=0.025, mu=0.1, view_frustum_min=0.3, view_frustum_max=3.0),
        alloc_subsample=2,
        hashing=VoxelBlockHashParams(n_buckets=0x4000, n_excess=0x400, n_blocks=0x1800, max_visible_blocks=0x1000),
        tracking=TrackingParams(n_levels=3, min_valid_points=50),
        tracker_type=tt,
    )


def T(a):
    return torch.from_numpy(np.array(a))


def pose_error(P, G):
    """(camera-centre distance in metres, rotation angle in degrees), float64."""
    P, G = np.asarray(P, np.float64), np.asarray(G, np.float64)
    t = np.linalg.norm(np.linalg.inv(P)[:3, 3] - np.linalg.inv(G)[:3, 3])
    dR = P[:3, :3] @ G[:3, :3].T
    v = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]])
    return t, np.degrees(np.arctan2(0.5 * np.linalg.norm(v), 0.5 * (np.trace(dR) - 1.0)))


@pytest.fixture(scope="module")
def standalone():
    """tests/test_trackers_extra.py:70-86: one frame fused at the identity by
    the JAX package, the same volume in the port, both grid readers, and the
    depth of a camera moved by a small twist."""
    settings = settings_for(TrackerType.ICP)
    depth = j_synth.render_depth(jnp.eye(4), jnp.asarray(PROJ), IMG)
    vol, rs, st = j_hp.create_engine_state(settings, IMG)
    vol, rs, st, _ = j_hp.process_frame_hash(vol, rs, st, JView(depth=depth), jnp.asarray(PROJ), settings)
    j_read = j_hv.make_grid_reader(vol, j_hv.build_block_grid(vol, settings.block_grid, settings.hashing),
                                   settings.block_grid, settings.hashing)
    t_vol = convert.from_numpy(t_hv.HashVolume, convert.to_numpy(vol), device="cpu")
    t_read = t_hv.make_grid_reader(t_vol, t_hv.build_block_grid(t_vol, settings.block_grid), settings.block_grid,
                                   settings.hashing)
    gt = j_se3.se3_exp(jnp.asarray(TWIST))
    depth2 = np.asarray(j_synth.render_depth(gt, jnp.asarray(PROJ), IMG))
    return settings, j_read, t_read, depth2, np.asarray(gt)


@pytest.mark.parametrize("r", [[0.0, 0.0, 0.0], [0.01, -0.02, 0.005], [-0.2, 0.1, 0.3]])
def test_mrp_rotation_and_delta_match_jax(r):
    step = np.array([0.01, -0.02, 0.03, *r], np.float32)
    np.testing.assert_allclose(t_rt.mrp_rotation(T(step[3:])).numpy(),
                               np.asarray(j_rt.mrp_rotation(jnp.asarray(step[3:]))), rtol=0, atol=2e-7)
    np.testing.assert_allclose(t_rt.delta_matrix(T(step)).numpy(), np.asarray(j_rt.delta_matrix(jnp.asarray(step))),
                               rtol=0, atol=2e-7)


def test_unproject_view_matches_jax(standalone):
    _s, _jr, _tr, depth2, _gt = standalone
    np.testing.assert_array_equal(t_rt.unproject_view(T(depth2), T(PROJ)).numpy(),
                                  np.asarray(j_rt.unproject_view(jnp.asarray(depth2), jnp.asarray(PROJ))))


@pytest.mark.parametrize("offset", [0, 1], ids=["identity", "offset"])
def test_energy_and_gradient_hessian_match_jax(standalone, offset):
    settings, j_read, t_read, depth2, _gt = standalone
    inv = np.asarray(j_se3.se3_exp(jnp.asarray(TWIST * 0.5 * offset)))
    one_over = 1.0 / settings.scene.voxel_size
    j_pts = j_rt.unproject_view(jnp.asarray(depth2), jnp.asarray(PROJ))
    t_pts = t_rt.unproject_view(T(depth2), T(PROJ))
    f_j = float(j_rt.energy(j_read, j_pts, jnp.asarray(inv), one_over))
    f_t = float(t_rt.energy(t_read, t_pts, T(inv), one_over))
    assert f_j < -1000.0  # most pixels see the surface
    assert abs(f_t - f_j) <= 1e-5 * abs(f_j), (f_t, f_j)
    g_j, h_j = (np.asarray(a) for a in j_rt.gradient_hessian(j_read, j_pts, jnp.asarray(inv), one_over))
    g_t, h_t = (a.numpy() for a in t_rt.gradient_hessian(t_read, t_pts, T(inv), one_over))
    assert np.abs(h_j).max() > 0
    assert np.abs(g_t - g_j).max() <= 1e-4 * np.abs(g_j).max()
    assert np.abs(h_t - h_j).max() <= 1e-4 * np.abs(h_j).max()


def test_track_ren_small_offset_matches_jax(standalone):
    settings, j_read, t_read, depth2, gt = standalone
    tr_j = j_tr.track_ren(jnp.eye(4), jnp.asarray(depth2), jnp.asarray(PROJ), j_read, settings.scene.voxel_size,
                          settings.tracking)
    tr_t = t_tr.track_ren(torch.eye(4), T(depth2), T(PROJ), t_read, settings.scene.voxel_size, settings.tracking)
    t_err, r_err = pose_error(tr_t.pose.numpy(), tr_j.pose)
    assert t_err <= 1e-4 and r_err <= 0.01, (t_err, r_err)
    assert abs(float(tr_t.f) - float(tr_j.f)) <= 1e-5 * abs(float(tr_j.f))
    assert int(tr_t.num_valid) == int(tr_j.num_valid)
    # the refinement moved towards the truth, as the JAX package's test asks
    assert pose_error(tr_t.pose.numpy(), gt)[0] < 0.6 * pose_error(np.eye(4), gt)[0]


def test_ren_replay_matches_jax():
    """tests/test_trackers_extra.py::test_ren_tracker_refines: 6 synthetic
    frames through both frame steps with the composite ICP → Ren tracker;
    ICP runs levels 2..1 here (no_icp_run_till_level = 1), and no kernel is
    launched on the CPU."""
    settings = settings_for(TrackerType.REN)
    src = j_synth.SyntheticSource(CALIB, n_frames=6, img_size=IMG)
    v_j, r_j, s_j = j_hp.create_engine_state(settings, IMG)
    v_t, r_t, s_t = t_hp.create_engine_state(settings, IMG, device="cpu")
    build.reset_launch_counts()
    for i in range(6):
        d, _r, gt = src.get_images()
        v_j, r_j, s_j, d_j = j_hp.process_frame_hash(v_j, r_j, s_j, JView(depth=d), jnp.asarray(PROJ), settings)
        v_t, r_t, s_t, d_t = t_hp.process_frame_hash(v_t, r_t, s_t, View(depth=T(d)), T(PROJ), settings)
        t_err, r_err = pose_error(s_t.pose.numpy(), s_j.pose)
        assert t_err <= 1e-4 and r_err <= 0.01, f"frame {i}: {t_err:.2e} m, {r_err:.2e} deg"
        if i > 0:
            assert abs(int(d_t.num_valid) - int(d_j.num_valid)) <= max(3, int(d_j.num_valid) // 500)
            assert abs(float(d_t.f) - float(d_j.f)) <= 1e-3 * abs(float(d_j.f))
    assert pose_error(s_t.pose.numpy(), gt)[0] < 0.03
    assert build.launch_counts() == dict.fromkeys(build.KERNELS, 0)
