"""The weighted ICP tracker (WICP), the external tracker and the IMU prior
held to the JAX package on the CPU.

K1's weighted reduction copies the JAX package's `reduce_gh(weights=)`
quirks: ω² on H, ω once on ∇, Σ(ωb)² for f and an unweighted N. Its plain
twin (`icp_gh_plain(weights=)`) is held to JAX `compute_residuals` +
`reduce_gh(weights=)` at the unweighted parity's tolerances
(tests/test_torch_icp.py: the same per-pixel terms summed in another order,
H and f relative 1e-5, ∇ 1e-4); fed the same residuals, the reduction alone
agrees to 1.4e-6 relative (bar 1e-5: BLAS and XLA sum in other orders).
The tracker and a 5-frame replay are held to the JAX package at the bars of
tests/test_torch_icp.py and tests/test_torch_slice.py (pose 1e-5; per frame
1e-4 m and 0.01°).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinitam_tpu.calib import default_calib
from infinitam_tpu.config import (
    SceneParams,
    Settings,
    TrackerType,
    TrackingParams,
    VoxelBlockHashParams,
    tiny_test_settings,
)
from infinitam_tpu.engine import hash_pipeline as j_hp
from infinitam_tpu.engine import trackers as j_tr
from infinitam_tpu.engine.view_builder import build_view_from_metric_depth as j_build
from infinitam_tpu.io import synth as j_synth
from infinitam_tpu.ops import icp as j_icp
from infinitam_tpu.ops import view_ops as j_vo
from infinitam_tpu.ops.pyramid import subsample_with_holes as j_subsample
from infinitam_tpu.utils import se3 as j_se3
from infinitam_tpu_torch.engine import hash_pipeline as t_hp
from infinitam_tpu_torch.engine import trackers as t_tr
from infinitam_tpu_torch.engine.view_builder import View, build_view_from_metric_depth as t_build
from infinitam_tpu_torch.io import synth as t_synth
from infinitam_tpu_torch.ops import icp as t_icp
from infinitam_tpu_torch.ops.kernels import build
from infinitam_tpu_torch.ops.kernels import icp as k_icp
from infinitam_tpu_torch.utils import se3 as t_se3

IMG = (60, 80)
STEP = np.array([0.004, -0.006, 0.003, 0.004, -0.002, 0.006], np.float32)

# the tensors here are tiny: one intra-op thread per process keeps torch from
# contending for the cores with the other test workers (tier-1 runs under xdist)
torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def make_scene(H=64, W=64, seed=0):
    """Smooth synthetic maps, noisy depth with holes and a weight map ω in
    [0.5, 1] with 5% zeros (the scene of tests/test_torch_icp.py)."""
    rng = np.random.default_rng(seed)
    proj = np.array([80.0, 80.0, W / 2 - 0.5, H / 2 - 0.5], np.float32)
    xs = np.arange(W, dtype=np.float32)[None, :]
    ys = np.arange(H, dtype=np.float32)[:, None]
    z = 1.5 + 0.2 * np.sin(xs / 17.0) * np.cos(ys / 13.0)
    pts = np.stack([z * (xs - proj[2]) / proj[0], z * (ys - proj[3]) / proj[1], z, np.ones_like(z)], -1)
    pts[..., 3] = np.where(rng.uniform(size=(H, W)) < 0.07, -1.0, 1.0)
    n = np.zeros((H, W, 4), np.float32)
    n[..., 2] = -1.0
    n[..., 0] = 0.1 * np.sin(ys / 11.0)
    n[..., :3] /= np.linalg.norm(n[..., :3], axis=-1, keepdims=True)
    n[..., 3] = pts[..., 3]
    depth = z + rng.normal(0, 0.002, size=z.shape).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.05] = -1.0
    w = rng.uniform(0.5, 1.0, size=(H, W)).astype(np.float32)
    w[rng.uniform(size=w.shape) < 0.05] = 0.0
    return depth.astype(np.float32), proj, pts.astype(np.float32), n, w


def jax_args(depth, proj, pts, nrm, inv_pose):
    return [jnp.asarray(a) for a in (depth, proj, pts, nrm, proj, inv_pose, np.eye(4, dtype=np.float32))]


def test_weighted_reduce_gh_matches_jax():
    """The reduction alone, fed the JAX package's residuals."""
    depth, proj, pts, nrm, w = make_scene(seed=3)
    inv_pose = np.asarray(j_se3.se3_exp(jnp.asarray(STEP / 2)))
    b, A, valid, _p = j_icp.compute_residuals(*jax_args(depth, proj, pts, nrm, inv_pose), 0.04)
    gh_j = j_icp.reduce_gh(b, A, valid, 100, weights=jnp.asarray(w))
    gh_t = t_icp.reduce_gh(T(b), T(A), T(valid), 100, weights=T(w))
    assert int(gh_t.num_valid) == int(gh_j.num_valid) == int(np.asarray(valid).sum()) > 2000
    np.testing.assert_allclose(gh_t.hessian.numpy(), np.asarray(gh_j.hessian), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gh_t.nabla.numpy(), np.asarray(gh_j.nabla), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(gh_t.f), float(gh_j.f), rtol=1e-5)


def test_weighted_plain_k1_matches_jax():
    depth, proj, pts, nrm, w = make_scene(seed=3)
    inv_pose = np.asarray(j_se3.se3_exp(jnp.asarray(STEP / 2)))
    args_j = jax_args(depth, proj, pts, nrm, inv_pose)
    gh_j = j_icp.reduce_gh(*j_icp.compute_residuals(*args_j, 0.04)[:3], 100, weights=jnp.asarray(w))
    gh_t = k_icp.icp_gh_plain(*[T(np.asarray(a)) for a in args_j], 0.04, 100, weights=T(w))
    assert int(gh_t.num_valid) == int(gh_j.num_valid)
    np.testing.assert_allclose(gh_t.hessian.numpy(), np.asarray(gh_j.hessian), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gh_t.nabla.numpy(), np.asarray(gh_j.nabla), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(float(gh_t.f), float(gh_j.f), rtol=1e-5)
    # the weights moved every sum
    gh_u = k_icp.icp_gh_plain(*[T(np.asarray(a)) for a in args_j], 0.04, 100)
    assert not torch.allclose(gh_t.hessian, gh_u.hessian, rtol=1e-2) and float(gh_t.f) < float(gh_u.f)


def test_zero_weights_keep_the_count():
    """ω = 0 everywhere: N is the unweighted count, H = ∇ = 0 and f = 0."""
    depth, proj, pts, nrm, _w = make_scene(seed=4)
    args = [T(a) for a in (depth, proj, pts, nrm, proj, np.asarray(j_se3.se3_exp(jnp.asarray(STEP))))]
    gh_u = k_icp.icp_gh(*args, torch.eye(4), 0.04, 100)
    gh_0 = k_icp.icp_gh(*args, torch.eye(4), 0.04, 100, weights=torch.zeros(depth.shape))
    assert int(gh_0.num_valid) == int(gh_u.num_valid) > 2000
    assert (gh_0.hessian == 0).all() and (gh_0.nabla == 0).all() and float(gh_0.f) == 0.0


def test_weighted_k1_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors the weighted call is the plain twin bit for bit, the
    unweighted call is unchanged, and no kernel is counted."""
    depth, proj, pts, nrm, w = make_scene(seed=5)
    args = (T(depth), T(proj), T(pts), T(nrm), T(proj), T(np.asarray(j_se3.se3_exp(jnp.asarray(STEP)))),
            torch.eye(4), 0.04, 100)
    build.reset_launch_counts()
    for x, y in zip(k_icp.icp_gh(*args, weights=T(w)), k_icp.icp_gh_plain(*args, weights=T(w))):
        assert torch.equal(x, y)
    b, A, valid, _p = t_icp.compute_residuals(*args[:8])
    for x, y in zip(k_icp.icp_gh(*args), t_icp.reduce_gh(b, A, valid, 100)):
        assert torch.equal(x, y)
    assert build.launch_counts()["icp"] == build.launch_counts()["icp_weighted"] == 0
    with pytest.raises(ValueError):  # the kernel path refuses CPU tensors
        k_icp.icp_gh_cuda(*args, weights=T(w))


def test_weight_pyramid_matches_jax():
    """σ subsampled with holes, ω = minσ/σ·0.5 + 0.5 where σ > 0, else 0, as
    trackers.py:96-107 of the JAX package builds it."""
    depth, proj, _pts, _nrm, _w = make_scene(seed=6)
    intr = default_calib(64, 64).intrinsics_d
    _n, sigma = j_vo.compute_normals_and_weights(jnp.asarray(depth), intr)
    want, sig = [], sigma
    for lvl in range(4):
        pos = sig > 0
        min_sigma = jnp.min(jnp.where(pos, sig, jnp.inf))
        want.append(np.asarray(jnp.where(pos, min_sigma / jnp.maximum(sig, 1e-12) * 0.5 + 0.5, 0.0)))
        sig = j_subsample(sig)
    got = t_tr.weight_pyramid(T(np.asarray(sigma)), 4)
    for g, wnt in zip(got, want):
        assert g.shape == wnt.shape
        np.testing.assert_allclose(g.numpy(), wnt, rtol=1e-6, atol=0)
        assert (wnt > 0).mean() > 0.5 and wnt.max() == 1.0 and wnt[wnt > 0].min() >= 0.5


def test_track_depth_weighted_matches_jax():
    depth, proj, pts, nrm, _w = make_scene(seed=11)
    intr = default_calib(64, 64).intrinsics_d
    sigma = np.asarray(j_vo.compute_normals_and_weights(jnp.asarray(depth), intr)[1])
    params = TrackingParams(n_levels=3, min_valid_points=50)
    pose0 = np.asarray(j_se3.invert(j_se3.se3_exp(jnp.asarray(STEP))))
    eye = np.eye(4, dtype=np.float32)
    tr_j = j_tr.track_depth(jnp.asarray(pose0), jnp.asarray(depth), jnp.asarray(proj), jnp.asarray(pts),
                            jnp.asarray(nrm), jnp.asarray(eye), params, weights_map=jnp.asarray(sigma))
    tr_t = t_tr.track_depth(T(pose0), T(depth), T(proj), T(pts), T(nrm), T(eye), params, weights_map=T(sigma))
    # sums in another order move the solve by float32 noise
    np.testing.assert_allclose(tr_t.pose.numpy(), np.asarray(tr_j.pose), atol=1e-5)
    assert int(tr_t.num_valid) == int(tr_j.num_valid)
    np.testing.assert_allclose(float(tr_t.f), float(tr_j.f), rtol=1e-4)
    tr_u = t_tr.track_depth(T(pose0), T(depth), T(proj), T(pts), T(nrm), T(eye), params)
    assert float(tr_u.f) != float(tr_t.f)  # the weights reached the tracker


def pose_error(P, G):
    """(camera-centre distance in metres, rotation angle in degrees), float64."""
    P, G = np.asarray(P, np.float64), np.asarray(G, np.float64)
    t = np.linalg.norm(np.linalg.inv(P)[:3, 3] - np.linalg.inv(G)[:3, 3])
    dR = P[:3, :3] @ G[:3, :3].T
    v = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]])
    return t, np.degrees(np.arctan2(0.5 * np.linalg.norm(v), 0.5 * (np.trace(dR) - 1.0)))


def test_five_frame_wicp_replay_matches_jax():
    """WICP with the bilateral filter and the sensor-noise model, frame for
    frame from the same depth through each package's view builder and
    process_frame_hash."""
    settings = tiny_test_settings().replace(tracking=TrackingParams(n_levels=3, min_valid_points=50),
                                            tracker_type=TrackerType.WICP, model_sensor_noise=True,
                                            use_bilateral_filter=True)
    calib = default_calib(IMG[1], IMG[0])
    src = j_synth.SyntheticSource(calib, n_frames=5, img_size=IMG)
    proj = calib.intrinsics_d.vector
    v_j, r_j, s_j = j_hp.create_engine_state(settings, IMG)
    v_t, r_t, s_t = t_hp.create_engine_state(settings, IMG, device="cpu")
    for i in range(5):
        depth, _rgb, gt = src.get_images()
        depth = np.asarray(depth)
        view_j = j_build(jnp.asarray(depth), settings, calib)
        view_t = t_build(T(depth), settings, calib)
        assert view_t.depth_uncertainty is not None
        v_j, r_j, s_j, d_j = j_hp.process_frame_hash(v_j, r_j, s_j, view_j, jnp.asarray(proj), settings)
        v_t, r_t, s_t, d_t = t_hp.process_frame_hash(v_t, r_t, s_t, view_t, T(proj), settings)
        t_err, r_err = pose_error(s_t.pose.numpy(), s_j.pose)
        assert t_err <= 1e-4 and r_err <= 0.01, f"frame {i}: {t_err:.2e} m, {r_err:.2e} deg"
        assert int(d_t.n_visible) == int(d_j.n_visible)
    assert pose_error(s_t.pose.numpy(), gt)[0] < 0.01


def settings_for(tt):
    """tests/test_trackers_extra.py's settings."""
    return Settings(
        scene=SceneParams(voxel_size=0.025, mu=0.1, view_frustum_min=0.3, view_frustum_max=3.0),
        alloc_subsample=2,
        hashing=VoxelBlockHashParams(n_buckets=0x4000, n_excess=0x400, n_blocks=0x1800, max_visible_blocks=0x1000),
        tracking=TrackingParams(n_levels=3, min_valid_points=50),
        tracker_type=tt,
    )


def test_external_tracker_injects_pose():
    """Mirror of tests/test_trackers_extra.py::test_external_tracker_injects_pose."""
    settings = settings_for(TrackerType.EXTERNAL)
    calib = default_calib(IMG[1], IMG[0])
    proj = torch.as_tensor(calib.intrinsics_d.vector)
    src = t_synth.SyntheticSource(calib, n_frames=4, img_size=IMG, device="cpu")
    vol, rs, st = t_hp.create_engine_state(settings, IMG, device="cpu")
    for _ in range(4):
        d, _r, gt = src.get_images()
        vol, rs, st, diag = t_hp.process_frame_hash(vol, rs, st, View(depth=d), proj, settings, external_pose=gt)
    np.testing.assert_allclose(st.pose.numpy(), src.gt_poses[3], atol=1e-6)
    assert int(diag.n_visible) > 100 and float(diag.f) == 0.0


def test_imu_rotation_prior_helps():
    """Mirror of tests/test_trackers_extra.py::test_imu_rotation_prior_helps,
    with the prior itself held to the JAX package's."""
    settings = settings_for(TrackerType.ICP)
    calib = default_calib(IMG[1], IMG[0])
    proj = torch.as_tensor(calib.intrinsics_d.vector)
    depth0 = t_synth.render_depth(torch.eye(4), proj, IMG)
    vol, rs, st = t_hp.create_engine_state(settings, IMG, device="cpu")
    vol, rs, st, _ = t_hp.process_frame_hash(vol, rs, st, View(depth=depth0), proj, settings)
    twist = torch.tensor([0.0, 0.0, 0.0, 0.10, -0.08, 0.05])  # ~8°, beyond the ICP basin at these levels
    gt = t_se3.se3_exp(twist)
    depth1 = t_synth.render_depth(gt, proj, IMG)
    delta_rot = t_se3.so3_exp(twist[3:] * 0.95)  # 5% gyro error
    prior = t_tr.apply_imu_rotation(st.pose, delta_rot)
    np.testing.assert_allclose(
        prior.numpy(), np.asarray(j_tr.apply_imu_rotation(jnp.asarray(st.pose.numpy()),
                                                          jnp.asarray(delta_rot.numpy()))), atol=1e-6)
    _v, _r, st2, _ = t_hp.process_frame_hash(vol, rs, st._replace(pose=prior), View(depth=depth1), proj, settings)
    err_with = float(torch.linalg.vector_norm(t_se3.se3_log(st2.pose @ t_se3.invert(gt))))
    assert err_with < 0.02, err_with
