"""The port's colour tracker (ops/pyramid.py's rgb half, ops/color_tracking.py,
trackers.track_color, the colour reads and hash_pipeline.create_point_cloud)
held to the JAX package on the CPU, plus the port's versions of the three
tests of tests/test_color_tracking.py at their bars.

Settings, image size and calibration are those of tests/test_color_tracking.py
(60×80, 2.5 cm voxels, 3-level colour pyramid). Sums over the point cloud run
in another order in the two packages, so energies, gradients and Hessians
agree to relative 1e-4 and poses to 1e-4 m / 0.01°.
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
from infinitam_tpu.ops import color_tracking as j_ct
from infinitam_tpu.ops import pyramid as j_pyr
from infinitam_tpu.ops import voxel_access as j_va
from infinitam_tpu.utils import se3 as j_se3
from infinitam_tpu_torch import convert
from infinitam_tpu_torch.engine import captured
from infinitam_tpu_torch.engine import hash_pipeline as t_hp
from infinitam_tpu_torch.engine import hash_volume as t_hv
from infinitam_tpu_torch.engine import trackers as t_tr
from infinitam_tpu_torch.engine.view_builder import View
from infinitam_tpu_torch.io import synth as t_synth
from infinitam_tpu_torch.ops import color_tracking as t_ct
from infinitam_tpu_torch.ops import pyramid as t_pyr
from infinitam_tpu_torch.ops import voxel_access as t_va
from infinitam_tpu_torch.utils import se3 as t_se3

IMG = (60, 80)

# the tensors here are tiny: one intra-op thread per process keeps torch from
# contending for the cores with the other test workers (tier-1 runs under xdist)
torch.set_num_threads(1)
SETTINGS = Settings(
    scene=SceneParams(voxel_size=0.025, mu=0.1, view_frustum_min=0.3, view_frustum_max=3.0),
    hashing=VoxelBlockHashParams(n_buckets=0x4000, n_excess=0x400, n_blocks=0x1800, max_visible_blocks=0x1000),
    tracking=TrackingParams(n_levels=3, min_valid_points=50, color_n_levels=3),
    tracker_type=TrackerType.COLOR,
    use_color=True,
)
CALIB = default_calib(IMG[1], IMG[0])
PROJ = CALIB.intrinsics_d.vector
N_FRAMES = 4


def T(a):
    return torch.from_numpy(np.array(a))


def pose_error(P, G):
    P, G = np.asarray(P, np.float64), np.asarray(G, np.float64)
    t = np.linalg.norm(np.linalg.inv(P)[:3, 3] - np.linalg.inv(G)[:3, 3])
    dR = P[:3, :3] @ G[:3, :3].T
    v = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]])
    return t, np.degrees(np.arctan2(0.5 * np.linalg.norm(v), 0.5 * (np.trace(dR) - 1.0)))


def assert_rel(a, b, rel):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= rel * np.abs(b).max(), (np.abs(a - b).max(), np.abs(b).max())


@pytest.fixture(scope="module")
def replay():
    """The JAX package and the port run the colour tracker on the same
    N_FRAMES RGB-D frames side by side; per frame (JAX state, port state)."""
    src = j_synth.SyntheticSource(CALIB, n_frames=N_FRAMES, img_size=IMG, with_rgb=True)
    frames = [src.get_images() for _ in range(N_FRAMES)]
    v_j, r_j, s_j = j_hp.create_engine_state(SETTINGS, IMG)
    v_t, r_t, s_t = t_hp.create_engine_state(SETTINGS, IMG, device="cpu")
    out = []
    for depth, rgb, _gt in frames:
        v_j, r_j, s_j, d_j = j_hp.process_frame_hash(v_j, r_j, s_j, JView(depth=depth, rgb=rgb), jnp.asarray(PROJ),
                                                     SETTINGS, proj_rgb=jnp.asarray(PROJ))
        v_t, r_t, s_t, d_t = t_hp.process_frame_hash(v_t, r_t, s_t, View(depth=T(depth), rgb=T(rgb)), T(PROJ),
                                                     SETTINGS, proj_rgb=T(PROJ))
        # the port's step writes its state in place (captured.run): keep a
        # copy per frame
        out.append(((v_j, r_j, s_j, d_j), (*captured.tree_map(torch.clone, (v_t, r_t, s_t)), d_t)))
    return frames, out


@pytest.mark.parametrize("channels", [3, 0])
def test_rgb_pyramid_and_gradients_match_jax(channels):
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, IMG + ((channels,) if channels else ())).astype(np.float32)
    for f_t, f_j in ((t_pyr.gradient_x, j_pyr.gradient_x), (t_pyr.gradient_y, j_pyr.gradient_y),
                     (t_pyr.subsample_box, j_pyr.subsample_box)):
        a, b = f_t(T(img)).numpy(), np.asarray(f_j(jnp.asarray(img)))
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    pt, pj = t_pyr.build_rgb_pyramid(T(img), 4), j_pyr.build_rgb_pyramid(jnp.asarray(img), 4)
    assert [p.shape for p in pt] == [p.shape for p in pj]
    for a, b in zip(pt, pj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)


@pytest.mark.parametrize("skip", [False, True])
def test_color_f_and_g_match_jax(replay, skip):
    """On the point cloud after 2 frames and frame 3's image, at a perturbed
    pose. With skipPoints the JAX package masks every other point; the port's
    tracker slices the maps [::2, ::2], which must give the same sums."""
    frames, out = replay
    (_v, _r, s_j, _d), _port = out[1]
    rgb = frames[2][1]
    M = np.asarray(j_se3.se3_exp(jnp.array([0.004, -0.003, 0.005, 0.003, -0.004, 0.002])) @ s_j.pose)
    locs, cols = np.asarray(s_j.points_map), np.asarray(s_j.normals_map)
    for lvl in range(3):
        img_j = j_pyr.build_rgb_pyramid(jnp.asarray(rgb), 3)[lvl]
        img_t = t_pyr.build_rgb_pyramid(T(rgb), 3)[lvl]
        proj = PROJ * 0.5**lvl
        mask = j_ct.skip_points_mask(IMG, skip)
        g_j = j_ct.color_g(jnp.asarray(locs), jnp.asarray(cols), img_j, j_pyr.gradient_x(img_j),
                           j_pyr.gradient_y(img_j), jnp.asarray(proj), jnp.asarray(M), mask)
        f_j, n_j = j_ct.color_f(jnp.asarray(locs), jnp.asarray(cols), img_j, jnp.asarray(proj), jnp.asarray(M), mask)
        lt, ct = (T(locs[::2, ::2]), T(cols[::2, ::2])) if skip else (T(locs), T(cols))
        g_t = t_ct.color_g(lt, ct, img_t, t_pyr.gradient_x(img_t), t_pyr.gradient_y(img_t), T(proj), T(M))
        f_t, n_t = t_ct.color_f(lt, ct, img_t, T(proj), T(M))
        assert int(g_t.num_valid) == int(g_j.num_valid) == int(n_t) == int(n_j) > 200
        assert_rel(g_t.f, g_j.f, 1e-4)
        assert_rel(f_t, f_j, 1e-4)
        assert_rel(g_t.nabla, g_j.nabla, 1e-4)
        assert_rel(g_t.hessian, g_j.hessian, 1e-4)


def test_track_color_matches_jax(replay):
    """From the same maps and a pose 1 cm / 0.4° off, both trackers land on
    the same pose."""
    frames, out = replay
    (_v, _r, s_j, _d), _port = out[1]
    _depth, rgb, gt = frames[2]
    start = np.asarray(j_se3.se3_exp(jnp.array([0.006, -0.004, 0.005, 0.004, -0.003, 0.003])) @ s_j.pose)
    eye = np.eye(4, dtype=np.float32)
    tp = SETTINGS.tracking
    r_j = j_tr.track_color(jnp.asarray(start), jnp.asarray(rgb), jnp.asarray(PROJ), s_j.points_map, s_j.normals_map,
                           jnp.asarray(eye), jnp.asarray(eye), tp, skip_points=True)
    r_t = t_tr.track_color(T(start), T(rgb), T(PROJ), T(s_j.points_map), T(s_j.normals_map), T(eye), T(eye), tp,
                           skip_points=True)
    t_err, r_err = pose_error(r_t.pose.numpy(), r_j.pose)
    assert t_err <= 1e-4 and r_err <= 0.01, (t_err, r_err)
    assert int(r_t.num_valid) == int(r_j.num_valid) > 500
    np.testing.assert_allclose(float(r_t.f), float(r_j.f), rtol=1e-3)
    assert pose_error(r_t.pose.numpy(), gt)[0] < pose_error(start, gt)[0]  # it moved towards the truth


def test_color_tracker_replay_matches_jax(replay):
    frames, out = replay
    for i, ((v_j, r_j, s_j, d_j), (v_t, r_t, s_t, d_t)) in enumerate(out):
        t_err, r_err = pose_error(s_t.pose.numpy(), s_j.pose)
        assert t_err <= 1e-4 and r_err <= 0.01, f"frame {i}: {t_err:.2e} m, {r_err:.2e} deg"
        assert int(d_t.num_valid) == int(d_j.num_valid)
        hit_j, hit_t = np.asarray(s_j.points_map)[..., 3] > 0, s_t.points_map[..., 3].numpy() > 0
        assert (hit_j != hit_t).sum() == 0, f"frame {i}"
        if i > 0:
            np.testing.assert_allclose(float(d_t.f), float(d_j.f), rtol=1e-3)
    assert pose_error(out[-1][1][2].pose.numpy(), frames[-1][2])[0] < 0.02


def test_color_reads_match_jax(replay):
    """The hash colour reader and the trilinear colour read on the same
    volume and points."""
    _frames, out = replay
    (v_j, _r, s_j, _d), _port = out[1]
    v_t = convert.from_numpy(t_hv.HashVolume, convert.to_numpy(v_j), device="cpu")
    rng = np.random.default_rng(4)
    # voxel coordinates around the surface the last raycast hit
    surf = np.asarray(s_j.points_map)
    surf = surf[surf[..., 3] > 0][:, :3] / SETTINGS.scene.voxel_size
    pts = (surf + rng.uniform(-1, 1, surf.shape)).astype(np.float32)
    read_j = j_hv.make_hash_color_reader(v_j, SETTINGS.hashing)
    read_t = t_hv.make_hash_color_reader(v_t, SETTINGS.hashing)
    ipts = np.floor(pts).astype(np.int32)
    np.testing.assert_array_equal(read_t(T(ipts)).numpy(), np.asarray(read_j(jnp.asarray(ipts))))
    c_j = np.asarray(j_va.read_color_interpolated(read_j, jnp.asarray(pts)))
    c_t = t_va.read_color_interpolated(read_t, T(pts)).numpy()
    # the 8-term trilinear sum rounds a few ulp apart (values up to 1)
    np.testing.assert_allclose(c_t, c_j, rtol=0, atol=1e-5)
    assert (c_t > 0).any(-1).mean() > 0.9
    no_color = t_hv.make_hash_color_reader(v_t._replace(vox_rgb=None), SETTINGS.hashing)
    assert not no_color(T(ipts)).any()


def test_create_point_cloud_matches_jax(replay):
    """The RGB-frame raycast and colour read from the same volume: hit masks
    equal, colours within 1/255, locations within 10 µm (the plain raycast
    follows the XLA march to ~1e-4 voxel, tests/test_torch_raycast.py). The
    JAX package's maps are those its frame step prepared from that volume."""
    _frames, out = replay
    (v_j, r_j, s_j, _d), _port = out[2]
    d2r = np.linalg.inv(np.asarray(CALIB.rgb_to_depth)).astype(np.float32)
    v_t = convert.from_numpy(t_hv.HashVolume, convert.to_numpy(v_j), device="cpu")
    r_t = convert.from_numpy(t_hv.RenderStateVH, convert.to_numpy(r_j), device="cpu")
    l_t, c_t = t_hp.create_point_cloud(v_t, r_t, T(s_j.pose), T(PROJ), T(d2r), IMG, SETTINGS)
    l_j, c_j, l_t, c_t = np.asarray(s_j.points_map), np.asarray(s_j.normals_map), l_t.numpy(), c_t.numpy()
    hit = l_j[..., 3] > 0
    np.testing.assert_array_equal(l_t[..., 3], l_j[..., 3])
    np.testing.assert_array_equal(c_t[..., 3], c_j[..., 3])
    assert hit.sum() > 0.5 * hit.size
    np.testing.assert_allclose(c_t[..., :3], c_j[..., :3], rtol=0, atol=1.0 / 255.0)
    np.testing.assert_allclose(l_t[..., :3], l_j[..., :3], rtol=0, atol=1e-5)
    assert (c_t[hit][:, :3] > 0).all(-1).mean() > 0.9


# --- the port's versions of tests/test_color_tracking.py ---------------------


def _fuse(frames):
    vol, rs, st = t_hp.create_engine_state(SETTINGS, IMG, device="cpu")
    for depth, rgb in frames:
        vol, rs, st, _d = t_hp.process_frame_hash(vol, rs, st, View(depth=depth, rgb=rgb), T(PROJ), SETTINGS,
                                                  proj_rgb=T(PROJ))
    return vol, rs, st


def test_color_fusion_stores_scene_color():
    depth, rgb = t_synth.render_rgbd(torch.eye(4), T(PROJ), IMG)
    vol, _rs, _st = _fuse([(depth, rgb)])
    wc = t_hv.rgb_wc(vol.vox_rgb)
    assert int((wc > 0).sum()) > 1000
    touched = t_hv.rgb_clr_q(vol.vox_rgb)[wc > 0].to(torch.float32)
    assert float(touched.std()) > 0.05


def test_color_point_cloud_colours_match_observation():
    depth, rgb = t_synth.render_rgbd(torch.eye(4), T(PROJ), IMG)
    _vol, _rs, st = _fuse([(depth, rgb)])
    valid = st.points_map[..., 3] > 0
    assert float(valid.float().mean()) > 0.3
    err = (st.normals_map[..., :3] - rgb).abs()[valid]
    assert float(err.median()) < 0.15


def test_color_tracker_recovers_small_motion():
    depth0, rgb0 = t_synth.render_rgbd(torch.eye(4), T(PROJ), IMG)
    gt_pose = t_se3.se3_exp(torch.tensor([0.004, -0.003, 0.005, 0.003, -0.004, 0.002]))
    depth1, rgb1 = t_synth.render_rgbd(gt_pose, T(PROJ), IMG)
    _vol, _rs, st = _fuse([(depth0, rgb0), (depth0, rgb0), (depth1, rgb1)])
    err = t_se3.se3_log(st.pose @ t_se3.invert(gt_pose))
    t_err, r_err = float(err[:3].norm()), float(err[3:].norm())
    assert t_err < 0.008, f"translation error {t_err}"
    assert r_err < 0.01, f"rotation error {r_err}"
