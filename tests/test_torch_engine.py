"""The port's MainEngine façade held to the JAX package's on the CPU.

The same synthetic RGB-D frames go through both engines: the per-frame
poses must agree to 1e-4 m and 0.01° (tests/test_torch_slice.py's bar: the
ICP sums run in another order), the LazyDiag keys and counters must be
equal, and every image `get_image` renders, freeview included, must lie
within 1 LSB of the JAX package's on ≥ 99% of its pixels (the same
raycast, shaded in float32 ops that may round an ulp apart before the cast
to uint8). The committed PGM fixture replays through the port's
ImageFileReader and MainEngine on raw depth: within 1 cm and 1° of the
recorded trajectory (tests/test_file_replay.py's gate) and within 1e-4 m of
the JAX engine on every frame. The colormaps and the fusion-weight readers
behind `get_image` are held to the JAX package's as well.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinitam_tpu.calib import default_calib
from infinitam_tpu.config import SceneParams, Settings, TrackingParams, VoxelBlockHashParams, tiny_test_settings
from infinitam_tpu.engine import hash_volume as j_hv
from infinitam_tpu.engine.main_engine import MainEngine as JEngine
from infinitam_tpu.io import synth as j_synth
from infinitam_tpu.io.sources import ImageFileReader as JReader
from infinitam_tpu.ops import colormaps as j_cm
from infinitam_tpu_torch.engine import hash_pipeline as t_hp
from infinitam_tpu_torch.engine import hash_volume as t_hv
from infinitam_tpu_torch.engine.main_engine import LazyDiag, MainEngine
from infinitam_tpu_torch.io.sources import ImageFileReader
from infinitam_tpu_torch.ops import colormaps as t_cm
from infinitam_tpu_torch.ops.kernels import build

IMG = (60, 80)
N_FRAMES = 3
FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "replay")
COUNTERS = ("n_alloc_overflow", "n_render_overflow", "n_pool_overflow", "n_too_big_blocks", "n_window_clipped")

# the tensors here are tiny: one intra-op thread per process keeps torch from
# contending for the cores with the other test workers (tier-1 runs under xdist)
torch.set_num_threads(1)


def pose_error(P, G):
    """(camera-centre distance in metres, rotation angle in degrees), float64."""
    P, G = np.asarray(P, np.float64), np.asarray(G, np.float64)
    t = np.linalg.norm(np.linalg.inv(P)[:3, 3] - np.linalg.inv(G)[:3, 3])
    dR = P[:3, :3] @ G[:3, :3].T
    v = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]])
    return t, np.degrees(np.arctan2(0.5 * np.linalg.norm(v), 0.5 * (np.trace(dR) - 1.0)))


def settings():
    """tests/test_freeview_swap.py's small settings, with colour fusion."""
    return Settings(
        scene=SceneParams(voxel_size=0.025, mu=0.1, view_frustum_min=0.3, view_frustum_max=3.0),
        hashing=VoxelBlockHashParams(n_buckets=0x4000, n_excess=0x400, n_blocks=0x1800, n_transfer_blocks=0x200,
                                     max_visible_blocks=0x1000),
        tracking=TrackingParams(n_levels=3, min_valid_points=50),
        alloc_subsample=2,
        use_color=True,
    )


def back_pose():
    """A camera behind the scene looking back at it (tests/test_freeview_swap.py)."""
    R = np.array([[-1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, -1.0]])
    M = np.eye(4, dtype=np.float32)
    M[:3, :3] = R
    M[:3, 3] = -R @ np.array([0.0, 0.0, 3.2])
    return M


@pytest.fixture(scope="module")
def engines():
    """Both engines after the same N_FRAMES RGB-D frames (numpy in), with
    the port's per-frame poses, diagnostics and launch counts."""
    calib = default_calib(IMG[1], IMG[0])
    src = j_synth.SyntheticSource(calib, n_frames=N_FRAMES, img_size=IMG, with_rgb=True)
    frames = [tuple(np.asarray(a) for a in src.get_images()) for _ in range(N_FRAMES)]
    j, t = JEngine(settings(), calib, IMG), MainEngine(settings(), calib, IMG, device="cpu")
    build.reset_launch_counts()
    rows = []
    for depth, rgb, gt in frames:
        d_j = j.process_frame(metric_depth=depth, rgb=rgb)
        d_t = t.process_frame(metric_depth=depth, rgb=rgb)
        rows.append((j.get_pose(), t.get_pose(), d_j, d_t, gt))
    return j, t, frames, rows, build.launch_counts()


def test_frames_match_jax(engines):
    _j, t, _frames, rows, launches = engines
    for i, (p_j, p_t, d_j, d_t, gt) in enumerate(rows):
        t_err, r_err = pose_error(p_t, p_j)
        assert t_err <= 1e-4 and r_err <= 0.01, f"frame {i}: {t_err:.2e} m, {r_err:.2e} deg"
        # the JAX package's keys, then the port's own diagnostic
        assert isinstance(d_t, LazyDiag) and tuple(d_t.keys()) == tuple(d_j.keys()) + ("n_alloc_unplaced",)
        for k in COUNTERS + ("n_visible", "n_free_blocks"):
            assert d_t[k] == d_j[k], (i, k)
        assert all(d_t[k] == 0 for k in COUNTERS)
        assert d_t.get("no_such_key", "x") == "x" and set(d_t.as_dict()) == set(d_j.as_dict()) | {"n_alloc_unplaced"}
        if i > 0:
            assert abs(d_t["num_valid"] - d_j["num_valid"]) <= max(3, d_j["num_valid"] // 500)
    assert pose_error(rows[-1][1], rows[-1][4])[0] < 0.01
    assert t.frame_no == N_FRAMES
    # a CPU engine runs the plain versions only
    assert launches == dict.fromkeys(build.KERNELS, 0)


IMAGES = {  # name → get_image arguments
    "raycast": dict(which="raycast"),
    "normals": dict(which="normals"),
    "colour": dict(which="colour"),
    "depth": dict(which="depth"),
    "depth_of_view": dict(which="depth", view="last"),
    "weight": dict(which="weight"),
    "freeview_raycast": dict(which="raycast", pose="back"),
    "freeview_depth": dict(which="depth", pose="back"),
}


@pytest.mark.parametrize("name", list(IMAGES))
def test_get_image_matches_jax(engines, name):
    j, t, frames, _rows, _l = engines
    kw = dict(IMAGES[name])
    if kw.get("view") == "last":
        kw["view"] = frames[-1][0]
    if kw.get("pose") == "back":
        kw["pose"] = back_pose()
    im_j, im_t = np.asarray(j.get_image(**kw)), t.get_image(**kw)
    assert isinstance(im_t, np.ndarray) and im_t.dtype == im_j.dtype == np.uint8 and im_t.shape == im_j.shape
    assert im_t.shape[:2] == IMG
    lsb = np.abs(im_t.astype(np.int32) - im_j.astype(np.int32))
    if lsb.ndim == 3:
        lsb = lsb.max(axis=-1)
    assert (lsb <= 1).mean() >= 0.99, f"{name}: {(lsb <= 1).mean():.4f} of pixels within 1 LSB"
    filled = (im_j > 0).reshape(*IMG, -1).any(-1).mean()
    assert filled > (0.1 if "freeview" in name else 0.3), filled


def test_turn_off_integration_leaves_the_map(engines, tmp_path):
    _j, _t, frames, _rows, _l = engines
    calib = default_calib(IMG[1], IMG[0])
    eng = MainEngine(settings(), calib, IMG, device="cpu")
    eng.process_frame(metric_depth=frames[0][0], rgb=frames[0][1])
    vox, vox_rgb = eng.vol.vox.clone(), eng.vol.vox_rgb.clone()
    eng.turn_off_integration()
    eng.process_frame(metric_depth=frames[1][0], rgb=frames[1][1])
    assert torch.equal(eng.vol.vox, vox) and torch.equal(eng.vol.vox_rgb, vox_rgb)
    eng.turn_on_integration()
    eng.process_frame(metric_depth=frames[2][0], rgb=frames[2][1])
    assert not torch.equal(eng.vol.vox, vox)
    # main processing off: the frame is skipped
    eng.turn_off_main_processing()
    assert eng.process_frame(metric_depth=frames[2][0]) == {} and eng.frame_no == 3
    eng.turn_on_main_processing()
    # set_pose / get_pose, then reset_scene empties the map
    eng.set_pose(frames[1][2])
    np.testing.assert_array_equal(eng.get_pose(), frames[1][2])
    eng.reset_scene()
    assert int((eng.vol.entry_ptr >= 0).sum()) == 0 and int(eng.tracking_state.age) == -1
    np.testing.assert_array_equal(eng.get_pose(), np.eye(4, dtype=np.float32))
    # the empty map's mesh: no triangle, an STL of its header alone
    assert eng.update_mesh().n_triangles == 0
    eng.save_scene_to_mesh(str(tmp_path / "scene.stl"))
    assert (tmp_path / "scene.stl").read_bytes() == bytes(84)


def test_pgm_fixture_replay_matches_jax_engine():
    """ImageFileReader → MainEngine on raw depth (affine mm conversion),
    the port against the recorded trajectory and the JAX engine."""
    calib_path, mask = os.path.join(FIX, "calib.txt"), os.path.join(FIX, "depth_%04i.pgm")
    src, jsrc = ImageFileReader(calib_path, "", mask), JReader(calib_path, "", mask)
    gt = np.load(os.path.join(FIX, "gt_poses.npy"))
    img = (src.calib.intrinsics_d.height, src.calib.intrinsics_d.width)
    eng = MainEngine(tiny_test_settings(), src.calib, img, device="cpu")
    j_eng = JEngine(tiny_test_settings(), jsrc.calib, img)
    n = 0
    while src.has_more_images():
        raw, _rgb = src.get_images()
        assert raw.dtype == np.uint16
        diag = eng.process_frame(raw_depth=raw)
        j_eng.process_frame(raw_depth=jsrc.get_images()[0])
        t_err, r_err = pose_error(eng.get_pose(), j_eng.get_pose())
        assert t_err <= 1e-4 and r_err <= 0.01, f"frame {n}: {t_err:.2e} m, {r_err:.2e} deg"
        n += 1
    assert n == gt.shape[0] == 10
    t_err, r_err = pose_error(eng.get_pose(), gt[-1])
    assert t_err < 0.01 and r_err < 1.0, (t_err, r_err)
    assert diag["num_valid"] > 500
    shot = eng.get_image("raycast")
    assert shot.shape == img and shot.max() > 0


@pytest.mark.parametrize("name", ["depth", "normal", "weight"])
def test_colormaps_match_jax(name):
    """The display colormaps on seeded inputs with invalid pixels, ≤ 1 LSB
    on ≥ 99% of the pixels (float32 ops that may round an ulp apart before
    the cast to uint8)."""
    rng = np.random.default_rng(7)
    if name == "depth":
        x = np.where(rng.random(IMG) < 0.1, -1.0, rng.uniform(0.4, 3.0, IMG)).astype(np.float32)
        got, want = t_cm.depth_to_uchar4(torch.from_numpy(x)), j_cm.depth_to_uchar4(jnp.asarray(x))
    elif name == "normal":
        n = rng.standard_normal((*IMG, 3)).astype(np.float32)
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        valid = rng.random(IMG) > 0.1
        got = t_cm.normal_to_uchar4(torch.from_numpy(n), torch.from_numpy(valid))
        want = j_cm.normal_to_uchar4(jnp.asarray(n), jnp.asarray(valid))
    else:
        x = np.where(rng.random(IMG) < 0.1, 0.0, rng.integers(1, 101, IMG)).astype(np.float32)
        got, want = t_cm.weight_to_uchar4(torch.from_numpy(x)), j_cm.weight_to_uchar4(jnp.asarray(x))
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == (*IMG, 4)
    lsb = np.abs(got.astype(np.int32) - want.astype(np.int32)).max(axis=-1)
    assert (lsb <= 1).mean() >= 0.99 and lsb.max() <= 1
    assert (got > 0).any(-1).mean() > 0.8


def test_weight_readers_match_jax(engines):
    """The fusion-weight readers through the hash table and through the
    block grid give the same weights, equal to the JAX package's hash
    reader at the raycast surface's voxels on ≥ 99% of them (the two maps
    fused the same frames at poses 1e-5 m apart)."""

    j, t, _frames, _rows, _l = engines
    s = t.settings
    res = t_hp.raycast_hash(t.vol, t.render_state, t.tracking_state.pose, t.proj, IMG, s)
    pts = torch.floor(res.points[..., :3] + 0.5).to(torch.int32)[res.points[..., 3] > 0]
    w_hash, f_hash = t_hv.make_hash_weight_reader(t.vol, s.hashing)(pts)
    grid = t_hv.get_block_grid(t.vol, s.block_grid)
    w_grid, f_grid = t_hv.make_grid_weight_reader(t.vol, grid, s.block_grid, s.hashing)(pts)
    assert torch.equal(w_hash, w_grid) and torch.equal(f_hash, f_grid)
    assert f_hash.float().mean() > 0.99 and float(w_hash.max()) >= N_FRAMES - 1
    w_j, f_j = j_hv.make_hash_weight_reader(j.vol, s.hashing)(jnp.asarray(pts.numpy()))
    assert (np.asarray(w_j) == w_hash.numpy()).mean() >= 0.99
    assert (np.asarray(f_j) == f_hash.numpy()).mean() >= 0.99
