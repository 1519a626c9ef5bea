"""The port's dense voxel array (engine/volume.py, engine/dense_pipeline.py,
meshing_engine.mesh_scene_dense, the DenseVolume conversion and kernel
K3d's plain twin) held to the JAX package on the CPU, at the JAX package's
own small dense settings (tests/test_dense_pipeline.py: 128×128×100 voxels
of 2.5 cm) and 60×80 frames.

Tolerances:
- the volume, its readers and the voxel centres: exact;
- integration: every weight equal; every sdf within one LSB of the
  float32 sdf at its full scale 1.0 (2⁻²³). The camera transform rounds as
  the JAX package's einsum does, but inside the jit XLA fuses the running
  average's w·f + f_new into one FMA, which the port's float32 ops round
  twice: the rounding of w·f (≤ half an ulp of w·f ≤ w) shrinks by
  1/(w + 1) in the quotient, so the two differ by less than 2⁻²⁴ plus the
  quotient's own ulp;
- the raycast: the same march over the same voxels, the hit mask equal;
  inside a jit XLA fuses the rays' and the refinement's multiply-adds and
  rounds points apart (measured: ≤ 7.1e-4 voxel), so points agree within
  1e-3 voxel, the bar of tests/test_torch_raycast.py. The 4e-6-voxel bar
  holds kernel K3d to its plain twin, on the card
  (tests/test_torch_kernels_cuda.py, chip_smoke.py); on the CPU the wrapper
  is the plain twin, exactly;
- a 5-frame replay: poses within 1e-4 m and 0.01° a frame (the ICP sums run
  in another order, as in tests/test_torch_slice.py);
- the mesh: the JAX `triangulate_voxels` run uncapped over the same blocks
  in the same order gives the same triangles within 1e-6 m.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinitam_tpu.calib import default_calib
from infinitam_tpu.config import PlainVoxelArrayParams, SceneParams, Settings, TrackingParams
from infinitam_tpu.engine import dense_pipeline as j_dp
from infinitam_tpu.engine import volume as j_vol
from infinitam_tpu.engine.view_builder import View as JView
from infinitam_tpu.io import synth as j_synth
from infinitam_tpu.ops import meshing as j_mops
from infinitam_tpu_torch import convert
from infinitam_tpu_torch.engine import dense_pipeline as t_dp
from infinitam_tpu_torch.engine import meshing_engine as t_me
from infinitam_tpu_torch.engine import volume as t_vol
from infinitam_tpu_torch.engine.view_builder import View
from infinitam_tpu_torch.ops.kernels import build
from infinitam_tpu_torch.ops.kernels import raycast as k_ray
from infinitam_tpu_torch.utils import se3 as t_se3

IMG = (60, 80)
CALIB = default_calib(IMG[1], IMG[0])
PROJ = CALIB.intrinsics_d.vector
N_FRAMES = 5

# the tensors here are tiny: one intra-op thread per process keeps torch from
# contending for the cores with the other test workers (tier-1 runs under xdist)
torch.set_num_threads(1)


def small_settings() -> Settings:
    """tests/test_dense_pipeline.py small_settings()."""
    return Settings(
        scene=SceneParams(voxel_size=0.025, mu=0.1, view_frustum_min=0.3, view_frustum_max=3.0),
        plain=PlainVoxelArrayParams(size=(128, 128, 100), offset=(-64, -64, 0)),
        tracking=TrackingParams(n_levels=3, min_valid_points=50),
    )


SETTINGS = small_settings()


def T(a):
    return torch.from_numpy(np.array(a))


def to_port(vol):
    return convert.from_numpy(t_vol.DenseVolume, convert.to_numpy(vol), device="cpu")


@pytest.fixture(scope="module")
def replay():
    """The JAX package's 5-frame replay on the dense volume: per frame the
    depth, the ground truth, the volume and tracking state before the frame
    and the pose after it."""
    src = j_synth.SyntheticSource(CALIB, n_frames=N_FRAMES, img_size=IMG)
    vol, st = j_dp.create_engine_state(SETTINGS, IMG)
    frames = []
    for _ in range(N_FRAMES):
        depth, _rgb, gt = src.get_images()
        before = (vol, st)
        vol, st, diag = j_dp.process_frame_dense(vol, st, JView(depth=depth), jnp.asarray(PROJ), SETTINGS)
        frames.append(dict(depth=np.asarray(depth), gt=np.asarray(gt), before=before, pose=np.asarray(st.pose),
                           num_valid=int(diag.num_valid)))
    return frames, vol


def test_create_dense_readers_and_coords_match_jax(replay):
    p = SETTINGS.plain
    for color in (False, True):
        a, b = t_vol.create_dense(p, with_color=color, device="cpu"), j_vol.create_dense(p, with_color=color)
        for f in a._fields:
            assert (getattr(a, f) is None) == (getattr(b, f) is None)
            if getattr(a, f) is not None:
                assert str(getattr(a, f).dtype).split(".")[-1] == str(getattr(b, f).dtype)
                np.testing.assert_array_equal(getattr(a, f).numpy(), np.asarray(getattr(b, f)))
        assert a.size_xyz == b.size_xyz == p.size
    reset = t_vol.reset_dense(to_port(replay[1]))
    assert float(reset.sdf.min()) == 1.0 and int(reset.w_depth.max()) == 0
    # the coordinate planes broadcast to the JAX package's [Z, Y, X, 3] grid
    x, y, z = t_vol.voxel_world_coords(p, SETTINGS.scene.voxel_size, device="cpu")
    ref = np.asarray(j_vol.voxel_world_coords(p, SETTINGS.scene.voxel_size))
    for k, c in enumerate((x, y, z)):
        np.testing.assert_array_equal(torch.broadcast_to(c, ref.shape[:3]).numpy(), ref[..., k])
    # readers on a fused volume, inside, on the faces and outside the array
    vj = replay[1]
    vt = to_port(vj)
    rng = np.random.default_rng(3)
    lo, hi = np.array(p.offset) - 3, np.array(p.offset) + np.array(p.size) + 3
    pts = rng.integers(lo, hi, (20000, 3)).astype(np.int32)
    s_j, f_j = j_vol.dense_read_sdf(vj, p, jnp.asarray(pts))
    s_t, f_t = t_vol.dense_read_sdf(vt, p, T(pts))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    assert 0.5 < f_t.float().mean() < 1.0
    s_j, w_j, f_j = j_vol.dense_read_sdf_and_weight(vj, p, jnp.asarray(pts))
    s_t, w_t, f_t = t_vol.dense_read_sdf_and_weight(vt, p, T(pts))
    for a, b in ((s_t, s_j), (w_t, w_j), (f_t, f_j)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    s_r, f_r = t_vol.make_dense_reader(vt, p)(T(pts))
    assert torch.equal(s_r, s_t) and torch.equal(f_r, f_t)
    # colour reader: zeros without colour; the colour plane where it is
    zero = t_vol.make_dense_color_reader(vt, p)(T(pts))
    assert zero.shape == (20000, 3) and float(zero.abs().max()) == 0.0
    cj = j_vol.create_dense(p, with_color=True)
    clr = rng.random(cj.clr.shape, dtype=np.float32)
    cj = cj._replace(clr=jnp.asarray(clr))
    c_j = j_vol.make_dense_color_reader(cj, p)(jnp.asarray(pts))
    c_t = t_vol.make_dense_color_reader(to_port(cj), p)(T(pts))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))


def test_dense_volume_round_trips_through_numpy(replay):
    """convert: a JAX DenseVolume → numpy → the port's → numpy, exact, with
    and without colour; the port's copy does not alias the arrays."""
    for vj in (replay[1], j_vol.create_dense(SETTINGS.plain, with_color=True)):
        arrays = convert.to_numpy(vj)
        vt = convert.from_numpy(t_vol.DenseVolume, arrays, device="cpu")
        assert isinstance(vt, t_vol.DenseVolume) and vt.sdf.dtype == torch.float32
        back = convert.to_numpy(vt)
        assert back.keys() == arrays.keys()
        for k, v in arrays.items():
            assert (v is None) == (back[k] is None)
            if v is not None:
                np.testing.assert_array_equal(back[k], v)
        vt.sdf.fill_(0.5)
        assert float(arrays["sdf"].max()) == 1.0
    with pytest.raises(KeyError):
        convert.from_numpy(t_vol.DenseVolume, {"sdf": arrays["sdf"]}, device="cpu")


@pytest.mark.parametrize("frame, color", [(0, False), (3, False), (3, True)], ids=["0", "3", "3-colour"])
def test_integrate_frame_dense_matches_jax(replay, frame, color):
    """With `color`, the frame fuses an rgb image (numpy, from a seed) into
    colour planes that already hold colour of weight 0-5 (from the same
    seed): the colour planes as the JAX package's, within 1.8e-7 (a float32
    running average of values in [0, 1], rounded twice where the jit fuses
    it into one FMA), the colour weights equal."""
    frames, _vol = replay
    f = frames[frame]
    vol_j, st_j = f["before"]
    pose = f["pose"]
    settings = SETTINGS.replace(use_color=color)
    view_j, view_t, kw_j, kw_t = JView(depth=jnp.asarray(f["depth"])), View(depth=T(f["depth"])), {}, {}
    if color:
        rng = np.random.default_rng(17)
        blank = j_vol.create_dense(SETTINGS.plain, with_color=True)
        clr = rng.random(blank.clr.shape, dtype=np.float32)
        wc = rng.integers(0, 6, blank.w_color.shape).astype(np.asarray(blank.w_color).dtype)
        vol_j = vol_j._replace(clr=jnp.asarray(clr), w_color=jnp.asarray(wc))
        rgb = rng.random((*IMG, 3), dtype=np.float32)
        view_j, view_t = JView(depth=view_j.depth, rgb=jnp.asarray(rgb)), View(depth=view_t.depth, rgb=T(rgb))
        kw_j, kw_t = dict(proj_rgb=jnp.asarray(PROJ)), dict(proj_rgb=T(PROJ))
    out_j = jax.jit(j_dp.integrate_frame_dense, static_argnames=("settings",))(
        vol_j, view_j, jnp.asarray(pose), jnp.asarray(PROJ), settings, **kw_j)
    out_t = t_dp.integrate_frame_dense(to_port(vol_j), view_t, T(pose), T(PROJ), settings, **kw_t)
    if color:
        wc_j, wc_t = np.asarray(out_j.w_color), out_t.w_color.numpy()
        np.testing.assert_array_equal(wc_t, wc_j)
        changed = int((wc_j != np.asarray(vol_j.w_color)).sum())
        assert changed > 1000
        np.testing.assert_allclose(out_t.clr.numpy(), np.asarray(out_j.clr), rtol=0, atol=1.8e-7)
    w_j, w_t = np.asarray(out_j.w_depth), out_t.w_depth.numpy()
    np.testing.assert_array_equal(w_t, w_j)
    assert int((w_j > 0).sum()) > 10000
    sdf_j, sdf_t = np.asarray(out_j.sdf), out_t.sdf.numpy()
    np.testing.assert_allclose(sdf_t, sdf_j, rtol=0, atol=2.0**-23)
    # the fused-average rounding is the only difference: most voxels are equal
    assert int((sdf_t != sdf_j).sum()) < 0.01 * int((w_j > 0).sum())


def test_raycast_dense_matches_jax(replay):
    frames, vol_j = replay
    pose = frames[-1]["pose"]
    # a camera moved off the last pose, so the rays do not repeat the frames'
    twist = jnp.array([0.01, -0.005, 0.02, 0.01, 0.02, -0.01], jnp.float32)
    from infinitam_tpu.utils import se3 as j_se3

    pose = np.asarray(j_se3.se3_exp(twist) @ jnp.asarray(pose))
    ref = np.asarray(jax.jit(j_dp.raycast_dense, static_argnames=("img_size", "settings"))(
        vol_j, jnp.asarray(pose), jnp.asarray(PROJ), IMG, SETTINGS).points)
    vt = to_port(vol_j)
    build.reset_launch_counts()
    out = t_dp.raycast_dense(vt, T(pose), T(PROJ), IMG, SETTINGS).points.numpy()
    assert build.launch_counts()["raycast_dense"] == 0  # the CPU takes the plain twin
    f_j, f_t = ref[..., 3] > 0, out[..., 3] > 0
    assert f_j.mean() > 0.6
    np.testing.assert_array_equal(f_t, f_j)
    both = f_j & f_t
    assert np.abs(out[..., :3][both] - ref[..., :3][both]).max() < 1e-3
    # the wrapper on the CPU is the plain twin, exactly; the CUDA path refuses CPU tensors
    sp = SETTINGS.scene
    zmin = torch.full(IMG, sp.view_frustum_min)
    zmax = torch.full(IMG, sp.view_frustum_max)
    args = (vt, SETTINGS.plain, t_se3.invert(T(pose)), T(PROJ), IMG, 1.0 / sp.voxel_size, sp.mu, zmin, zmax)
    plain = k_ray.raycast_dense_plain(*args).points
    np.testing.assert_array_equal(out, plain.numpy())
    off = torch.zeros((), dtype=torch.bool)
    kept = torch.full((*IMG, 4), -7.0)
    assert torch.equal(k_ray.raycast_dense(*args, enable=off, out=kept.clone()).points, kept)
    with pytest.raises(ValueError):
        k_ray.raycast_dense_cuda(*args)


def test_five_frame_dense_replay_matches_jax(replay):
    frames, _vol = replay
    vol, st = t_dp.create_engine_state(SETTINGS, IMG, device="cpu")
    build.reset_launch_counts()
    for i, f in enumerate(frames):
        vol, st, diag = t_dp.process_frame_dense(vol, st, View(depth=T(f["depth"])), T(PROJ), SETTINGS)
        P, G = st.pose.numpy().astype(np.float64), f["pose"].astype(np.float64)
        t_err = np.linalg.norm(np.linalg.inv(P)[:3, 3] - np.linalg.inv(G)[:3, 3])
        dR = P[:3, :3] @ G[:3, :3].T
        v = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]])
        r_err = np.degrees(np.arctan2(0.5 * np.linalg.norm(v), 0.5 * (np.trace(dR) - 1.0)))
        assert t_err <= 1e-4 and r_err <= 0.01, f"frame {i}: {t_err:.2e} m, {r_err:.2e} deg"
        if i > 0:
            assert abs(int(diag.num_valid) - f["num_valid"]) <= max(3, f["num_valid"] // 500)
    assert set(diag._fields) == {"f", "num_valid"} and int(st.age) == 0
    gt = frames[-1]["gt"].astype(np.float64)
    assert np.linalg.norm(np.linalg.inv(P)[:3, 3] - np.linalg.inv(gt)[:3, 3]) < 0.01
    assert build.launch_counts() == dict.fromkeys(build.KERNELS, 0)


def test_mesh_scene_dense_matches_uncapped_jax_triangulation(replay):
    """Every occupied 8³ block, in the JAX package's order (x, then y, then
    z), meshed through the dense reader: the JAX `triangulate_voxels` over
    the same blocks, uncapped, in block / voxel / slot order."""
    _frames, vol_j = replay
    p = SETTINGS.plain
    vt = to_port(vol_j)
    blocks = t_me.dense_blocks(vt, p).numpy()
    # the JAX package's screen (its reshape needs extents divisible by 8: crop z to 96)
    w = np.asarray(vol_j.w_depth)[:96] > 0
    occ = w.reshape(12, 8, 16, 8, 16, 8).any(axis=(1, 3, 5))
    ref = np.stack(np.nonzero(occ.transpose(2, 1, 0)), -1) + np.array(p.offset) // 8
    # z blocks 12 (voxels 96-99, a partial block) are screened only by the port
    np.testing.assert_array_equal(blocks[blocks[:, 2] < 12], ref)
    assert len(blocks) > 100
    mesh = t_me.mesh_scene_dense(vt, SETTINGS)
    lin = np.arange(512)
    local = np.stack([lin % 8, (lin // 8) % 8, lin // 64], -1)
    gvox = (blocks[:, None, :] * 8 + local[None]).astype(np.int32)
    v_j, ok_j = (np.asarray(a) for a in j_mops.triangulate_voxels(j_vol.make_dense_reader(vol_j, p),
                                                                   jnp.asarray(gvox)))
    tris_j = v_j[ok_j] * SETTINGS.scene.voxel_size
    assert mesh.n_triangles == len(tris_j) > 1000
    np.testing.assert_allclose(mesh.triangles, tris_j, rtol=0, atol=1e-6)
    # with any offset the blocks are those of the global 8³ grid that hold a
    # fused voxel, each once (also where the offset is not a multiple of 8)
    zyx = np.argwhere(np.asarray(vol_j.w_depth) > 0)
    for off in (p.offset, (p.offset[0] + 4, p.offset[1] - 3, p.offset[2] + 1)):
        shifted = PlainVoxelArrayParams(size=p.size, offset=off)
        got = t_me.dense_blocks(vt, shifted).numpy()
        want = np.unique((zyx[:, ::-1] + np.array(off)) // 8, axis=0)
        assert len(got) == len(np.unique(got, axis=0))
        np.testing.assert_array_equal(np.unique(got, axis=0), want)
