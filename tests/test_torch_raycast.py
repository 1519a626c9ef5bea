"""Kernel K3's module (ops/raycast.py, ops/voxel_access.py,
ops/kernels/raycast.py) and the range / map steps of hash_pipeline held to
the JAX package's XLA oracle on the CPU, on identical volumes.

The plain K3 repeats the oracle's march step for step: every ray takes the
same steps and reads the same voxels. Its rays come from `pixel_rays`,
which rounds as the JAX package's `pixel_rays` run op by op, bit for bit;
inside a jit XLA fuses the normalisation with the rays' end points and may
round an ulp apart, which moves a hit by far less than 1e-3 voxel; a ray
grazing a surface at the march's step can still flip, hence the ≥ 99.9%
hit/miss agreement.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinitam_tpu.calib import default_calib
from infinitam_tpu.config import TrackingParams, tiny_test_settings
from infinitam_tpu.engine import hash_pipeline as j_hp
from infinitam_tpu.engine import hash_volume as j_hv
from infinitam_tpu.engine.view_builder import View as JView
from infinitam_tpu.io import synth as j_synth
from infinitam_tpu.ops import raycast as j_rc
from infinitam_tpu.ops import voxel_access as j_va
from infinitam_tpu.utils import se3 as j_se3
from infinitam_tpu_torch import convert
from infinitam_tpu_torch.engine import hash_pipeline as t_hp
from infinitam_tpu_torch.engine import hash_volume as t_hv
from infinitam_tpu_torch.ops import raycast as t_rc
from infinitam_tpu_torch.ops import voxel_access as t_va
from infinitam_tpu_torch.ops.kernels import build
from infinitam_tpu_torch.ops.kernels import raycast as k_ray
from infinitam_tpu_torch.utils import se3 as t_se3

IMG = (60, 80)

# the tensors here are tiny: one intra-op thread per process keeps torch from
# contending for the cores with the other test workers (tier-1 runs under xdist)
torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def scene():
    """JAX state after 3 fused frames; the next camera pose moved off the
    last one so the ranges and the march are not trivially aligned."""
    settings = tiny_test_settings().replace(tracking=TrackingParams(n_levels=3, min_valid_points=50))
    calib = default_calib(IMG[1], IMG[0])
    proj = jnp.asarray(calib.intrinsics_d.vector)
    src = j_synth.SyntheticSource(calib, n_frames=3, img_size=IMG)
    vol, rs, st = j_hp.create_engine_state(settings, IMG)
    for _ in range(3):
        depth, _r, _g = src.get_images()
        vol, rs, st, _d = j_hp.process_frame_hash(vol, rs, st, JView(depth=depth), proj, settings)
    pose = np.asarray(j_se3.se3_exp(jnp.array([0.01, -0.005, 0.02, 0.01, 0.02, -0.01], jnp.float32)) @ st.pose)
    vt = convert.from_numpy(t_hv.HashVolume, convert.to_numpy(vol), device="cpu")
    rt = convert.from_numpy(t_hv.RenderStateVH, convert.to_numpy(rs), device="cpu")
    return settings, np.asarray(proj), pose, vol, rs, vt, rt


def test_expected_depth_ranges_match_jax(scene):
    settings, proj, pose, vol, rs, vt, rt = scene
    zmin_j, zmax_j, n_j = j_hp.expected_depth_ranges(vol, rs, jnp.asarray(pose), jnp.asarray(proj), IMG, settings)
    zmin_t, zmax_t, n_t = t_hp.expected_depth_ranges(vt, rt, T(pose), T(proj), IMG, settings)
    # corner projections round as XLA's einsum; the raster is exact min/max
    np.testing.assert_array_equal(zmin_t.numpy(), np.asarray(zmin_j))
    np.testing.assert_array_equal(zmax_t.numpy(), np.asarray(zmax_j))
    assert int(n_t) == int(n_j)
    assert (np.asarray(zmax_j) > np.asarray(zmin_j)).mean() > 0.5
    assert int(t_hp.count_too_big_blocks(vt, rt, T(pose), T(proj), settings, IMG)) == int(
        j_hp.count_too_big_blocks(vol, rs, jnp.asarray(pose), jnp.asarray(proj), settings)
    )


@pytest.mark.parametrize("beside", [False, True], ids=["in_image", "beside_image"])
def test_too_big_counter_skips_blocks_beside_the_image(beside):
    """One block close to the camera whose projected bbox exceeds the range
    raster's tile: straddling the camera plane it covers the image, and both
    packages count it; wholly beside the image (where the swap path's
    visibility test, which pads the image by 1/8, can keep a block), the
    raster clips it to the border and widens nothing, so the port does not
    count it, while the JAX package does (ROADMAP Queue 3)."""
    settings = tiny_test_settings()
    hp_ = settings.hashing
    proj = default_calib(IMG[1], IMG[0]).intrinsics_d.vector
    vol = t_hv.create_hash(hp_, grid_params=settings.block_grid, device="cpu")
    vol.entry_pos[0] = torch.tensor([5, 0, 1] if beside else [0, 0, 0], dtype=torch.int32)
    vol.entry_ptr[0] = 0
    rs = t_hv.create_render_state(hp_, grid_params=settings.block_grid, device="cpu")
    rs.visible_ids[0] = 0
    pose = np.eye(4, dtype=np.float32)
    U, _V, _Z = t_hp._project_block_corners(vol.entry_pos[:1].float(), T(pose), T(proj),
                                            hp_.block_size * settings.scene.voxel_size)
    assert bool((U.amin() > IMG[1]) if beside else (U.amax() - U.amin() > IMG[1]))
    jvol = j_hv.HashVolume(**{k: None if v is None else jnp.asarray(v) for k, v in convert.to_numpy(vol).items()})
    jrs = j_hv.RenderStateVH(**{k: None if v is None else jnp.asarray(v) for k, v in convert.to_numpy(rs).items()})
    n_j = int(j_hp.count_too_big_blocks(jvol, jrs, jnp.asarray(pose), jnp.asarray(proj), settings))
    n_t = int(t_hp.count_too_big_blocks(vol, rs, T(pose), T(proj), settings, IMG))
    assert (n_j, n_t) == ((1, 0) if beside else (1, 1))


def test_pixel_rays_match_jax(scene):
    settings, proj, pose, vol, rs, _vt, _rt = scene
    zmin, zmax, _n = j_hp.expected_depth_ranges(vol, rs, jnp.asarray(pose), jnp.asarray(proj), IMG, settings)
    inv = np.asarray(j_se3.invert(jnp.asarray(pose)))
    out_j = j_rc.pixel_rays(jnp.asarray(inv), jnp.asarray(proj), IMG, 50.0, zmin, zmax)
    out_t = t_rc.pixel_rays(T(inv), T(proj), IMG, 50.0, T(zmin), T(zmax))
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("seed", range(3))
def test_pixel_rays_norm_matches_jax(seed):
    """pixel_rays' norms (`norm3`, the FMA chain kernel K3 also computes)
    round as the JAX package's `jnp.linalg.norm`: on random camera poses and
    depth ranges, some of them empty (zmin = zmax: a zero ray, which both
    normalise through the 1e-12 floor), the start points, unit directions
    and both lengths equal the JAX package's bit for bit."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(-0.5, 0.5, 6).astype(np.float32)
    inv = np.asarray(j_se3.se3_exp(jnp.asarray(w)))
    proj = np.array([70.0, 72.0, 39.5, 29.5], np.float32)
    zmin = rng.uniform(0.2, 4.0, IMG).astype(np.float32)
    zmax = np.where(rng.random(IMG) < 0.1, zmin, zmin + rng.uniform(0.0, 2.0, IMG)).astype(np.float32)
    for inv_voxel in (50.0, 200.0):
        out_j = j_rc.pixel_rays(jnp.asarray(inv), jnp.asarray(proj), IMG, inv_voxel, jnp.asarray(zmin),
                                jnp.asarray(zmax))
        out_t = t_rc.pixel_rays(T(inv), T(proj), IMG, inv_voxel, T(zmin), T(zmax))
        for a, b in zip(out_t, out_j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        norm = np.linalg.norm(out_t[1].numpy(), axis=-1)
        np.testing.assert_allclose(norm[zmax > zmin], 1.0, atol=1e-6)
        assert (norm[zmax == zmin] == 0).all()


def test_norm3_matches_jnp_norm():
    """`norm3` on 200,000 random float32 vectors of lengths 1e-3..1e3 equals
    `jnp.linalg.norm` bit for bit (a plain float32 sum of squares, or torch's
    float32 sqrt on the CPU, differ from it on about 1% of them)."""
    rng = np.random.default_rng(0)
    v = (rng.standard_normal((200_000, 3)) * 10.0 ** rng.uniform(-3, 3, (200_000, 1))).astype(np.float32)
    want = np.asarray(jnp.linalg.norm(jnp.asarray(v), axis=-1))
    got = t_rc.norm3(*T(v).unbind(-1))
    np.testing.assert_array_equal(got.numpy(), want)


def test_interpolated_reads_match_jax(scene):
    settings, _proj, _pose, vol, _rs, vt, _rt = scene
    gp, hp = settings.block_grid, settings.hashing
    read_j = j_hv.make_grid_reader(vol, j_hv.get_block_grid(vol, gp, hp), gp, hp)
    read_t = t_hv.make_grid_reader(vt, t_hv.get_block_grid(vt, gp), gp, hp)
    rng = np.random.default_rng(0)
    live = np.asarray(vol.entry_pos)[np.asarray(vol.entry_ptr) >= 0]
    pts = (live[rng.integers(0, len(live), 3000)] * 8 + rng.uniform(-2, 10, (3000, 3))).astype(np.float32)
    s_j, f_j = j_va.read_sdf_interpolated(read_j, jnp.asarray(pts))
    s_t, f_t = t_va.read_sdf_interpolated(read_t, T(pts))
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-6)
    u_j, g_j = j_va.read_sdf_uninterpolated(read_j, jnp.asarray(pts))
    u_t, g_t = t_va.read_sdf_uninterpolated(read_t, T(pts))
    np.testing.assert_array_equal(u_t.numpy(), np.asarray(u_j))
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))


def test_plain_k3_matches_xla_oracle(scene):
    settings, proj, pose, vol, rs, vt, rt = scene
    ref = np.asarray(j_hp.raycast_hash(vol, rs, jnp.asarray(pose), jnp.asarray(proj), IMG, settings).points)
    out = t_hp.raycast_hash(vt, rt, T(pose), T(proj), IMG, settings).points.numpy()
    f_j, f_t = ref[..., 3] > 0, out[..., 3] > 0
    assert f_j.sum() > 0.6 * f_j.size
    assert (f_j == f_t).mean() >= 0.999
    both = f_j & f_t
    assert np.abs(out[..., :3][both] - ref[..., :3][both]).max() < 1e-3
    # misses report the march's last point; compare where both missed too
    miss = ~f_j & ~f_t
    assert np.median(np.abs(out[..., :3][miss] - ref[..., :3][miss])) < 1e-3


def test_icp_maps_and_normals_match_jax(scene):
    settings, proj, pose, vol, rs, _vt, _rt = scene
    res = j_hp.raycast_hash(vol, rs, jnp.asarray(pose), jnp.asarray(proj), IMG, settings)
    inv = np.asarray(j_se3.invert(jnp.asarray(pose)))
    pm_j, nm_j = j_rc.make_icp_maps(res, settings.scene.voxel_size, jnp.asarray(inv))
    pm_t, nm_t = t_rc.make_icp_maps(t_rc.RaycastResult(points=T(res.points)), settings.scene.voxel_size, T(inv))
    np.testing.assert_array_equal(pm_t[..., 3].numpy(), np.asarray(pm_j[..., 3]))
    np.testing.assert_allclose(pm_t.numpy(), np.asarray(pm_j), atol=1e-6)
    np.testing.assert_allclose(nm_t.numpy(), np.asarray(nm_j), atol=1e-5)
    assert (np.asarray(pm_j[..., 3]) > 0).sum() > 0.5 * pm_j[..., 3].size
    light = -inv[:3, 2] / np.linalg.norm(inv[:3, 2])
    for smooth in (False, True):
        n_j, a_j, v_j = j_rc.compute_normals_image_space(res.points, 0.02, jnp.asarray(light), smooth)
        n_t, a_t, v_t = t_rc.compute_normals_image_space(T(res.points), 0.02, T(light), smooth)
        np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
        np.testing.assert_allclose(n_t.numpy(), np.asarray(n_j), atol=1e-5)
        np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=1e-5)


def test_prepare_tracking_maps_matches_jax(scene):
    settings, proj, pose, vol, rs, vt, rt = scene
    pm_j, nm_j, n_j = j_hp.prepare_tracking_maps(vol, rs, jnp.asarray(pose), jnp.asarray(proj), IMG, settings)
    pm_t, nm_t, n_t = t_hp.prepare_tracking_maps(vt, rt, T(pose), T(proj), IMG, settings)
    v_j, v_t = np.asarray(pm_j[..., 3]) > 0, pm_t[..., 3].numpy() > 0
    assert (v_j == v_t).mean() >= 0.998  # a flipped hit also flips its neighbours' normals
    both = v_j & v_t
    assert np.abs(pm_t.numpy()[both] - np.asarray(pm_j)[both]).max() < 1e-4
    assert int(n_t) == int(n_j) == 0


def test_k3_wrapper_takes_plain_version_on_cpu(scene):
    settings, proj, pose, vol, rs, vt, rt = scene
    zmin, zmax, _n = t_hp.expected_depth_ranges(vt, rt, T(pose), T(proj), IMG, settings)
    args = (vt, t_hv.get_block_grid(vt, settings.block_grid), settings.block_grid, settings.hashing,
            t_se3.invert(T(pose)), T(proj), IMG, 50.0, settings.scene.mu, zmin, zmax)
    build.reset_launch_counts()
    a = k_ray.raycast_grid(*args).points
    b = k_ray.raycast_grid_plain(*args).points
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert build.launch_counts()["raycast"] == 0
    with pytest.raises(ValueError):  # the kernel path refuses CPU tensors
        k_ray.raycast_grid_cuda(*args)
