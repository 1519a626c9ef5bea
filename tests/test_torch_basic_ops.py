"""The port's small modules held to the JAX package on the CPU: utils/se3,
ops/pixel, ops/pyramid, ops/view_ops, engine/view_builder,
engine/tracking_state and io/synth.

Inputs are made with numpy from a fixed seed and handed to both sides.
Tolerances: elementwise float32 ops that evaluate the same expression in the
same order are compared exactly; transcendental functions and small matrix
products (whose kernels differ between XLA and PyTorch) at a few float32
ulps, 1e-6 absolute on values of order 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinitam_tpu.calib import default_calib, read_rgbd_calib
from infinitam_tpu.config import Settings
from infinitam_tpu.engine import tracking_state as j_ts
from infinitam_tpu.engine import view_builder as j_vb
from infinitam_tpu.io import synth as j_synth
from infinitam_tpu.ops import pixel as j_pixel
from infinitam_tpu.ops import pyramid as j_pyr
from infinitam_tpu.ops import view_ops as j_vo
from infinitam_tpu.utils import se3 as j_se3
from infinitam_tpu_torch.engine import tracking_state as t_ts
from infinitam_tpu_torch.engine import view_builder as t_vb
from infinitam_tpu_torch.io import synth as t_synth
from infinitam_tpu_torch.ops import pixel as t_pixel
from infinitam_tpu_torch.ops import pyramid as t_pyr
from infinitam_tpu_torch.ops import view_ops as t_vo
from infinitam_tpu_torch.utils import se3 as t_se3

RNG_SEED = 1234

# the tensors here are tiny: one intra-op thread per process keeps torch from
# contending for the cores with the other test workers (tier-1 runs under xdist)
torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def twists(n=16, scale=0.3):
    rng = np.random.default_rng(RNG_SEED)
    return (rng.standard_normal((n, 6)) * scale).astype(np.float32)


def test_se3_exp_log_invert_match_jax():
    tw = twists()
    tw[0, 3:] = 1e-6  # small-angle series branch
    M_j = np.asarray(j_se3.se3_exp(jnp.asarray(tw)))
    M_t = t_se3.se3_exp(T(tw)).numpy()
    np.testing.assert_allclose(M_t, M_j, atol=1e-6)
    np.testing.assert_allclose(t_se3.invert(T(M_j)).numpy(), np.asarray(j_se3.invert(jnp.asarray(M_j))), atol=1e-6)
    np.testing.assert_allclose(t_se3.se3_log(T(M_j)).numpy(), np.asarray(j_se3.se3_log(jnp.asarray(M_j))), atol=2e-6)
    R = M_j[:, :3, :3]
    np.testing.assert_allclose(t_se3.so3_log(T(R)).numpy(), np.asarray(j_se3.so3_log(jnp.asarray(R))), atol=2e-6)
    np.testing.assert_allclose(
        t_se3.so3_exp(T(tw[:, 3:])).numpy(), np.asarray(j_se3.so3_exp(jnp.asarray(tw[:, 3:]))), atol=1e-6
    )


def test_se3_coerce_small_delta_apply_match_jax():
    tw = twists(scale=0.1)
    M = np.asarray(j_se3.se3_exp(jnp.asarray(tw)))
    rng = np.random.default_rng(RNG_SEED + 1)
    noisy = M + rng.normal(0, 1e-3, M.shape).astype(np.float32)
    # batched (the JAX 4×4 fast path is scalar-unrolled; same Newton steps)
    np.testing.assert_allclose(t_se3.coerce(T(noisy)).numpy(), np.asarray(j_se3.coerce(jnp.asarray(noisy))), atol=1e-6)
    np.testing.assert_allclose(
        t_se3.coerce(T(noisy[0])).numpy(), np.asarray(j_se3.coerce(jnp.asarray(noisy[0]))), atol=1e-6
    )
    np.testing.assert_allclose(
        t_se3.small_delta(T(tw)).numpy(), np.asarray(j_se3.small_delta(jnp.asarray(tw))), atol=0
    )
    p = rng.standard_normal((16, 3)).astype(np.float32)
    np.testing.assert_allclose(t_se3.apply(T(M), T(p)).numpy(), np.asarray(j_se3.apply(jnp.asarray(M), jnp.asarray(p))), atol=1e-6)
    np.testing.assert_allclose(t_se3.rotate(T(M), T(p)).numpy(), np.asarray(j_se3.rotate(jnp.asarray(M), jnp.asarray(p))), atol=1e-6)


def test_apply_planes_rounds_like_jax_einsum():
    """se3.apply_planes reproduces the JAX package's einsum transform bit
    for bit (XLA's CPU dot is an FMA chain) — the property that makes the
    integrate kernel exact against the JAX package."""
    rng = np.random.default_rng(RNG_SEED + 2)
    M = np.asarray(j_se3.se3_exp(jnp.asarray(twists(1)[0])))
    p = (rng.standard_normal((4096, 3)) * 2).astype(np.float32)
    ref = np.asarray(jnp.einsum("ij,...j->...i", jnp.asarray(M)[:3, :3], jnp.asarray(p)) + jnp.asarray(M)[:3, 3])
    out = np.stack([c.numpy() for c in t_se3.apply_planes(T(M), T(p[:, 0]), T(p[:, 1]), T(p[:, 2]))], -1)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("channels", [0, 3, 4])
def test_bilinear_matches_jax(channels):
    rng = np.random.default_rng(RNG_SEED + channels)
    shape = (12, 17) if channels == 0 else (12, 17, channels)
    img = rng.standard_normal(shape).astype(np.float32)
    x = rng.uniform(-1, 17, 200).astype(np.float32)
    y = rng.uniform(-1, 12, 200).astype(np.float32)
    out_j = np.asarray(j_pixel.bilinear(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y)))
    out_t = t_pixel.bilinear(T(img), T(x), T(y)).numpy()
    np.testing.assert_array_equal(out_t, out_j)  # same ops, same order


def test_bilinear_with_holes_vec_matches_jax():
    rng = np.random.default_rng(RNG_SEED)
    img = rng.standard_normal((12, 17, 4)).astype(np.float32)
    img[..., 3] = np.where(rng.uniform(size=(12, 17)) < 0.2, -1.0, 1.0)
    x = rng.uniform(0, 15, 300).astype(np.float32)
    y = rng.uniform(0, 10, 300).astype(np.float32)
    v_j, ok_j = j_pixel.bilinear_with_holes_vec(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y))
    v_t, ok_t = t_pixel.bilinear_with_holes_vec(T(img), T(x), T(y))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))


def test_depth_pyramid_matches_jax():
    rng = np.random.default_rng(RNG_SEED)
    depth = rng.uniform(0.5, 3.0, (61, 83)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.3] = -1.0
    depth[:8, :8] = -1.0  # all-invalid cells → 0
    pj = j_pyr.build_depth_pyramid(jnp.asarray(depth), 4)
    pt = t_pyr.build_depth_pyramid(T(depth), 4)
    assert [p.shape for p in pt] == [tuple(p.shape) for p in pj]
    for a, b in zip(pt, pj):
        # masked mean: the 2×2 sums may associate differently → 1 ulp
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-7, atol=0)
    np.testing.assert_allclose(
        t_pyr.subsample_with_holes(T(depth)).numpy(), np.asarray(j_pyr.subsample_with_holes(jnp.asarray(depth))),
        rtol=2e-7, atol=0,
    )


def test_depth_conversions_match_jax():
    rng = np.random.default_rng(RNG_SEED)
    raw = rng.integers(0, 33000, (20, 30)).astype(np.uint16)
    np.testing.assert_array_equal(
        t_vo.depth_affine_to_float(T(raw.astype(np.int32)), 1e-3, 0.0).numpy(),
        np.asarray(j_vo.depth_affine_to_float(jnp.asarray(raw), 1e-3, 0.0)),
    )
    disp = rng.integers(0, 1100, (20, 30)).astype(np.int32)
    disp[0, 0] = 1090  # a − d == 0 → invalid
    np.testing.assert_array_equal(
        t_vo.disparity_to_depth(T(disp), 1090.0, 0.0755, 570.0).numpy(),
        np.asarray(j_vo.disparity_to_depth(jnp.asarray(disp), 1090.0, 0.0755, 570.0)),
    )


@pytest.mark.parametrize("disparity", ["affine", "kinect"])
def test_build_view_matches_jax(disparity):
    if disparity == "affine":
        calib = default_calib(40, 30)
        raw = np.random.default_rng(RNG_SEED).integers(0, 4000, (30, 40)).astype(np.uint16)
    else:
        calib = read_rgbd_calib(
            "640 480\n504.261 503.905\n352.457 272.202\n\n640 480\n573.71 574.394\n346.471 249.031\n\n"
            "0.999926 -0.0101 -0.0067 0.0256\n0.0102 0.9999 0.0093 0.0004\n0.0066 -0.0094 0.9999 0.0005\n\n"
            "1135.09 0.0819141\n"
        )
        raw = np.random.default_rng(RNG_SEED).integers(0, 1100, (30, 40)).astype(np.uint16)
    assert calib.disparity.type == disparity
    settings = Settings()
    v_j = j_vb.build_view(jnp.asarray(raw), calib, settings)
    v_t = t_vb.build_view(T(raw.astype(np.int32)), calib, settings)
    np.testing.assert_array_equal(v_t.depth.numpy(), np.asarray(v_j.depth))
    depth = np.asarray(v_j.depth)
    m_j = j_vb.build_view_from_metric_depth(jnp.asarray(depth), settings, calib)
    m_t = t_vb.build_view_from_metric_depth(T(depth), settings, calib)
    np.testing.assert_array_equal(m_t.depth.numpy(), np.asarray(m_j.depth))


def test_build_view_refuses_unported_filters():
    """No view-builder option is refused any more: the filter and the
    sensor-noise model run (tests/test_torch_view.py holds them to the JAX
    package). On a 4×4 frame every pixel lies in the filter's 2 px border,
    which passes through, and only the inner 2×2 pixels have the four
    neighbours a normal needs: a flat wall facing the camera there."""
    view = t_vb.build_view_from_metric_depth(
        torch.ones(4, 4), Settings(use_bilateral_filter=True, model_sensor_noise=True), default_calib(4, 4))
    np.testing.assert_array_equal(view.depth.numpy(), np.ones((4, 4), np.float32))
    assert view.depth_normals.shape == (4, 4, 4) and view.depth_uncertainty.shape == (4, 4)
    inner = np.zeros((4, 4), bool)
    inner[1:3, 1:3] = True
    np.testing.assert_array_equal(view.depth_uncertainty.numpy() > 0, inner)
    np.testing.assert_array_equal(view.depth_normals.numpy()[inner], np.tile([0.0, 0.0, 1.0, 1.0], (4, 1)))


def test_tracking_state_matches_jax():
    s_j = j_ts.create_tracking_state((6, 8))
    s_t = t_ts.create_tracking_state((6, 8), device="cpu")
    assert s_t._fields == s_j._fields
    for name in s_j._fields:
        a, b = getattr(s_t, name).numpy(), np.asarray(getattr(s_j, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b)


def test_synthetic_renderer_matches_jax():
    calib = default_calib(40, 30)
    src_j = j_synth.SyntheticSource(calib, n_frames=3, img_size=(30, 40))
    src_t = t_synth.SyntheticSource(calib, n_frames=3, img_size=(30, 40), device="cpu")
    # trajectories: the same float32 twists through each package's se3_exp
    np.testing.assert_allclose(src_t.gt_poses, src_j.gt_poses, atol=1e-6)
    for _ in range(3):
        d_j, _r, _g = src_j.get_images()
        d_t, _r2, _g2 = src_t.get_images()
        d_j, d_t = np.asarray(d_j), d_t.numpy()
        hit_j, hit_t = d_j > 0, d_t > 0
        # 96 sphere-tracing steps amplify ulp-level differences of the SDF
        # arithmetic only at grazing silhouettes
        assert (hit_j == hit_t).mean() > 0.995
        both = hit_j & hit_t
        assert both.sum() > 500
        assert np.median(np.abs(d_j[both] - d_t[both])) < 1e-6
        assert np.abs(d_j[both] - d_t[both]).max() < 1e-3


def test_scalar_bilinear_with_holes_and_in_bounds_match_jax():
    rng = np.random.default_rng(RNG_SEED + 5)
    img = rng.uniform(0.5, 3.0, (12, 17)).astype(np.float32)
    img[rng.uniform(size=img.shape) < 0.2] = -1.0
    x = rng.uniform(-1, 17, 300).astype(np.float32)
    y = rng.uniform(-1, 12, 300).astype(np.float32)
    x[:40] = np.floor(x[:40])  # on a column: the right corners carry no weight
    y[20:60] = np.floor(y[20:60])
    v_j, ok_j = j_pixel.bilinear_with_holes_scalar(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y))
    v_t, ok_t = t_pixel.bilinear_with_holes_scalar(T(img), T(x), T(y))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    assert 0 < int(ok_t.sum()) < 300
    for margin in (0, 2):
        np.testing.assert_array_equal(t_pixel.in_bounds(T(x), T(y), 17, 12, margin).numpy(),
                                      np.asarray(j_pixel.in_bounds(jnp.asarray(x), jnp.asarray(y), 17, 12, margin)))


def test_vec_subsample_with_holes_matches_jax():
    rng = np.random.default_rng(RNG_SEED + 6)
    img = rng.standard_normal((13, 18, 4)).astype(np.float32)
    img[..., 3] = np.where(rng.uniform(size=(13, 18)) < 0.3, -1.0, 1.0)
    img[:2, :2, 3] = -1.0  # an all-invalid cell → w = −1
    out_j = np.asarray(j_pyr.subsample_with_holes_vec(jnp.asarray(img)))
    out_t = t_pyr.subsample_with_holes_vec(T(img)).numpy()
    assert out_t.shape == out_j.shape == (6, 9, 4) and out_t[0, 0, 3] == -1.0
    # masked mean: the 2×2 sums may associate differently → 1 ulp
    np.testing.assert_allclose(out_t, out_j, rtol=2e-7, atol=1e-7)


def test_compute_normal_from_sdf_matches_jax():
    """Central differences of the trilinear field over a dense array holding
    a tilted plane's sdf, at points near the surface."""
    from infinitam_tpu.config import PlainVoxelArrayParams
    from infinitam_tpu.engine import volume as j_vol
    from infinitam_tpu.ops import voxel_access as j_va
    from infinitam_tpu_torch.engine import volume as t_vol
    from infinitam_tpu_torch.ops import voxel_access as t_va

    p = PlainVoxelArrayParams(size=(24, 20, 16), offset=(-12, -10, 0))
    z, y, x = np.meshgrid(np.arange(16), np.arange(20) - 10, np.arange(24) - 12, indexing="ij")
    sdf = np.clip((0.3 * x + 0.2 * y + z - 8.0) / 4.0, -1, 1).astype(np.float32)
    vj = j_vol.create_dense(p)._replace(sdf=jnp.asarray(sdf))
    vt = t_vol.create_dense(p, device="cpu")._replace(sdf=T(sdf))
    rng = np.random.default_rng(RNG_SEED + 7)
    pts = rng.uniform((-8, -6, -1), (8, 6, 1), (200, 3))
    pts[:, 2] += 8.0 - 0.3 * pts[:, 0] - 0.2 * pts[:, 1]  # within a voxel of the plane
    pts = pts.astype(np.float32)
    n_j = np.asarray(j_va.compute_normal_from_sdf(j_vol.make_dense_reader(vj, p), jnp.asarray(pts)))
    n_t = t_va.compute_normal_from_sdf(t_vol.make_dense_reader(vt, p), T(pts)).numpy()
    np.testing.assert_allclose(n_t, n_j, rtol=0, atol=1e-6)
    n = n_t / np.linalg.norm(n_t, axis=-1, keepdims=True)
    assert np.abs(n @ np.array([0.3, 0.2, 1.0]) / np.linalg.norm([0.3, 0.2, 1.0]) - 1).max() < 1e-3
