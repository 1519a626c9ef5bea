"""The view builder's bilateral filter and sensor-noise model (the weighted
ICP tracker's inputs) held to the JAX package on the CPU, 60×80.

The input is a synthetic depth frame with seeded holes and noise. Validity
masks must be equal. Tolerances, measured before they were set:

- the filter sums its 25 taps over a stacked axis, not in the JAX package's
  loop order, and torch's and XLA's `exp` round apart by an ulp: one pass
  differs by ≤ 1e-6 m, five by ≤ 2e-6 m (bar 5e-6 m);
- on the same depth the normals are equal bit for bit (the cross product
  rounds as `jnp.cross` does, the norm as `jnp.linalg.norm`); σ_z goes
  through `arccos`, whose torch and XLA versions round apart by an ulp or
  two, and θ/(π/2 − θ) magnifies that as the normal turns away from the
  camera: ≤ 4e-6 relative where |n_z| ≥ 0.05 (bar 1e-5), ≤ 1.9e-5 at the
  ~1% of pixels seen at a grazing angle, |n_z| < 0.05 (bar 1e-4);
- the normals are differences of neighbouring depths, so after the filter
  an ulp of depth moves them by up to 1e-4: a view built with both options
  is held to the JAX package through its parts (the filtered depth within
  the bar, the noise model of the JAX package's filtered depth, and the
  port's view equal to its own noise model of its own depth).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinitam_tpu.calib import default_calib, read_rgbd_calib
from infinitam_tpu.config import Settings
from infinitam_tpu.engine import view_builder as j_vb
from infinitam_tpu.io import synth as j_synth
from infinitam_tpu.ops import view_ops as j_vo
from infinitam_tpu_torch.engine import view_builder as t_vb
from infinitam_tpu_torch.ops import view_ops as t_vo

IMG = (60, 80)
SEED = 5
DEPTH_TOL = 5e-6  # metres, after five filter passes
SIGMA_RTOL = 1e-5
SIGMA_RTOL_GRAZING = 1e-4  # pixels whose normal has |n_z| < GRAZING
GRAZING = 0.05
KINECT_CALIB = (
    "640 480\n504.261 503.905\n352.457 272.202\n\n640 480\n573.71 574.394\n346.471 249.031\n\n"
    "0.999926 -0.0101 -0.0067 0.0256\n0.0102 0.9999 0.0093 0.0004\n0.0066 -0.0094 0.9999 0.0005\n\n"
    "1135.09 0.0819141\n"
)

# the tensors here are tiny: one intra-op thread per process keeps torch from
# contending for the cores with the other test workers (tier-1 runs under xdist)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def noisy_depth():
    """Metric depth [60, 80] of the synthetic scene, 2 mm noise, 5% holes (−1)."""
    calib = default_calib(IMG[1], IMG[0])
    d = np.asarray(j_synth.SyntheticSource(calib, n_frames=1, img_size=IMG).get_images()[0])
    rng = np.random.default_rng(SEED)
    d = d + (rng.standard_normal(d.shape) * 0.002).astype(np.float32) * (d > 0)
    d[(rng.random(d.shape) < 0.05) | (d <= 0)] = -1.0
    return d.astype(np.float32)


def assert_depth_close(t, j, tol):
    t, j = np.asarray(t), np.asarray(j)
    np.testing.assert_array_equal(t < 0, j < 0)
    np.testing.assert_allclose(t, j, rtol=0, atol=tol)


def assert_noise_model_close(normals_t, sigma_t, normals_j, sigma_j):
    normals_t, sigma_t, normals_j, sigma_j = map(np.asarray, (normals_t, sigma_t, normals_j, sigma_j))
    np.testing.assert_array_equal(normals_t, normals_j)
    np.testing.assert_array_equal(sigma_t < 0, sigma_j < 0)
    grazing = np.abs(normals_j[..., 2]) < GRAZING
    np.testing.assert_allclose(sigma_t[~grazing], sigma_j[~grazing], rtol=SIGMA_RTOL, atol=0)
    np.testing.assert_allclose(sigma_t[grazing], sigma_j[grazing], rtol=SIGMA_RTOL_GRAZING, atol=0)
    assert (sigma_j > 0).sum() > 2000 and (grazing & (sigma_j > 0)).mean() < 0.02


@pytest.mark.parametrize("passes", [1, 5])
def test_bilateral_filter_matches_jax(noisy_depth, passes):
    j, t = jnp.asarray(noisy_depth), torch.from_numpy(noisy_depth.copy())
    for _ in range(passes):
        j, t = j_vo.bilateral_filter_depth(j), t_vo.bilateral_filter_depth(t)
    assert_depth_close(t.numpy(), j, 1e-6 if passes == 1 else DEPTH_TOL)
    # the 2 px border passes through; the filter moved the interior
    np.testing.assert_array_equal(t.numpy()[:2], noisy_depth[:2])
    assert np.abs(t.numpy() - noisy_depth)[2:-2, 2:-2].max() > 1e-4


def test_normals_and_weights_match_jax(noisy_depth):
    intr = default_calib(IMG[1], IMG[0]).intrinsics_d
    n_j, s_j = j_vo.compute_normals_and_weights(jnp.asarray(noisy_depth), intr)
    n_t, s_t = t_vo.compute_normals_and_weights(torch.from_numpy(noisy_depth.copy()), intr)
    assert n_t.shape == (*IMG, 4) and s_t.shape == IMG
    assert_noise_model_close(n_t.numpy(), s_t.numpy(), n_j, s_j)


def raw_frames(noisy_depth):
    """(name, calib, raw frame) for the affine (mm) and Kinect disparity models."""
    kinect = read_rgbd_calib(KINECT_CALIB)
    d = kinect.disparity
    mm = np.where(noisy_depth > 0, np.round(noisy_depth * 1000.0), 0).astype(np.uint16)
    # holes: the sensor's 2047 (a − d < 0, so invalid)
    disp = np.where(noisy_depth > 0, np.round(d.a - 8.0 * d.b * kinect.intrinsics_d.fx / noisy_depth), 2047)
    return {"affine": (default_calib(IMG[1], IMG[0]), mm), "kinect": (kinect, disp.astype(np.uint16))}


@pytest.mark.parametrize("source", ["affine", "kinect", "metric"])
@pytest.mark.parametrize("options", [(True, False), (False, True), (True, True)], ids=["filter", "noise", "both"])
def test_build_view_options_match_jax(noisy_depth, source, options):
    settings = Settings(use_bilateral_filter=options[0], model_sensor_noise=options[1])
    if source == "metric":
        calib = default_calib(IMG[1], IMG[0])
        v_j = j_vb.build_view_from_metric_depth(jnp.asarray(noisy_depth), settings, calib)
        v_t = t_vb.build_view_from_metric_depth(torch.from_numpy(noisy_depth.copy()), settings, calib)
    else:
        calib, raw = raw_frames(noisy_depth)[source]
        assert calib.disparity.type == source
        v_j = j_vb.build_view(jnp.asarray(raw), calib, settings)
        v_t = t_vb.build_view(torch.from_numpy(raw.astype(np.int32)), calib, settings)
    assert_depth_close(v_t.depth.numpy(), v_j.depth, DEPTH_TOL if settings.use_bilateral_filter else 0.0)
    if not settings.model_sensor_noise:
        assert v_t.depth_normals is None and v_t.depth_uncertainty is None
        return
    n_t, s_t = v_t.depth_normals.numpy(), v_t.depth_uncertainty.numpy()
    if settings.use_bilateral_filter:
        np.testing.assert_array_equal(n_t[..., 3], np.asarray(v_j.depth_normals)[..., 3])
        np.testing.assert_array_equal(s_t < 0, np.asarray(v_j.depth_uncertainty) < 0)
        own = t_vo.compute_normals_and_weights(v_t.depth, calib.intrinsics_d)
        np.testing.assert_array_equal(n_t, own[0].numpy())
        np.testing.assert_array_equal(s_t, own[1].numpy())
        # the port's noise model of the JAX package's filtered depth
        n_t, s_t = (x.numpy() for x in t_vo.compute_normals_and_weights(torch.from_numpy(np.array(v_j.depth)),
                                                                        calib.intrinsics_d))
    assert_noise_model_close(n_t, s_t, v_j.depth_normals, v_j.depth_uncertainty)
