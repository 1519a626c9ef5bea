"""Kernel K1's module (ops/icp.py, ops/kernels/icp.py) and the tracker
(engine/trackers.py) held to the JAX package on the CPU.

The plain version of K1 (`compute_residuals` + `reduce_gh`) is compared
with the JAX XLA oracle at tight tolerance, and with the Pallas kernel in
interpret mode at the bars the JAX package's own tests hold that kernel to
(tests/test_pallas_icp.py: b < 5e-4, A < 5e-3, and its reduction bars).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinitam_tpu.config import TrackingParams
from infinitam_tpu.engine import trackers as j_tr
from infinitam_tpu.ops import icp as j_icp
from infinitam_tpu.ops.pallas import icp_kernel as j_ik
from infinitam_tpu.utils import se3 as j_se3
from infinitam_tpu_torch.engine import trackers as t_tr
from infinitam_tpu_torch.ops import icp as t_icp
from infinitam_tpu_torch.ops import pyramid as t_pyr
from infinitam_tpu_torch.ops.kernels import build
from infinitam_tpu_torch.ops.kernels import icp as k_icp

# the tensors here are tiny: one intra-op thread per process keeps torch from
# contending for the cores with the other test workers (tier-1 runs under xdist)
torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def make_scene(H=64, W=64, seed=0):
    """Smooth synthetic maps + noisy depth with holes (the JAX package's
    tests/test_pallas_icp.py scene)."""
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
    return depth.astype(np.float32), proj, pts.astype(np.float32), n


STEP = np.array([0.004, -0.006, 0.003, 0.004, -0.002, 0.006], np.float32)


def untile(flat, h, w):
    """Pallas icp_kernel tile order → [h, w] row-major."""
    th, tw = (h + 15) // 16, (w + 15) // 16
    a = np.asarray(flat).reshape(th, tw, 16, 16).transpose(0, 2, 1, 3)
    return a.reshape(th * 16, tw * 16)[:h, :w]


@pytest.mark.parametrize("level", [0, 1])
def test_compute_residuals_matches_xla_oracle(level):
    depth, proj, pts, nrm = make_scene()
    d_lvl = depth[::2, ::2] if level else depth
    vproj = proj * 0.5**level
    inv_pose = np.asarray(j_se3.se3_exp(jnp.asarray(STEP)))
    scene_pose = np.eye(4, dtype=np.float32)
    b_j, A_j, v_j, p_j = j_icp.compute_residuals(
        jnp.asarray(d_lvl), jnp.asarray(vproj), jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(proj),
        jnp.asarray(inv_pose), jnp.asarray(scene_pose), 0.04,
    )
    b_t, A_t, v_t, p_t = t_icp.compute_residuals(
        T(d_lvl), T(vproj), T(pts), T(nrm), T(proj), T(inv_pose), T(scene_pose), 0.04
    )
    v_j = np.asarray(v_j)
    # the transforms round as XLA's einsum does; the remaining products may
    # differ by an ulp, which can flip a pixel sitting exactly on a gate
    assert (v_t.numpy() == v_j).mean() > 0.999
    both = v_t.numpy() & v_j
    assert both.sum() > 0.5 * d_lvl.size
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-6)
    np.testing.assert_allclose(b_t.numpy()[both], np.asarray(b_j)[both], atol=1e-6)
    np.testing.assert_allclose(A_t.numpy()[both], np.asarray(A_j)[both], atol=1e-5)


def test_reduce_gh_matches_xla_oracle():
    depth, proj, pts, nrm = make_scene(seed=3)
    inv_pose = np.asarray(j_se3.se3_exp(jnp.asarray(STEP / 2)))
    args_j = [jnp.asarray(a) for a in (depth, proj, pts, nrm, proj, inv_pose, np.eye(4, dtype=np.float32))]
    gh_j = j_icp.reduce_gh(*j_icp.compute_residuals(*args_j, 0.04)[:3], 100)
    gh_t = k_icp.icp_gh_plain(*[T(np.asarray(a)) for a in args_j], 0.04, 100)
    assert int(gh_t.num_valid) == int(gh_j.num_valid)
    # sums over ~3.7 k pixels in another order: relative 1e-5
    np.testing.assert_allclose(gh_t.hessian.numpy(), np.asarray(gh_j.hessian), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gh_t.nabla.numpy(), np.asarray(gh_j.nabla), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(float(gh_t.f), float(gh_j.f), rtol=1e-5)


@pytest.mark.parametrize("level", [0, 1])
def test_plain_k1_within_pallas_kernel_bars(level):
    """The JAX package's Pallas ICP kernel (interpret mode) vs the port's
    plain K1, at tests/test_pallas_icp.py's bars (the kernel taps bf16-split
    maps, hence the loose bars)."""
    depth, proj, pts, nrm = make_scene()
    H, W = depth.shape
    h, w = H >> level, W >> level
    d_lvl = depth[::2, ::2] if level else depth
    vproj = proj * 0.5**level
    inv_pose = np.asarray(j_se3.se3_exp(jnp.asarray(STEP)))
    planes = j_ik.prep_maps(jnp.asarray(pts), jnp.asarray(nrm))
    b_k, A_k, valid_k = j_ik.residuals_tiles(
        jnp.asarray(d_lvl), jnp.asarray(vproj), planes, jnp.asarray(proj), jnp.asarray(inv_pose),
        jnp.eye(4), 0.04, (H, W), level, interpret=True,
    )
    b_k = untile(b_k, h, w)
    valid_k = untile(np.asarray(valid_k).astype(np.float32), h, w) > 0.5
    A_k = np.stack([untile(A_k[:, j], h, w) for j in range(6)], axis=-1)
    b_t, A_t, v_t, _p = t_icp.compute_residuals(
        T(d_lvl), T(vproj), T(pts), T(nrm), T(proj), T(inv_pose), torch.eye(4), 0.04
    )
    v_t = v_t.numpy()
    assert (v_t == valid_k).mean() > 0.995
    both = v_t & valid_k
    assert both.sum() > 100
    assert np.abs(b_t.numpy()[both] - b_k[both]).max() < 5e-4
    assert np.abs(A_t.numpy()[both] - A_k[both]).max() < 5e-3


def test_plain_k1_reduction_within_pallas_kernel_bars():
    """GH sums of the plain K1 vs the Pallas kernel's residuals reduced by
    the JAX package, on tests/test_pallas_icp.py::test_reduction_matches_oracle's
    scene, pose and bars."""
    depth, proj, pts, nrm = make_scene(seed=3)
    H, W = depth.shape
    inv_pose = np.asarray(j_se3.se3_exp(jnp.array([0.002, 0.001, -0.003, 0.002, 0.004, -0.001], jnp.float32)))
    planes = j_ik.prep_maps(jnp.asarray(pts), jnp.asarray(nrm))
    b_k, A_k, valid_k = j_ik.residuals_tiles(
        jnp.asarray(depth), jnp.asarray(proj), planes, jnp.asarray(proj), jnp.asarray(inv_pose), jnp.eye(4), 0.04,
        (H, W), 0, interpret=True,
    )
    gh_k = j_icp.reduce_gh(b_k, A_k, valid_k, 100)
    gh_t = k_icp.icp_gh_plain(T(depth), T(proj), T(pts), T(nrm), T(proj), T(inv_pose), torch.eye(4), 0.04, 100)
    assert abs(int(gh_t.num_valid) - int(gh_k.num_valid)) <= max(3, 0.005 * int(gh_k.num_valid))
    np.testing.assert_allclose(float(gh_t.f), float(gh_k.f), rtol=2e-2)
    np.testing.assert_allclose(gh_t.nabla.numpy(), np.asarray(gh_k.nabla), rtol=5e-2, atol=5e-3)
    np.testing.assert_allclose(gh_t.hessian.numpy(), np.asarray(gh_k.hessian), rtol=5e-2, atol=5e-2)


def test_k1_wrapper_takes_plain_version_on_cpu():
    depth, proj, pts, nrm = make_scene(seed=5)
    args = (T(depth), T(proj), T(pts), T(nrm), T(proj), T(np.asarray(j_se3.se3_exp(jnp.asarray(STEP)))),
            torch.eye(4), 0.04, 100)
    build.reset_launch_counts()
    a, b = k_icp.icp_gh(*args), k_icp.icp_gh_plain(*args)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert build.launch_counts()["icp"] == 0
    with pytest.raises(ValueError):  # the kernel path refuses CPU tensors
        k_icp.icp_gh_cuda(*args)


@pytest.mark.parametrize("level", range(3))
def test_k1_wrapper_plain_path_equals_residuals_and_reduction(level):
    """On CPU tensors the K1 wrapper is compute_residuals + reduce_gh, bit
    for bit, at each pyramid level's view depth against the full-resolution
    maps, as trackers.track_depth calls it."""
    depth, proj, pts, nrm = make_scene(seed=13)
    d = t_pyr.build_depth_pyramid(T(depth), 3)[level]
    vproj = t_tr.scale_proj(T(proj), level)
    inv_pose = T(np.asarray(j_se3.se3_exp(jnp.asarray(STEP))))
    b, A, valid, _p = t_icp.compute_residuals(d, vproj, T(pts), T(nrm), T(proj), inv_pose, torch.eye(4), 0.04)
    want = t_icp.reduce_gh(b, A, valid, 20)
    got = k_icp.icp_gh(d, vproj, T(pts), T(nrm), T(proj), inv_pose, torch.eye(4), 0.04, 20)
    assert int(want.num_valid) > 20
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_k1_result_buffer_layout():
    """gh_from_buffer reads what csrc/icp.cu writes — H row-major in words
    0-35, ∇ in 36-41, f in 42 of the float buffer, N in an int32 word of its
    own — as views of those two buffers, so the wrapper issues no device op
    of its own; buffer_from_gh writes that layout back."""
    rng = np.random.default_rng(2)
    J = rng.standard_normal((6, 6)).astype(np.float32)
    H, g = T(J @ J.T), T(rng.standard_normal(6).astype(np.float32))
    out = torch.empty(k_icp.N_OUT)
    out[:36], out[36:42], out[42] = H.reshape(-1), g, 12.5
    count = torch.tensor(123456, dtype=torch.int32)
    r = k_icp.gh_from_buffer(out, count)
    assert torch.equal(r.hessian, H) and torch.equal(r.nabla, g) and float(r.f) == 12.5
    assert r.f.shape == () and r.num_valid.shape == () and r.num_valid.dtype == torch.int32
    assert int(r.num_valid) == 123456
    assert all(t.untyped_storage().data_ptr() == out.untyped_storage().data_ptr() for t in r[:3])
    assert r.num_valid is count
    back, n = k_icp.buffer_from_gh(r)
    assert torch.equal(back, out) and torch.equal(n, count)


def spd(seed):
    rng = np.random.default_rng(seed)
    J = rng.standard_normal((40, 6)).astype(np.float32)
    return (J.T @ J / 40).astype(np.float32), rng.standard_normal(6).astype(np.float32)


@pytest.mark.parametrize("mode", [t_icp.MODE_BOTH, t_icp.MODE_ROTATION, t_icp.MODE_TRANSLATION])
def test_solve_and_apply_delta_match_jax(mode):
    H, g = spd(7)
    lam = np.float32(0.1)
    s_j = np.asarray(j_icp.solve_delta(jnp.asarray(g), jnp.asarray(H), jnp.asarray(lam), mode))
    s_t = t_icp.solve_delta(T(g), T(H), T(lam), mode).numpy()
    # LAPACK Cholesky vs the JAX package's unrolled one: a few ulps
    np.testing.assert_allclose(s_t, s_j, rtol=1e-5, atol=1e-6)
    P = np.asarray(j_se3.se3_exp(jnp.asarray(STEP)))
    step = (s_j * 0.01).astype(np.float32)
    np.testing.assert_allclose(
        t_icp.apply_delta(T(P), T(step)).numpy(), np.asarray(j_icp.apply_delta(jnp.asarray(P), jnp.asarray(step))),
        atol=1e-7,
    )
    for thr in (1e-3, 1e-9):
        assert bool(t_icp.has_converged(T(step), thr)) == bool(j_icp.has_converged(jnp.asarray(step), thr))


def test_solve_delta_singular_gives_zero_step():
    zero = torch.zeros((6, 6))
    assert (t_icp.solve_delta(torch.ones(6), zero, torch.tensor(0.1), t_icp.MODE_BOTH) == 0).all()


def test_level_schedule_matches_jax():
    for params in (TrackingParams(), TrackingParams(n_levels=3, iterations_per_level=(2,))):
        assert t_tr.level_modes(params) == j_tr.level_modes(params)
        assert t_tr.level_dist_thresh(params) == j_tr.level_dist_thresh(params)
        assert t_tr.level_iterations(params) == j_tr.level_iterations(params)
    proj = np.array([525.0, 525.0, 319.5, 239.5], np.float32)
    np.testing.assert_array_equal(t_tr.scale_proj(T(proj), 3).numpy(), np.asarray(j_tr.scale_proj(jnp.asarray(proj), 3)))


def test_track_depth_matches_jax():
    """The fixed-iteration frozen-mask loop gives the early-exit loop's pose
    (this scene leaves the rotation about z weakly constrained, so the pose
    wanders far; what matters is that both trackers wander alike)."""
    depth, proj, pts, nrm = make_scene(seed=11)
    params = TrackingParams(n_levels=3, min_valid_points=50)
    pose0 = np.asarray(j_se3.invert(j_se3.se3_exp(jnp.asarray(STEP))))
    scene_pose = np.eye(4, dtype=np.float32)
    tr_j = j_tr.track_depth(
        jnp.asarray(pose0), jnp.asarray(depth), jnp.asarray(proj), jnp.asarray(pts), jnp.asarray(nrm),
        jnp.asarray(scene_pose), params,
    )
    tr_t = t_tr.track_depth(T(pose0), T(depth), T(proj), T(pts), T(nrm), T(scene_pose), params)
    # sums in another order move the solve by float32 noise
    np.testing.assert_allclose(tr_t.pose.numpy(), np.asarray(tr_j.pose), atol=1e-5)
    assert int(tr_t.num_valid) == int(tr_j.num_valid)
    np.testing.assert_allclose(float(tr_t.f), float(tr_j.f), rtol=1e-4)
