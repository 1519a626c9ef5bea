"""Kernel K2's module (ops/tsdf.py, ops/kernels/integrate.py and
hash_pipeline.integrate_into_scene) held to the JAX package on the CPU.

On identical volumes, poses and depth, the plain K2 must reproduce the JAX
package's XLA gather → update → scatter bit for bit, and so also its Pallas
integrate kernel in interpret mode, which tests/test_pallas_integrate.py
holds to the same oracle bit for bit. The camera transform rounds as XLA's
einsum (utils/se3.apply_planes); every other step is the same float32
operation in the same order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinitam_tpu.calib import default_calib
from infinitam_tpu.config import BlockGridParams, SceneParams, Settings, TrackingParams, VoxelBlockHashParams
from infinitam_tpu.engine import hash_pipeline as j_hp
from infinitam_tpu.engine.view_builder import View as JView
from infinitam_tpu.io import synth as j_synth
from infinitam_tpu.ops import tsdf as j_tsdf
from infinitam_tpu_torch import convert
from infinitam_tpu_torch.engine import hash_pipeline as t_hp
from infinitam_tpu_torch.engine import hash_volume as t_hv
from infinitam_tpu_torch.engine.view_builder import View
from infinitam_tpu_torch.ops import tsdf as t_tsdf
from infinitam_tpu_torch.ops.kernels import build
from infinitam_tpu_torch.ops.kernels import integrate as k_int

IMG = (64, 64)

# the tensors here are tiny: one intra-op thread per process keeps torch from
# contending for the cores with the other test workers (tier-1 runs under xdist)
torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def make_settings(**scene) -> Settings:
    """tests/test_pallas_integrate.py's settings."""
    return Settings(
        scene=SceneParams(voxel_size=0.025, mu=0.1, view_frustum_min=0.3, view_frustum_max=3.0, **scene),
        hashing=VoxelBlockHashParams(n_buckets=0x4000, n_excess=0x400, n_blocks=0x1800, max_visible_blocks=0x1000),
        block_grid=BlockGridParams(dims=(32, 32, 32), origin=(-16, -16, 0)),
        tracking=TrackingParams(n_levels=3, min_valid_points=50),
        max_fused_blocks=1024,
        max_render_blocks=512,
    )


def fused_scene(settings):
    calib = default_calib(IMG[1], IMG[0])
    proj = jnp.asarray(calib.intrinsics_d.vector)
    depth, _rgb, _gt = j_synth.SyntheticSource(calib, n_frames=2, img_size=IMG).get_images()
    vol, rs, st = j_hp.create_engine_state(settings, IMG)
    for _ in range(2):
        vol, rs, st, _d = j_hp.process_frame_hash(vol, rs, st, JView(depth=depth), proj, settings)
    return depth, proj, vol, rs, st


@pytest.fixture(scope="module")
def scene():
    settings = make_settings()
    return (settings,) + fused_scene(settings)


def port_state(vol, rs):
    return (convert.from_numpy(t_hv.HashVolume, convert.to_numpy(vol), device="cpu"),
            convert.from_numpy(t_hv.RenderStateVH, convert.to_numpy(rs), device="cpu"))


def port_integrate(settings, depth, proj, vol, rs, pose, enable=True):
    vt, rt = port_state(vol, rs)
    out = t_hp.integrate_into_scene(vt, rt, View(depth=T(depth)), T(pose), T(proj), settings,
                                    enable=torch.tensor(enable))
    assert out.vox is vt.vox  # in place
    return out.vox.numpy()


def test_update_voxel_depth_matches_jax():
    rng = np.random.default_rng(0)
    depth = rng.uniform(0.5, 2.5, (30, 40)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.1] = -1.0
    pts = rng.uniform([-1, -1, 0.2], [1, 1, 3], (5000, 3)).astype(np.float32)
    old_sdf = rng.uniform(-1, 1, 5000).astype(np.float32)
    old_w = rng.integers(0, 10, 5000).astype(np.int32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.01, -0.02, 0.03]
    proj = np.array([50.0, 50.0, 19.5, 14.5], np.float32)
    u_j = j_tsdf.update_voxel_depth(jnp.asarray(old_sdf), jnp.asarray(old_w), jnp.asarray(pts), jnp.asarray(pose),
                                    jnp.asarray(proj), jnp.asarray(depth), 0.1, 100)
    u_t = t_tsdf.update_voxel_depth(T(old_sdf), T(old_w), tuple(T(pts[:, i]) for i in range(3)), T(pose), T(proj),
                                    T(depth), 0.1, 100)
    for a, b in zip(u_t, u_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert u_t.updated.sum() > 200


def test_plain_k2_matches_xla_oracle_exactly(scene):
    settings, depth, proj, vol, rs, st = scene
    ref = np.asarray(j_hp.integrate_into_scene(vol, rs, JView(depth=depth), st.pose, proj, settings).vox)
    out = port_integrate(settings, depth, proj, vol, rs, st.pose)
    assert (ref != np.asarray(vol.vox)).sum() > 1000  # not a vacuous pass
    assert (out != ref).sum() == 0


def test_plain_k2_matches_pallas_kernel_exactly(scene):
    settings, depth, proj, vol, rs, st = scene
    kern = j_hp.integrate_into_scene_pallas(vol, rs, JView(depth=depth), st.pose, proj, settings, interpret=True)
    out = port_integrate(settings, depth, proj, vol, rs, st.pose)
    assert (out != np.asarray(kern.vox)).sum() == 0


def test_plain_k2_enable_gate(scene):
    settings, depth, proj, vol, rs, st = scene
    out = port_integrate(settings, depth, proj, vol, rs, st.pose, enable=False)
    np.testing.assert_array_equal(out, np.asarray(vol.vox))


def test_plain_k2_stop_at_max_w_matches_xla_oracle():
    settings = make_settings(max_w=2, stop_integrating_at_max_w=True)
    depth, proj, vol, rs, st = fused_scene(settings)
    ref = np.asarray(j_hp.integrate_into_scene(vol, rs, JView(depth=depth), st.pose, proj, settings).vox)
    out = port_integrate(settings, depth, proj, vol, rs, st.pose)
    assert (out != ref).sum() == 0
    # frozen voxels (w ≥ max_w) kept their value
    w = (np.asarray(vol.vox) >> 8) & 0xFF
    np.testing.assert_array_equal(out[w >= 2], np.asarray(vol.vox)[w >= 2])


def test_k2_wrapper_takes_plain_version_on_cpu(scene):
    settings, depth, proj, vol, rs, st = scene
    sp = settings.scene
    vt, rt = port_state(vol, rs)
    args = (rt.visible_ids, vt.entry_ptr, vt.entry_pos, T(depth), T(st.pose), T(proj), torch.tensor(True),
            sp.voxel_size, sp.mu, sp.max_w, False, 8, settings.max_fused_blocks)
    a, b = vt.vox.clone(), vt.vox.clone()
    build.reset_launch_counts()
    k_int.integrate_depth(a, *args)
    k_int.integrate_depth_plain(b, *args)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert build.launch_counts()["integrate"] == 0
    with pytest.raises(ValueError):  # the kernel path refuses CPU tensors
        k_int.integrate_depth_cuda(a, *args)
    # the sentinel row takes the skipped rows and is left as it was
    sent = t_hv.sentinel_row(settings.hashing)
    np.testing.assert_array_equal(b[sent].numpy(), vt.vox[sent].numpy())


def test_k2_cuda_wrapper_refuses_cpu_tensors_and_other_block_sizes(scene):
    """The CUDA kernel is written for 8³ blocks, as the Pallas kernel is: its
    wrapper raises on any other block size (no fallback), and on CPU
    tensors, before it builds anything."""
    settings, depth, proj, vol, rs, st = scene
    sp = settings.scene
    vt, rt = port_state(vol, rs)
    args = (vt.vox, rt.visible_ids, vt.entry_ptr, vt.entry_pos, T(depth), T(st.pose), T(proj), torch.tensor(True),
            sp.voxel_size, sp.mu, sp.max_w, False)
    with pytest.raises(ValueError, match="8³ blocks only"):
        k_int.integrate_depth_cuda(*args, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        k_int.integrate_depth_cuda(*args, 8)
    assert build.launch_counts()["integrate"] == 0


def edited_list(vol, ids: np.ndarray) -> np.ndarray:
    """The live rows of `ids` with a −1 row after each, one id whose entry
    has no block (entry_ptr < 0) among them, and −1 rows to the end: the
    same length, the same live blocks."""
    ptr = np.asarray(vol.entry_ptr)
    live = ids[(ids >= 0) & (ptr[np.clip(ids, 0, None)] >= 0)]
    out = np.full_like(ids, -1)
    out[: 2 * len(live) : 2] = live
    out[len(live) | 1] = np.flatnonzero(ptr < 0)[0]
    assert 2 * len(live) + 2 < len(ids) and len(live) > 50
    return out


@pytest.mark.parametrize("case", ["interleaved", "capped"])
def test_plain_k2_visible_list_matches_xla_oracle(scene, case):
    """(interleaved) a list with −1 rows between and after the live ones and
    an id without a block, fused whole (max_fused_blocks 0); (capped)
    max_fused_blocks below the live count, so that the blocks past the cap
    stay unfused (JAX package: hash_pipeline.py:722-723). Both equal the
    JAX package's XLA integrate_into_scene on the same state."""
    settings, depth, proj, vol, rs, st = scene
    ids = np.asarray(rs.visible_ids)
    n_live = int((ids >= 0).sum())
    if case == "interleaved":
        settings = settings.replace(max_fused_blocks=0)
        rs = rs._replace(visible_ids=jnp.asarray(edited_list(vol, ids)))
    else:
        settings = settings.replace(max_fused_blocks=n_live // 2)
    ref = np.asarray(j_hp.integrate_into_scene(vol, rs, JView(depth=depth), st.pose, proj, settings).vox)
    out = port_integrate(settings, depth, proj, vol, rs, st.pose)
    assert (out != ref).sum() == 0
    full = port_integrate(make_settings(), depth, proj, vol, rs._replace(visible_ids=jnp.asarray(ids)), st.pose)
    changed = (ref != np.asarray(vol.vox)).sum()
    if case == "interleaved":  # the same blocks as the original list
        np.testing.assert_array_equal(out, full)
    else:  # the cap left blocks unfused
        assert 1000 < changed < (full != np.asarray(vol.vox)).sum()
