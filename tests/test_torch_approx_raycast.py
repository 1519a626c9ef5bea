"""The approximate raycast of the port (trackers.track_far_from_point_cloud,
the approximate branch of the frame step and K3's device-side enable flag)
held to the JAX package on the CPU, at the settings of
tests/test_extras.py.

The JAX package picks the branch with `lax.cond`; the port raycasts on
every frame with the march switched by a device bool and chooses the maps,
their pose and age with torch.where. The 8-frame replay must give poses
within 1e-4 m and 0.01° a frame (the bar of tests/test_torch_slice.py) and
the same map age on every frame.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinitam_tpu.calib import default_calib
from infinitam_tpu.config import SceneParams, Settings, TrackingParams, VoxelBlockHashParams
from infinitam_tpu.engine import hash_pipeline as j_hp
from infinitam_tpu.engine import trackers as j_tr
from infinitam_tpu.engine.view_builder import View as JView
from infinitam_tpu.io import synth as j_synth
from infinitam_tpu.utils import se3 as j_se3
from infinitam_tpu_torch.engine import hash_pipeline as t_hp
from infinitam_tpu_torch.engine import trackers as t_tr
from infinitam_tpu_torch.engine.view_builder import View
from infinitam_tpu_torch.ops.kernels import build
from infinitam_tpu_torch.ops.kernels import raycast as k_ray
from infinitam_tpu_torch.utils import se3 as t_se3

IMG = (60, 80)
CALIB = default_calib(IMG[1], IMG[0])
PROJ = CALIB.intrinsics_d.vector
# tests/test_extras.py:29-35
SETTINGS = Settings(
    scene=SceneParams(voxel_size=0.025, mu=0.1, view_frustum_min=0.3, view_frustum_max=3.0),
    hashing=VoxelBlockHashParams(n_buckets=0x4000, n_excess=0x400, n_blocks=0x1800, max_visible_blocks=0x1000),
    tracking=TrackingParams(n_levels=3, min_valid_points=50),
)

# the tensors here are tiny: one intra-op thread per process keeps torch from
# contending for the cores with the other test workers (tier-1 runs under xdist)
torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def pose_error(P, G):
    """(camera-centre distance in metres, rotation angle in degrees), float64."""
    P, G = np.asarray(P, np.float64), np.asarray(G, np.float64)
    t = np.linalg.norm(np.linalg.inv(P)[:3, 3] - np.linalg.inv(G)[:3, 3])
    dR = P[:3, :3] @ G[:3, :3].T
    v = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]])
    return t, np.degrees(np.arctan2(0.5 * np.linalg.norm(v), 0.5 * (np.trace(dR) - 1.0)))


@pytest.mark.parametrize("case", ["still", "young", "old", "moved", "just_under", "rotated"])
def test_track_far_from_point_cloud_matches_jax(case):
    base = np.asarray(j_se3.se3_exp(jnp.asarray([0.1, -0.05, 0.2, 0.01, 0.02, -0.03], jnp.float32)))
    twist, age = {
        "still": ([0.0] * 6, 0), "young": ([0.001, 0.0, 0.0, 0.0, 0.0, 0.0], 5),
        "old": ([0.0] * 6, 6), "moved": ([0.02, 0.015, 0.0, 0.0, 0.0, 0.0], 1),
        "just_under": ([0.0223, 0.0, 0.0, 0.0, 0.0, 0.0], 2), "rotated": ([0.0, 0.0, 0.0, 0.3, 0.0, 0.0], 2),
    }[case]
    pose = np.asarray(j_se3.se3_exp(jnp.asarray(twist, jnp.float32))) @ base
    j = bool(j_tr.track_far_from_point_cloud(jnp.asarray(pose), jnp.asarray(base), jnp.int32(age)))
    t = t_tr.track_far_from_point_cloud(T(pose), T(base), torch.tensor(age, dtype=torch.int32))
    assert t.dtype == torch.bool and t.shape == () and bool(t) == j


def test_approximate_replay_matches_jax():
    """tests/test_extras.py::test_approximate_raycast_pipeline_tracks: 8
    frames; the first one takes the full branch (age −1), and both packages
    keep their stale maps on the same frames."""
    settings = SETTINGS.replace(use_approximate_raycast=True)
    src = j_synth.SyntheticSource(CALIB, n_frames=8, img_size=IMG)
    v_j, r_j, s_j = j_hp.create_engine_state(settings, IMG)
    v_t, r_t, s_t = t_hp.create_engine_state(settings, IMG, device="cpu")
    build.reset_launch_counts()
    ages = []
    for i in range(8):
        d, _r, gt = src.get_images()
        v_j, r_j, s_j, _d = j_hp.process_frame_hash(v_j, r_j, s_j, JView(depth=d), jnp.asarray(PROJ), settings)
        v_t, r_t, s_t, _d = t_hp.process_frame_hash(v_t, r_t, s_t, View(depth=T(d)), T(PROJ), settings)
        t_err, r_err = pose_error(s_t.pose.numpy(), s_j.pose)
        assert t_err <= 1e-4 and r_err <= 0.01, f"frame {i}: {t_err:.2e} m, {r_err:.2e} deg"
        assert int(s_t.age) == int(s_j.age), f"frame {i}"
        t_err, r_err = pose_error(s_t.pose_point_cloud.numpy(), s_j.pose_point_cloud)
        assert t_err <= 1e-4 and r_err <= 0.01, f"frame {i}"
        np.testing.assert_allclose(s_t.points_map.numpy(), np.asarray(s_j.points_map), rtol=0, atol=1e-3)
        ages.append(int(s_t.age))
    assert ages[0] == 0 and max(ages) > 0 and 0 in ages[1:], ages
    assert pose_error(s_t.pose.numpy(), gt)[0] < 0.04
    assert build.launch_counts() == dict.fromkeys(build.KERNELS, 0)


@pytest.fixture(scope="module")
def fused():
    """Port state after two frames at the default settings of the test."""
    src = j_synth.SyntheticSource(CALIB, n_frames=2, img_size=IMG)
    vol, rs, st = t_hp.create_engine_state(SETTINGS, IMG, device="cpu")
    for _ in range(2):
        vol, rs, st, _d = t_hp.process_frame_hash(vol, rs, st, View(depth=T(src.get_images()[0])), T(PROJ), SETTINGS)
    return vol, rs, st


@pytest.mark.parametrize("flag", [None, True, False])
def test_raycast_enable_flag_of_the_plain_twin(fused, flag):
    """With the flag true (or absent) the raycast is the full one; false, the
    points are those of `out`, as the kernel leaves its output."""
    vol, rs, st = fused
    sp = SETTINGS.scene
    zmin, zmax, _n = t_hp.expected_depth_ranges(vol, rs, st.pose, T(PROJ), IMG, SETTINGS)
    args = (vol, t_hp.hv.get_block_grid(vol, SETTINGS.block_grid), SETTINGS.block_grid, SETTINGS.hashing,
            t_se3.invert(st.pose), T(PROJ), IMG, 1.0 / sp.voxel_size, sp.mu, zmin, zmax)
    full = k_ray.raycast_grid(*args).points
    assert int((full[..., 3] > 0).sum()) > 0.5 * IMG[0] * IMG[1]
    sentinel = torch.full((*IMG, 4), -7.0)
    enable = None if flag is None else torch.tensor(flag)
    got = k_ray.raycast_grid(*args, enable=enable, out=sentinel).points
    assert torch.equal(got, sentinel if flag is False else full)
