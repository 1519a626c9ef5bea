"""Card-only tests: each hand-written CUDA kernel (K2 with and without its
colour half) against its plain PyTorch version on an NVIDIA GPU, at a small
size, and the launch counts of the depth and colour frame loops.

They carry the `cuda` marker and skip where no card is present. On a machine
with a card (JAX need not be installed there), run them with:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py

chip_smoke.py repeats these comparisons at the main path's full size.
"""

import numpy as np
import pytest
import torch

from infinitam_tpu_torch.calib import default_calib
from infinitam_tpu_torch.config import TrackingParams, tiny_test_settings
from infinitam_tpu_torch.engine import hash_pipeline as hp
from infinitam_tpu_torch.engine import trackers
from infinitam_tpu_torch.engine.view_builder import View
from infinitam_tpu_torch.io import synth
from infinitam_tpu_torch.ops.kernels import build, icp, integrate, raycast
from infinitam_tpu_torch.utils import se3

pytestmark = pytest.mark.cuda

IMG = (120, 160)


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def fused(device):
    """Port state after 3 synthetic frames fused on the card, and frame 4."""
    settings = tiny_test_settings().replace(tracking=TrackingParams(n_levels=3, min_valid_points=50))
    calib = default_calib(IMG[1], IMG[0])
    proj = torch.as_tensor(calib.intrinsics_d.vector, device=device)
    src = synth.SyntheticSource(calib, n_frames=4, img_size=IMG, device=device)
    vol, rs, st = hp.create_engine_state(settings, IMG, device=device)
    build.reset_launch_counts()
    for _ in range(3):
        vol, rs, st, _d = hp.process_frame_hash(vol, rs, st, View(depth=src.get_images()[0]), proj, settings)
    torch.cuda.synchronize()
    return settings, proj, vol, rs, st, src.get_images()[0], build.launch_counts()


def test_main_path_launched_every_kernel(fused):
    *_rest, counts = fused
    levels = TrackingParams(n_levels=3).iterations_per_level[:3]
    assert counts == {"icp": 3 * sum(levels), "integrate": 3, "integrate_color": 0, "raycast": 3}


def test_k1_matches_plain(fused):
    settings, proj, _vol, _rs, st, depth, _c = fused
    tp = settings.tracking
    args = (depth, proj, st.points_map, st.normals_map, proj, se3.invert(st.pose), st.pose_point_cloud,
            trackers.level_dist_thresh(tp)[0], tp.min_valid_points)
    k, p = icp.icp_gh(*args), icp.icp_gh_plain(*args)
    assert int(k.num_valid) == int(p.num_valid) > 5000
    # the same per-pixel terms summed in another order
    torch.testing.assert_close(k.hessian, p.hessian, rtol=1e-4, atol=1e-4 * float(p.hessian.abs().max()))
    torch.testing.assert_close(k.nabla, p.nabla, rtol=1e-4, atol=1e-4 * float(p.nabla.abs().max()))
    torch.testing.assert_close(k.f, p.f, rtol=1e-4, atol=0)


def test_k2_matches_plain_bit_for_bit(fused, device):
    settings, proj, vol, rs, st, depth, _c = fused
    sp = settings.scene
    _ids, ptr, bpos, valid = hp._visible_rows(vol, rs, settings, settings.max_fused_blocks)
    args = (torch.where(valid, ptr, -1).contiguous(), bpos.contiguous(), depth, st.pose, proj,
            torch.ones((), dtype=torch.bool, device=device), sp.voxel_size, sp.mu, sp.max_w, False)
    vk, vp = vol.vox.clone(), vol.vox.clone()
    integrate.integrate_depth(vk, *args)
    integrate.integrate_depth_plain(vp, *args)
    assert int((vp != vol.vox).sum()) > 10000
    assert int((vk != vp).sum()) == 0
    off = vol.vox.clone()
    integrate.integrate_depth(off, *args[:5], torch.zeros((), dtype=torch.bool, device=device), *args[6:])
    assert torch.equal(off, vol.vox)  # the divergence gate, read on the card


@pytest.fixture(scope="module")
def fused_rgb(device):
    """Port state after 3 RGB-D frames fused with colour on the card, frame 4
    (depth, rgb) and the launch counts of those 3 frames."""
    settings = tiny_test_settings().replace(tracking=TrackingParams(n_levels=3, min_valid_points=50), use_color=True)
    calib = default_calib(IMG[1], IMG[0])
    proj = torch.as_tensor(calib.intrinsics_d.vector, device=device)
    src = synth.SyntheticSource(calib, n_frames=4, img_size=IMG, with_rgb=True, device=device)
    vol, rs, st = hp.create_engine_state(settings, IMG, device=device)
    build.reset_launch_counts()
    for _ in range(3):
        depth, rgb, _gt = src.get_images()
        vol, rs, st, _d = hp.process_frame_hash(vol, rs, st, View(depth=depth, rgb=rgb), proj, settings, proj_rgb=proj)
    torch.cuda.synchronize()
    counts = build.launch_counts()
    depth, rgb, _gt = src.get_images()
    return settings, proj, vol, rs, st, depth, rgb, counts


def test_color_path_launches_the_color_kernel(fused_rgb):
    *_rest, counts = fused_rgb
    levels = TrackingParams(n_levels=3).iterations_per_level[:3]
    assert counts == {"icp": 3 * sum(levels), "integrate": 0, "integrate_color": 3, "raycast": 3}


@pytest.mark.parametrize("extrinsic", [False, True])
def test_k2_color_matches_plain_bit_for_bit(fused_rgb, device, extrinsic):
    settings, proj, vol, rs, st, depth, rgb, _c = fused_rgb
    sp = settings.scene
    M_rgb, proj_rgb = st.pose, proj
    if extrinsic:  # rgb camera 2.5 cm along x, turned 1.5° about y, other intrinsics
        r2d = se3.se3_exp(torch.tensor([0.025, 0.0, 0.0, 0.0, 0.026, 0.0], device=device))
        M_rgb = se3.invert(r2d) @ st.pose
        proj_rgb = proj * torch.tensor([1.04, 1.03, 1.0, 1.0], device=device)
    _ids, ptr, bpos, valid = hp._visible_rows(vol, rs, settings, settings.max_fused_blocks)
    args = (torch.where(valid, ptr, -1).contiguous(), bpos.contiguous(), depth, rgb, st.pose, proj,
            M_rgb.contiguous(), proj_rgb, torch.ones((), dtype=torch.bool, device=device), sp.voxel_size, sp.mu,
            sp.max_w, False)
    k = (vol.vox.clone(), vol.vox_rgb.clone())
    p = (vol.vox.clone(), vol.vox_rgb.clone())
    integrate.integrate_rgbd(*k, *args)
    integrate.integrate_rgbd_plain(*p, *args)
    assert int((p[1] != vol.vox_rgb).sum()) > 10000
    assert int((k[0] != p[0]).sum()) == 0
    assert int((k[1] != p[1]).sum()) == 0
    off = (vol.vox.clone(), vol.vox_rgb.clone())
    integrate.integrate_rgbd(*off, *args[:8], torch.zeros((), dtype=torch.bool, device=device), *args[9:])
    assert torch.equal(off[0], vol.vox) and torch.equal(off[1], vol.vox_rgb)


def test_k3_matches_plain(fused):
    settings, proj, vol, rs, st, _depth, _c = fused
    sp = settings.scene
    zmin, zmax, _n = hp.expected_depth_ranges(vol, rs, st.pose, proj, IMG, settings)
    args = (vol, hp.hv.get_block_grid(vol, settings.block_grid), settings.block_grid, settings.hashing,
            se3.invert(st.pose), proj, IMG, 1.0 / sp.voxel_size, sp.mu, zmin, zmax)
    k = raycast.raycast_grid(*args).points
    p = raycast.raycast_grid_plain(*args).points
    assert int((p[..., 3] > 0).sum()) > 0.5 * IMG[0] * IMG[1]
    assert torch.equal(k, p)


def test_wrappers_check_their_inputs(fused, device):
    settings, proj, vol, rs, st, depth, _c = fused
    with pytest.raises(ValueError):
        icp.icp_sums_cuda(depth.double(), proj, st.points_map, st.normals_map, proj, st.pose, st.pose, 0.01)
    with pytest.raises(ValueError):
        icp.icp_sums_cuda(depth, proj, st.points_map.transpose(0, 1), st.normals_map, proj, st.pose, st.pose, 0.01)
    ptrs = torch.full((4,), -1, dtype=torch.int32, device=device)
    with pytest.raises(ValueError):
        integrate.integrate_depth_cuda(vol.vox, ptrs, torch.zeros((4, 2), dtype=torch.int32, device=device), depth,
                                       st.pose, proj, torch.ones((), dtype=torch.bool, device=device), 0.02, 0.08,
                                       100, False)
    vox_rgb = torch.zeros_like(vol.vox)
    bpos = torch.zeros((4, 3), dtype=torch.int32, device=device)
    rgb = torch.zeros(depth.shape + (3,), device=device)
    one = torch.ones((), dtype=torch.bool, device=device)
    for bad in (dict(rgb=rgb[..., :2]), dict(rgb=rgb.double()), dict(vox_rgb=vox_rgb[:-1]),
                dict(rgb=rgb.cpu())):
        a = dict(vox_rgb=vox_rgb, rgb=rgb) | bad
        with pytest.raises(ValueError):
            integrate.integrate_rgbd_cuda(vol.vox, a["vox_rgb"], ptrs, bpos, depth, a["rgb"], st.pose, proj, st.pose,
                                          proj, one, 0.02, 0.08, 100, False)
    assert np.isfinite(st.pose.cpu().numpy()).all()
