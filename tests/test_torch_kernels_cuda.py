"""Card-only tests: each hand-written CUDA kernel (K1 at the five pyramid
levels' shapes and twice on one input, unweighted and with per-pixel
weights, K2 with and without its colour half,
also on edited visible lists and on a one-CTA grid, K3 at two voxel sizes
and with its enable flag false and true) against its plain PyTorch version
on an NVIDIA GPU, at a small size; the launch counts of the depth, colour,
Ren and approximate-raycast frame loops; the mesh on the card against the
same code on the CPU; K2 and K2c on visible lists with swapped-out and
reallocated rows; the swap eviction and merge on the card against the same
code on the CPU, and a swapping engine's round trip through the pinned
exchange; K3's two reader variants, K3h through the hash table (also on
blocks outside the grid's window, behind an excess link and swapped out)
and K3d over a dense voxel array, with the dense frame loop's launches and
its mesh on the card against the CPU's; the lock-step design that K3h and
K3d replaced equal to the main path's design on the same inputs, also on
ranges that end inside a lookahead batch and on rays that leave the dense
array. The lane-indexed launches at B = 3 under torch.vmap (K1 and K1w, K2
and K2c, K3, K3h and K3d, with shared and
per-lane arguments): one launch for the three lanes, each lane equal to its
single-lane launch (K1 and K2 bit for bit) and held to the plain twin as the
single-lane launch is; and a batched frame step against the same frames
stepped lane by lane.

They carry the `cuda` marker and skip where no card is present. On a machine
with a card (JAX need not be installed there), run them with:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py

chip_smoke.py repeats these comparisons at the main path's full size.
"""

import numpy as np
import pytest
import torch

from infinitam_tpu_torch.calib import default_calib
from infinitam_tpu_torch.config import (
    PlainVoxelArrayParams,
    SceneParams,
    SwappingMode,
    TrackerType,
    TrackingParams,
    VoxelBlockHashParams,
    tiny_test_settings,
)
from infinitam_tpu_torch.engine import dense_pipeline as dp
from infinitam_tpu_torch.engine import hash_pipeline as hp
from infinitam_tpu_torch.engine import hash_volume as hv
from infinitam_tpu_torch.engine import swapping, trackers
from infinitam_tpu_torch.engine.swapping import SWAP_IN_FLIGHT
from infinitam_tpu_torch.engine.view_builder import View
from infinitam_tpu_torch.io import synth
from infinitam_tpu_torch.ops import pyramid, view_ops
from infinitam_tpu_torch.ops.kernels import build, icp, integrate, raycast
from infinitam_tpu_torch.utils import se3

pytestmark = pytest.mark.cuda

IMG = (120, 160)


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


SETTINGS = tiny_test_settings().replace(tracking=TrackingParams(n_levels=3, min_valid_points=50))
# 1 cm voxels: twice the tiny settings' resolution, with room for the blocks
SETTINGS_1CM = SETTINGS.replace(
    scene=SceneParams(voxel_size=0.01, mu=0.04),
    hashing=VoxelBlockHashParams(n_buckets=0x4000, n_excess=0x800, n_blocks=0x2000, n_transfer_blocks=0x100,
                                 n_global_blocks=0x4000, max_visible_blocks=0x2000),
)


def fuse_frames(settings, device):
    """Port state after 3 synthetic frames fused on the card, frame 4's depth
    and the launch counts of those 3 frames."""
    calib = default_calib(IMG[1], IMG[0])
    proj = torch.as_tensor(calib.intrinsics_d.vector, device=device)
    src = synth.SyntheticSource(calib, n_frames=4, img_size=IMG, device=device)
    vol, rs, st = hp.create_engine_state(settings, IMG, device=device)
    build.reset_launch_counts()
    for _ in range(3):
        vol, rs, st, _d = hp.process_frame_hash(vol, rs, st, View(depth=src.get_images()[0]), proj, settings)
    torch.cuda.synchronize()
    return settings, proj, vol, rs, st, src.get_images()[0], build.launch_counts()


@pytest.fixture(scope="module")
def fused(device):
    return fuse_frames(SETTINGS, device)


@pytest.fixture(scope="module")
def fused_1cm(device):
    return fuse_frames(SETTINGS_1CM, device)


def test_main_path_launched_every_kernel(fused):
    *_rest, counts = fused
    levels = TrackingParams(n_levels=3).iterations_per_level[:3]
    assert counts == dict.fromkeys(build.KERNELS, 0) | {
        "icp": 3 * sum(levels), "icp_weighted": 0, "integrate": 3, "integrate_color": 0,
        "raycast": 3, "raycast_hash": 0, "raycast_dense": 0}


def k1_args(fused, level=0):
    """K1's arguments at pyramid `level` of a 5-level pyramid of frame 4,
    against the full-resolution maps, as trackers.track_depth passes them."""
    settings, proj, _vol, _rs, st, depth, _c = fused
    tp = TrackingParams(min_valid_points=settings.tracking.min_valid_points)
    d = pyramid.build_depth_pyramid(depth, tp.n_levels)[level]
    return (d, trackers.scale_proj(proj, level), st.points_map, st.normals_map, proj, se3.invert(st.pose),
            st.pose_point_cloud, trackers.level_dist_thresh(tp)[level], tp.min_valid_points)


def test_k1_matches_plain(fused):
    args = k1_args(fused)
    k, p = icp.icp_gh(*args), icp.icp_gh_plain(*args)
    assert int(k.num_valid) == int(p.num_valid) > 5000
    # the same per-pixel terms summed in another order
    torch.testing.assert_close(k.hessian, p.hessian, rtol=1e-4, atol=1e-4 * float(p.hessian.abs().max()))
    torch.testing.assert_close(k.nabla, p.nabla, rtol=1e-4, atol=1e-4 * float(p.nabla.abs().max()))
    torch.testing.assert_close(k.f, p.f, rtol=1e-4, atol=0)


@pytest.mark.parametrize("level", range(5))
def test_k1_matches_plain_at_every_level(fused, level):
    args = k1_args(fused, level)
    build.reset_launch_counts()
    k = icp.icp_gh(*args)
    assert build.launch_counts()["icp"] == 1
    p = icp.icp_gh_plain(*args)
    assert k.num_valid.dtype == torch.int32 and int(k.num_valid) == int(p.num_valid) > 0
    torch.testing.assert_close(k.hessian, p.hessian, rtol=1e-4, atol=1e-4 * float(p.hessian.abs().max()))
    torch.testing.assert_close(k.nabla, p.nabla, rtol=1e-4, atol=1e-4 * float(p.nabla.abs().max()))
    torch.testing.assert_close(k.f, p.f, rtol=1e-4, atol=0)
    assert torch.equal(k.hessian, k.hessian.T)


def test_k1_is_bit_reproducible(fused):
    """The last CTA sums the partials in a fixed order: two launches on one
    input agree bit for bit, and the ticket counter is back at 0."""
    args = k1_args(fused)
    a, b = icp.icp_gh(*args), icp.icp_gh(*args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert int(icp._counter(args[0].device.index, build.stream_ptr(), 1)) == 0


def test_k1_on_two_streams(fused):
    """Each stream has its own ticket counter: launches on two streams that
    run at once give each stream the single-stream result."""
    args = k1_args(fused)
    ref = icp.icp_gh(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    main_out, side_out = [], []
    for _ in range(20):
        main_out.append(icp.icp_gh(*args))
        with torch.cuda.stream(side):
            side_out.append(icp.icp_gh(*args))
    torch.cuda.synchronize()
    for got in main_out + side_out:
        for x, y in zip(got, ref):
            assert torch.equal(x, y)


def k1_weights(fused, level):
    """The weighted tracker's ω at pyramid `level`, from σ_z of frame 4's
    bilateral-filtered depth (trackers.weight_pyramid)."""
    depth = fused[5]
    for _ in range(5):
        depth = view_ops.bilateral_filter_depth(depth)
    sigma = view_ops.compute_normals_and_weights(depth, default_calib(IMG[1], IMG[0]).intrinsics_d)[1]
    return trackers.weight_pyramid(sigma, 5)[level]


@pytest.mark.parametrize("level", range(5))
def test_weighted_k1_matches_plain_at_every_level(fused, level):
    args, w = k1_args(fused, level), k1_weights(fused, level)
    assert w.shape == args[0].shape and float(w.max()) == 1.0
    build.reset_launch_counts()
    k = icp.icp_gh(*args, weights=w)
    assert build.launch_counts()["icp_weighted"] == 1 and build.launch_counts()["icp"] == 0
    p = icp.icp_gh_plain(*args, weights=w)
    assert int(k.num_valid) == int(p.num_valid) == int(icp.icp_gh_plain(*args).num_valid) > 0
    torch.testing.assert_close(k.hessian, p.hessian, rtol=1e-4, atol=1e-4 * float(p.hessian.abs().max()))
    torch.testing.assert_close(k.nabla, p.nabla, rtol=1e-4, atol=1e-4 * float(p.nabla.abs().max()))
    torch.testing.assert_close(k.f, p.f, rtol=1e-4, atol=0)
    # the weights reached the sums
    assert not torch.allclose(k.hessian, icp.icp_gh(*args).hessian, rtol=1e-3)


def test_weighted_k1_is_bit_reproducible_with_one_device_op(fused):
    """Two weighted launches on one input agree bit for bit; a call runs
    one kernel and no other device op; the unweighted call is unchanged by
    a weighted one before it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    args, w = k1_args(fused), k1_weights(fused, 0)
    before = icp.icp_gh(*args)
    a, b = icp.icp_gh(*args, weights=w), icp.icp_gh(*args, weights=w)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    for x, y in zip(icp.icp_gh(*args), before):
        assert torch.equal(x, y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            icp.icp_gh(*args, weights=w)
        torch.cuda.synchronize()
    ops = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(ops) == 10 and all("itpu_icp_kernel" in n for n in ops), ops[:4]


def k2_args(fused, device, ids=None, max_rows=None):
    """K2's arguments after `vox` on the fused state's visible list (or on
    `ids`), as integrate_into_scene passes them."""
    settings, proj, vol, rs, st, depth, _c = fused
    sp = settings.scene
    return (rs.visible_ids if ids is None else ids, vol.entry_ptr, vol.entry_pos, depth, st.pose, proj,
            torch.ones((), dtype=torch.bool, device=device), sp.voxel_size, sp.mu, sp.max_w, False, 8,
            settings.max_fused_blocks if max_rows is None else max_rows)


def test_k2_matches_plain_bit_for_bit(fused, device):
    _settings, _proj, vol, _rs, _st, _depth, _c = fused
    args = k2_args(fused, device)
    vk, vp = vol.vox.clone(), vol.vox.clone()
    build.reset_launch_counts()
    integrate.integrate_depth(vk, *args)
    assert build.launch_counts()["integrate"] == 1
    integrate.integrate_depth_plain(vp, *args)
    assert int((vp != vol.vox).sum()) > 10000
    assert int((vk != vp).sum()) == 0
    again = vol.vox.clone()
    integrate.integrate_depth(again, *args)
    assert torch.equal(again, vk)  # two launches on one input agree
    off = vol.vox.clone()
    integrate.integrate_depth(off, *args[:6], torch.zeros((), dtype=torch.bool, device=device), *args[7:])
    assert torch.equal(off, vol.vox)  # the divergence gate, read on the card


def test_k2_division_steps_match_ieee_division(device):
    """K2 divides in straight-line code (csrc/integrate.cu rcp_step and
    div_step) where both operands lie in [2^-60, 2^60] and falls back to `/`
    elsewhere. There its quotient must be the IEEE quotient bit for bit
    (numpy's, on the CPU): on operands spread over that whole range, on
    K2's own kinds (η/μ, a merged sdf over a weight + 1, pixel coordinates
    over a depth), and at the range's ends."""
    rng = np.random.default_rng(7)
    n = 1 << 21

    def spread(k):
        x = rng.uniform(1.0, 2.0, k) * np.exp2(rng.integers(-60, 60, k)) * rng.choice([-1.0, 1.0], k)
        return x.astype(np.float32)

    ends = np.float32([2.0**-60, 2.0**60, -(2.0**-60), 1.0, 1.5, 3.0])
    a = np.concatenate([spread(n), rng.uniform(-0.02, 0.5, n), rng.uniform(-1.0, 1.0, n),
                        rng.uniform(-600.0, 600.0, n), np.repeat(ends, len(ends))]).astype(np.float32)
    b = np.concatenate([spread(n), np.full(n, 0.02), rng.integers(1, 257, n), rng.uniform(0.1, 4.0, n),
                        np.tile(ends, len(ends))]).astype(np.float32)
    out = torch.empty(a.size, dtype=torch.float32, device=device)
    at, bt = torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)
    assert build.library().itpu_div_step_check(at.data_ptr(), bt.data_ptr(), out.data_ptr(), a.size,
                                               build.stream_ptr()) == 0
    got = out.cpu().numpy()
    in_range = (np.abs(a) >= 2.0**-60) & (np.abs(a) <= 2.0**60) & (np.abs(b) >= 2.0**-60) & (np.abs(b) <= 2.0**60)
    assert in_range.mean() > 0.99
    np.testing.assert_array_equal(got[in_range].view(np.int32), (a[in_range] / b[in_range]).view(np.int32))
    assert np.isnan(got[~in_range]).all()


def edited_lists(ids, entry_ptr) -> dict:
    """name → (visible list, max_rows) made from the fused list `ids`: every
    way a list can hold its live rows that the kernel's row loop must get
    right."""
    V = ids.numel()
    ptr = entry_ptr[ids.clamp(min=0).long()]
    live = ids[(ids >= 0) & (ptr >= 0)]
    n = live.numel()
    assert 256 < n and 2 * n + 2 < V
    empty = torch.full_like(ids, -1)
    single, at_end, inter = empty.clone(), empty.clone(), empty.clone()
    single[5] = live[n // 2]
    at_end[V - n:] = live
    inter[: 2 * n : 2] = live
    inter[n | 1] = int(torch.nonzero(entry_ptr < 0)[0])  # an entry without a block
    return {"all_empty": (empty, 0), "single": (single, 0), "at_end": (at_end, 0), "interleaved": (inter, 0),
            # a cap that ends inside a warp's 32 rows
            "cap_mid_chunk": (ids, n // 2 + 3), "whole_list": (ids, 0)}


LIST_CASES = ("all_empty", "single", "at_end", "interleaved", "cap_mid_chunk", "whole_list")


@pytest.mark.parametrize("n_ctas", [0, 1])
@pytest.mark.parametrize("case", LIST_CASES)
def test_k2_visible_lists_match_plain(fused, device, case, n_ctas):
    """K2 on edited visible lists, bit for bit against its plain twin, on the
    full persistent grid and on one CTA, whose 8 warps take 256 rows a pass:
    there the fused list's 552 live rows make the loop go round."""
    _settings, _proj, vol, rs, _st, _depth, _c = fused
    ids, max_rows = edited_lists(rs.visible_ids, vol.entry_ptr)[case]
    args = k2_args(fused, device, ids.contiguous(), max_rows)
    vk, vp = vol.vox.clone(), vol.vox.clone()
    integrate.integrate_depth_cuda(vk, *args, n_ctas=n_ctas)
    integrate.integrate_depth_plain(vp, *args)
    assert int((vk != vp).sum()) == 0
    assert (int((vp != vol.vox).sum()) == 0) == (case == "all_empty")


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
    assert counts == dict.fromkeys(build.KERNELS, 0) | {
        "icp": 3 * sum(levels), "icp_weighted": 0, "integrate": 0, "integrate_color": 3,
        "raycast": 3, "raycast_hash": 0, "raycast_dense": 0}


def k2c_args(fused_rgb, device, extrinsic=False, ids=None, max_rows=None):
    """K2c's arguments after `vox, vox_rgb`, as integrate_into_scene passes
    them; with `extrinsic` the rgb camera sits 2.5 cm along x, turned 1.5°
    about y, with other intrinsics."""
    settings, proj, vol, rs, st, depth, rgb, _c = fused_rgb
    sp = settings.scene
    M_rgb, proj_rgb = st.pose, proj
    if extrinsic:
        r2d = se3.se3_exp(torch.tensor([0.025, 0.0, 0.0, 0.0, 0.026, 0.0], device=device))
        M_rgb = se3.invert(r2d) @ st.pose
        proj_rgb = proj * torch.tensor([1.04, 1.03, 1.0, 1.0], device=device)
    return (rs.visible_ids if ids is None else ids, vol.entry_ptr, vol.entry_pos, depth, rgb, st.pose, proj,
            M_rgb.contiguous(), proj_rgb, torch.ones((), dtype=torch.bool, device=device), sp.voxel_size, sp.mu,
            sp.max_w, False, 8, settings.max_fused_blocks if max_rows is None else max_rows)


@pytest.mark.parametrize("extrinsic", [False, True])
def test_k2_color_matches_plain_bit_for_bit(fused_rgb, device, extrinsic):
    _settings, _proj, vol, _rs, _st, _depth, _rgb, _c = fused_rgb
    args = k2c_args(fused_rgb, device, extrinsic)
    k = (vol.vox.clone(), vol.vox_rgb.clone())
    p = (vol.vox.clone(), vol.vox_rgb.clone())
    build.reset_launch_counts()
    integrate.integrate_rgbd(*k, *args)
    assert build.launch_counts()["integrate_color"] == 1
    integrate.integrate_rgbd_plain(*p, *args)
    assert int((p[1] != vol.vox_rgb).sum()) > 10000
    assert int((k[0] != p[0]).sum()) == 0
    assert int((k[1] != p[1]).sum()) == 0
    again = (vol.vox.clone(), vol.vox_rgb.clone())
    integrate.integrate_rgbd(*again, *args)
    assert torch.equal(again[0], k[0]) and torch.equal(again[1], k[1])  # two launches on one input agree
    off = (vol.vox.clone(), vol.vox_rgb.clone())
    integrate.integrate_rgbd(*off, *args[:9], torch.zeros((), dtype=torch.bool, device=device), *args[10:])
    assert torch.equal(off[0], vol.vox) and torch.equal(off[1], vol.vox_rgb)


@pytest.mark.parametrize("n_ctas", [0, 1])
@pytest.mark.parametrize("case", LIST_CASES)
def test_k2_color_visible_lists_match_plain(fused_rgb, device, case, n_ctas):
    """K2c on the edited visible lists of test_k2_visible_lists_match_plain,
    with the 2.5 cm / 1.5° extrinsic, bit for bit against its plain twin."""
    _settings, _proj, vol, rs, _st, _depth, _rgb, _c = fused_rgb
    ids, max_rows = edited_lists(rs.visible_ids, vol.entry_ptr)[case]
    args = k2c_args(fused_rgb, device, True, ids.contiguous(), max_rows)
    k = (vol.vox.clone(), vol.vox_rgb.clone())
    p = (vol.vox.clone(), vol.vox_rgb.clone())
    integrate.integrate_rgbd_cuda(*k, *args, n_ctas=n_ctas)
    integrate.integrate_rgbd_plain(*p, *args)
    assert int((k[0] != p[0]).sum()) == 0 and int((k[1] != p[1]).sum()) == 0
    assert (int((p[0] != vol.vox).sum()) == 0) == (case == "all_empty")
    if case not in ("all_empty", "single"):
        assert int((p[1] != vol.vox_rgb).sum()) > 1000


@pytest.mark.parametrize("volume", ["fused", "fused_1cm"])
def test_k3_matches_plain(volume, request):
    """The kernel builds its rays itself; they round as pixel_rays, so the
    march and its points equal the plain version's, at 2 cm and at 1 cm."""
    settings, proj, vol, rs, st, _depth, _c = request.getfixturevalue(volume)
    sp = settings.scene
    zmin, zmax, _n = hp.expected_depth_ranges(vol, rs, st.pose, proj, IMG, settings)
    args = (vol, hp.hv.get_block_grid(vol, settings.block_grid), settings.block_grid, settings.hashing,
            se3.invert(st.pose), proj, IMG, 1.0 / sp.voxel_size, sp.mu, zmin, zmax)
    k = raycast.raycast_grid(*args).points
    p = raycast.raycast_grid_plain(*args).points
    assert int((p[..., 3] > 0).sum()) > 0.5 * IMG[0] * IMG[1]
    assert torch.equal(k, p)


@pytest.mark.parametrize("flag", [True, False])
def test_k3_enable_flag(fused, device, flag):
    """With the device flag true K3 equals the plain march; false, no ray is
    marched and an output filled with a sentinel comes back unchanged. The
    flag costs no launch of its own."""
    settings, proj, vol, rs, st, _depth, _c = fused
    sp = settings.scene
    zmin, zmax, _n = hp.expected_depth_ranges(vol, rs, st.pose, proj, IMG, settings)
    args = (vol, hp.hv.get_block_grid(vol, settings.block_grid), settings.block_grid, settings.hashing,
            se3.invert(st.pose), proj, IMG, 1.0 / sp.voxel_size, sp.mu, zmin, zmax)
    enable = torch.tensor(flag, device=device)
    sentinel = torch.full((*IMG, 4), -7.0, device=device)
    build.reset_launch_counts()
    k = raycast.raycast_grid(*args, enable=enable, out=sentinel.clone()).points
    assert build.launch_counts()["raycast"] == 1
    p = raycast.raycast_grid_plain(*args, enable=enable, out=sentinel).points
    assert torch.equal(k, p)
    assert torch.equal(k, sentinel) != flag


@pytest.mark.parametrize("case", ["ren", "approximate_raycast"])
def test_ren_and_approximate_paths_launch_their_kernels(device, case):
    """3 frames on the card: Ren's ICP pre-step runs the levels above 0
    (no_icp_run_till_level = 1); the approximate raycast launches K3 on
    every frame, its march switched by a device flag."""
    extra = dict(tracker_type=TrackerType.REN) if case == "ren" else dict(use_approximate_raycast=True)
    _s, _p, vol, _rs, st, _d, counts = fuse_frames(SETTINGS.replace(**extra), device)
    iters = TrackingParams(n_levels=3).iterations_per_level[:3]
    icp_per_frame = sum(iters[1:]) if case == "ren" else sum(iters)
    assert counts == dict.fromkeys(build.KERNELS, 0) | {
        "icp": 3 * icp_per_frame, "icp_weighted": 0, "integrate": 3, "integrate_color": 0,
        "raycast": 3, "raycast_hash": 0, "raycast_dense": 0}
    assert np.isfinite(st.pose.cpu().numpy()).all() and int((vol.entry_ptr >= 0).sum()) > 100


def test_mesh_on_the_card_equals_the_cpu_mesh(fused):
    """The same extraction code on the card and on a CPU copy of the volume:
    the same triangles (counts equal, vertices within 1e-6 m)."""
    from infinitam_tpu_torch.engine import meshing_engine

    settings, _proj, vol, _rs, _st, _depth, _c = fused
    on_card = meshing_engine.mesh_scene_hash(vol, settings)
    cpu_vol = type(vol)(*(None if t is None else t.cpu() for t in vol))
    on_cpu = meshing_engine.mesh_scene_hash(cpu_vol, settings)
    assert on_card.n_triangles == on_cpu.n_triangles > 1000
    np.testing.assert_allclose(on_card.triangles, on_cpu.triangles, rtol=0, atol=1e-6)


def test_wrappers_check_their_inputs(fused, device):
    settings, proj, vol, rs, st, depth, _c = fused
    with pytest.raises(ValueError):
        icp.icp_gh_cuda(depth.double(), proj, st.points_map, st.normals_map, proj, st.pose, st.pose, 0.01, 50)
    with pytest.raises(ValueError):
        icp.icp_gh_cuda(depth, proj, st.points_map.transpose(0, 1), st.normals_map, proj, st.pose, st.pose, 0.01, 50)
    with pytest.raises(ValueError):  # the kernel reads the pose rows from memory: contiguous only
        icp.icp_gh_cuda(depth, proj, st.points_map, st.normals_map, proj, st.pose.T, st.pose, 0.01, 50)
    for bad_w in (torch.ones_like(depth)[:, :-1], torch.ones_like(depth).double(), torch.ones_like(depth).cpu()):
        with pytest.raises(ValueError):  # the weight map: [H, W] float32 on the card
            icp.icp_gh_cuda(depth, proj, st.points_map, st.normals_map, proj, st.pose, st.pose, 0.01, 50,
                            weights=bad_w)
    one = torch.ones((), dtype=torch.bool, device=device)
    rows = (rs.visible_ids, vol.entry_ptr, vol.entry_pos)
    for bad in (dict(entry_pos=vol.entry_pos[:, :2]), dict(visible_ids=rs.visible_ids.long()),
                dict(pose=st.pose.T), dict(block_size=4)):
        a = dict(visible_ids=rs.visible_ids, entry_pos=vol.entry_pos, pose=st.pose, block_size=8) | bad
        with pytest.raises(ValueError):
            integrate.integrate_depth_cuda(vol.vox, a["visible_ids"], vol.entry_ptr, a["entry_pos"], depth, a["pose"],
                                           proj, one, 0.02, 0.08, 100, False, a["block_size"])
    vox_rgb = torch.zeros_like(vol.vox)
    rgb = torch.zeros(depth.shape + (3,), device=device)
    for bad in (dict(rgb=rgb[..., :2]), dict(rgb=rgb.double()), dict(vox_rgb=vox_rgb[:-1]),
                dict(rgb=rgb.cpu())):
        a = dict(vox_rgb=vox_rgb, rgb=rgb) | bad
        with pytest.raises(ValueError):
            integrate.integrate_rgbd_cuda(vol.vox, a["vox_rgb"], *rows, depth, a["rgb"], st.pose, proj, st.pose,
                                          proj, one, 0.02, 0.08, 100, False)
    assert np.isfinite(st.pose.cpu().numpy()).all()


def swapped_out_and_back(fused, device):
    """A copy of the fused volume in which every other entry of the visible
    list was evicted (ptr −1, its block cleared and freed) and every other
    evicted entry then took a fresh block again (reallocated, cleared), as
    the swap path leaves a visible list before K2 runs."""
    settings, _proj, vol, rs, _st, _depth, *_c = fused
    S = settings.replace(swapping_mode=SwappingMode.ENABLED)
    E = S.hashing.n_entries
    ids = rs.visible_ids[rs.visible_ids >= 0]
    out, back = ids[::2], ids[::4]
    vt = torch.ones(E, dtype=torch.int32, device=device)
    vt[out.long()] = 0
    vol2 = type(vol)(*(None if t is None else t.clone() for t in vol))
    ss = torch.full((E,), 2, dtype=torch.int32, device=device)
    vol2, ss, _ids, _s, _w, _c, _wc, n = swapping.evict_blocks(vol2, ss, vt, S, cap=int(out.numel()))
    assert int(n) == out.numel()
    vt2 = torch.zeros(E, dtype=torch.int32, device=device)
    vt2[back.long()] = hv.VT_VISIBLE_SWAPPED
    vol2 = swapping.reallocate_swapped_out(vol2, vt2, S, visible_ids=back.contiguous())
    ptr = vol2.entry_ptr[ids.long()]
    assert int((ptr == -1).sum()) > 50 and bool((vol2.entry_ptr[back.long()] >= 0).all())
    return vol2


def test_k2_on_a_list_with_swapped_out_and_reallocated_rows(fused, device):
    """K2 skips the rows whose entry is swapped out (ptr −1) and fuses the
    reallocated (cleared) blocks, bit for bit as its plain twin."""
    vol2 = swapped_out_and_back(fused, device)
    args = list(k2_args(fused, device))
    args[1] = vol2.entry_ptr
    vk, vp = vol2.vox.clone(), vol2.vox.clone()
    build.reset_launch_counts()
    integrate.integrate_depth(vk, *args)
    assert build.launch_counts()["integrate"] == 1
    integrate.integrate_depth_plain(vp, *args)
    assert int((vp != vol2.vox).sum()) > 10000 and int((vk != vp).sum()) == 0


def test_k2_color_on_a_list_with_swapped_out_and_reallocated_rows(fused_rgb, device):
    vol2 = swapped_out_and_back(fused_rgb, device)
    args = list(k2c_args(fused_rgb, device, True))
    args[1] = vol2.entry_ptr
    k = (vol2.vox.clone(), vol2.vox_rgb.clone())
    p = (vol2.vox.clone(), vol2.vox_rgb.clone())
    integrate.integrate_rgbd(*k, *args)
    integrate.integrate_rgbd_plain(*p, *args)
    assert int((p[1] != vol2.vox_rgb).sum()) > 1000
    assert int((k[0] != p[0]).sum()) == 0 and int((k[1] != p[1]).sum()) == 0


def cpu_copy(x):
    """A copy on the CPU of a tensor or a state NamedTuple of tensors."""
    if x is None:
        return None
    return x.to("cpu", copy=True) if torch.is_tensor(x) else type(x)(*(cpu_copy(t) for t in x))


def assert_equal_outputs(card, cpu):
    for a, b in zip(card, cpu):
        if hasattr(a, "_fields"):
            assert_equal_outputs(a, b)
        elif a is not None:
            assert torch.equal(a.cpu(), b), a.dtype


@pytest.mark.parametrize("window", [0, 7, 15])
def test_evict_blocks_window_on_the_card_equals_the_cpu(fused, device, window):
    """The same eviction code on the card and on a CPU copy, with random
    swap states and visible-type codes from a seed: every output equal."""
    settings, _proj, vol, _rs, _st, _depth, _c = fused
    S = settings.replace(swapping_mode=SwappingMode.ENABLED)
    E = S.hashing.n_entries
    rng = np.random.default_rng(window)
    ss = torch.from_numpy(rng.choice(4, E, p=[0.2, 0.2, 0.5, 0.1]).astype(np.int32))
    vt = torch.from_numpy(rng.choice(4, E, p=[0.6, 0.2, 0.1, 0.1]).astype(np.int32))
    card = swapping.evict_blocks_window(type(vol)(*(None if t is None else t.clone() for t in vol)), ss.to(device),
                                        vt.to(device), S, 64, torch.tensor(window + 32, device=device))
    cpu = swapping.evict_blocks_window(cpu_copy(vol), ss, vt, S, 64, torch.tensor(window + 32))
    assert int(cpu[-1]) > 0
    assert_equal_outputs(card, cpu)


@pytest.mark.parametrize("color", [False, True], ids=["depth", "colour"])
def test_merge_data_slab_on_the_card_equals_the_cpu(fused, fused_rgb, color):
    """A data slab packed from random host blocks (SwapExchange's packing),
    merged by the same code on the card and on a CPU copy: the voxels (and
    colours) and the swap states equal word for word."""
    settings, _proj, vol, *_rest = fused_rgb if color else fused
    S = settings.replace(swapping_mode=SwappingMode.ENABLED)
    hp_, S3 = S.hashing, S.hashing.block_volume
    rng = np.random.default_rng(3)
    alloc = torch.nonzero(vol.entry_ptr >= 0).squeeze(1).cpu().numpy()
    q = swapping.exchange_quantum(S)
    ids = rng.choice(alloc, q, replace=False).astype(np.int32)
    has = rng.random(q) < 0.5
    bs = rng.integers(-32767, 32768, (q, S3)).astype(np.int16)
    bw = np.where(has[:, None], rng.integers(0, 120, (q, S3)), 0).astype(np.uint8)
    bc = rng.integers(0, 256, (q, S3, 3)).astype(np.uint8) if color else None
    bwc = np.where(has[:, None], rng.integers(0, 120, (q, S3)), 0).astype(np.uint8) if color else None
    slab = swapping.SwapExchange(S, color, device="cpu")._pack_data_slab(ids, bs, bw, has, bc, bwc, int(has.sum()))
    ss = torch.full((hp_.n_entries,), SWAP_IN_FLIGHT, dtype=torch.int32)
    card = swapping.merge_data_slab(type(vol)(*(None if t is None else t.clone() for t in vol)), ss.to(vol.vox.device),
                                    torch.from_numpy(slab).to(vol.vox.device), S, with_color=color)
    cpu = swapping.merge_data_slab(cpu_copy(vol), ss, torch.from_numpy(slab), S, with_color=color)
    assert int((cpu[0].vox != vol.vox.cpu()).sum()) > 1000
    assert_equal_outputs(card, cpu)


def test_swap_engine_round_trip_on_the_card(device):
    """MainEngine with swapping on the card: K1, K2 and K3 launched every
    frame; blocks go out on a look-away frame and merge their stored data
    when the camera comes back; after the flush every allocated block is
    resident or stored. Op by op (capture=False) the exchange's pinned
    copies are always ready when the host reads them two frames on (0
    waits); captured (the default), the host issues frames faster than the
    card runs them, so it may wait there for the card (backpressure), but
    at most once a frame whose host half runs (frames − PIPE_DEPTH): only
    on that frame's own copy, never on an upload slot. The captured engine
    ends as the op-by-op one does: equal poses, exchange counts and host
    store."""
    from infinitam_tpu_torch.engine.main_engine import MainEngine

    settings = SETTINGS.replace(swapping_mode=SwappingMode.ENABLED)
    calib = default_calib(IMG[1], IMG[0])
    src = synth.SyntheticSource(calib, n_frames=6, img_size=IMG, device=device)
    frames = [src.get_images() for _ in range(6)]
    iters = sum(TrackingParams(n_levels=3).iterations_per_level[:3])
    away = se3.se3_exp(torch.tensor([0.0, 0.0, 0.0, 0.0, float(np.pi), 0.0], device=device))
    engines = {}
    n_frames = len(frames) + 1 + 5
    for capture in (False, True):
        eng = MainEngine(settings, calib, IMG, device=device)
        build.reset_launch_counts()
        for depth, _rgb, _gt in frames:
            eng.process_frame(metric_depth=depth, capture=capture)
        assert build.launch_counts() == dict.fromkeys(build.KERNELS, 0) | {
            "icp": 6 * iters, "icp_weighted": 0, "integrate": 6, "integrate_color": 0, "raycast": 6,
            "raycast_hash": 0, "raycast_dense": 0}
        eng.set_pose(away)
        eng.tracking_state = eng.tracking_state._replace(age=torch.tensor(-1, dtype=torch.int32, device=device))
        eng.process_frame(metric_depth=synth.render_depth(away, eng.proj, IMG), capture=capture)
        eng.set_pose(frames[0][2])
        eng.tracking_state = eng.tracking_state._replace(age=torch.tensor(-1, dtype=torch.int32, device=device))
        for depth, _rgb, _gt in frames[:5]:
            eng.process_frame(metric_depth=depth, capture=capture)
        ex = eng.swap_exchange
        assert ex.n_evicted > 0 and ex.n_merged > 0
        assert ex.n_waits <= (n_frames - ex.PIPE_DEPTH if capture else 0)
        eng.flush_swap()
        allocated = torch.nonzero(eng.vol.entry_ptr >= -1).squeeze(1)
        resident = eng.vol.entry_ptr[allocated] >= 0
        stored = torch.from_numpy(eng.global_cache.has_stored).to(device)[allocated]
        assert bool((resident | stored).all())
        assert np.isfinite(eng.get_pose()).all()
        engines[capture] = eng
    a, b = engines[False], engines[True]
    np.testing.assert_array_equal(a.get_pose(), b.get_pose())
    assert (a.swap_exchange.n_evicted, a.swap_exchange.n_listed, a.swap_exchange.n_merged) == \
        (b.swap_exchange.n_evicted, b.swap_exchange.n_listed, b.swap_exchange.n_merged)
    np.testing.assert_array_equal(a.global_cache.has_stored, b.global_cache.has_stored)
    assert torch.equal(a.vol.vox, b.vol.vox)


def assert_raycast_matches_plain(k, p):
    """K3's bar against its plain twin: the hit mask equal, points within
    4e-6 voxel."""
    fk, fp = k[..., 3] > 0, p[..., 3] > 0
    assert torch.equal(fk, fp)
    if bool(fp.any()):  # ranges that hit nothing leave only the mask to compare
        assert float((k[..., :3] - p[..., :3]).abs()[fp].max()) <= 4e-6


def assert_lockstep_equal(lockstep_fn, args, k, enable=None, out=None):
    """The lock-step design's points equal the main path design's (`k`) on
    the same inputs (into a copy of `out` when given)."""
    got = lockstep_fn(*args, enable=enable, out=None if out is None else out.clone()).points
    assert torch.equal(got, k)


@pytest.mark.parametrize("volume", ["fused", "fused_1cm"])
def test_k3h_matches_plain(volume, request, device):
    """K3h walks the hash chains; on a map inside the grid's window it also
    equals K3. Its enable flag keeps `out` as K3's does."""
    settings, proj, vol, rs, st, _depth, _c = request.getfixturevalue(volume)
    sp = settings.scene
    zmin, zmax, _n = hp.expected_depth_ranges(vol, rs, st.pose, proj, IMG, settings)
    args = (vol, settings.hashing, se3.invert(st.pose), proj, IMG, 1.0 / sp.voxel_size, sp.mu, zmin, zmax)
    build.reset_launch_counts()
    k = raycast.raycast_hash_probe(*args).points
    assert build.launch_counts()["raycast_hash"] == 1
    p = raycast.raycast_hash_probe_plain(*args).points
    assert int((p[..., 3] > 0).sum()) > 0.5 * IMG[0] * IMG[1]
    assert_raycast_matches_plain(k, p)
    g = raycast.raycast_grid(vol, hp.hv.get_block_grid(vol, settings.block_grid), settings.block_grid,
                             settings.hashing, *args[2:]).points
    assert torch.equal(k, g)
    build.reset_launch_counts()
    assert_lockstep_equal(raycast.raycast_hash_probe_lockstep, args, k)
    assert build.launch_counts()["raycast_hash"] == 0  # the lock-step launches are not counted
    sentinel = torch.full((*IMG, 4), -7.0, device=device)
    off = torch.zeros((), dtype=torch.bool, device=device)
    assert torch.equal(raycast.raycast_hash_probe(*args, enable=off, out=sentinel.clone()).points, sentinel)
    assert_lockstep_equal(raycast.raycast_hash_probe_lockstep, args, sentinel, enable=off, out=sentinel)


def far_blocks(device, swapped: bool):
    """Three solid blocks (sdf −0.5) outside the tiny settings' grid window
    in front of a camera at x = 6.56 m: (40, 0, 4); (41, 0, 4) in the excess
    list behind (−4055, 0, 4), which hashes to its bucket; (40, 1, 4),
    swapped out when `swapped`. Returns (volume, pose)."""
    h, gp = SETTINGS.hashing, SETTINGS.block_grid
    vol = hv.create_hash(h, grid_params=gp, device=device)
    vt = torch.zeros(h.n_entries, dtype=torch.int32, device=device)
    A, B, C, D = (40, 0, 4), (41, 0, 4), (-4055, 0, 4), (40, 1, 4)
    for group in ([C], [A, B, D]):
        blocks = torch.tensor(group, dtype=torch.int32, device=device)
        vol, vt, _w = hv.insert_blocks(vol, vt, blocks, torch.ones(len(group), dtype=torch.bool, device=device), h,
                                       gp)
    pr = hv.probe(vol, torch.tensor([A, B, D], dtype=torch.int32, device=device), h)
    assert bool(pr.found.all()) and int(pr.entry_idx[1]) >= h.n_buckets
    vol.vox[pr.entry_ptr.long()] = hv.pack_vox(hv.sdf_to_q(torch.full((h.block_volume,), -0.5, device=device)),
                                               torch.ones(h.block_volume, dtype=torch.int32, device=device))
    if swapped:
        ptr = vol.entry_ptr.clone()
        ptr[pr.entry_idx[2].long()] = hv.SWAPPED_PTR
        vol = vol._replace(entry_ptr=ptr)
    pose = torch.eye(4, device=device)
    pose[:3, 3] = torch.tensor([-6.56, -0.16, 0.0], device=device)
    return vol, pose


def test_k3h_finds_blocks_outside_the_grid(device):
    """Blocks the grid cannot see: K3h finds them (one through an excess
    link) as its plain twin does, and a swapped-out block reads as empty."""
    sp, h = SETTINGS.scene, SETTINGS.hashing
    proj = torch.as_tensor(default_calib(IMG[1], IMG[0]).intrinsics_d.vector, device=device)
    zmin = torch.full(IMG, sp.view_frustum_min, device=device)
    zmax = torch.full(IMG, sp.view_frustum_max, device=device)
    hits = {}
    for swapped in (False, True):
        vol, pose = far_blocks(device, swapped)
        args = (vol, h, se3.invert(pose), proj, IMG, 1.0 / sp.voxel_size, sp.mu, zmin, zmax)
        k = raycast.raycast_hash_probe(*args).points
        assert_raycast_matches_plain(k, raycast.raycast_hash_probe_plain(*args).points)
        assert_lockstep_equal(raycast.raycast_hash_probe_lockstep, args, k)
        hits[swapped] = k[..., 3] > 0
    assert int(hits[True].sum()) < int(hits[False].sum()) and not bool((hits[True] & ~hits[False]).any())


@pytest.fixture(scope="module")
def dense_fused(device):
    """3 synthetic frames through the dense frame loop on the card, at 2 cm
    in a 128³ array, with the loop's launch counts."""
    settings = SETTINGS.replace(plain=PlainVoxelArrayParams(size=(128, 128, 128), offset=(-64, -64, 0)))
    calib = default_calib(IMG[1], IMG[0])
    proj = torch.as_tensor(calib.intrinsics_d.vector, device=device)
    src = synth.SyntheticSource(calib, n_frames=3, img_size=IMG, device=device)
    vol, st = dp.create_engine_state(settings, IMG, device=device)
    build.reset_launch_counts()
    for _ in range(3):
        vol, st, _d = dp.process_frame_dense(vol, st, View(depth=src.get_images()[0]), proj, settings)
    torch.cuda.synchronize()
    return settings, proj, vol, st, build.launch_counts()


def test_k3d_matches_plain_and_the_dense_loop_launches_it(dense_fused, device):
    settings, proj, vol, st, counts = dense_fused
    iters = sum(TrackingParams(n_levels=3).iterations_per_level[:3])
    assert counts == dict.fromkeys(build.KERNELS, 0) | {"icp": 3 * iters, "raycast_dense": 3}
    sp = settings.scene
    zmin = torch.full(IMG, sp.view_frustum_min, device=device)
    zmax = torch.full(IMG, sp.view_frustum_max, device=device)
    args = (vol, settings.plain, se3.invert(st.pose), proj, IMG, 1.0 / sp.voxel_size, sp.mu, zmin, zmax)
    k = raycast.raycast_dense(*args).points
    p = raycast.raycast_dense_plain(*args).points
    assert int((p[..., 3] > 0).sum()) > 0.5 * IMG[0] * IMG[1]
    assert_raycast_matches_plain(k, p)
    assert_lockstep_equal(raycast.raycast_dense_lockstep, args, k)
    sentinel = torch.full((*IMG, 4), -7.0, device=device)
    for flag in (True, False):
        enable = torch.tensor(flag, device=device)
        out = raycast.raycast_dense(*args, enable=enable, out=sentinel.clone()).points
        assert torch.equal(out, k if flag else sentinel)
        assert_lockstep_equal(raycast.raycast_dense_lockstep, args, out, enable=enable, out=sentinel)
    with pytest.raises(ValueError):  # the sdf must match the array's size
        raycast.raycast_dense_cuda(vol._replace(sdf=vol.sdf[:-1]), *args[1:])


def test_dense_mesh_on_the_card_equals_the_cpu_mesh(dense_fused):
    from infinitam_tpu_torch.engine import meshing_engine

    settings, _proj, vol, _st, _c = dense_fused
    on_card = meshing_engine.mesh_scene_dense(vol, settings)
    on_cpu = meshing_engine.mesh_scene_dense(type(vol)(*(None if t is None else t.cpu() for t in vol)), settings)
    assert on_card.n_triangles == on_cpu.n_triangles > 1000
    np.testing.assert_allclose(on_card.triangles, on_cpu.triangles, rtol=0, atol=1e-6)


# ---- lane-indexed launches (torch.vmap, parallel/batch.py) ----------------


def lanes3(x, scales=(1.0, 1.001, 0.999)):
    """Three lanes of `x` (a [B]-stacked tensor), scaled per lane."""
    return torch.stack([x * s for s in scales])


def perturbed_poses(pose):
    """Three world→camera poses: `pose` and two nudged by ~1 mm / 0.06°."""
    d = torch.tensor([[0.0] * 6, [0.001, -0.001, 0.0005, 0.001, 0.0, -0.001],
                      [-0.0008, 0.0005, 0.001, -0.001, 0.001, 0.0]], device=pose.device)
    return torch.stack([se3.se3_exp(v) @ pose for v in d])


@pytest.mark.parametrize("weighted", [False, True], ids=["k1", "k1w"])
@pytest.mark.parametrize("level", [0, 2])
def test_lane_indexed_k1_at_b3(fused, level, weighted):
    d, vproj, pm, nm, proj, _ip, scene_pose, thresh, min_valid = k1_args(fused, level)
    depth = lanes3(d)
    inv = torch.stack([se3.invert(p) for p in perturbed_poses(se3.invert(_ip))])
    w = k1_weights(fused, level) if weighted else None

    def one(dl, ip):
        return icp.icp_gh(dl, vproj, pm, nm, proj, ip, scene_pose, thresh, min_valid, weights=w)

    build.reset_launch_counts()
    got = torch.vmap(one)(depth, inv)  # maps, intrinsics and weights shared (stride 0)
    counts = build.launch_counts()
    assert counts["icp_weighted" if weighted else "icp"] == 1 and sum(counts.values()) == 1
    for b in range(3):
        single = one(depth[b], inv[b])
        for x, y in zip(got, single):
            assert torch.equal(x[b], y), b
        p = icp.icp_gh_plain(depth[b], vproj, pm, nm, proj, inv[b], scene_pose, thresh, min_valid, weights=w)
        assert int(single.num_valid) == int(p.num_valid) > 0
        torch.testing.assert_close(single.hessian, p.hessian, rtol=1e-4, atol=1e-4 * float(p.hessian.abs().max()))
        torch.testing.assert_close(single.nabla, p.nabla, rtol=1e-4, atol=1e-4 * float(p.nabla.abs().max()))
    assert not torch.equal(got.hessian[0], got.hessian[1])


@pytest.mark.parametrize("color", [False, True], ids=["k2", "k2c"])
def test_lane_indexed_k2_at_b3(fused, fused_rgb, device, color):
    """Each lane fuses the frame from its own pose into its own copy of the
    volume; the list, the entries and the intrinsics are shared."""
    if color:
        _s, _p, vol, _rs, st, _d, _rgb, _c = fused_rgb
        args = list(k2c_args(fused_rgb, device, True))
        planes = (lanes3(vol.vox, (1, 1, 1)), lanes3(vol.vox_rgb, (1, 1, 1)))
    else:
        _s, _p, vol, _rs, st, _d, _c = fused
        args = list(k2_args(fused, device))
        planes = (lanes3(vol.vox, (1, 1, 1)),)
    poses = perturbed_poses(st.pose)
    pose_at = 5 if color else 4
    fn = integrate.integrate_rgbd if color else integrate.integrate_depth
    n = len(planes)

    def one(*a):
        call = list(args)
        call[pose_at] = a[n]
        fn(*a[:n], *call)
        return a[:n]

    ref = [tuple(p[b].clone() for p in planes) for b in range(3)]
    build.reset_launch_counts()
    torch.vmap(one)(*planes, poses)
    assert build.launch_counts()["integrate_color" if color else "integrate"] == 1
    for b in range(3):
        single = tuple(p.clone() for p in ref[b])
        one(*single, poses[b])
        plain = tuple(p.clone() for p in ref[b])
        call = list(args)
        call[pose_at] = poses[b]
        (integrate.integrate_rgbd_plain if color else integrate.integrate_depth_plain)(*plain, *call)
        for k in range(n):
            assert torch.equal(planes[k][b], single[k]) and torch.equal(single[k], plain[k]), (b, k)
            assert not torch.equal(single[k], ref[b][k])
    assert not torch.equal(planes[0][1], planes[0][2])


@pytest.mark.parametrize("reader", ["k3", "k3h", "k3d"])
def test_lane_indexed_k3_at_b3(fused, dense_fused, device, reader):
    """Three lanes with their own copy of the volume (lane 2's emptied), own
    camera and own enable flag (lane 1's false: its output keeps the
    sentinel); the intrinsics and the ranges shared."""
    if reader == "k3d":
        settings, proj, dvol, st, _c = dense_fused
        vox = torch.stack([dvol.sdf, dvol.sdf, torch.ones_like(dvol.sdf)])
    else:
        settings, proj, vol, rs, st, _depth, _c = fused
        vox = torch.stack([vol.vox, vol.vox, torch.full_like(vol.vox, hv.VOX_INIT)])
    sp = settings.scene
    zmin = torch.full(IMG, sp.view_frustum_min, device=device)
    zmax = torch.full(IMG, sp.view_frustum_max, device=device)
    inv = torch.stack([se3.invert(p) for p in perturbed_poses(st.pose)])
    enable = torch.tensor([True, False, True], device=device)
    out = torch.full((3, *IMG, 4), -7.0, device=device)
    tail = (IMG, 1.0 / sp.voxel_size, sp.mu, zmin, zmax)
    if reader == "k3":
        grid = hp.hv.get_block_grid(vol, settings.block_grid)
        kernel, plain = raycast.raycast_grid, raycast.raycast_grid_plain

        def head(v):
            return (vol._replace(vox=v), grid, settings.block_grid, settings.hashing)
    elif reader == "k3h":
        kernel, plain = raycast.raycast_hash_probe, raycast.raycast_hash_probe_plain

        def head(v):
            return (vol._replace(vox=v), settings.hashing)
    else:
        kernel, plain = raycast.raycast_dense, raycast.raycast_dense_plain

        def head(v):
            return (dvol._replace(sdf=v), settings.plain)

    def one(v, im, en, o):
        return kernel(*head(v), im, proj, *tail, enable=en, out=o).points

    ref = out.clone()
    build.reset_launch_counts()
    torch.vmap(one)(vox, inv, enable, out)
    counts = build.launch_counts()
    assert sum(counts.values()) == 1
    for b in range(3):
        single = one(vox[b], inv[b], enable[b], ref[b].clone())
        assert torch.equal(out[b], single), b
        p = plain(*head(vox[b]), inv[b], proj, *tail, enable=enable[b], out=ref[b].clone()).points
        if b == 0:
            assert_raycast_matches_plain(single, p)
        else:  # lane 1 switched off, lane 2 empty: no hit in either
            assert torch.equal(single[..., 3], p[..., 3])
    assert int((out[0][..., 3] > 0).sum()) > 0.5 * IMG[0] * IMG[1]
    assert torch.equal(out[1], ref[1]) and int((out[2][..., 3] > 0).sum()) == 0
    if reader != "k3":  # the lock-step design at B = 3, against the vmap launch
        fn = raycast.raycast_hash_probe_lockstep if reader == "k3h" else raycast.raycast_dense_lockstep
        lane_head = ((vol._replace(vox=vox, entry_pos=torch.stack([vol.entry_pos] * 3),
                                   entry_ptr=torch.stack([vol.entry_ptr] * 3),
                                   entry_offset=torch.stack([vol.entry_offset] * 3)), settings.hashing)
                     if reader == "k3h" else (dvol._replace(sdf=vox), settings.plain))
        o = ref.clone()
        fn(*lane_head, inv, proj, IMG, 1.0 / sp.voxel_size, sp.mu, torch.stack([zmin] * 3), torch.stack([zmax] * 3),
           enable=enable, out=o, lanes=3)
        assert torch.equal(o, out)


@pytest.mark.parametrize("reader, ranges", [("k3h", "end_mid_batch"), ("k3d", "end_mid_batch"),
                                           ("k3d", "leaving_the_array")])
def test_lookahead_designs_on_edge_rays(fused, dense_fused, device, reader, ranges):
    """Rays whose len_end falls inside a lookahead batch (ranges 4-12 voxels
    long, starting anywhere in the first 1.5 m of the frustum) and rays that
    leave the dense array (a camera 0.68 m inside its side, looking along +x,
    so the rays leave through the side a few steps in): the main path's
    design is held to the plain march, and the lock-step design equals it."""
    if reader == "k3d":
        settings, proj, vol, st, _c = dense_fused
        head = (vol, settings.plain)
        kernel, plain, lockstep = raycast.raycast_dense, raycast.raycast_dense_plain, raycast.raycast_dense_lockstep
    else:
        settings, proj, vol, rs, st, _depth, _c = fused
        head = (vol, settings.hashing)
        kernel, plain, lockstep = (raycast.raycast_hash_probe, raycast.raycast_hash_probe_plain,
                                   raycast.raycast_hash_probe_lockstep)
    sp = settings.scene
    pose = st.pose
    zmin = torch.full(IMG, sp.view_frustum_min, device=device)
    zmax = torch.full(IMG, sp.view_frustum_max, device=device)
    if ranges == "end_mid_batch":
        g = torch.Generator().manual_seed(11)
        zmin = zmin + torch.rand(IMG, generator=g).to(device) * 1.5
        zmax = zmin + sp.voxel_size * (4.0 + 8.0 * torch.rand(IMG, generator=g).to(device))
    else:  # at x = 0.6 m of the array's ±1.28 m, looking along +x
        R = torch.tensor([[0.0, 0.0, -1.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0]], device=device)
        pose = torch.eye(4, device=device)
        pose[:3, :3] = R
        pose[:3, 3] = -R @ torch.tensor([0.6, 0.0, 1.2], device=device)
    args = (*head, se3.invert(pose), proj, IMG, 1.0 / sp.voxel_size, sp.mu, zmin, zmax)
    k = kernel(*args).points
    assert_raycast_matches_plain(k, plain(*args).points)
    assert_lockstep_equal(lockstep, args, k)


def test_batched_replay_step_equals_the_unbatched_steps(device):
    """Two lanes with their own trajectories through parallel/batch.py for 3
    frames, against the same frames stepped lane by lane: one launch per
    kernel call of a frame, whatever B (30 K1 … here the 3-level tracker's,
    1 K2, 1 K3 a step), and poses that agree with the unbatched lanes'."""
    from infinitam_tpu_torch.parallel import batch as pb

    calib = default_calib(IMG[1], IMG[0])
    proj = torch.as_tensor(calib.intrinsics_d.vector, device=device)
    trajs = [torch.as_tensor(synth.make_trajectory(3, scale=1.0 - 0.15 * b), device=device) for b in range(2)]
    depths = [torch.stack([synth.render_depth(trajs[b][f], proj, IMG) for b in range(2)]) for f in range(3)]
    vol, rs, st = pb.batched_state_hash(SETTINGS, IMG, 2, device=device)
    step = pb.make_batched_step(SETTINGS)
    build.reset_launch_counts()
    for d in depths:
        vol, rs, st, metrics = step(vol, rs, st, View(depth=d), proj)
    torch.cuda.synchronize()
    iters = sum(TrackingParams(n_levels=3).iterations_per_level[:3])
    assert build.launch_counts() == dict.fromkeys(build.KERNELS, 0) | {"icp": 3 * iters, "integrate": 3,
                                                                       "raycast": 3}
    for b in range(2):
        v, r, s = hp.create_engine_state(SETTINGS, IMG, device=device)
        for d in depths:
            v, r, s, _diag = hp.process_frame_hash(v, r, s, View(depth=d[b]), proj, SETTINGS)
        c = [np.linalg.inv(x.cpu().numpy().astype(np.float64))[:3, 3] for x in (s.pose, st.pose[b])]
        assert np.linalg.norm(c[0] - c[1]) < 1e-4, b
        assert int(r.n_visible) > 100
    assert float(metrics["mean_valid"]) > 1000


@pytest.mark.parametrize("kind", ["hash", "dense"])
@pytest.mark.parametrize("cards", ["shared", "one_a_rank"])
def test_ranks_match_the_one_process_batched_step(device, kind, cards):
    """Two ranks (parallel/ranks.py, each its own process) replay 3 frames of
    B lanes (4 on the hash volume, 2 on a 128³ dense array), half a rank:
    sharing card 0 through gloo, or one card a rank through NCCL (skips
    with fewer than two cards), against the one-process batched step on
    card 0. Both ranks hold equal fleet metrics, and each launches its
    kernels as often as one unbatched frame. The dense lanes lie within
    1e-6 m of the one-process lanes (a rank's batch of one takes cuBLAS's
    and cuSOLVER's one-matrix kernels: ~1e-8 m apart here) and their
    metrics within 1e-6 relative. The hash lanes lie within 1e-6 m of the
    one-process lanes too: the allocator elects each contended bucket's
    winner by a max-reduction, so the blocks a frame places do not depend
    on the run. Their block sets are held within 4 blocks, mean_valid
    within 1%, mean_f within 5%, total_visible within 4 blocks a lane."""
    from infinitam_tpu_torch.parallel import batch as pb
    from infinitam_tpu_torch.parallel import ranks

    if cards == "one_a_rank" and torch.cuda.device_count() < 2:
        pytest.skip("one card a rank needs two cards")
    dense = kind == "dense"
    B, n = (2, 3) if dense else (4, 3)
    settings = SETTINGS.replace(plain=PlainVoxelArrayParams(size=(128, 128, 128), offset=(-64, -64, 0)))
    calib = default_calib(IMG[1], IMG[0])
    proj = torch.as_tensor(calib.intrinsics_d.vector, device=device)
    trajs = [torch.as_tensor(synth.make_trajectory(n, scale=1.0 - 0.15 * b), device=device) for b in range(B)]
    depths = torch.stack([torch.stack([synth.render_depth(trajs[b][f], proj, IMG) for b in range(B)])
                          for f in range(n)])
    if dense:
        state, step = pb.batched_state_dense(settings, IMG, B, device=device), pb.make_batched_step_dense(settings)
    else:
        state, step = pb.batched_state_hash(settings, IMG, B, device=device), pb.make_batched_step(settings)
    poses, metrics = [], []
    for d in depths:
        *state, m = step(*state, View(depth=d), proj)
        poses.append(state[-1].pose.clone())
        metrics.append(m)
    out = ranks.spawn(ranks.replay, 2, args=(settings, depths.cpu().numpy(), proj.cpu().numpy(), dense, None, None,
                                             cards == "shared"), timeout=300)
    assert [r["device"] for r in out] == (["cuda:0", "cuda:0"] if cards == "shared" else ["cuda:0", "cuda:1"])
    P = np.concatenate([r["poses"] for r in out], axis=1).astype(np.float64)
    one = torch.stack(poses).cpu().numpy().astype(np.float64)
    diff = np.linalg.norm(np.linalg.inv(P)[..., :3, 3] - np.linalg.inv(one)[..., :3, 3], axis=-1)
    assert float(diff.max()) < 1e-6, diff
    keys = ("mean_f", "mean_valid") if dense else ("mean_f", "mean_valid", "total_visible")
    bars = {"mean_f": 1e-6, "mean_valid": 1e-6} if dense else {"mean_f": 0.05, "mean_valid": 0.01}
    for k in keys:
        assert np.array_equal(out[0][k], out[1][k]), k
        want = np.array([float(m[k]) for m in metrics])
        if k == "total_visible":
            assert np.all(np.abs(out[0][k] - want) <= 4 * B), (k, out[0][k], want)
        else:
            assert np.all(np.abs(out[0][k] - want) <= bars[k] * np.abs(want)), (k, out[0][k], want)
    if not dense:
        pos, ptr = state[0].entry_pos.cpu().numpy(), state[0].entry_ptr.cpu().numpy()
        for r in out:
            for b in range(2):
                lane = r["lanes"][0] + b
                rank_set = set(map(tuple, r["state"][0]["entry_pos"][b][r["state"][0]["entry_ptr"][b] >= 0].tolist()))
                one_set = set(map(tuple, pos[lane][ptr[lane] >= 0].tolist()))
                assert len(rank_set ^ one_set) <= 4 and len(one_set) > 100, lane
    iters = sum(TrackingParams(n_levels=3).iterations_per_level[:3])
    per_frame = {"icp": iters, "raycast_dense": 1} if dense else {"icp": iters, "integrate": 1, "raycast": 1}
    for r in out:
        assert r["launches"] == dict.fromkeys(build.KERNELS, 0) | {k: v * n for k, v in per_frame.items()}
    assert float(out[0]["mean_valid"][-1]) > 1000
