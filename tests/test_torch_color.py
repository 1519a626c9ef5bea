"""Colour fusion of the port (ops/tsdf.py's colour half, K2's colour half in
ops/kernels/integrate.py, the colour plane of the hash volume, RGB rendering
and the colour frame loop) held to the JAX package on the CPU.

The bars are those the JAX package holds its own Pallas kernel to against
the XLA oracle (tests/test_pallas_integrate.py): the packed depth plane bit
for bit, each colour channel within 1 uint8 LSB and the colour weight exact.
Against the unjitted XLA integrate the plain K2 is bit-exact in colour too.
Under `jit` XLA's CPU compiler may contract the bilinear tap and the running
average into multiply-adds where PyTorch rounds every step, so the replay
keeps the 1 LSB bar.

The scene is the colour tests' own (tests/test_color_tracking.py: 2.5 cm
voxels, μ 10 cm) at 60×80, fused by the JAX package; the extrinsic case uses
a 2.5 cm baseline, a 1.5° rotation and other rgb intrinsics so that the rgb
projection differs from the depth one.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinitam_tpu.calib import default_calib
from infinitam_tpu.config import SceneParams, Settings, TrackingParams, VoxelBlockHashParams
from infinitam_tpu.engine import hash_pipeline as j_hp
from infinitam_tpu.engine import hash_volume as j_hv
from infinitam_tpu.engine.view_builder import View as JView
from infinitam_tpu.io import synth as j_synth
from infinitam_tpu.ops import tsdf as j_tsdf
from infinitam_tpu_torch import convert
from infinitam_tpu_torch.engine import captured
from infinitam_tpu_torch.engine import hash_pipeline as t_hp
from infinitam_tpu_torch.engine import hash_volume as t_hv
from infinitam_tpu_torch.engine.view_builder import View
from infinitam_tpu_torch.io import synth as t_synth
from infinitam_tpu_torch.ops import tsdf as t_tsdf
from infinitam_tpu_torch.ops.kernels import build
from infinitam_tpu_torch.ops.kernels import integrate as k_int

IMG = (60, 80)

# the tensors here are tiny: one intra-op thread per process keeps torch from
# contending for the cores with the other test workers (tier-1 runs under xdist)
torch.set_num_threads(1)
SETTINGS = Settings(
    scene=SceneParams(voxel_size=0.025, mu=0.1, view_frustum_min=0.3, view_frustum_max=3.0),
    hashing=VoxelBlockHashParams(n_buckets=0x4000, n_excess=0x400, n_blocks=0x1800, max_visible_blocks=0x1000),
    tracking=TrackingParams(n_levels=3, min_valid_points=50, color_n_levels=3),
    use_color=True,
)
CALIB = default_calib(IMG[1], IMG[0])
PROJ = CALIB.intrinsics_d.vector
N_FRAMES = 5
COUNTERS = ("n_alloc_overflow", "n_render_overflow", "n_pool_overflow", "n_too_big_blocks", "n_window_clipped")


def T(a):
    return torch.from_numpy(np.array(a))


def extrinsic() -> np.ndarray:
    """rgb → depth: 1.5° about y, 2.5 cm along x."""
    a = np.radians(1.5)
    M = np.eye(4, dtype=np.float32)
    M[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    M[:3, 3] = [0.025, 0.0, 0.0]
    return M


PROJ_RGB_OTHER = (PROJ * np.array([1.04, 1.03, 1.0, 1.0], np.float32) + np.array([0, 0, 1.5, -1.0], np.float32))

# integrate cases: (settings, proj_rgb, rgb_to_depth or None, enable)
CASES = {
    "identity": (SETTINGS, PROJ, None, True),
    "disabled": (SETTINGS, PROJ, None, False),
    "stop_at_max_w": (SETTINGS.replace(scene=dataclasses.replace(SETTINGS.scene, max_w=2,
                                                                 stop_integrating_at_max_w=True)), PROJ, None, True),
    "extrinsic": (SETTINGS, PROJ_RGB_OTHER, extrinsic(), True),
}


def pose_error(P, G):
    P, G = np.asarray(P, np.float64), np.asarray(G, np.float64)
    t = np.linalg.norm(np.linalg.inv(P)[:3, 3] - np.linalg.inv(G)[:3, 3])
    dR = P[:3, :3] @ G[:3, :3].T
    v = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]])
    return t, np.degrees(np.arctan2(0.5 * np.linalg.norm(v), 0.5 * (np.trace(dR) - 1.0)))


def rgb_by_block(vol) -> dict:
    d = convert.to_numpy(vol)
    live = d["entry_ptr"] >= 0
    return {tuple(p): d["vox_rgb"][r] for p, r in zip(d["entry_pos"][live].tolist(), d["entry_ptr"][live])}


def color_diff(a: np.ndarray, b: np.ndarray):
    """(max channel difference in LSB, channels differing, colour weights
    differing) between two packed colour planes."""
    a, b = a.view(np.uint32), b.view(np.uint32)
    ch = [np.abs(((a >> s) & 0xFF).astype(np.int32) - ((b >> s) & 0xFF).astype(np.int32)) for s in (24, 16, 8)]
    return max(int(c.max()) for c in ch), sum(int((c > 0).sum()) for c in ch), int(((a & 0xFF) != (b & 0xFF)).sum())


@pytest.fixture(scope="module")
def replay():
    """The JAX package and the port replay the same 5 RGB-D frames side by
    side; per frame: (JAX state, port state, JAX diag, port diag)."""
    src = j_synth.SyntheticSource(CALIB, n_frames=N_FRAMES, img_size=IMG, with_rgb=True)
    frames = [src.get_images() for _ in range(N_FRAMES)]
    v_j, r_j, s_j = j_hp.create_engine_state(SETTINGS, IMG)
    v_t, r_t, s_t = t_hp.create_engine_state(SETTINGS, IMG, device="cpu")
    out = []
    for depth, rgb, _gt in frames:
        v_j, r_j, s_j, d_j = j_hp.process_frame_hash(v_j, r_j, s_j, JView(depth=depth, rgb=rgb), jnp.asarray(PROJ),
                                                     SETTINGS, proj_rgb=jnp.asarray(PROJ))
        v_t, r_t, s_t, d_t = t_hp.process_frame_hash(v_t, r_t, s_t, View(depth=T(depth), rgb=T(rgb)), T(PROJ),
                                                     SETTINGS, proj_rgb=T(PROJ))
        # the port's step writes its state in place (captured.run): keep a
        # copy per frame
        out.append(((v_j, r_j, s_j), captured.tree_map(torch.clone, (v_t, r_t, s_t)), d_j, d_t))
    return frames, out


def test_update_voxel_color_matches_jax():
    rng = np.random.default_rng(1)
    rgb = rng.uniform(0, 1, (30, 40, 3)).astype(np.float32)
    # points that mostly project into the image, around the colour gate |η| ≤ μ/4
    u, v, z = rng.uniform([-2, -2, 0.5], [41, 31, 3], (6000, 3)).T
    pts = np.stack([(u - 19.5) * z / 50.0, (v - 14.5) * z / 50.0, z], -1).astype(np.float32)
    old_clr = (rng.integers(0, 256, (6000, 3)) / 255.0).astype(np.float32)
    old_wc = rng.integers(0, 100, 6000).astype(np.int32)
    eta = rng.uniform(-0.04, 0.04, 6000).astype(np.float32)
    eta[rng.uniform(size=6000) < 0.1] = -1.0
    updated = rng.uniform(size=6000) < 0.8
    M = extrinsic()
    proj = np.array([50.0, 51.0, 19.5, 14.5], np.float32)
    c_j, w_j = j_tsdf.update_voxel_color(jnp.asarray(old_clr), jnp.asarray(old_wc), jnp.asarray(pts), jnp.asarray(M),
                                         jnp.asarray(proj), jnp.asarray(rgb), jnp.asarray(eta), 0.1, 100,
                                         jnp.asarray(updated))
    c_t, w_t = t_tsdf.update_voxel_color(T(old_clr), T(old_wc), tuple(T(pts[:, i]) for i in range(3)), T(M), T(proj),
                                         T(rgb), T(eta), 0.1, 100, T(updated))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
    assert (w_t.numpy() != old_wc).sum() > 1000  # the gate let many through


@pytest.mark.parametrize("stop", [False, True])
def test_integrate_dense_matches_jax(stop):
    rng = np.random.default_rng(2)
    n = 6000
    depth = rng.uniform(0.5, 2.5, (30, 40)).astype(np.float32)
    rgb = rng.uniform(0, 1, (30, 40, 3)).astype(np.float32)
    # points within ±3 cm of the depth surface, so that many pass both gates
    u, v = rng.uniform([0, 0], [40, 30], (n, 2)).T
    z = depth[np.clip(np.round(v), 0, 29).astype(int), np.clip(np.round(u), 0, 39).astype(int)]
    z = z + rng.uniform(-0.03, 0.03, n)
    pts = np.stack([(u - 19.5) * z / 50.0, (v - 14.5) * z / 50.0, z], -1).astype(np.float32)
    sdf = rng.uniform(-1, 1, n).astype(np.float32)
    w = rng.integers(0, 4, n).astype(np.int32)
    clr = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    wc = rng.integers(0, 4, n).astype(np.int32)
    pose = np.eye(4, dtype=np.float32)
    proj = np.array([50.0, 50.0, 19.5, 14.5], np.float32)
    args = (pose, proj, depth, 0.1, 3)
    out_j = j_tsdf.integrate_dense(*(jnp.asarray(a) for a in (sdf, w, pts)), *(jnp.asarray(a) for a in args[:3]),
                                   *args[3:], stop_at_max_w=stop, vol_clr=jnp.asarray(clr), vol_wc=jnp.asarray(wc),
                                   M_rgb=jnp.asarray(extrinsic()), proj_rgb=jnp.asarray(proj), rgb=jnp.asarray(rgb))
    out_t = t_tsdf.integrate_dense(T(sdf), T(w), tuple(T(pts[:, i]) for i in range(3)), *(T(a) for a in args[:3]),
                                   *args[3:], stop_at_max_w=stop, vol_clr=T(clr), vol_wc=T(wc), M_rgb=T(extrinsic()),
                                   proj_rgb=T(proj), rgb=T(rgb))
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (out_t[3].numpy() != wc).sum() > 1000
    if stop:
        np.testing.assert_array_equal(out_t[2].numpy()[w >= 3], clr[w >= 3])


@pytest.mark.parametrize("oracle", ["xla", "pallas"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_k2_color_matches_jax(replay, case, oracle):
    """Plain K2 with colour vs the JAX package's XLA integrate_into_scene
    and its Pallas kernel (interpret mode), on the JAX state after 2 fused
    frames and frame 3's RGB-D."""
    frames, out = replay
    (vol, rs, st), _port, _dj, _dt = out[1]
    depth, rgb, _gt = frames[2]
    settings, proj_rgb, r2d, enable = CASES[case]
    jargs = dict(proj_rgb=jnp.asarray(proj_rgb), rgb_to_depth=None if r2d is None else jnp.asarray(r2d),
                 enable=jnp.asarray(enable))
    jview = JView(depth=depth, rgb=rgb)
    if oracle == "xla":
        ref = j_hp.integrate_into_scene(vol, rs, jview, st.pose, jnp.asarray(PROJ), settings, **jargs)
    else:
        ref = j_hp.integrate_into_scene_pallas(vol, rs, jview, st.pose, jnp.asarray(PROJ), settings, interpret=True,
                                               **jargs)
    vt = convert.from_numpy(t_hv.HashVolume, convert.to_numpy(vol), device="cpu")
    rt = convert.from_numpy(t_hv.RenderStateVH, convert.to_numpy(rs), device="cpu")
    out_t = t_hp.integrate_into_scene(vt, rt, View(depth=T(depth), rgb=T(rgb)), T(st.pose), T(PROJ), settings,
                                      proj_rgb=T(proj_rgb), rgb_to_depth=None if r2d is None else T(r2d),
                                      enable=torch.tensor(enable))
    assert out_t.vox_rgb is vt.vox_rgb  # in place
    np.testing.assert_array_equal(out_t.vox.numpy(), np.asarray(ref.vox))
    lsb, n_ch, n_wc = color_diff(out_t.vox_rgb.numpy(), np.asarray(ref.vox_rgb))
    n_updated = int((np.asarray(ref.vox_rgb) != np.asarray(vol.vox_rgb)).sum())
    assert lsb <= 1 and n_wc == 0, (lsb, n_wc)
    if oracle == "xla":
        # unjitted, XLA rounds every step as PyTorch does (measured: 0 of
        # 12,605 updated voxels differ); the Pallas kernel's bf16 bilinear
        # weights move ~20% of the channels by 1 LSB
        assert n_ch == 0, f"{n_ch} channels of {n_updated} updated voxels differ"
    if case == "stop_at_max_w":
        assert n_updated > 300  # most voxels are frozen at w = 2
    elif enable:
        assert n_updated > 10000  # not a vacuous pass
    else:
        np.testing.assert_array_equal(out_t.vox_rgb.numpy(), np.asarray(vol.vox_rgb))
    if case == "stop_at_max_w":
        frozen = ((np.asarray(vol.vox) >> 8) & 0xFF) >= 2
        assert frozen.sum() > 1000
        np.testing.assert_array_equal(out_t.vox_rgb.numpy()[frozen], np.asarray(vol.vox_rgb)[frozen])


def test_k2_color_wrapper_takes_plain_version_on_cpu(replay):
    frames, out = replay
    (vol, rs, st), _port, _dj, _dt = out[1]
    depth, rgb, _gt = frames[2]
    sp = SETTINGS.scene
    vt = convert.from_numpy(t_hv.HashVolume, convert.to_numpy(vol), device="cpu")
    rt = convert.from_numpy(t_hv.RenderStateVH, convert.to_numpy(rs), device="cpu")
    M_rgb = torch.linalg.inv(T(extrinsic())) @ T(st.pose)
    args = (rt.visible_ids, vt.entry_ptr, vt.entry_pos, T(depth), T(rgb), T(st.pose), T(PROJ), M_rgb,
            T(PROJ_RGB_OTHER), torch.tensor(True), sp.voxel_size, sp.mu, sp.max_w, False, 8, SETTINGS.max_fused_blocks)
    a = (vt.vox.clone(), vt.vox_rgb.clone())
    b = (vt.vox.clone(), vt.vox_rgb.clone())
    build.reset_launch_counts()
    k_int.integrate_rgbd(*a, *args)
    k_int.integrate_rgbd_plain(*b, *args)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert (a[1] != vt.vox_rgb).sum() > 3000
    assert build.launch_counts() == dict.fromkeys(build.KERNELS, 0)
    with pytest.raises(ValueError):  # the kernel path refuses CPU tensors
        k_int.integrate_rgbd_cuda(*a, *args)
    with pytest.raises(ValueError, match="8³ blocks only"):  # and blocks other than 8³
        k_int.integrate_rgbd_cuda(*a, *args[:14], 4)
    # the sentinel row takes the skipped rows and is left as it was
    sent = t_hv.sentinel_row(SETTINGS.hashing)
    np.testing.assert_array_equal(b[1][sent].numpy(), vt.vox_rgb[sent].numpy())


@pytest.mark.parametrize("case", ["interleaved", "capped"])
def test_plain_k2_color_visible_list_matches_xla_oracle(replay, case):
    """K2 with colour on edited visible lists, against the JAX package's XLA
    integrate_into_scene on the same state, with the 2.5 cm / 1.5° extrinsic:
    (interleaved) −1 rows between and after the live rows and an id whose
    entry has no block, the whole list fused (max_fused_blocks 0); (capped)
    max_fused_blocks at half the live rows (JAX package:
    hash_pipeline.py:722-723)."""
    frames, out = replay
    (vol, rs, st), _port, _dj, _dt = out[1]
    depth, rgb, _gt = frames[2]
    ids = np.asarray(rs.visible_ids)
    ptr = np.asarray(vol.entry_ptr)
    live = ids[(ids >= 0) & (ptr[np.clip(ids, 0, None)] >= 0)]
    if case == "interleaved":
        edited = np.full_like(ids, -1)
        edited[: 2 * len(live) : 2] = live
        edited[len(live) | 1] = np.flatnonzero(ptr < 0)[0]
        assert 2 * len(live) + 2 < len(ids)
        settings, rs = SETTINGS.replace(max_fused_blocks=0), rs._replace(visible_ids=jnp.asarray(edited))
    else:
        settings = SETTINGS.replace(max_fused_blocks=len(live) // 2)
    ref = j_hp.integrate_into_scene(vol, rs, JView(depth=depth, rgb=rgb), st.pose, jnp.asarray(PROJ), settings,
                                    proj_rgb=jnp.asarray(PROJ_RGB_OTHER), rgb_to_depth=jnp.asarray(extrinsic()))
    vt = convert.from_numpy(t_hv.HashVolume, convert.to_numpy(vol), device="cpu")
    rt = convert.from_numpy(t_hv.RenderStateVH, convert.to_numpy(rs), device="cpu")
    out_t = t_hp.integrate_into_scene(vt, rt, View(depth=T(depth), rgb=T(rgb)), T(st.pose), T(PROJ), settings,
                                      proj_rgb=T(PROJ_RGB_OTHER), rgb_to_depth=T(extrinsic()))
    np.testing.assert_array_equal(out_t.vox.numpy(), np.asarray(ref.vox))
    np.testing.assert_array_equal(out_t.vox_rgb.numpy(), np.asarray(ref.vox_rgb))
    n_updated = int((np.asarray(ref.vox_rgb) != np.asarray(vol.vox_rgb)).sum())
    assert n_updated > (10000 if case == "interleaved" else 3000)  # not a vacuous pass


def test_five_frame_color_replay_matches_jax(replay):
    """Poses to 1e-4 m / 0.01° (the bar of tests/test_torch_slice.py), the
    same blocks and visible lists, and the colour plane by block coordinate
    within 1 LSB with equal colour weights, every frame."""
    frames, out = replay
    for i, ((v_j, r_j, s_j), (v_t, r_t, s_t), d_j, d_t) in enumerate(out):
        t_err, r_err = pose_error(s_t.pose.numpy(), s_j.pose)
        assert t_err <= 1e-4 and r_err <= 0.01, f"frame {i}: {t_err:.2e} m, {r_err:.2e} deg"
        b_j, b_t = rgb_by_block(v_j), rgb_by_block(v_t)
        assert b_j.keys() == b_t.keys(), f"frame {i}"
        vis = [sorted(map(tuple, convert.to_numpy(v)["entry_pos"][ids[ids >= 0]].tolist()))
               for v, ids in ((v_j, np.asarray(r_j.visible_ids)), (v_t, r_t.visible_ids.numpy()))]
        assert vis[0] == vis[1], f"frame {i}"
        keys = sorted(b_j)
        lsb, _n_ch, n_wc = color_diff(np.stack([b_t[k] for k in keys]), np.stack([b_j[k] for k in keys]))
        assert lsb <= 1 and n_wc == 0, f"frame {i}: {lsb} LSB, {n_wc} weights differ"
        assert all(int(getattr(d_t, k)) == 0 == int(getattr(d_j, k)) for k in COUNTERS), f"frame {i}"
    wc = t_hv.rgb_wc(out[-1][1][0].vox_rgb)
    assert int((wc > 0).sum()) > 10000
    assert pose_error(out[-1][1][2].pose.numpy(), frames[-1][2])[0] < 0.01


def test_sequence_with_rgb_equals_frame_loop(replay):
    frames, out = replay
    depths = torch.stack([T(d) for d, _r, _g in frames[:2]])
    rgbs = torch.stack([T(r) for _d, r, _g in frames[:2]])
    state = t_hp.create_engine_state(SETTINGS, IMG, device="cpu")
    v, _r, _s, poses, diags = t_hp.process_sequence_hash(*state, depths, T(PROJ),
                                                        SETTINGS, rgbs=rgbs, proj_rgb=T(PROJ))
    np.testing.assert_array_equal(poses[1].numpy(), out[1][1][2].pose.numpy())
    np.testing.assert_array_equal(v.vox_rgb.numpy(), out[1][1][0].vox_rgb.numpy())
    assert diags.num_valid.shape == (2,)


def test_hash_state_with_color_matches_jax_and_converts_both_ways(replay):
    v_j = j_hv.create_hash(SETTINGS.hashing, with_color=True, grid_params=SETTINGS.block_grid)
    v_t = t_hv.create_hash(SETTINGS.hashing, with_color=True, grid_params=SETTINGS.block_grid, device="cpu")
    for name in v_j._fields:
        a, b = getattr(v_t, name), getattr(v_j, name)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert t_hv.create_hash(SETTINGS.hashing, device="cpu").vox_rgb is None
    # a fused JAX volume with colour → the port → numpy, unchanged
    _frames, out = replay
    vol = out[-1][0][0]
    back = convert.to_numpy(convert.from_numpy(t_hv.HashVolume, convert.to_numpy(vol), device="cpu"))
    for name in vol._fields:
        a, b = back[name], getattr(vol, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, np.asarray(b))
    assert (back["vox_rgb"] != 0).sum() > 10000


def test_rgbd_renderer_matches_jax():
    calib = default_calib(40, 30)
    src_j = j_synth.SyntheticSource(calib, n_frames=2, img_size=(30, 40), with_rgb=True)
    src_t = t_synth.SyntheticSource(calib, n_frames=2, img_size=(30, 40), with_rgb=True, device="cpu")
    for _ in range(2):
        d_j, c_j, _g = src_j.get_images()
        d_t, c_t, _g2 = src_t.get_images()
        d_j, c_j, d_t, c_t = np.asarray(d_j), np.asarray(c_j), d_t.numpy(), c_t.numpy()
        assert c_t.shape == c_j.shape == (30, 40, 3) and c_t.dtype == np.float32
        # hit masks as in tests/test_torch_basic_ops.py's renderer test
        both = (d_j > 0) & (d_t > 0)
        assert both.sum() > 500 and ((d_j > 0) == (d_t > 0)).mean() > 0.995
        assert np.abs(c_j[both] - c_t[both]).max() < 1e-3
        assert np.median(np.abs(c_j[both] - c_t[both])) < 1e-5
        assert (c_t[~(d_t > 0)] == 0).all()
        assert c_t[both].std() > 0.05
