"""The read paths beside K3's block grid, held to the JAX package on the CPU
at 60×80: the hash-probe raycast (`use_block_grid=False`: kernel K3h's plain
twin, the march over hash_volume.make_hash_reader), the coarse pre-pass
(`raycast_coarse_factor`, ops/raycast.py refine_ranges_from_coarse), the Ren
tracker and the weight image through the hash reader; and the incremental
raycast, `forward_project` and `forward_render` (ops/raycast.py).

Tolerances: the range refinement is exact; a raycast is held to the JAX
package's XLA march as in tests/test_torch_raycast.py (inside a jit XLA
rounds a ray an ulp apart: ≥ 99.9% of the hit mask equal, points within
1e-3 voxel), and on a map inside the block grid's window the hash and grid
readers give the port identical results; replays are held to 1e-4 m and
0.01° a frame, the bar of tests/test_torch_slice.py. XLA's scatter and the
port's pick an unspecified winner where several points land on one pixel:
forward_project's pixels are compared as sets there (each side's point one
of the colliding ones) and exactly (within 1e-5 voxel) elsewhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinitam_tpu.calib import default_calib
from infinitam_tpu.config import TrackerType, TrackingParams, tiny_test_settings
from infinitam_tpu.engine import hash_pipeline as j_hp
from infinitam_tpu.engine import hash_volume as j_hv
from infinitam_tpu.engine import trackers as j_tr
from infinitam_tpu.engine.view_builder import View as JView
from infinitam_tpu.io import synth as j_synth
from infinitam_tpu.ops import raycast as j_rc
from infinitam_tpu.utils import se3 as j_se3
from infinitam_tpu_torch import convert
from infinitam_tpu_torch.engine import hash_pipeline as t_hp
from infinitam_tpu_torch.engine import hash_volume as t_hv
from infinitam_tpu_torch.engine import trackers as t_tr
from infinitam_tpu_torch.engine.main_engine import MainEngine
from infinitam_tpu_torch.engine.view_builder import View
from infinitam_tpu_torch.ops import raycast as t_rc
from infinitam_tpu_torch.ops.kernels import build
from infinitam_tpu_torch.ops.kernels import raycast as k_ray
from infinitam_tpu_torch.utils import se3 as t_se3

IMG = (60, 80)
CALIB = default_calib(IMG[1], IMG[0])
PROJ = CALIB.intrinsics_d.vector
SETTINGS = tiny_test_settings().replace(tracking=TrackingParams(n_levels=3, min_valid_points=50))

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


def assert_raycasts_agree(out: np.ndarray, ref: np.ndarray, min_hits: float = 0.6):
    f_j, f_t = ref[..., 3] > 0, out[..., 3] > 0
    assert f_j.mean() > min_hits
    assert (f_j == f_t).mean() >= 0.999
    both = f_j & f_t
    assert np.abs(out[..., :3][both] - ref[..., :3][both]).max() < 1e-3


def to_jax(cls, state):
    return cls(**{k: None if v is None else jnp.asarray(v) for k, v in convert.to_numpy(state).items()})


@pytest.fixture(scope="module")
def scene():
    """JAX state after 3 fused frames, the same state in the port and the
    next camera pose moved off the last one."""
    src = j_synth.SyntheticSource(CALIB, n_frames=3, img_size=IMG)
    vol, rs, st = j_hp.create_engine_state(SETTINGS, IMG)
    for _ in range(3):
        depth, _r, _g = src.get_images()
        vol, rs, st, _d = j_hp.process_frame_hash(vol, rs, st, JView(depth=depth), jnp.asarray(PROJ), SETTINGS)
    pose = np.asarray(j_se3.se3_exp(jnp.array([0.01, -0.005, 0.02, 0.01, 0.02, -0.01], jnp.float32)) @ st.pose)
    vt = convert.from_numpy(t_hv.HashVolume, convert.to_numpy(vol), device="cpu")
    rt = convert.from_numpy(t_hv.RenderStateVH, convert.to_numpy(rs), device="cpu")
    return pose, vol, rs, vt, rt


def test_hash_probe_raycast_matches_jax(scene):
    pose, vol, rs, vt, rt = scene
    s = SETTINGS.replace(use_block_grid=False)
    ref = np.asarray(j_hp.raycast_hash(vol, rs, jnp.asarray(pose), jnp.asarray(PROJ), IMG, s).points)
    build.reset_launch_counts()
    out = t_hp.raycast_hash(vt, rt, T(pose), T(PROJ), IMG, s).points
    assert build.launch_counts() == dict.fromkeys(build.KERNELS, 0)  # the CPU takes the plain twins
    assert_raycasts_agree(out.numpy(), ref)
    # every block of this map lies in the grid's window: both readers agree exactly
    grid = t_hp.raycast_hash(vt, rt, T(pose), T(PROJ), IMG, SETTINGS).points
    assert torch.equal(out, grid)
    zmin, zmax, _n = t_hp.expected_depth_ranges(vt, rt, T(pose), T(PROJ), IMG, s)
    args = (vt, s.hashing, t_se3.invert(T(pose)), T(PROJ), IMG, 1.0 / s.scene.voxel_size, s.scene.mu, zmin, zmax)
    assert torch.equal(k_ray.raycast_hash_probe_plain(*args).points, out)
    with pytest.raises(ValueError):  # the kernel path refuses CPU tensors
        k_ray.raycast_hash_probe_cuda(*args)


def far_block_volume(swapped: bool):
    """A fresh port volume at the tiny settings holding three solid blocks
    (sdf −0.5, weight 1) outside the block grid's window, in front of a
    camera at x = 6.56 m: A (40, 0, 4) in its bucket, B (41, 0, 4) in the
    excess list behind C (−4055, 0, 4), which hashes to B's bucket and was
    inserted first, and D (40, 1, 4), marked swapped out when `swapped`.
    Returns (volume, camera pose, B's entry index)."""
    hp, gp = SETTINGS.hashing, SETTINGS.block_grid
    vol = t_hv.create_hash(hp, grid_params=gp, device="cpu")
    vt = torch.zeros(hp.n_entries, dtype=torch.int32)
    A, B, C, D = (40, 0, 4), (41, 0, 4), (-4055, 0, 4), (40, 1, 4)
    for group in ([C], [A, B, D]):
        blocks = torch.tensor(group, dtype=torch.int32)
        vol, vt, _w = t_hv.insert_blocks(vol, vt, blocks, torch.ones(len(group), dtype=torch.bool), hp, gp)
    pr = t_hv.probe(vol, torch.tensor([A, B, D], dtype=torch.int32), hp)
    assert bool(pr.found.all())
    solid = t_hv.pack_vox(t_hv.sdf_to_q(torch.full((hp.block_volume,), -0.5)), torch.ones(hp.block_volume,
                                                                                            dtype=torch.int32))
    vol.vox[pr.entry_ptr.long()] = solid
    if swapped:
        ptr = vol.entry_ptr.clone()
        ptr[pr.entry_idx[2].long()] = t_hv.SWAPPED_PTR
        vol = vol._replace(entry_ptr=ptr)
    pose = torch.eye(4)
    pose[:3, 3] = torch.tensor([-6.56, -0.16, 0.0])
    return vol, pose, int(pr.entry_idx[1])


def test_hash_reader_finds_blocks_outside_the_grid():
    """K3h's plain twin against the JAX march over its hash reader on blocks
    the grid reader cannot see: one reached through an excess link, and a
    swapped-out one, which reads as empty."""
    hp, sp = SETTINGS.hashing, SETTINGS.scene
    hits = {}
    for swapped in (False, True):
        vol, pose, b_idx = far_block_volume(swapped)
        assert b_idx >= hp.n_buckets  # B sits in the excess list
        zmin, zmax = torch.full(IMG, sp.view_frustum_min), torch.full(IMG, sp.view_frustum_max)
        inv = t_se3.invert(pose)
        args = (inv, T(PROJ), IMG, 1.0 / sp.voxel_size, sp.mu, zmin, zmax)
        out = k_ray.raycast_hash_probe(vol, hp, *args).points.numpy()
        jvol = to_jax(j_hv.HashVolume, vol)
        ref = np.asarray(j_rc.generic_raycast(j_hv.make_hash_reader(jvol, hp), *(jnp.asarray(a.numpy()) if
                                              torch.is_tensor(a) else a for a in args)).points)
        np.testing.assert_array_equal(out[..., 3], ref[..., 3])
        hit = out[..., 3] > 0
        assert np.abs(out[..., :3][hit] - ref[..., :3][hit]).max() < 1e-3
        grid = t_hv.build_block_grid(vol, SETTINGS.block_grid)
        assert int((grid >= 0).sum()) == 0  # the grid sees none of them
        assert float(k_ray.raycast_grid(vol, grid, SETTINGS.block_grid, hp, *args).points[..., 3].sum()) == 0.0
        hits[swapped] = hit
        # B, reached through its chain, is hit: some hit lies within a voxel of it
        b_lo = np.array([41, 0, 4]) * 8
        near_b = ((out[..., :3] >= b_lo - 1) & (out[..., :3] <= b_lo + 9)).all(-1) & hit
        assert near_b.sum() > 0
    # the swapped-out block reads as empty: its pixels go from hit to miss
    assert hits[True].sum() < hits[False].sum() and not (hits[True] & ~hits[False]).any()


def test_refine_ranges_from_coarse_matches_jax():
    """Random coarse hits with misses, one of them in column 0, so the 3×3
    neighbourhoods of the last column wrap onto it (jnp.roll)."""
    rng = np.random.default_rng(7)
    Hc, Wc, c = 15, 20, 4
    H, W = Hc * c, Wc * c
    pts = np.concatenate([rng.uniform(-40, 40, (Hc, Wc, 2)), rng.uniform(30, 120, (Hc, Wc, 1)),
                          (rng.random((Hc, Wc, 1)) > 0.06).astype(np.float64)], -1).astype(np.float32)
    pts[3:6, Wc - 4:, 3] = pts[3:6, :3, 3] = 1.0
    pts[4, 0, 3] = 0.0  # the miss at (4, 0), alone in its neighbourhood
    M = np.asarray(j_se3.se3_exp(jnp.asarray(rng.normal(0, 0.05, 6).astype(np.float32))))
    zmin0 = rng.uniform(0.2, 0.6, (H, W)).astype(np.float32)
    zmax0 = rng.uniform(2.0, 3.0, (H, W)).astype(np.float32)
    args = (0.02, (H, W), c, 0.16)
    ref = j_rc.refine_ranges_from_coarse(jnp.asarray(pts), jnp.asarray(M), *args, jnp.asarray(zmin0),
                                         jnp.asarray(zmax0))
    out = t_rc.refine_ranges_from_coarse(T(pts), T(M), *args, T(zmin0), T(zmax0))
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (out[0].numpy() != zmin0).mean() > 0.3  # most pixels tightened
    # with ranges wider than any coarse depth, a pixel keeps its ranges
    # exactly where its coarse 3×3 neighbourhood holds a miss; the last
    # column's neighbourhood at coarse row 4 wraps onto the miss at (4, 0)
    wide0, wide1 = np.full((H, W), 0.01, np.float32), np.full((H, W), 100.0, np.float32)
    zmin, zmax = (a.numpy() for a in t_rc.refine_ranges_from_coarse(T(pts), T(M), *args, T(wide0), T(wide1)))
    ok = np.ones((Hc, Wc), bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ok &= np.roll(pts[..., 3] > 0, (dy, dx), axis=(0, 1))
    up = ok.repeat(c, 0).repeat(c, 1)
    np.testing.assert_array_equal(zmin != wide0, up)
    np.testing.assert_array_equal(zmax != wide1, up)
    assert not ok[4, Wc - 1] and ok[4, Wc - 3]


@pytest.mark.parametrize("factor,use_grid", [(2, True), (4, True), (7, True), (2, False)],
                         ids=["c2", "c4", "c7_not_dividing", "c2_hash_probe"])
def test_coarse_raycast_matches_jax(scene, factor, use_grid):
    """The coarse pass (every intrinsic divided by c, the JAX package's
    `proj / c`) then the full launch, against JAX raycast_hash with the same
    settings; c = 7 divides neither 60 nor 80, so no coarse pass runs."""
    pose, vol, rs, vt, rt = scene
    s = SETTINGS.replace(raycast_coarse_factor=factor, use_block_grid=use_grid)
    ref = np.asarray(j_hp.raycast_hash(vol, rs, jnp.asarray(pose), jnp.asarray(PROJ), IMG, s).points)
    out = t_hp.raycast_hash(vt, rt, T(pose), T(PROJ), IMG, s).points
    assert_raycasts_agree(out.numpy(), ref)
    if factor == 7:
        assert torch.equal(out, t_hp.raycast_hash(vt, rt, T(pose), T(PROJ), IMG, SETTINGS).points)


@pytest.mark.parametrize("extra", [dict(use_block_grid=False), dict(raycast_coarse_factor=2)],
                         ids=["hash_probe", "coarse2"])
def test_five_frame_replay_matches_jax(extra):
    s = SETTINGS.replace(**extra)
    src = j_synth.SyntheticSource(CALIB, n_frames=5, img_size=IMG)
    v_j, r_j, s_j = j_hp.create_engine_state(s, IMG)
    v_t, r_t, s_t = t_hp.create_engine_state(s, IMG, device="cpu")
    build.reset_launch_counts()
    for i in range(5):
        depth, _r, gt = src.get_images()
        v_j, r_j, s_j, d_j = j_hp.process_frame_hash(v_j, r_j, s_j, JView(depth=depth), jnp.asarray(PROJ), s)
        v_t, r_t, s_t, d_t = t_hp.process_frame_hash(v_t, r_t, s_t, View(depth=T(depth)), T(PROJ), s)
        t_err, r_err = pose_error(s_t.pose.numpy(), s_j.pose)
        assert t_err <= 1e-4 and r_err <= 0.01, f"frame {i}: {t_err:.2e} m, {r_err:.2e} deg"
        assert int(d_t.n_visible) == int(d_j.n_visible)
        if i > 0:
            assert abs(int(d_t.num_valid) - int(d_j.num_valid)) <= max(3, int(d_j.num_valid) // 500)
    assert pose_error(s_t.pose.numpy(), np.asarray(gt))[0] < 0.01
    assert build.launch_counts() == dict.fromkeys(build.KERNELS, 0)


def test_ren_reads_through_the_hash(scene):
    """Ren's SDF LM over the hash reader against the JAX package's, from the
    last pose of a 3-frame map to a camera moved by a small twist; and the
    port's REN frame step gives the same poses through either reader on a
    map inside the grid's window."""
    pose, vol, _rs, vt, _rt = scene
    twist = np.array([0.004, -0.003, 0.004, 0.002, -0.003, 0.002], np.float32)
    start = np.asarray(j_se3.invert(j_se3.se3_exp(jnp.array([0.01, -0.005, 0.02, 0.01, 0.02, -0.01],
                                                            jnp.float32))) @ jnp.asarray(pose))
    gt = np.asarray(j_se3.se3_exp(jnp.asarray(twist)) @ jnp.asarray(start))
    depth2 = np.asarray(j_synth.render_depth(jnp.asarray(gt), jnp.asarray(PROJ), IMG))
    vs, tp = SETTINGS.scene.voxel_size, SETTINGS.tracking
    tr_j = j_tr.track_ren(jnp.asarray(start), jnp.asarray(depth2), jnp.asarray(PROJ),
                          j_hv.make_hash_reader(vol, SETTINGS.hashing), vs, tp)
    tr_t = t_tr.track_ren(T(start), T(depth2), T(PROJ), t_hv.make_hash_reader(vt, SETTINGS.hashing), vs, tp)
    t_err, r_err = pose_error(tr_t.pose.numpy(), tr_j.pose)
    assert t_err <= 1e-4 and r_err <= 0.01, (t_err, r_err)
    assert int(tr_t.num_valid) == int(tr_j.num_valid) > 1000

    src = j_synth.SyntheticSource(CALIB, n_frames=2, img_size=IMG)
    frames = [T(src.get_images()[0]) for _ in range(2)]
    poses = {}
    for use_grid in (True, False):
        s = SETTINGS.replace(tracker_type=TrackerType.REN, use_block_grid=use_grid)
        v, r, st_t = t_hp.create_engine_state(s, IMG, device="cpu")
        for d in frames:
            v, r, st_t, _d = t_hp.process_frame_hash(v, r, st_t, View(depth=d), T(PROJ), s)
        poses[use_grid] = st_t.pose
    assert torch.equal(poses[True], poses[False])


def test_weight_image_reads_through_the_hash():
    """MainEngine's weight image with use_block_grid=False reads through
    make_hash_weight_reader: the image equals the grid reader's on a map
    inside the window, and the reader equals the JAX package's."""
    src = j_synth.SyntheticSource(CALIB, n_frames=3, img_size=IMG)
    frames = [np.asarray(src.get_images()[0]) for _ in range(3)]
    engines = {}
    for use_grid in (True, False):
        eng = MainEngine(SETTINGS.replace(use_block_grid=use_grid), CALIB, IMG, device="cpu")
        for d in frames:
            eng.process_frame(metric_depth=d)
        engines[use_grid] = eng
    img = engines[False].get_image("weight")
    np.testing.assert_array_equal(img, engines[True].get_image("weight"))
    assert (img[..., :3] > 0).any(-1).mean() > 0.3
    vt = engines[False].vol
    rng = np.random.default_rng(5)
    ids = np.nonzero(vt.entry_ptr.numpy() >= 0)[0]
    pts = (vt.entry_pos.numpy()[rng.choice(ids, 2000)] * 8 + rng.integers(-4, 12, (2000, 3))).astype(np.int32)
    w_t, f_t = t_hv.make_hash_weight_reader(vt, SETTINGS.hashing)(T(pts))
    w_j, f_j = j_hv.make_hash_weight_reader(to_jax(j_hv.HashVolume, vt), SETTINGS.hashing)(jnp.asarray(pts))
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    assert (w_t.numpy() > 0).mean() > 0.1


@pytest.fixture(scope="module")
def forward_case(scene):
    """The JAX package's 60×80 raycast map of the scene at its last pose
    (metres, w = ±1), a new pose and its expected-depth ranges, in both
    packages."""
    pose, vol, rs, vt, rt = scene
    sp = SETTINGS.scene
    grid = j_hv.build_block_grid(vol, SETTINGS.block_grid, SETTINGS.hashing)
    read_j = j_hv.make_grid_reader(vol, grid, SETTINGS.block_grid, SETTINGS.hashing)
    old = j_se3.invert(jnp.asarray(pose))  # the scene's last camera, the pose the map was cast from
    zmin, zmax, _n = j_hp.expected_depth_ranges(vol, rs, jnp.asarray(np.linalg.inv(np.asarray(old))), jnp.asarray(PROJ),
                                                IMG, SETTINGS)
    cast = j_rc.generic_raycast(read_j, old, jnp.asarray(PROJ), IMG, 1.0 / sp.voxel_size, sp.mu, zmin, zmax)
    pts = np.asarray(cast.points)
    prev = np.concatenate([pts[..., :3] * sp.voxel_size, np.where(pts[..., 3:] > 0, 1.0, -1.0)], -1)
    new_pose = np.asarray(j_se3.se3_exp(jnp.array([0.01, 0.005, -0.008, 0.004, -0.006, 0.003], jnp.float32))
                          @ jnp.asarray(pose))
    zmin_n, zmax_n, _n = j_hp.expected_depth_ranges(vol, rs, jnp.asarray(new_pose), jnp.asarray(PROJ), IMG, SETTINGS)
    return prev.astype(np.float32), new_pose, np.asarray(zmin_n), np.asarray(zmax_n), read_j


def collisions(prev, M, proj, one_over_voxel_size):
    """{flat pixel: [payloads]} of the points forward_project lands on each
    pixel (numpy, float64 projection of the same rule)."""
    H, W = IMG
    fx, fy, cx, cy = proj
    pc = prev[..., :3].reshape(-1, 3).astype(np.float64) @ M[:3, :3].T.astype(np.float64) + M[:3, 3]
    z = np.where(pc[:, 2] <= 0, 1.0, pc[:, 2])
    u, v = fx * pc[:, 0] / z + cx, fy * pc[:, 1] / z + cy
    ok = (prev[..., 3].reshape(-1) > 0) & (pc[:, 2] > 0) & (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    out = {}
    for i in np.nonzero(ok)[0]:
        key = int(np.clip(int(v[i] + 0.5), 0, H - 1)) * W + int(np.clip(int(u[i] + 0.5), 0, W - 1))
        out.setdefault(key, []).append(prev.reshape(-1, 4)[i, :3] * one_over_voxel_size)
    return out


@pytest.mark.parametrize("back", [0.0, 0.4], ids=["near", "stepped_back"])
def test_forward_project_matches_jax(forward_case, back):
    """At the new pose, and 40 cm further back, where the map shrinks in the
    image and several points land on one pixel."""
    prev, M, _zmin, _zmax, _read = forward_case
    M = M.copy()
    M[2, 3] += back
    inv_v = 1.0 / SETTINGS.scene.voxel_size
    ref = np.asarray(j_rc.forward_project(jnp.asarray(prev), jnp.asarray(M), jnp.asarray(PROJ), IMG, inv_v))
    out = t_rc.forward_project(T(prev), T(M), T(PROJ), IMG, inv_v).numpy()
    hit_j, hit_t = ref[..., 3] > 0, out[..., 3] > 0
    assert hit_j.mean() > 0.5
    # pixels a float32 rounding puts on either side of a pixel edge: few
    assert (hit_j != hit_t).mean() < 0.002
    cands = collisions(prev, M, PROJ, inv_v)
    n_multi = 0
    for key in np.nonzero((hit_j & hit_t).reshape(-1))[0]:
        got, want = out.reshape(-1, 4)[key, :3], ref.reshape(-1, 4)[key, :3]
        c = cands.get(int(key), [])
        if len(c) > 1:
            n_multi += 1
            assert min(np.abs(got - x).max() for x in c) < 1e-5
            assert min(np.abs(want - x).max() for x in c) < 1e-5
        else:
            assert np.abs(got - want).max() < 1e-5
    assert (n_multi > 100) == (back > 0)  # stepped back, many pixels collide


def test_forward_render_matches_jax(scene, forward_case):
    _pose, _vol, _rs, vt, _rt = scene
    prev, M, zmin, zmax, read_j = forward_case
    sp = SETTINGS.scene
    inv_v = 1.0 / sp.voxel_size
    ref = np.asarray(j_rc.forward_render(read_j, jnp.asarray(prev), jnp.asarray(M), jnp.asarray(PROJ), IMG, inv_v,
                                         sp.mu, jnp.asarray(zmin), jnp.asarray(zmax)).points)
    read_t = t_hv.make_grid_reader(vt, t_hv.get_block_grid(vt, SETTINGS.block_grid), SETTINGS.block_grid,
                                   SETTINGS.hashing)
    out = t_rc.forward_render(read_t, T(prev), T(M), T(PROJ), IMG, inv_v, sp.mu, T(zmin), T(zmax)).points.numpy()
    fwd = t_rc.forward_project(T(prev), T(M), T(PROJ), IMG, inv_v).numpy()
    filled = fwd[..., 3] <= 0
    assert filled.sum() > 50  # missing pixels the march filled in
    # the marched pixels are a raycast: held to the XLA march's bar
    assert_raycasts_agree(np.where(filled[..., None], out, 0), np.where(filled[..., None], ref, 0), min_hits=0.0)
    assert ((out[..., 3] > 0) == (ref[..., 3] > 0)).mean() >= 0.998
    # and the whole image covers the full raycast's hits, as tests/test_extras.py asks of JAX
    full = t_rc.generic_raycast(read_t, t_se3.invert(T(M)), T(PROJ), IMG, inv_v, sp.mu, T(zmin), T(zmax)).points
    f_full = full[..., 3].numpy() > 0
    assert (out[..., 3] > 0)[f_full].mean() > 0.8
    assert build.launch_counts()["raycast"] == 0
