"""Batched multi-sequence SLAM in the port (parallel/batch.py), held to the
JAX package's parallel/batch.py and to the port's own unbatched step, on the
CPU.

The settings are tests/test_parallel.py's (48×64, a small hash table), with
B = 3 lanes replaying make_trajectory(4, scale=0.5 + 0.15·b). Each frame
starts both sides from the same state (the JAX state converted), so a
difference is that frame's own and does not compound.

1. The JAX `make_batched_step(SETTINGS)` against the port's, each lane
   also against JAX `process_frame_hash` on that lane from the same state.
   JAX's two answers differ: its batched step strays from its unbatched one
   by up to 1.3e-4 m and 0.044° (frame 3, lane 2; its vmapped products
   round otherwise, and a Gauss-Newton step that lands on the other side of
   the convergence threshold amplifies that). Each port lane's pose lies
   within 1e-4 m and 0.01° of the nearer of the two (1.3e-7 m measured) and
   within 5e-4 m and 0.1° of both. The allocated
   and the visible block sets differ from either by at most 4 blocks (a pose
   that differs by float32 noise moves a band ray across a block face; the
   same bound as the compact allocator's against its oracle,
   tests/test_hash_pipeline.py), and the metrics agree with the JAX batched
   step's: mean_valid within 1%, mean_f within 5%, total_visible within 4
   blocks a lane.
2. The port's batched step against B unbatched `process_frame_hash` runs
   from the same state: poses within 1e-6 m (the batched 4×4 products round
   differently: 1e-8 measured), block and visible sets equal.
3. The same two for `make_batched_step_dense` on the JAX package's small
   dense array (128×128×100), B = 2: poses within 1e-4 m and 0.01° of the
   JAX batched step and 1e-6 m of the unbatched port; the lane's sdf within
   1e-5 of the unbatched one's, its weights equal but at ≤ 1 voxel in
   10,000 fused ones, by 1.
4. The kernels' custom ops under `torch.vmap` with the intrinsics shared
   (in_dims None): K1, K2, K3 and K3d equal lane for lane to their
   unbatched calls (on the CPU both are the plain version), the mutated
   volume and output written through the vmap rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinitam_tpu.calib import default_calib
from infinitam_tpu.config import PlainVoxelArrayParams, SceneParams, Settings, TrackingParams, VoxelBlockHashParams
from infinitam_tpu.engine import dense_pipeline as j_dp
from infinitam_tpu.engine import hash_pipeline as j_hp
from infinitam_tpu.engine.view_builder import View as JView
from infinitam_tpu.io import synth as j_synth
from infinitam_tpu.parallel import batch as j_pb
from infinitam_tpu_torch import convert
from infinitam_tpu_torch.engine import dense_pipeline as t_dp
from infinitam_tpu_torch.engine import hash_pipeline as t_hp
from infinitam_tpu_torch.engine import hash_volume as t_hv
from infinitam_tpu_torch.engine import volume as t_vol
from infinitam_tpu_torch.engine.tracking_state import TrackingState
from infinitam_tpu_torch.engine.view_builder import View
from infinitam_tpu_torch.ops.kernels import build
from infinitam_tpu_torch.ops.kernels import icp as k_icp
from infinitam_tpu_torch.ops.kernels import integrate as k_int
from infinitam_tpu_torch.ops.kernels import raycast as k_ray
from infinitam_tpu_torch.parallel import batch as t_pb
from infinitam_tpu_torch.utils import se3 as t_se3

IMG = (48, 64)
B = 3
N_FRAMES = 4
SETTINGS = Settings(
    scene=SceneParams(voxel_size=0.025, mu=0.1, view_frustum_min=0.3, view_frustum_max=3.0),
    hashing=VoxelBlockHashParams(n_buckets=0x2000, n_excess=0x200, n_blocks=0x800, max_visible_blocks=0x400),
    tracking=TrackingParams(n_levels=3, min_valid_points=50),
)
DENSE = Settings(
    scene=SceneParams(voxel_size=0.025, mu=0.1, view_frustum_min=0.3, view_frustum_max=3.0),
    plain=PlainVoxelArrayParams(size=(128, 128, 100), offset=(-64, -64, 0)),
    tracking=TrackingParams(n_levels=3, min_valid_points=50),
)
CALIB = default_calib(IMG[1], IMG[0])
PROJ = np.asarray(CALIB.intrinsics_d.vector, dtype=np.float32)

# the tensors here are tiny: one intra-op thread per process keeps torch from
# contending for the cores with the other test workers (tier-1 runs under xdist)
torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def depths():
    """[N_FRAMES, B, H, W] depth of lane b's trajectory, scale 0.5 + 0.15·b."""
    trajs = [j_synth.make_trajectory(N_FRAMES, scale=0.5 + 0.15 * b) for b in range(B)]
    proj = jnp.asarray(PROJ)
    return np.stack([np.stack([np.asarray(j_synth.render_depth(jnp.asarray(trajs[b][f]), proj, IMG))
                               for b in range(B)]) for f in range(N_FRAMES)])


def pose_error(P, G):
    """(camera-centre distance in metres, rotation angle in degrees) in float64."""
    P, G = np.asarray(P, np.float64), np.asarray(G, np.float64)
    t = np.linalg.norm(np.linalg.inv(P)[:3, 3] - np.linalg.inv(G)[:3, 3])
    dR = P[:3, :3] @ G[:3, :3].T
    v = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]])
    return t, np.degrees(np.arctan2(0.5 * np.linalg.norm(v), 0.5 * (np.trace(dR) - 1.0)))


def block_sets(vol, rs, b=None):
    """(allocated blocks, visible blocks) as sets of coordinates, of lane b
    of a batched state (or of an unbatched one)."""
    d, r = convert.to_numpy(vol), convert.to_numpy(rs)
    pos, ptr, ids = d["entry_pos"], d["entry_ptr"], r["visible_ids"]
    if b is not None:
        pos, ptr, ids = pos[b], ptr[b], ids[b]
    return set(map(tuple, pos[ptr >= 0].tolist())), set(map(tuple, pos[ids[ids >= 0]].tolist()))


def to_port(state):
    """The port's (HashVolume, RenderStateVH, TrackingState) of a batched JAX state."""
    vol, rs, st = state
    return (convert.from_numpy(t_hv.HashVolume, convert.to_numpy(vol), device="cpu"),
            convert.from_numpy(t_hv.RenderStateVH, convert.to_numpy(rs), device="cpu"),
            convert.from_numpy(TrackingState, convert.to_numpy(st), device="cpu"))


def lane(tree, b):
    """Lane b of a batched NamedTuple (a copy)."""
    return type(tree)(*(None if x is None else x[b].clone() for x in tree))


def test_batched_step_matches_jax(depths):
    jstate = j_pb.batched_state_hash(SETTINGS, IMG, B)
    jstep = j_pb.make_batched_step(SETTINGS)
    jone = jax.jit(lambda v, r, s, d: j_hp.process_frame_hash(v, r, s, JView(depth=d), jnp.asarray(PROJ), SETTINGS))
    tstep = t_pb.make_batched_step(SETTINGS)
    projs = jnp.tile(jnp.asarray(PROJ)[None], (B, 1))
    build.reset_launch_counts()
    for f in range(N_FRAMES):
        vt, rt, st = to_port(jstate)
        ones = [jone(*jax.tree_util.tree_map(lambda x, b=b: x[b], jstate), jnp.asarray(depths[f][b]))
                for b in range(B)]
        *jstate, mj = jstep(*jstate, JView(depth=jnp.asarray(depths[f])), projs)
        vt, rt, st, mt = tstep(vt, rt, st, View(depth=T(depths[f])), T(PROJ))
        for b, (v1, r1, s1, _d1) in enumerate(ones):
            errs = [pose_error(np.asarray(p), st.pose[b].numpy()) for p in (s1.pose, jstate[2].pose[b])]
            assert any(t < 1e-4 and r < 0.01 for t, r in errs), (f, b, errs)
            assert all(t < 5e-4 and r < 0.1 for t, r in errs), (f, b, errs)
            alloc_t, vis_t = block_sets(vt, rt, b)
            for alloc_j, vis_j in (block_sets(*jstate[:2], b), block_sets(v1, r1)):
                assert len(alloc_j ^ alloc_t) <= 4 and len(vis_j ^ vis_t) <= 4, (f, b)
            assert len(vis_t) > 100
        assert abs(float(mt["mean_valid"]) - float(mj["mean_valid"])) <= 0.01 * float(mj["mean_valid"])
        assert abs(float(mt["mean_f"]) - float(mj["mean_f"])) <= 0.05 * float(mj["mean_f"])
        assert abs(int(mt["total_visible"]) - int(mj["total_visible"])) <= 4 * B
    assert float(mt["mean_valid"]) > 100
    assert build.launch_counts() == dict.fromkeys(build.KERNELS, 0)  # the CPU takes the plain twins


def test_batched_step_matches_unbatched(depths):
    vol, rs, st = t_pb.batched_state_hash(SETTINGS, IMG, B, device="cpu")
    step = t_pb.make_batched_step(SETTINGS)
    for f in range(N_FRAMES):
        lanes = [(lane(vol, b), lane(rs, b), lane(st, b)) for b in range(B)]
        vol, rs, st, metrics = step(vol, rs, st, View(depth=T(depths[f])), T(PROJ))
        n_visible = 0
        for b, (v, r, s) in enumerate(lanes):
            v, r, s, diag = t_hp.process_frame_hash(v, r, s, View(depth=T(depths[f][b])), T(PROJ), SETTINGS)
            assert float((s.pose - st.pose[b]).abs().max()) < 1e-6, (f, b)
            assert block_sets(vol, rs, b) == block_sets(v, r), (f, b)
            assert int(r.n_visible) == int(rs.n_visible[b])
            n_visible += int(diag.n_visible)
        assert int(metrics["total_visible"]) == n_visible
    assert float(metrics["mean_valid"]) > 100


def test_batched_dense_step_matches_jax_and_unbatched(depths):
    nb = 2
    jstate = jax.vmap(lambda _: j_dp.create_engine_state(DENSE, IMG))(jnp.arange(nb))
    jstep = j_pb.make_batched_step_dense(DENSE)
    tstep = t_pb.make_batched_step_dense(DENSE)
    projs = jnp.tile(jnp.asarray(PROJ)[None], (nb, 1))
    tvol, tst = t_pb.batched_state_dense(DENSE, IMG, nb, device="cpu")
    assert tvol.sdf.shape == (nb, 100, 128, 128) and tst.pose.shape == (nb, 4, 4)
    for f in range(N_FRAMES):
        vt = convert.from_numpy(t_vol.DenseVolume, convert.to_numpy(jstate[0]), device="cpu")
        st = convert.from_numpy(TrackingState, convert.to_numpy(jstate[1]), device="cpu")
        lanes = [(lane(vt, b), lane(st, b)) for b in range(nb)]
        d = depths[f][:nb]
        *jstate, mj = jstep(*jstate, JView(depth=jnp.asarray(d)), projs)
        vt, st, mt = tstep(vt, st, View(depth=T(d)), T(PROJ))
        for b, (v, s) in enumerate(lanes):
            t_err, r_err = pose_error(np.asarray(jstate[1].pose[b]), st.pose[b].numpy())
            assert t_err < 1e-4 and r_err < 0.01, (f, b, t_err, r_err)
            v, s, _diag = t_dp.process_frame_dense(v, s, View(depth=T(d[b])), T(PROJ), DENSE)
            assert float((s.pose - st.pose[b]).abs().max()) < 1e-6, (f, b)
            # the poses differ by the batched products' rounding: the sdf by
            # that over μ (2.4e-6 measured), well inside 1e-5
            assert float((v.sdf - vt.sdf[b]).abs().max()) < 1e-5, (f, b)
            # a voxel whose η sits on the −μ gate within that rounding may
            # take the update on one side only (1 of 221,376 measured)
            n_w = int((v.w_depth != vt.w_depth[b]).sum())
            assert n_w <= int((v.w_depth > 0).sum()) // 10000 and float((v.w_depth - vt.w_depth[b]).abs().max()) <= 1
        assert abs(float(mt["mean_valid"]) - float(mj["mean_valid"])) <= 0.01 * float(mj["mean_valid"])
    assert float(mt["mean_valid"]) > 100


@pytest.fixture(scope="module")
def fused_lanes(depths):
    """Three lanes after two batched frames: (vol, rs, st), batched."""
    vol, rs, st = t_pb.batched_state_hash(SETTINGS, IMG, B, device="cpu")
    step = t_pb.make_batched_step(SETTINGS)
    for f in range(2):
        vol, rs, st, _m = step(vol, rs, st, View(depth=T(depths[f])), T(PROJ))
    return vol, rs, st


def test_kernel_ops_vmap_with_shared_intrinsics(fused_lanes, depths):
    vol, rs, st = fused_lanes
    sp = SETTINGS.scene
    proj, depth = T(PROJ), T(depths[2])
    inv = torch.stack([t_se3.invert(st.pose[b]) for b in range(B)])
    # K1 (weighted, each lane its own ω): depth, maps, poses and weights batched, both intrinsics shared
    w = torch.rand(depth.shape, generator=torch.Generator().manual_seed(3))
    icp = torch.vmap(lambda d, pm, nm, ip, sp_, wt: k_icp.icp_gh(d, proj, pm, nm, proj, ip, sp_, 0.04, 50, weights=wt))
    got = icp(depth, st.points_map, st.normals_map, inv, st.pose, w)
    for b in range(B):
        want = k_icp.icp_gh(depth[b], proj, st.points_map[b], st.normals_map[b], proj, inv[b], st.pose[b], 0.04, 50,
                            weights=w[b])
        for x, y in zip(got, want):
            assert torch.equal(x[b], y)
        assert int(want.num_valid) > 100
    # K2: each lane fuses its next frame into its own volume; proj shared
    on = torch.ones((B,), dtype=torch.bool)
    vox = vol.vox.clone()
    fuse = (sp.voxel_size, sp.mu, sp.max_w, sp.stop_integrating_at_max_w)

    def integrate(vx, ids, ep, epos, d, pose, en):
        k_int.integrate_depth(vx, ids, ep, epos, d, pose, proj, en, *fuse)
        return vx

    torch.vmap(integrate)(vox, rs.visible_ids, vol.entry_ptr, vol.entry_pos, depth, st.pose, on)
    for b in range(B):
        want = vol.vox[b].clone()
        k_int.integrate_depth(want, rs.visible_ids[b], vol.entry_ptr[b], vol.entry_pos[b], depth[b], st.pose[b], proj,
                              on[b], *fuse)
        assert torch.equal(vox[b], want)
        assert not torch.equal(want, vol.vox[b])
    # K3 through the block grid and K3d: proj and the ranges shared, out made inside from the pose
    zmin = torch.full(IMG, sp.view_frustum_min)
    zmax = torch.full(IMG, sp.view_frustum_max)
    gp, hp = SETTINGS.block_grid, SETTINGS.hashing
    grids = torch.stack([t_hv.get_block_grid(lane(vol, b), gp) for b in range(B)])

    def k3(vx, grid, im):
        v = t_hv.HashVolume(None, None, None, vx, None, None, None, None)
        return k_ray.raycast_grid(v, grid, gp, hp, im, proj, IMG, 1.0 / sp.voxel_size, sp.mu, zmin, zmax).points

    pts = torch.vmap(k3, in_dims=(0, 0, 0))(vox, grids, inv)
    for b in range(B):
        v = t_hv.HashVolume(None, None, None, vox[b], None, None, None, None)
        want = k_ray.raycast_grid(v, grids[b], gp, hp, inv[b], proj, IMG, 1.0 / sp.voxel_size, sp.mu, zmin, zmax)
        assert torch.equal(pts[b], want.points)
        assert int((want.points[..., 3] > 0).sum()) > 0.3 * IMG[0] * IMG[1]
    # lane 0 a plane 1 m in front of the cameras, lane 1 switched off
    Z, Y, X = 100, 128, 128
    plane = ((torch.arange(Z, dtype=torch.float32) - 40.0) * 0.25).clamp(-1.0, 1.0)[:, None, None].expand(Z, Y, X)
    sdf = torch.stack([plane, torch.ones((Z, Y, X))])
    enable = torch.tensor([True, False])

    def k3d(s, im, en, o):
        return k_ray.raycast_dense(t_vol.DenseVolume(sdf=s, w_depth=None), DENSE.plain, im, proj, IMG,
                                   1.0 / sp.voxel_size, sp.mu, zmin, zmax, enable=en, out=o).points

    sentinel = torch.full((2, *IMG, 4), -7.0)
    pts = sentinel.clone()
    torch.vmap(k3d)(sdf, inv[:2], enable, pts)
    for b in range(2):
        want = k3d(sdf[b], inv[b], enable[b], sentinel[b].clone())
        assert torch.equal(pts[b], want)
    assert torch.equal(pts[1], sentinel[1])
    assert int((pts[0][..., 3] > 0).sum()) > 0.5 * IMG[0] * IMG[1]
    assert build.launch_counts() == dict.fromkeys(build.KERNELS, 0)


def test_mesh_and_shard_batch():
    """make_mesh without ranks is a one-rank mesh on the device asked for
    (the card by default: without one it raises); shard_batch keeps each
    rank's contiguous lane range of every [B]-leading tensor on the mesh's
    device, absent fields staying None, and a one-rank mesh keeps every
    lane. A mesh of several ranks (parallel/ranks.py starts them;
    tests/test_torch_batch_ranks.py runs them) splits B = 4 into 2 + 2."""
    assert t_pb.make_mesh(device="cpu") == t_pb.Mesh(1, 0, torch.device("cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="card"):
            t_pb.make_mesh()
    vol, rs, st = t_pb.batched_state_hash(SETTINGS, IMG, 4, device="cpu")
    rs = rs._replace(cell_claim=None)
    st = st._replace(pose=st.pose + torch.arange(4.0)[:, None, None])  # lanes told apart
    placed = t_pb.shard_batch((vol, rs, st), t_pb.Mesh(1, 0, torch.device("cpu")))
    assert placed[1].cell_claim is None and placed[0].vox.shape == vol.vox.shape
    assert all(torch.equal(a, b) for a, b in zip(placed[2], st))
    for rank in range(2):
        vol_r, rs_r, st_r = t_pb.shard_batch((vol, rs, st), t_pb.Mesh(2, rank, torch.device("cpu")))
        assert rs_r.cell_claim is None and vol_r.vox.shape == (2,) + vol.vox.shape[1:]
        assert all(torch.equal(a, b[2 * rank:2 * rank + 2]) for a, b in zip(st_r, st))
        assert torch.equal(vol_r.entry_ptr, vol.entry_ptr[2 * rank:2 * rank + 2])
