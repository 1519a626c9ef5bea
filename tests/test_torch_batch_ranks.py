"""Lanes over several ranks (parallel/batch.py's mesh, parallel/ranks.py),
held to the JAX package's sharded batched step and to the port's
one-process batched step, on the CPU.

The settings are tests/test_parallel.py's (48×64, a small hash table). B = 4
lanes replay make_trajectory(4, scale=0.5 + 0.15·b) over 4 frames. The port
runs them as 2 gloo ranks of 2 lanes, each rank a spawned process
(`ranks.spawn`) that runs `ranks.replay` from a module that imports no JAX,
with one intra-op thread (OMP_NUM_THREADS=1: the tier-1 run already has
several test workers). Every spawn has its own timeout and kills its ranks
when one fails or hangs.

1. Against the JAX package's `make_batched_step(SETTINGS, mesh=make_mesh(2))`
   on two of the virtual CPU devices, both free-running from the same fresh
   state (the JAX state, through `convert` as numpy): each lane's pose
   within 5e-4 m and 0.1° of the JAX lane at every frame
   (tests/test_torch_batch.py test 1's bound, there per frame from a shared
   state; 4 free-running frames stay inside it: 2.1e-4 m and 0.064°
   measured), the final allocated and
   visible block sets within 4 blocks, and the fleet metrics as that test
   holds them: mean_valid within 1%, mean_f within 5%, total_visible within
   4 blocks a lane; the metrics equal on both ranks.
2. Against the port's one-process B = 4 step from the same fresh state: each
   lane's pose entries within 1e-6 at every frame (on the CPU a lane
   computes the same at any batch size: equal measured), the final block
   and visible sets and every frame's visible counts equal; mean_f,
   mean_valid and total_visible equal bit for bit on both ranks, within
   1e-6 relative of the one-process metrics (the sums run in another
   order), total_visible equal.
3. `make_batched_step_dense` as 2 ranks × 1 lane on the JAX package's small
   dense array (128×128×100) against the one-process B = 2 step: poses
   within 1e-6 m, each lane's sdf within 1e-5, its weights equal but at ≤ 1
   voxel in 10,000 (as tests/test_torch_batch.py test 3 holds the batched
   step to the unbatched one), the metrics equal on both ranks.
4. Mesh semantics without ranks: a one-rank mesh is bit-equal to no mesh and
   creates no process group; a batch that does not split evenly raises
   ValueError; more ranks than cards raise unless asked to share one.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from infinitam_tpu.calib import default_calib
from infinitam_tpu.config import SceneParams, Settings, TrackingParams, VoxelBlockHashParams
from infinitam_tpu.engine.view_builder import View as JView
from infinitam_tpu.io import synth as j_synth
from infinitam_tpu.parallel import batch as j_pb
from infinitam_tpu_torch import convert
from infinitam_tpu_torch.config import PlainVoxelArrayParams as TPlain
from infinitam_tpu_torch.config import SceneParams as TScene
from infinitam_tpu_torch.config import Settings as TSettings
from infinitam_tpu_torch.config import TrackingParams as TTracking
from infinitam_tpu_torch.config import VoxelBlockHashParams as THash
from infinitam_tpu_torch.engine.view_builder import View
from infinitam_tpu_torch.parallel import batch as t_pb
from infinitam_tpu_torch.parallel import ranks

IMG = (48, 64)
B = 4
N_FRAMES = 4
N_RANKS = 2
TIMEOUT = 240.0  # seconds for one spawn of the ranks; a rank takes ~10-30 s here
SCENE = dict(voxel_size=0.025, mu=0.1, view_frustum_min=0.3, view_frustum_max=3.0)
HASH = dict(n_buckets=0x2000, n_excess=0x200, n_blocks=0x800, max_visible_blocks=0x400)
DENSE_ARRAY = dict(size=(128, 128, 100), offset=(-64, -64, 0))
J_SETTINGS = Settings(scene=SceneParams(**SCENE), hashing=VoxelBlockHashParams(**HASH),
                      tracking=TrackingParams(n_levels=3, min_valid_points=50))
SETTINGS = TSettings(scene=TScene(**SCENE), hashing=THash(**HASH), tracking=TTracking(n_levels=3, min_valid_points=50))
DENSE = TSettings(scene=TScene(**SCENE), plain=TPlain(**DENSE_ARRAY), tracking=TTracking(n_levels=3, min_valid_points=50))
PROJ = np.asarray(default_calib(IMG[1], IMG[0]).intrinsics_d.vector, dtype=np.float32)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def depths():
    """[N_FRAMES, B, H, W] depth of lane b's trajectory, scale 0.5 + 0.15·b."""
    trajs = [j_synth.make_trajectory(N_FRAMES, scale=0.5 + 0.15 * b) for b in range(B)]
    proj = jnp.asarray(PROJ)
    return np.stack([np.stack([np.asarray(j_synth.render_depth(jnp.asarray(trajs[b][f]), proj, IMG))
                               for b in range(B)]) for f in range(N_FRAMES)])


@pytest.fixture(scope="module")
def one_thread_ranks():
    """Spawned ranks start with one intra-op thread."""
    before = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    if before is None:
        del os.environ["OMP_NUM_THREADS"]
    else:
        os.environ["OMP_NUM_THREADS"] = before


def run_ranks(settings, depths, dense=False, state=None):
    """ranks.replay on N_RANKS gloo ranks on the CPU; their results by rank."""
    out = ranks.spawn(ranks.replay, N_RANKS, args=(settings, depths, PROJ, dense, state, "cpu"), timeout=TIMEOUT)
    k = depths.shape[1] // N_RANKS
    assert [r["lanes"] for r in out] == [(r * k, (r + 1) * k) for r in range(N_RANKS)]
    return out


def fleet(results, key):
    """A per-lane output of every rank, joined along the lane axis (axis 1)."""
    return np.concatenate([r[key] for r in results], axis=1)


def pose_error(P, G):
    """(camera-centre distance in metres, rotation angle in degrees) in float64."""
    P, G = np.asarray(P, np.float64), np.asarray(G, np.float64)
    t = np.linalg.norm(np.linalg.inv(P)[:3, 3] - np.linalg.inv(G)[:3, 3])
    dR = P[:3, :3] @ G[:3, :3].T
    v = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]])
    return t, np.degrees(np.arctan2(0.5 * np.linalg.norm(v), 0.5 * (np.trace(dR) - 1.0)))


def block_sets(vol, rs, b):
    """(allocated blocks, visible blocks) of lane b of a batched state given
    as `convert.to_numpy` dicts, as sets of block coordinates."""
    pos, ptr, ids = vol["entry_pos"][b], vol["entry_ptr"][b], rs["visible_ids"][b]
    return set(map(tuple, pos[ptr >= 0].tolist())), set(map(tuple, pos[ids[ids >= 0]].tolist()))


def rank_lanes(results):
    """(rank result, local lane) of each fleet lane, in lane order."""
    return [(r, b) for r in results for b in range(r["lanes"][1] - r["lanes"][0])]


def assert_equal_on_every_rank(results, keys):
    for k in keys:
        for r in results[1:]:
            assert np.array_equal(r[k], results[0][k]), k


def test_ranks_match_jax_sharded_step(depths, one_thread_ranks):
    mesh = j_pb.make_mesh(N_RANKS)
    jstate = j_pb.batched_state_hash(J_SETTINGS, IMG, B)
    start = tuple(convert.to_numpy(s) for s in jstate)
    jstate = j_pb.shard_batch(jstate, mesh)
    jstep = j_pb.make_batched_step(J_SETTINGS, mesh=mesh)
    projs = jnp.tile(jnp.asarray(PROJ)[None], (B, 1))
    jposes, jmetrics = [], []
    for f in range(N_FRAMES):
        *jstate, m = jstep(*jstate, JView(depth=jnp.asarray(depths[f])), projs)
        jposes.append(np.asarray(jstate[2].pose))
        jmetrics.append({k: float(v) for k, v in m.items()})
    assert len(jstate[0].vox.sharding.device_set) == N_RANKS
    out = run_ranks(SETTINGS, depths, state=start)
    poses = fleet(out, "poses")
    for f in range(N_FRAMES):
        for b in range(B):
            t, r = pose_error(jposes[f][b], poses[f, b])
            assert t < 5e-4 and r < 0.1, (f, b, t, r)
        mj = jmetrics[f]
        assert abs(float(out[0]["mean_valid"][f]) - mj["mean_valid"]) <= 0.01 * mj["mean_valid"]
        assert abs(float(out[0]["mean_f"][f]) - mj["mean_f"]) <= 0.05 * mj["mean_f"]
        assert abs(int(out[0]["total_visible"][f]) - mj["total_visible"]) <= 4 * B
    assert_equal_on_every_rank(out, ("mean_f", "mean_valid", "total_visible"))
    jvol, jrs = convert.to_numpy(jstate[0]), convert.to_numpy(jstate[1])
    for lane, (r, b) in enumerate(rank_lanes(out)):
        alloc_t, vis_t = block_sets(*r["state"][:2], b)
        alloc_j, vis_j = block_sets(jvol, jrs, lane)
        assert len(alloc_j ^ alloc_t) <= 4 and len(vis_j ^ vis_t) <= 4, lane
        assert len(vis_t) > 100
    assert float(out[0]["mean_valid"][-1]) > 100
    assert all(sum(r["launches"].values()) == 0 for r in out)  # the CPU takes the plain twins


def test_ranks_match_one_process(depths, one_thread_ranks):
    vol, rs, st = t_pb.batched_state_hash(SETTINGS, IMG, B, device="cpu")
    step = t_pb.make_batched_step(SETTINGS)
    out = run_ranks(SETTINGS, depths)
    poses, n_visible = fleet(out, "poses"), fleet(out, "n_visible")
    for f in range(N_FRAMES):
        vol, rs, st, m = step(vol, rs, st, View(depth=torch.from_numpy(depths[f])), torch.from_numpy(PROJ))
        assert np.abs(poses[f] - st.pose.numpy()).max() < 1e-6, f
        assert np.array_equal(n_visible[f], m["diag"].n_visible.numpy()), f
        for k in ("mean_f", "mean_valid"):
            assert abs(float(out[0][k][f]) - float(m[k])) <= 1e-6 * abs(float(m[k])), (f, k)
        assert int(out[0]["total_visible"][f]) == int(m["total_visible"])
    assert_equal_on_every_rank(out, ("mean_f", "mean_valid", "total_visible"))
    one = (convert.to_numpy(vol), convert.to_numpy(rs))
    for lane, (r, b) in enumerate(rank_lanes(out)):
        assert block_sets(*r["state"][:2], b) == block_sets(*one, lane), lane
    assert float(out[0]["mean_valid"][-1]) > 100


def test_dense_ranks_match_one_process(depths, one_thread_ranks):
    nb = N_RANKS  # one lane a rank
    d = np.ascontiguousarray(depths[:, :nb])
    vol, st = t_pb.batched_state_dense(DENSE, IMG, nb, device="cpu")
    step = t_pb.make_batched_step_dense(DENSE)
    out = run_ranks(DENSE, d, dense=True)
    assert [r["lanes"] for r in out] == [(0, 1), (1, 2)]
    poses = fleet(out, "poses")
    for f in range(N_FRAMES):
        vol, st, m = step(vol, st, View(depth=torch.from_numpy(d[f])), torch.from_numpy(PROJ))
        assert np.abs(poses[f] - st.pose.numpy()).max() < 1e-6, f
        for k in ("mean_f", "mean_valid"):
            assert abs(float(out[0][k][f]) - float(m[k])) <= 1e-6 * abs(float(m[k])), (f, k)
    assert_equal_on_every_rank(out, ("mean_f", "mean_valid"))
    for lane, (r, b) in enumerate(rank_lanes(out)):
        sdf, w = r["state"][0]["sdf"][b], r["state"][0]["w_depth"][b]
        assert np.abs(sdf - vol.sdf[lane].numpy()).max() < 1e-5, lane
        one_w = vol.w_depth[lane].numpy()
        assert (w != one_w).sum() <= (one_w > 0).sum() // 10000 and np.abs(w - one_w).max() <= 1, lane
    assert float(out[0]["mean_valid"][-1]) > 100


def test_one_rank_mesh_is_the_path_without_a_mesh(depths):
    mesh = t_pb.make_mesh(device="cpu")
    assert mesh == t_pb.Mesh(1, 0, torch.device("cpu"), None) and not dist.is_initialized()
    runs = []
    for m in (None, mesh):
        vol, rs, st = t_pb.batched_state_hash(SETTINGS, IMG, 2, device="cpu", mesh=m)
        vol, rs, st = t_pb.shard_batch((vol, rs, st), mesh)  # one rank: every lane stays
        step = t_pb.make_batched_step(SETTINGS, mesh=m)
        for f in range(2):
            vol, rs, st, metrics = step(vol, rs, st, View(depth=torch.from_numpy(depths[f][:2])),
                                        torch.from_numpy(PROJ))
        runs.append((vol, rs, st, metrics))
    (v0, r0, s0, m0), (v1, r1, s1, m1) = runs
    for a, b in ((v0, v1), (r0, r1), (s0, s1)):
        assert all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(m0[k], m1[k]) for k in ("mean_f", "mean_valid", "total_visible"))
    assert not dist.is_initialized()


def test_mesh_refuses_uneven_batches_and_missing_cards():
    two = t_pb.Mesh(2, 1, torch.device("cpu"))
    assert two.lane_range(4) == range(2, 4)
    with pytest.raises(ValueError, match="3 lanes .* 2 ranks"):
        t_pb.shard_batch((torch.zeros(3, 5),), two)
    with pytest.raises(ValueError, match="3 lanes .* 2 ranks"):
        t_pb.batched_state_hash(SETTINGS, IMG, 3, mesh=two)
    # more ranks than this machine has cards (none here): refused, not folded
    for kwargs in ({}, {"device": "cuda:0"}, {"share_card": True}):
        with pytest.raises(ValueError, match="card"):
            t_pb.make_mesh(2, rank=0, **kwargs)
    with pytest.raises(ValueError, match="one process a rank"):
        t_pb.make_mesh(2, device="cpu")
    assert not dist.is_initialized()
