"""Card-only tests of the captured frame steps (engine/captured.py): 5
frames replayed as CUDA graphs equal 5 frames run op by op, bit for bit
(poses, diagnostics, hash entries and voxels) on the hash volume, the dense
array and the batched step at B = 4, through process_sequence_hash and
through MainEngine.process_frame; one graph a replay with exact launch
counts, read from the graph's own kernel nodes (a capture whose kernel
nodes differ from its wrappers' count raises); a step that syncs raises at
capture instead of running eagerly; a
K1 graph replayed while an eager K1 runs on another stream gives both the
single-stream result (each graph has its ticket counters, made in its
warm-up); DeviceFrameFeed's frames reach a captured step through its own
stream.

They carry the `cuda` marker and skip where no card is present. On a
machine with a card, run them with:

    python -m pytest --noconftest tests/test_torch_capture_cuda.py
"""

import numpy as np
import pytest
import torch

from infinitam_tpu_torch.calib import default_calib
from infinitam_tpu_torch.config import PlainVoxelArrayParams, SceneParams, TrackingParams, tiny_test_settings
from infinitam_tpu_torch.engine import captured
from infinitam_tpu_torch.engine import dense_pipeline as dp
from infinitam_tpu_torch.engine import hash_pipeline as hp
from infinitam_tpu_torch.engine.main_engine import MainEngine
from infinitam_tpu_torch.engine.view_builder import View
from infinitam_tpu_torch.io import sources, synth
from infinitam_tpu_torch.ops.kernels import build, icp
from infinitam_tpu_torch.parallel import batch
from infinitam_tpu_torch.utils import se3

pytestmark = pytest.mark.cuda

IMG = (120, 160)
N = 5
SETTINGS = tiny_test_settings().replace(tracking=TrackingParams(n_levels=3, min_valid_points=50))
DENSE = SETTINGS.replace(scene=SceneParams(voxel_size=0.025, mu=0.1, view_frustum_min=0.3, view_frustum_max=3.0),
                         plain=PlainVoxelArrayParams(size=(128, 128, 100), offset=(-64, -64, 0)))
ITERS = sum(TrackingParams(n_levels=3).iterations_per_level[:3])


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def frames(device):
    calib = default_calib(IMG[1], IMG[0])
    proj = torch.as_tensor(calib.intrinsics_d.vector, device=device)
    src = synth.SyntheticSource(calib, n_frames=N, img_size=IMG, device=device)
    depths = [src.get_images()[0] for _ in range(N)]
    return proj, [torch.where(d > 0, d, torch.full_like(d, -1.0)) for d in depths]


def assert_trees_equal(a, b):
    la, lb = captured.leaves(a), captured.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y)


def test_captured_hash_frames_equal_uncaptured(device, frames):
    proj, depths = frames
    out = {}
    captured.clear()
    for capture in (False, True):
        state = hp.create_engine_state(SETTINGS, IMG, device=device)
        build.reset_launch_counts()
        poses, diags = [], []
        for d in depths:
            *state, diag = hp.process_frame_hash(*state, View(depth=d), proj, SETTINGS, capture=capture)
            poses.append(state[2].pose.clone())
            diags.append(diag)
        torch.cuda.synchronize()
        out[capture] = (poses, diags, captured.tree_map(torch.clone, state), build.launch_counts())
    assert_trees_equal(out[False][:3], out[True][:3])
    assert out[True][3] == out[False][3] == dict.fromkeys(build.KERNELS, 0) | {"icp": N * ITERS, "integrate": N,
                                                                              "raycast": N}
    (g,) = captured.graphs()
    assert g["replays"] == N and g["kernel_nodes"] > 100 and g["pool_bytes"] > 0
    assert g["launches"] == g["tally"] == {"icp": ITERS, "integrate": 1, "raycast": 1}


def test_sequence_replays_the_frame_graph(device, frames):
    proj, depths = frames
    captured.clear()
    runs = [hp.process_sequence_hash(*hp.create_engine_state(SETTINGS, IMG, device=device), torch.stack(depths),
                                     proj, SETTINGS, capture=capture) for capture in (False, True)]
    assert_trees_equal(runs[0], runs[1])
    assert [g["replays"] for g in captured.graphs()] == [N]


def test_captured_dense_frames_equal_uncaptured(device, frames):
    proj, depths = frames
    out = {}
    captured.clear()
    for capture in (False, True):
        vol, st = dp.create_engine_state(DENSE, IMG, device=device)
        planes = (vol.sdf.data_ptr(), vol.w_depth.data_ptr())
        poses, diags = [], []
        for d in depths:
            vol, st, diag = dp.process_frame_dense(vol, st, View(depth=d), proj, DENSE, capture=capture)
            poses.append(st.pose.clone())
            diags.append(diag)
        # the integration writes the array's planes in place, captured or not
        assert (vol.sdf.data_ptr(), vol.w_depth.data_ptr()) == planes
        out[capture] = (poses, diags, captured.tree_map(torch.clone, (vol, st)))
    assert_trees_equal(out[False], out[True])
    (g,) = captured.graphs()
    assert g["launches"] == g["tally"] == {"icp": ITERS, "integrate_dense": 1, "raycast_dense": 1}


@pytest.mark.parametrize("kind", ["hash", "dense"])
def test_captured_batched_steps_equal_uncaptured(device, frames, kind):
    """B = 4 lanes, each on its own trajectory; torch.vmap traced inside the
    capture, each kernel one launch for the lanes."""
    proj, _depths = frames
    B = 4 if kind == "hash" else 2
    trajs = [torch.as_tensor(synth.make_trajectory(N, scale=1.0 - 0.15 * b), device=device) for b in range(B)]
    steps = [torch.stack([synth.render_depth(trajs[b][f], proj, IMG) for b in range(B)]) for f in range(N)]
    settings = SETTINGS if kind == "hash" else DENSE
    make, fresh = ((batch.make_batched_step, batch.batched_state_hash) if kind == "hash"
                   else (batch.make_batched_step_dense, batch.batched_state_dense))
    out = {}
    captured.clear()
    for capture in (False, True):
        state, step = fresh(settings, IMG, B, device=device), make(settings)
        build.reset_launch_counts()
        poses, metrics = [], []
        for d in steps:
            *state, m = step(*state, View(depth=d), proj, capture=capture)
            poses.append(state[-1].pose.clone())
            metrics.append(m)
        torch.cuda.synchronize()
        out[capture] = (poses, metrics, captured.tree_map(torch.clone, state), build.launch_counts())
    assert_trees_equal(out[False][:3], out[True][:3])
    per_step = ({"icp": ITERS, "integrate": 1, "raycast": 1} if kind == "hash"
                else {"icp": ITERS, "integrate_dense": 1, "raycast_dense": 1})
    assert out[True][3] == dict.fromkeys(build.KERNELS, 0) | {k: v * N for k, v in per_step.items()}
    (g,) = captured.graphs()
    assert g["launches"] == g["tally"] == per_step


def test_main_engine_frames_equal_uncaptured(device, frames):
    _proj, depths = frames
    calib = default_calib(IMG[1], IMG[0])
    out = {}
    for capture in (False, True):
        eng = MainEngine(SETTINGS, calib, IMG, device=device)
        poses, diags = [], []
        for d in depths:
            diags.append(eng.process_frame(metric_depth=d, capture=capture).as_dict())
            poses.append(eng.get_pose())
        out[capture] = (np.stack(poses), diags, eng.get_image("raycast"))
    np.testing.assert_array_equal(out[False][0], out[True][0])
    assert out[False][1] == out[True][1]
    np.testing.assert_array_equal(out[False][2], out[True][2])


def test_a_step_that_syncs_raises_at_capture(device):
    def body(state, frame):
        x = state[0] + frame[0]
        if bool(x.sum() > 0):  # a read to the host: not capturable
            x = x + 1
        return (x,), (x,)

    state = (torch.zeros(4, device=device),)
    with pytest.raises(Exception):
        captured.run("syncs", (), body, state, (torch.ones(4, device=device),))
    torch.cuda.synchronize()
    captured.clear()


def test_k1_graph_beside_an_eager_k1_on_another_stream(device, frames):
    """A graph of 4 K1 launches, replayed on the default stream while eager
    K1 launches run on a side stream at the same time: each gives the
    single-stream result (the graph's ticket counter is its own)."""
    proj, depths = frames
    state = hp.create_engine_state(SETTINGS, IMG, device=device)
    for d in depths[:3]:
        *state, _diag = hp.process_frame_hash(*state, View(depth=d), proj, SETTINGS, capture=False)
    st = state[2]
    args = (depths[3], proj, st.points_map, st.normals_map, proj, se3.invert(st.pose), st.pose_point_cloud, 0.1, 50)
    ref = icp.buffer_from_gh(icp.icp_gh(*args))

    def body(state, frame):
        outs = [icp.buffer_from_gh(icp.icp_gh(frame, *args[1:]))[0] for _ in range(4)]
        return state, torch.stack(outs)

    captured.clear()
    k1_state = (torch.zeros(1, device=device),)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph_out, side_out = [], []
    for _ in range(10):
        _s, out = captured.run("k1", (), body, k1_state, args[0])
        graph_out.append(out.read())
        assert captured.graphs()[0]["launches"] == {"icp": 4}
        with torch.cuda.stream(side):
            side_out.append(icp.buffer_from_gh(icp.icp_gh(*args))[0])
    torch.cuda.synchronize()
    for got in graph_out:
        for row in got:
            assert torch.equal(row, ref[0])
    for got in side_out:
        assert torch.equal(got, ref[0])
    assert int(icp._counter(device.index, side.cuda_stream, 1)) == 0
    captured.clear()


def test_a_graph_whose_kernels_differ_from_the_count_raises(device, frames, monkeypatch):
    """The launch counts a replay adds are the graph's own kernel nodes: a
    wrapper that counts a launch the graph does not hold (here K1 counting
    each launch twice) makes the capture raise."""
    proj, depths = frames
    state = hp.create_engine_state(SETTINGS, IMG, device=device)
    *state, _diag = hp.process_frame_hash(*state, View(depth=depths[0]), proj, SETTINGS, capture=False)
    st = state[2]
    args = (depths[1], proj, st.points_map, st.normals_map, proj, se3.invert(st.pose), st.pose_point_cloud, 0.1, 50)
    count = build.count_launch

    def twice(kernel):
        count(kernel)
        count(kernel)

    def body(state, frame):
        return state, icp.buffer_from_gh(icp.icp_gh(frame, *args[1:]))[0]

    captured.clear()
    monkeypatch.setattr(build, "count_launch", twice)
    with pytest.raises(RuntimeError, match="hand kernels"):
        captured.run("k1_twice", (), body, (torch.zeros(1, device=device),), args[0])
    torch.cuda.synchronize()
    captured.clear()


def test_device_frame_feed_into_a_captured_step(device):
    """Frames from the host through DeviceFrameFeed (its copies on its own
    stream, ordered before the step by an event) give the poses of the same
    frames handed over on the card."""
    calib = default_calib(IMG[1], IMG[0])
    host = synth.SyntheticSource(calib, n_frames=N, img_size=IMG, device="cpu")
    frames_np = [tuple(None if a is None else a.numpy() for a in host.get_images()[:2]) for _ in range(N)]

    class Replay(sources.ImageSourceEngine):
        def __init__(self):
            self.calib, self.i = calib, 0

        def has_more_images(self):
            return self.i < N

        def get_images(self):
            self.i += 1
            return frames_np[self.i - 1]

    feed = sources.DeviceFrameFeed(Replay(), device=device)
    poses = {}
    for name, get in (("feed", feed.get_images),
                      ("card", iter([tuple(torch.from_numpy(a).to(device) for a in f if a is not None)
                                     for f in frames_np]).__next__)):
        eng = MainEngine(SETTINGS, calib, IMG, device=device)
        out = []
        for _ in range(N):
            depth = get()[0]
            eng.process_frame(metric_depth=depth)
            out.append(eng.get_pose())
        poses[name] = np.stack(out)
    np.testing.assert_array_equal(poses["feed"], poses["card"])
