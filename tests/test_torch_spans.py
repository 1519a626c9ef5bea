"""The phase spans of the frame steps (engine/spans.py).

On the CPU, where captured.run runs its body eagerly and a mark writes the
host's clock in the timer's place:

1. A hash, a dense and a batched step give bit-equal poses, maps and
   diagnostics with spans on and off.
2. With spans off nothing is recorded: no mark, no host span, no issue
   time, and a host span's start reads 0.
3. Each frame's decoded phases, `finish` among them, sum to its begin → end
   span, in the order the step issues them (hash, dense, the batched
   steps, MainEngine with its loose view mark, the swap step); the host
   spans and issue times follow the steps.
4. The span window's gap share (perfbench/span_window.py) lies in [0, 1].
5. A ring smaller than the run counts the marks it dropped, and the
   benchmark's readers of the span metrics then give None; the mark kernel
   has no launch counter.

Marked `cuda`, on the card (skipped here): a graph with marks holds its
unmarked twin's nodes plus the marks and the same hand-kernel launches;
replays with marks give the poses of replays without, bit for bit; the
stamps rise within each replay. On a machine with a card:

    python -m pytest --noconftest tests/test_torch_spans.py
"""

import math

import pytest
import torch

from infinitam_tpu_torch.calib import default_calib
from infinitam_tpu_torch.config import (
    PlainVoxelArrayParams,
    SceneParams,
    SwappingMode,
    TrackingParams,
    tiny_test_settings,
)
from infinitam_tpu_torch.engine import captured, spans
from infinitam_tpu_torch.engine import dense_pipeline as dp
from infinitam_tpu_torch.engine import hash_pipeline as hp
from infinitam_tpu_torch.engine.main_engine import MainEngine
from infinitam_tpu_torch.engine.view_builder import View
from infinitam_tpu_torch.io import synth
from infinitam_tpu_torch.ops.kernels import build
from infinitam_tpu_torch.parallel import batch
from perfbench import registry, run, span_window

torch.set_num_threads(1)

IMG = (60, 80)
N = 3
SETTINGS = tiny_test_settings().replace(tracking=TrackingParams(n_levels=3, min_valid_points=50))
DENSE = SETTINGS.replace(scene=SceneParams(voxel_size=0.025, mu=0.1, view_frustum_min=0.3, view_frustum_max=3.0),
                         plain=PlainVoxelArrayParams(size=(128, 128, 100), offset=(-64, -64, 0)))
CALIB = default_calib(IMG[1], IMG[0])
PROJ = torch.as_tensor(CALIB.intrinsics_d.vector)
HASH_PHASES = ["track", "alloc", "integrate", "raycast", "finish"]
DENSE_PHASES = ["track", "integrate", "raycast", "finish"]


@pytest.fixture(scope="module")
def depths():
    src = synth.SyntheticSource(CALIB, n_frames=N, img_size=IMG, device="cpu")
    return [src.get_images()[0] for _ in range(N)]


@pytest.fixture(autouse=True)
def spans_off():
    yield
    spans.disable()


def run_steps(kind, depths, device="cpu"):
    """N frames of `kind` from a fresh map: (every state tensor, every
    output tensor) at the end, copies."""
    outs = []
    if kind == "hash":
        state = hp.create_engine_state(SETTINGS, IMG, device=device)
        for d in depths:
            *state, diag = hp.process_frame_hash(*state, View(depth=d.to(device)), PROJ.to(device), SETTINGS)
            outs.append(diag)
    elif kind == "dense":
        state = dp.create_engine_state(DENSE, IMG, device=device)
        for d in depths:
            *state, diag = dp.process_frame_dense(*state, View(depth=d.to(device)), PROJ.to(device), DENSE)
            outs.append(diag)
    elif kind == "batched_hash":
        state = batch.batched_state_hash(SETTINGS, IMG, 2, device=device)
        step = batch.make_batched_step(SETTINGS)
        for d in depths:
            *state, metrics = step(*state, View(depth=torch.stack([d, d.flip(1)]).to(device)), PROJ.to(device))
            outs.append(metrics)
    elif kind == "batched_dense":
        state = batch.batched_state_dense(DENSE, IMG, 2, device=device)
        step = batch.make_batched_step_dense(DENSE)
        for d in depths:
            *state, metrics = step(*state, View(depth=torch.stack([d, d.flip(1)]).to(device)), PROJ.to(device))
            outs.append(metrics)
    else:
        settings = SETTINGS.replace(swapping_mode=SwappingMode.ENABLED) if kind == "engine_swap" else SETTINGS
        eng = MainEngine(settings, CALIB, IMG, device=device)
        for d in depths:
            outs.append(eng.process_frame(metric_depth=d.to(device)).device)
        state = [eng.vol, eng.render_state, eng.tracking_state]
    return [t.clone() for t in captured.leaves(state)], [t.clone() for t in captured.leaves(outs)]


@pytest.mark.parametrize("kind", ["hash", "dense", "batched_hash"])
def test_spans_leave_the_step_bit_equal(depths, kind):
    off = run_steps(kind, depths)
    spans.enable("cpu")
    on = run_steps(kind, depths)
    assert len(spans.summary()["frames"]) == N
    for a, b in zip(off[0] + off[1], on[0] + on[1], strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b) or (a.is_floating_point() and torch.equal(a.isnan(), b.isnan())
                                     and torch.equal(a.nan_to_num(), b.nan_to_num()))


def test_spans_off_record_nothing(depths):
    spans.enable("cpu")
    spans.disable()
    assert spans.ring() == () and spans.start() == 0
    run_steps("hash", depths[:2])
    run_steps("engine", depths[:1])
    s = spans.summary()
    assert s["marks"] == [] and s["frames"] == [] and s["host"] == [] and s["issues"] == []
    assert s["dropped"] == 0 and s["host_dropped"] == 0


@pytest.mark.parametrize("kind,phases,loose", [
    ("hash", HASH_PHASES, []),
    ("dense", DENSE_PHASES, []),
    ("batched_hash", HASH_PHASES, []),
    ("batched_dense", DENSE_PHASES, []),
    ("engine", HASH_PHASES, ["view"]),
    ("engine_swap", ["track", "alloc", "integrate", "swap", "raycast", "finish"], ["view"]),
])
def test_phases_sum_to_the_frame(depths, kind, phases, loose):
    spans.enable("cpu")
    run_steps(kind, depths)
    s = spans.summary()
    assert s["clock"] == "perf_counter" and s["dropped"] == 0
    assert [f["seq"] for f in s["frames"]] == list(range(1, N + 1))
    for f in s["frames"]:
        assert list(f["phases"]) == phases
        assert sum(f["phases"].values()) == f["end_ns"] - f["begin_ns"]
        assert all(ns >= 0 for ns in f["phases"].values())
    assert len(s["gaps_ns"]) == N - 1 and all(g >= 0 for g in s["gaps_ns"])
    assert [m[0] for m in s["loose"]] == loose * N
    stamps = [t for _n, _s, t in s["marks"]]
    assert stamps == sorted(stamps)
    # one read a step on the CPU (no stage, no replay: the body runs eagerly),
    # and each phase call's issue time in the order of the marks
    reads = [h for h in s["host"] if h[0] == "read"]
    assert [h[1] for h in reads] == list(range(1, N + 1)) and all(h[2] <= h[3] for h in reads)
    assert [i[0] for i in s["issues"]] == [m[0] for m in s["marks"]]


def frames_at(bounds):
    return {"frames": [{"begin_ns": b, "end_ns": e, "phases": {"finish": e - b}} for b, e in bounds]}


@pytest.mark.parametrize("bounds,share", [
    ([(0, 10), (10, 20), (20, 30)], 0.0),  # back to back
    ([(0, 10), (15, 25), (100, 110)], 1 - 30 / 110),
    ([(0, 1), (1000, 1001)], 1 - 2 / 1001),  # mostly idle
    ([(5, 5)], 0.0),  # one frame of no length
])
def test_gap_share_of_built_frames(bounds, share):
    assert span_window.gap_share(frames_at(bounds)) == pytest.approx(share)


def test_gap_share_of_a_run_within_zero_and_one(depths):
    spans.enable("cpu")
    run_steps("hash", depths)
    s = spans.summary()
    share = span_window.gap_share(s)
    assert 0.0 < share < 1.0  # the host's work between the eager steps shows as gaps here
    means = span_window.phase_means_ms(s, lanes=1)
    assert sum(means[p] for p in HASH_PHASES) == pytest.approx(means["replay"], rel=1e-9)
    assert span_window.gap_share({"frames": []}) is None


def test_full_ring_counts_dropped_marks_and_readers_give_none(depths):
    spans.enable("cpu", capacity=8)
    run_steps("hash", depths)  # 6 marks a frame
    s = spans.summary()
    assert len(s["marks"]) == 8 and s["dropped"] == 6 * N - 8
    result = span_window.analyse(s, s, [], 1, 1.0)
    ctx = run.Context(lanes=1, spans=result)
    for q in span_window.QUANTITIES:
        assert registry.reader(f"{q}.hash")(ctx) is None
    # the same run in a ring that holds it: every reader has its value
    spans.enable("cpu")
    run_steps("hash", depths)
    s = spans.summary()
    ctx = run.Context(lanes=1, spans=span_window.analyse(s, s, [], 1, 1.0))
    values = {q: registry.reader(f"{q}.hash")(ctx) for q in span_window.QUANTITIES}
    assert all(v is not None and math.isfinite(v) and v >= 0 for v in values.values()), values
    assert 0.0 <= values["replay_gap_share"] <= 1.0


def test_mark_kernel_has_no_launch_counter():
    assert build.counter_of("_Z16itpu_mark_kernelPyPxiii") is None
    assert build.counter_of("void itpu_mark_kernel(unsigned long long*, long long*, int, int, int)") is None
    assert "mark.cu" in build.SOURCES and "itpu_mark" in build.SIGNATURES


# ----- on the card ----------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


def step_twice(kind, depth, device):
    """One step of `kind` with spans off, then one with spans on, on the same
    state (kept alive, so both graphs stay): the stats of each graph."""
    if kind == "hash":
        state = hp.create_engine_state(SETTINGS, IMG, device=device)
        step = lambda: hp.process_frame_hash(*state, View(depth=depth), PROJ.to(device), SETTINGS)  # noqa: E731
    elif kind == "dense":
        state = dp.create_engine_state(DENSE, IMG, device=device)
        step = lambda: dp.process_frame_dense(*state, View(depth=depth), PROJ.to(device), DENSE)  # noqa: E731
    else:
        state = batch.batched_state_hash(SETTINGS, IMG, 2, device=device)
        batched = batch.make_batched_step(SETTINGS)
        step = lambda: batched(*state, View(depth=torch.stack([depth, depth])), PROJ.to(device))  # noqa: E731
    captured.clear()
    step()
    (plain,) = captured.graphs()
    spans.enable(device)
    step()
    graphs = captured.graphs()
    assert len(graphs) == 2 and graphs[0]["nodes"] == plain["nodes"], graphs
    return plain, graphs[1]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,marks", [("hash", 6), ("dense", 5), ("batched_hash", 6)])
def test_marked_graph_holds_its_parents_nodes_and_the_marks(card, depths, kind, marks):
    plain, marked = step_twice(kind, depths[0].to(card), card)
    assert marked["nodes"] == plain["nodes"] + marks
    assert marked["kernel_nodes"] == plain["kernel_nodes"] + marks
    assert marked["launches"] == marked["tally"] == plain["launches"]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["hash", "dense", "batched_hash"])
def test_marked_replays_give_the_same_poses(card, depths, kind):
    off = run_steps(kind, depths, card)
    spans.enable(card)
    on = run_steps(kind, depths, card)
    for a, b in zip(off[0] + off[1], on[0] + on[1], strict=True):
        assert torch.equal(a.nan_to_num(), b.nan_to_num()) if a.is_floating_point() else torch.equal(a, b)


@pytest.mark.cuda
def test_stamps_rise_within_a_replay(card, depths):
    spans.enable(card)
    run_steps("hash", depths, card)
    s = spans.summary()
    assert s["clock"] == "globaltimer" and s["dropped"] == 0
    # every frame the ring holds is a replay: the capture's warm-up runs
    # with the marks paused, and the capture itself runs nothing
    assert len(s["frames"]) == N and not s["loose"]
    for f in s["frames"]:
        assert list(f["phases"]) == HASH_PHASES
        assert all(ns > 0 for ns in f["phases"].values()), f
    assert [h[0] for h in s["host"]] == ["stage", "replay", "read"] * N
