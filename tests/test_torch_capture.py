"""The captured frame steps (engine/captured.py) on the CPU, where the same
body runs eagerly with no graph.

1. Capture safety: one frame of each captured path (hash ICP, weighted
   ICP, Ren, colour fusion and the colour tracker, the approximate
   raycast, the hash-probe and coarse raycasts, the legacy allocator, the
   dense array, the batched hash and dense steps at B = 2) and the swap
   path's device half run under a TorchDispatchMode that fails on any op
   a CUDA graph cannot hold: a read to the host (aten._local_scalar_dense),
   an output whose size depends on the data (nonzero, masked_select,
   unique, bincount, repeat_interleave by a tensor), indexing by a boolean
   mask, or a tensor made from host data (aten.lift_fresh).
2. The captured body (the step, then its copy into the caller's state)
   over 4 frames equals the functional process_sequence_hash bit for bit,
   and the caller's state tensors keep their identity (data_ptr); the
   sequence through the captured body equals it too.
3. The captured body against the JAX package's process_sequence_hash (one
   lax.scan) over 3 frames, within test_torch_slice's bar: 1e-4 m and 0.01°
   a frame.
4. The pieces: packed outputs read back bit for bit with and without
   leading dims, the state un-aliased once and then stable, a copy-back
   whose step passes one field on as another or wrote a field in place,
   on_phase refused with capture, the launch tally, the names of the hand
   kernels' functions mapped to their launch counters (how a graph's own
   kernel nodes are counted).
5. The dense integration written into the array in place equals the
   functional update bit for bit, unbatched and under torch.vmap, with
   colour and the max_w freeze.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from infinitam_tpu.calib import default_calib as j_default_calib
from infinitam_tpu.config import TrackingParams as JTrackingParams
from infinitam_tpu.config import tiny_test_settings as j_tiny_test_settings
from infinitam_tpu.engine import hash_pipeline as j_hp
from infinitam_tpu.io import synth as j_synth
from infinitam_tpu_torch.calib import default_calib
from infinitam_tpu_torch.config import (
    PlainVoxelArrayParams,
    SceneParams,
    SwappingMode,
    TrackerType,
    TrackingParams,
    tiny_test_settings,
)
from infinitam_tpu_torch.engine import captured
from infinitam_tpu_torch.engine import dense_pipeline as dp
from infinitam_tpu_torch.engine import hash_pipeline as hp
from infinitam_tpu_torch.engine import swapping
from infinitam_tpu_torch.engine.view_builder import View, build_view_from_metric_depth
from infinitam_tpu_torch.io import synth
from infinitam_tpu_torch.ops import tsdf
from infinitam_tpu_torch.ops.kernels import build
from infinitam_tpu_torch.parallel import batch

torch.set_num_threads(1)

IMG = (60, 80)
SETTINGS = tiny_test_settings().replace(tracking=TrackingParams(n_levels=3, min_valid_points=50))
DENSE = SETTINGS.replace(scene=SceneParams(voxel_size=0.025, mu=0.1, view_frustum_min=0.3, view_frustum_max=3.0),
                         plain=PlainVoxelArrayParams(size=(128, 128, 100), offset=(-64, -64, 0)))
CALIB = default_calib(IMG[1], IMG[0])
PROJ = torch.as_tensor(CALIB.intrinsics_d.vector)

# ops a CUDA graph cannot hold: a read to the host, a size that depends on
# the data, a tensor made from host data
FORBIDDEN = ("aten._local_scalar_dense", "aten.nonzero", "aten.masked_select", "aten.unique", "aten._unique",
             "aten.unique_consecutive", "aten.unique_dim", "aten.bincount", "aten.repeat_interleave.Tensor",
             "aten.lift_fresh", "aten.argwhere")


class CaptureGuard(TorchDispatchMode):
    """Records each op the block dispatches that capture would refuse."""

    def __init__(self):
        super().__init__()
        self.bad: list = []
        self.n_ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.n_ops += 1
        name = str(func)
        if name.startswith(FORBIDDEN):
            self.bad.append(name)
        if name.startswith(("aten.index.", "aten.index_put", "aten._index_put_impl")):
            idx = args[1] if len(args) > 1 else kwargs.get("indices", ())
            if any(torch.is_tensor(t) and t.dtype == torch.bool for t in idx):
                self.bad.append(f"{name} by a boolean mask")
        return func(*args, **kwargs)


@pytest.fixture(scope="module")
def frames():
    src = synth.SyntheticSource(CALIB, n_frames=4, img_size=IMG, with_rgb=True, device="cpu")
    return [src.get_images() for _ in range(4)]


def guarded(fn, min_ops: int = 100):
    """fn() under the guard: (its result, the forbidden ops it ran); the
    guard must have seen at least `min_ops` ops."""
    with CaptureGuard() as guard:
        out = fn()
    assert guard.n_ops >= min_ops
    return out, guard.bad


def pose_error(P, G):
    """(camera-centre distance in metres, rotation angle in degrees) between
    two world→camera poses, as tests/test_torch_slice.py measures them."""
    P, G = np.asarray(P, np.float64), np.asarray(G, np.float64)
    t = np.linalg.norm(np.linalg.inv(P)[:3, 3] - np.linalg.inv(G)[:3, 3])
    dR = P[:3, :3] @ G[:3, :3].T
    v = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]])
    return t, np.degrees(np.arctan2(0.5 * np.linalg.norm(v), 0.5 * (np.trace(dR) - 1.0)))


HASH_PATHS = {
    "icp": SETTINGS,
    "wicp": SETTINGS.replace(tracker_type=TrackerType.WICP, model_sensor_noise=True, use_bilateral_filter=True),
    "ren": SETTINGS.replace(tracker_type=TrackerType.REN),
    "color_fusion": SETTINGS.replace(use_color=True),
    "color_tracker": SETTINGS.replace(use_color=True, tracker_type=TrackerType.COLOR,
                                      tracking=TrackingParams(n_levels=3, min_valid_points=50, color_n_levels=3)),
    "approximate_raycast": SETTINGS.replace(use_approximate_raycast=True),
    "hash_probe": SETTINGS.replace(use_block_grid=False),
    "coarse_raycast": SETTINGS.replace(raycast_coarse_factor=2),
    "legacy_allocator": SETTINGS,
}


@pytest.mark.parametrize("path", list(HASH_PATHS))
def test_hash_step_is_capture_safe(frames, path):
    settings = HASH_PATHS[path]
    state = hp.create_engine_state(settings, IMG, device="cpu")
    if path == "legacy_allocator":
        state = (state[0], state[1]._replace(cell_claim=None, entry_epoch=None, epoch=None), state[2])
    views = [build_view_from_metric_depth(d, settings, CALIB, rgb=rgb if settings.use_color else None)
             for d, rgb, _gt in frames[:2]]
    *state, _diag = hp.process_frame_hash(*state, views[0], PROJ, settings, proj_rgb=PROJ)
    (*_state, diag), bad = guarded(lambda: hp.process_frame_hash(*state, views[1], PROJ, settings, proj_rgb=PROJ))
    assert bad == []
    assert int(diag.num_valid) > 500  # Ren reports its ICP pre-step's count, from level 1


def test_dense_step_is_capture_safe(frames):
    vol, st = dp.create_engine_state(DENSE, IMG, device="cpu")
    vol, st, _d = dp.process_frame_dense(vol, st, View(depth=frames[0][0]), PROJ, DENSE)
    (_vol, _st, diag), bad = guarded(lambda: dp.process_frame_dense(vol, st, View(depth=frames[1][0]), PROJ, DENSE))
    assert bad == []
    assert int(diag.num_valid) > 1000


@pytest.mark.parametrize("kind", ["hash", "dense"])
def test_batched_step_is_capture_safe(kind):
    settings = SETTINGS if kind == "hash" else DENSE
    make, fresh = ((batch.make_batched_step, batch.batched_state_hash) if kind == "hash"
                   else (batch.make_batched_step_dense, batch.batched_state_dense))
    trajs = [synth.make_trajectory(2, scale=1.0 - 0.15 * b) for b in range(2)]
    depths = [torch.stack([synth.render_depth(torch.as_tensor(trajs[b][f]), PROJ, IMG) for b in range(2)])
              for f in range(2)]
    state, step = fresh(settings, IMG, 2, device="cpu"), make(settings)
    *state, _m = step(*state, View(depth=depths[0]), PROJ)
    (*_state, metrics), bad = guarded(lambda: step(*state, View(depth=depths[1]), PROJ))
    assert bad == []
    assert float(metrics["mean_valid"]) > 1000


def test_swap_device_half_is_capture_safe(frames):
    """step_frame_swap with an earlier frame's needed list and a data slab to
    merge, as the card captures it: every op of it can be captured."""
    settings = SETTINGS.replace(swapping_mode=SwappingMode.ENABLED)
    vol, rs, st = hp.create_engine_state(settings, IMG, device="cpu")
    sw = swapping.create_swap_states(settings, device="cpu")
    view = View(depth=frames[0][0])
    vol, rs, st, sw, _d, in_meta, _pack = hp.step_frame_swap(vol, rs, st, sw, view, PROJ, settings)
    s3 = settings.hashing.block_volume
    slab = torch.full((65, s3), 0x7FFF0000, dtype=torch.int32)
    slab[-1] = -1
    slab[-1, 0] = int(rs.visible_ids[0])
    out, bad = guarded(lambda: hp.step_frame_swap(vol, rs, st, sw, View(depth=frames[1][0]), PROJ, settings,
                                                  merge_flips=in_meta, merge_slab=slab))
    assert bad == []
    assert int(out[4].num_valid) > 1000


def test_guard_sees_what_capture_refuses():
    x = torch.arange(6.0)
    for fn in (lambda: x[x > 2], lambda: int(x.sum()), lambda: torch.nonzero(x), lambda: x + torch.tensor([1.0])):
        _out, bad = guarded(fn, min_ops=1)
        assert bad


def test_captured_body_equals_the_functional_sequence(frames):
    depths = torch.stack([torch.where(d > 0, d, torch.full_like(d, -1.0)) for d, _r, _g in frames])
    ref = hp.process_sequence_hash(*hp.create_engine_state(SETTINGS, IMG, device="cpu"), depths, PROJ, SETTINGS,
                                   capture=False)
    state = hp.create_engine_state(SETTINGS, IMG, device="cpu")
    poses, diags, ptrs = [], [], []
    for d in depths:
        *state, diag = hp.process_frame_hash(*state, View(depth=d), PROJ, SETTINGS)
        poses.append(state[2].pose.clone())
        diags.append(diag)
        ptrs.append([t.data_ptr() for t in captured.leaves(state)])
    assert all(p == ptrs[0] for p in ptrs)
    got = (*state, torch.stack(poses), hp.FrameDiagnostics(*(torch.stack(f) for f in zip(*diags))))
    seq = hp.process_sequence_hash(*hp.create_engine_state(SETTINGS, IMG, device="cpu"), depths, PROJ, SETTINGS)
    for run in (got, seq):
        for a, b in zip(captured.leaves(ref), captured.leaves(run), strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_captured_body_matches_the_jax_scan():
    """The captured body frame by frame against the JAX package's
    process_sequence_hash, its frames as one lax.scan."""
    j_settings = j_tiny_test_settings().replace(tracking=JTrackingParams(n_levels=3, min_valid_points=50))
    calib = j_default_calib(IMG[1], IMG[0])
    src = j_synth.SyntheticSource(calib, n_frames=3, img_size=IMG)
    depths = np.stack([np.asarray(src.get_images()[0]) for _ in range(3)])
    depths = np.where(depths > 0, depths, -1.0).astype(np.float32)
    proj = np.asarray(calib.intrinsics_d.vector, dtype=np.float32)
    *_s, j_poses, j_diags = j_hp.process_sequence_hash(*j_hp.create_engine_state(j_settings, IMG),
                                                       jnp.asarray(depths), jnp.asarray(proj), j_settings)
    state = hp.create_engine_state(SETTINGS, IMG, device="cpu")
    for i, d in enumerate(depths):
        *state, diag = hp.process_frame_hash(*state, View(depth=torch.from_numpy(d)), torch.from_numpy(proj),
                                             SETTINGS)
        t_err, r_err = pose_error(state[2].pose.numpy(), np.asarray(j_poses[i]))
        assert t_err <= 1e-4 and r_err <= 0.01, f"frame {i}: {t_err:.2e} m, {r_err:.2e} deg"
        assert abs(int(diag.num_valid) - int(j_diags.num_valid[i])) <= 0.01 * int(j_diags.num_valid[i])


def test_packed_outputs_read_back_bit_for_bit():
    out = {"f": torch.tensor([1.5, -0.0, float("nan")]), "n": torch.tensor(7, dtype=torch.int32),
           "pose": torch.randn(4, 4, dtype=torch.float64), "flag": torch.tensor([True, False]), "none": None,
           "nested": (torch.arange(5, dtype=torch.int16),)}
    packed = captured.pack(out)
    assert packed.buf.dtype == torch.uint8 and packed.buf.numel() % 8 == 0
    back = packed.read()
    assert back["none"] is None
    for a, b in zip(captured.leaves(out), captured.leaves(back), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(-1).view(torch.uint8) if a.dim() else a.reshape(1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))
    assert back["f"].data_ptr() != out["f"].data_ptr()  # a copy, not the packed buffer
    rows = torch.stack([packed.buf, captured.pack(captured.tree_map(torch.zeros_like, out)).buf])
    both = packed.read(rows)
    assert both["pose"].shape == (2, 4, 4) and torch.equal(both["pose"][0], out["pose"])
    assert int(both["n"][1]) == 0


def test_state_is_unaliased_once_then_kept():
    pose = torch.eye(4)
    state = ({"a": pose, "b": pose, "c": torch.zeros(3).expand(2, 3)}, torch.ones(2))
    once = captured.unalias(state)
    a, b, c = once[0]["a"], once[0]["b"], once[0]["c"]
    assert a.data_ptr() != b.data_ptr() and c.is_contiguous() and torch.equal(a, pose)
    again = captured.unalias(once)
    assert all(x is y for x, y in zip(captured.leaves(once), captured.leaves(again)))
    assert again[1] is state[1]


def test_copy_back_when_the_step_passes_one_field_on_as_another():
    """A step that swaps two fields: each caller tensor must end with the
    other's old value, not with a value an earlier copy wrote."""
    state = (torch.tensor([1.0]), torch.tensor([2.0]), torch.tensor([3.0]))
    ids = [t.data_ptr() for t in state]
    captured.copy_back(state, (state[1], state[0], state[2] + 1))
    assert [float(t) for t in state] == [2.0, 1.0, 4.0]
    assert [t.data_ptr() for t in state] == ids
    with pytest.raises(TypeError):
        captured.copy_back(state, (state[0], state[1], torch.zeros(2)))


def test_on_phase_needs_an_uncaptured_step(frames):
    state = hp.create_engine_state(SETTINGS, IMG, device="cpu")
    with pytest.raises(ValueError):
        hp.process_frame_hash(*state, View(depth=frames[0][0]), PROJ, SETTINGS, on_phase=lambda _n: None)
    seen = []
    hp.process_frame_hash(*state, View(depth=frames[0][0]), PROJ, SETTINGS, on_phase=seen.append, capture=False)
    assert seen == ["track", "alloc", "integrate", "raycast"]


def test_launch_tally_leaves_the_counts():
    build.reset_launch_counts()
    build.count_launch("icp")
    with build.tally() as counted:
        build.count_launch("icp")
        build.count_launch("raycast")
    assert counted == {"icp": 1, "raycast": 1}
    assert build.launch_counts()["icp"] == 1 and build.launch_counts()["raycast"] == 0
    build.add_launches(counted)
    assert build.launch_counts()["icp"] == 2 and build.launch_counts()["raycast"] == 1
    build.reset_launch_counts()


def test_copy_back_skips_a_field_written_in_place():
    """A step that wrote a field in place and returns it (or a view of the
    same memory, as torch.vmap hands back its input): nothing to copy."""
    state = (torch.arange(6.0).reshape(2, 3), torch.zeros(2))
    ids = [t.data_ptr() for t in state]
    state[0].add_(1.0)
    captured.copy_back(state, (state[0].view(2, 3), state[1] + 5))
    assert torch.equal(state[0], torch.arange(1.0, 7.0).reshape(2, 3)) and torch.equal(state[1], torch.full((2,), 5.0))
    assert [t.data_ptr() for t in state] == ids


# the hand kernels' functions as nvcc (Itanium ABI) names them, per launch
# counter: each template instance the csrc/*.cu sources launch
KERNEL_SYMBOLS = {
    "_Z15itpu_icp_kernelILb0EEvPKfS1_iiPK6float4S4_iiS1_S1_S1_S1_fiPfPjS5_Pi9ItpuLanes": "icp",
    "_Z15itpu_icp_kernelILb1EEvPKfS1_iiPK6float4S4_iiS1_S1_S1_S1_fiPfPjS5_Pi9ItpuLanes": "icp_weighted",
    "_Z21itpu_integrate_kernelILb0ELb0EEvPiS0_PKiiS2_S2_iPKfiiS4_iiS4_S4_S4_S4_PKbffii9ItpuLanes": "integrate",
    "_Z21itpu_integrate_kernelILb0ELb1EEvPiS0_PKiiS2_S2_iPKfiiS4_iiS4_S4_S4_S4_PKbffii9ItpuLanes": "integrate",
    "_Z21itpu_integrate_kernelILb1ELb0EEvPiS0_PKiiS2_S2_iPKfiiS4_iiS4_S4_S4_S4_PKbffii9ItpuLanes": "integrate_color",
    "_Z21itpu_integrate_kernelILb1ELb1EEvPiS0_PKiiS2_S2_iPKfiiS4_iiS4_S4_S4_S4_PKbffii9ItpuLanes": "integrate_color",
    "_Z19itpu_raycast_kernelI15ItpuBlockReaderI13ItpuGridIndexELb0ELi1EEvT_iPKfS5_fS5_S5_iifPKbPf9ItpuLanes": "raycast",
    "_Z19itpu_raycast_kernelI15ItpuBlockReaderI13ItpuGridIndexELb1ELi1EEvT_iPKfS5_fS5_S5_iifPKbPf9ItpuLanes": "raycast",
    "_Z19itpu_raycast_kernelI15ItpuBlockReaderI13ItpuHashIndexELb0ELi1EEvT_iPKfS5_fS5_S5_iifPKbPf9ItpuLanes":
        "raycast_hash",
    "_Z19itpu_raycast_kernelI15ItpuBlockReaderI13ItpuHashIndexELb1ELi1EEvT_iPKfS5_fS5_S5_iifPKbPf9ItpuLanes":
        "raycast_hash",
    "_Z19itpu_raycast_kernelI15ItpuDenseReaderLb0ELi2EEvT_iPKfS3_fS3_S3_iifPKbPf9ItpuLanes": "raycast_dense",
    "_Z19itpu_raycast_kernelI15ItpuDenseReaderLb1ELi2EEvT_iPKfS3_fS3_S3_iifPKbPf9ItpuLanes": "raycast_dense",
    # the lock-step designs, reached only for comparisons: uncounted
    "_Z19itpu_raycast_kernelI15ItpuBlockReaderI19ItpuHashIndexSerialELb0ELi1EEvT_iPKfS5_fS5_S5_iifPKbPf9ItpuLanes":
        None,
    "_Z19itpu_raycast_kernelI15ItpuDenseReaderLb0ELi1EEvT_iPKfS3_fS3_S3_iifPKbPf9ItpuLanes": None,
    # the same, demangled
    "void itpu_icp_kernel<true>(float const*, float const*, int, int, float4 const*)": "icp_weighted",
    "void itpu_integrate_kernel<false, true>(int*, int*, int const*, int)": "integrate",
    "void itpu_raycast_kernel<ItpuBlockReader<ItpuGridIndex>, false, 1>(ItpuBlockReader<ItpuGridIndex>)": "raycast",
    "void itpu_raycast_kernel<ItpuBlockReader<ItpuHashIndex>, true, 1>(ItpuBlockReader<ItpuHashIndex>)":
        "raycast_hash",
    "void itpu_raycast_kernel<ItpuBlockReader<ItpuHashIndexSerial>, false, 1>(ItpuBlockReader)": None,
    "void itpu_raycast_kernel<ItpuDenseReader, false, 2>(ItpuDenseReader, int)": "raycast_dense",
    "void itpu_raycast_kernel<ItpuDenseReader, false, 1>(ItpuDenseReader, int)": None,
    # the probes' kernels P1-P6 (csrc/probes.cu), one instantiation of each
    "_Z24itpu_probe_gather_kernelIhLi0EEvPKT_PKiPS0_xii": "probe_gather",
    "_Z22itpu_probe_rows_kernelIaLi0ELi3EEvPKT_PS0_iPKiiiS5_S5_S5_PKfiff": "probe_rows",
    "_Z22itpu_probe_rows_kernelIfLi2ELi1EEvPKT_PS0_iPKiiiS5_S5_S5_PKfiff": "probe_rows",
    "_Z26itpu_probe_page_sum_kernelIaLb1EEvPKT_iPKiiiPfif": "probe_page_sum",
    "_Z23itpu_probe_scale_kernelPK6float4PS_if": "probe_scale",
    "_Z22itpu_probe_gemm_kernel14CUtensorMap_stS_P13__nv_bfloat16iii": "probe_gemm",
    # the designs P4 and P5 replaced, reached only for comparisons: uncounted
    "_Z30itpu_probe_scale_simple_kernelPK6float4PS_if": None,
    "_Z27itpu_probe_gemm_wmma_kernelPK13__nv_bfloat16S1_PS_iii": None,
    "_Z29itpu_probe_window_sums_kernelPKfiPKiiiiPfi": "probe_window_sums",
    # P1 at its other element sizes and modes (2 bytes along axis 0; 4 bytes along axis 1, demangled)
    "_Z24itpu_probe_gather_kernelItLi1EEvPKT_PKiPS0_xii": "probe_gather",
    "void itpu_probe_gather_kernel<unsigned int, 2>(unsigned int const*, int const*, unsigned int*, long long, int, "
    "int)": "probe_gather",
    # P2 in its chunked design, and the design it replaced (comparisons: uncounted)
    "_Z22itpu_probe_rows_kernelIaLi0ELi3EEvPKvPviPKiiiiiS4_S4_S4_PKfiffii": "probe_rows",
    "_Z22itpu_probe_rows_kernelIfLi1ELi1EEvPKvPviPKiiiiiS4_S4_S4_PKfiffii": "probe_rows",
    "_Z29itpu_probe_rows_simple_kernelIaLi0ELi3EEvPKT_PS0_iPKiiiS5_S5_S5_PKfiff": None,
    "void itpu_probe_rows_simple_kernel<float, 1, 1>(float const*, float*, int, int const*, int, int)": None,
    # P3 and P6 in their redesigned kernels, and the designs they replaced (comparisons: uncounted)
    "_Z26itpu_probe_page_sum_kernelIaLb1EEvPKT_iPKiiiPfifi": "probe_page_sum",
    "_Z26itpu_probe_page_sum_kernelIfLb0EEvPKT_iPKiiiPfifi": "probe_page_sum",
    "void itpu_probe_page_sum_kernel<float, true>(float const*, int, int const*, int, int, float*, int, float, int)":
        "probe_page_sum",
    "_Z29itpu_probe_window_sums_kernelILi64ELi2EEvPKfiPKiiiiiPfiii": "probe_window_sums",
    "void itpu_probe_window_sums_kernel<0, 0>(float const*, int, int const*, int, int, int, int, float*, int, int, "
    "int)": "probe_window_sums",
    "_Z33itpu_probe_page_sum_simple_kernelIaLb1EEvPKT_iPKiiiPfif": None,
    "void itpu_probe_page_sum_simple_kernel<float, false>(float const*, int, int const*, int, int, float*, int, "
    "float)": None,
    "_Z36itpu_probe_window_sums_simple_kernelPKfiPKiiiiPfi": None,
    "itpu_probe_window_sums_simple_kernel(float const*, int, int const*, int, int, int, float*, int)": None,
    # torch's own kernels and the division-step test kernel
    "_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_11FillFunctorIfEESt5arrayIPcLm1EEEEviT0_T1_": None,
    "_Z20itpu_div_step_kernelPKfS0_Pfi": None,
}


@pytest.mark.parametrize("symbol", list(KERNEL_SYMBOLS))
def test_kernel_function_names_map_to_their_counters(symbol):
    assert build.counter_of(symbol) == KERNEL_SYMBOLS[symbol]


def test_every_counter_has_a_kernel_function():
    assert {k for k in KERNEL_SYMBOLS.values() if k} == set(build.KERNELS)


@pytest.mark.parametrize("color", [False, True])
@pytest.mark.parametrize("lanes", [0, 2])
def test_dense_integration_in_place_equals_the_functional_update(color, lanes):
    """tsdf.integrate_dense written into the array (`into`) against the
    functional update on the same inputs, bit for bit, with stop_at_max_w
    (a few voxels at max_w stay frozen), colour, and at 2 lanes under
    torch.vmap; the array's tensors keep their memory."""
    rng = np.random.default_rng(5)
    shape = (6, 10, 12)
    n = max(lanes, 1)
    planes = [torch.from_numpy(a) for a in (
        rng.uniform(-1, 1, (n, *shape)).astype(np.float32), rng.integers(0, 6, (n, *shape)).astype(np.int32),
        rng.random((n, *shape, 3), dtype=np.float32), rng.integers(0, 6, (n, *shape)).astype(np.int32))]
    zs, ys, xs = (torch.arange(k, dtype=torch.float32) * 0.05 for k in shape)
    pts = (xs[None, None, :] - 0.3, ys[None, :, None] - 0.25, zs[:, None, None] + 0.6)
    depth = torch.from_numpy(rng.uniform(0.55, 0.95, IMG).astype(np.float32))
    rgb = torch.from_numpy(rng.random((*IMG, 3), dtype=np.float32))
    pose = torch.eye(4)

    def update(sdf, w, clr, wc, into):
        return tsdf.integrate_dense(sdf, w, pts, pose, PROJ, depth, 0.1, 5, stop_at_max_w=True,
                                    vol_clr=clr if color else None, vol_wc=wc if color else None, M_rgb=pose,
                                    proj_rgb=PROJ, rgb=rgb, into=into)

    before = [p.clone() for p in planes]
    ref = [update(*(p[b].clone() for p in planes), False) for b in range(n)]
    ids = [p.data_ptr() for p in planes]
    if lanes:
        got = torch.vmap(lambda *p: update(*p, True)[:4 if color else 2])(*planes)
    else:
        got = update(*(p[0] for p in planes), True)[:4 if color else 2]
    assert [p.data_ptr() for p in planes] == ids
    for b in range(n):
        for k in range(4 if color else 2):
            assert torch.equal(planes[k][b], ref[b][k])
            assert torch.equal(got[k][b] if lanes else got[k], ref[b][k])
    # the update moved weights (and colour weights), and voxels at max_w stayed
    for k in (1, 3) if color else (1,):
        assert int((planes[k] != before[k]).sum()) > 10
    assert int((before[1] == 5).sum()) > 100
