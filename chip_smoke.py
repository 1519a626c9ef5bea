#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (infinitam_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels (K1 ICP reduction, unweighted and
with per-pixel weights, K2 TSDF integration with and without its colour
half, K3 raycast through the block grid and its two reader variants, K3h
through the hash table and K3d over the dense voxel array) from
infinitam_tpu_torch/csrc/ and holds each one to its plain PyTorch version on
the card at the main path's shapes: K1 at each of the five pyramid levels,
unweighted and weighted by the ω pyramid of a bilateral-filtered frame's
σ_z, K2 and K3 on the 5 mm and on the 1 cm volume, K2's colour half over
three chained frames, K3h on the 5 mm volume, K3d on the 512³ dense array
after three dense frames; each raycast also with its device-side enable
flag false (the output must come back untouched) and true. For each kernel
it prints its device time (the summed
duration of its own kernels in a torch.profiler window of calls with
arguments built once; for K2, K2c and the raycasts also cold, with a 128 MB
buffer written before each call to empty the L2), the wrapper's call time (CUDA events
around back-to-back calls, which time the host while it issues more slowly
than the card runs), the plain version's time, and the kernel's bound: the
larger of its bytes (each input read once, each output written once) over
the card's memory rate and its float32 operations over the card's float32
rate, with the share of the bound that the device time reaches. Bytes and
operations are those this run's inputs need: the distinct pixels, grid
cells, hash entries (20 B each) and voxel or sdf words the kernel touches,
the voxels it updates and the march steps its rays take, found through its
plain version. Each raycast also prints the distinct 32-byte sectors its
loads touch, beside the bound. K3h and K3d are timed, warm and cold, beside
the design their lookahead replaced (the lock-step march on one CTA a tile
and, for K3h, the serial walk of a hash level), on the same inputs in the
same call, whose points must equal theirs; both designs' registers
(ptxas), resident CTAs per SM and waves of a frame's tiles are printed, and
K3's.

The kernels are lane-indexed (one launch serves B lanes of a torch.vmap
batch): K1 at each level, K2, K3 and K3d are also launched for 3 lanes
(copies of the same inputs, each lane with its own pose), each lane held to
its single launch (K1 and K2 bit for bit, K3 and K3d equal) and to the
plain twin, with the B = 3 device time printed beside 3 × the single
launch's.

The probes' kernels P1-P6 (csrc/probes.cu, the counterparts of the 16
`pallas_call`s of tools/probe2.py and probe6-13.py) are checked next, each
at every site's full shape: P1's gathers (probe2's four tables and its
take_along_axis, probe6's nine tables), P2's row updates (probe7, probe8's
six bodies, probe9, probe10's eight attempts, probe12's `integ`, probe13's
int8 row stores), P3 (probe9's page accumulator, probe13's raycast
skeleton), P4 (probe11's two and probe12's three decompositions), P5
(probe11's 2048³ bf16 product; also bit-equal on integer inputs) and P6
(probe13's window sums), each held to its plain twin (bit-equal where no sum
order differs, and P3 and P6, whose sums run in plain's order or are exact
integers; P2's taps within 1e-6, P5 within the float32 summation bound of
the exact product, rounded to bf16, with the elements more than one bf16
ulp from plain counted), with device time cold (the L2 flushed) and warm,
call, plain and library time (`torch.take`, `torch.gather`, `torch.mul`,
`torch.matmul`, `F.embedding_bag` at probe9's page accumulator: every
device kernel of the call) and the bound (bytes of the distinct 32-byte
sectors and rows the inputs touch; P5's operations over 989.4 TFLOP/s
bf16); P3 and P6 also beside an L2 floor (the warm time of a plain read,
`l2_read`, of an L2-resident buffer as large as their 32-byte sector
requests, de-duplicated only within a page or window row; a warm
`torch.sum` of it beside, for reference). P2-P6 are also timed, cold and
warm, beside the designs they replaced on the same inputs
(`row_update_simple`, `page_sum_simple`, `scaled_copy_simple`,
`gemm_bf16_wmma`, `window_sums_simple`, each held to plain too), gated on
being faster than them where the redesign is for. Then `python -m infinitam_tpu_torch.probes` runs in-process (its
main(), all nine probes on the card), the path of P1-P6's launch counts:
each must launch.

Then it replays 30 synthetic 640×480 RGB-D frames, rendered on the card,
through the port's frame loop in the three configurations of the JAX
package's benchmark: 5 mm and 1 cm voxels with depth ICP, and the 1 cm point
with colour fusion (`1cm_rgb`); and through MainEngine.process_frame, the
façade a user calls, at 5 mm with the weighted ICP tracker, the bilateral
filter and the sensor-noise model (`5mm_wicp`) and with the composite ICP →
Ren tracker (`5mm_ren`); at 5 mm with the approximate raycast
(`5mm_approx`); and through MainEngine with the host swap tier at 5 mm and
at 1 cm (`5mm_swap`, `1cm_swap`, each right after its config without
swapping; per replay it prints the blocks evicted, the needed-list entries
resolved and those merged with stored data, the store's block count and the
exchange's host waits, and at the end the swap ratio of frames/s); through
the dense frame step on the reference's 512³ voxel array (`dense_5mm`: K1
30, K2d and K3d once a frame); at 5 mm read through
the hash table (`5mm_hashprobe`: K3h instead of K3) and with the coarse
320×240 raycast pre-pass (`5mm_coarse2`: K3 twice a frame); through
parallel/batch.py's batched steps (`batched_5mm`: 4 sequences at 5 mm,
`batched_dense_5mm`: 2 on their own 512³ arrays; lane 0 replays the smoke's
frames, lane b make_trajectory(30, scale=1 − 0.15·b), each right after its
unbatched config; gated per lane on ATE, rotation and counters, on exactly
30 K1, 1 K2 and 1 K3 launches a step (dense: 30 K1, 1 K2d, 1 K3d), whatever the
lane count, and on no host sync; printed: steps/s, frames/s summed over the
lanes, batch_efficiency = that ÷ (B × the unbatched replay's frames/s in
this call), lane 0's largest camera-centre difference from the unbatched
replay, peak memory); each batched config's lanes again as 2 ranks, one
process each (`batched_5mm_ranks`: 2 × 2 lanes, `batched_dense_5mm_ranks`:
2 × 1; parallel/ranks.py starts them, parallel/batch.py's mesh splits the
lanes and all-reduces the fleet metrics; on one card the ranks share it
through gloo, which stages each all-reduce through host memory, on ≥ 2
cards one card a rank through NCCL; gated per lane on ATE, rotation,
counters and poses within 1e-6 m of a one-process replay of the rank's
lanes (its difference from the B-lane replay printed), on the fleet
metrics equal on both ranks, on exactly 30 K1, 1 K2 and 1 K3 launches a
step in each rank (dense: 30 K1, 1 K2d, 1 K3d), one all-reduce a step and no
other host sync, and on no module of JAX in a rank; printed: steps/s,
frames/s summed over the ranks, its ratio to the one-process batched
replay's in this call, each rank's peak memory, the all-reduce calls); and
10 frames at 5 mm on a render state without its
claim plane (`5mm_gridless`: the legacy allocator, gated as the others; its
final block set's symmetric difference from the compact allocator's over
the same frames printed). Each
replay prints, for the hash paths, the wanted blocks that no insert round
placed in their frame (n_alloc_unplaced, not gated), and each
replay is gated on tracking accuracy (ATE RMSE < 1 cm,
rotation RMSE < 1°), the silent-cap counters its path has (max over the
replay = 0; the dense path has none), every kernel of its path launched
(exact launches a frame for the three replays above and the swap and
approximate ones; the colour kernel on every frame,
the weighted K1 30 times a frame; at `5mm_ren` K1 28 times a frame, K2 and
K3 once; at `5mm_approx` K1 30 times, K2 and K3 once, and both raycast
branches taken: 0 < frames with a full raycast < 30) and no host sync in
its frame loop. The 5 mm map after its replay is meshed on the card
(blocks, triangles, seconds), gated on 0 dropped triangles, identical
triangles from two chunk sizes, host syncs that do not grow with the
chunks, vertices inside the synthetic scene and a 256-block subset equal
to the same code on a CPU copy of the volume; the dense map after its replay
is meshed on the card too (0 dropped triangles, vertices on the scene's
surface), and the share of valid depth pixels whose surface lies inside
the 512³ array is printed, with each replay's peak device memory. The
`5mm_hashprobe`, `5mm_coarse2` and `dense_5mm` poses are printed against
the 5 mm replay's (not gated). The `5mm_swap` engine then
looks away for one frame (turned π about y) and replays frames 0-9 from
frame 0's pose, gated on blocks evicted and merged back with stored data,
the ATE over that return, the counters and no host sync; `flush_swap` must
leave no eviction backlog and no block neither resident nor stored (its
difference from a no-swap engine over the same 41 frames is printed, not
gated); `save_engine` and `load_engine` into a fresh engine must give a
byte-equal raycast image and an equal next pose (seconds and file sizes
printed); and `apps/viewer.py` renders a 4-image orbit of the snapshot
(4 PNGs and index.html, one image > 1% filled). From the last `5mm_wicp`
engine it renders every `get_image` type, a freeview image from behind the
scene among them, and the colour image of a `1cm_rgb` engine, and holds the
live raycast image to the same render of the plain raycast (≤ 1 LSB on ≥
99.9% of the pixels). Then the port's bench (infinitam_tpu_torch/bench.py,
the counterpart of the JAX package's bench.py): run_config in process at
5 mm, which raises on a graph captured inside its timed replay or on poses
that differ from its correctness replay's, gated on K1, K2 and K3 launched
on every frame; then `python -m
infinitam_tpu_torch.bench` in two subprocesses, the default mode and
ITPU_BENCH_CONFIG=replay, their JSON lines gated on bench.py's keys, value
> 0, ATE < 1 cm, rotation < 1°, every max_* counter of the diag lines 0, a
finite swap ratio, and each frames/s within [0.5, 2]× the smoke's own
captured replay of the same config (printed beside it). Last, the headless runner (`apps/cli.py`) runs in-process on
30 synthetic frames with its raycast dumps and `--out-mesh` (an STL of 84 +
50·T bytes), and the committed PGM fixture replays through the port's
ImageFileReader, DeviceFrameFeed and MainEngine on the card (final pose
within 1 cm / 1° of its recorded trajectory).

Every replay runs as the port's users run it: each frame step (each step
of a batched replay, each step of a rank) one replay of a CUDA graph
(engine/captured.py, the port's counterpart of jax.jit; the swap configs'
step is captured once for each set of merge inputs and each slab size, and
the exchange's host half runs between replays). Each config also runs once op
by op in the same call: that run is the reference its captured poses are
gated on, bit for bit. The phase table reads the phase marks inside the
captured frame (engine/spans.py: a one-thread kernel node at each phase
boundary of the graph), from a captured run with the spans on. Per config it prints the graphs captured,
their nodes (kernels among them), capture seconds (warm-up frame included)
and pool size; frames/s come from the captured timed replays, each from a
fresh map written into the tensors the graph was captured with, so no
capture falls inside a clock; a captured run under the sync debug mode is
gated on no host sync, as the uncaptured one is.

Output: the card's name and power limit, the kernel build time, the kernel
lines, per config the accuracy, counters, frames with a full raycast, launch
counts and launches per frame, the source line of every host sync the frame
loop issued, and a per-phase time table; the mesh lines; the total wall
time; then, only if every gate passed, a JSON line with the kernel results
and, last, `{"ok": true, "device": {...}}`. Any failure exits non-zero
without those two lines. Without a CUDA device, or run from a directory
that is not a checkout of the repository, it exits 1 at once.

    python3 chip_smoke.py --profile [CONFIG ...]

runs the same gates and adds, per config (each one, or those named), a
torch.profiler window over the
last PROFILE_FRAMES frames of a captured replay and of an uncaptured one:
device busy time per frame (the union
of the intervals in which a kernel, copy or set ran on the card), device ops
per frame, wall time per frame under the profiler, and the largest device
consumers; for the two batched configs per step, with their device ops a
step gated below 2× a frame of their unbatched config (a loop over the
lanes would show as ~B×).

It also builds native/itpu_io.cpp with g++ into build/native/ (a gate) and
checks every config's allocation stride with assert_alloc_stride_safe, as
the JAX package's bench.py does.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch

IMG = (480, 640)
N_FRAMES = 30
N_CHECK_FRAMES = 3  # frames fused before the kernel checks
N_CHAIN_FRAMES = 3  # frames the K2 colour check fuses by kernel and by plain version
N_TIMED = 3  # timed replays per config
N_BACK = 10  # frames replayed from frame 0's pose in the 5mm_swap return phase
PROFILE_FRAMES = 10  # frames in the --profile window, the last of the replay
BATCH_LANES = 4  # lanes of batched_5mm
DENSE_LANES = 2  # lanes of batched_dense_5mm (1 GiB of array a lane)
N_GRIDLESS = 10  # frames of 5mm_gridless
LANE_CHECK = 3  # lanes of the lane-indexed kernel checks
N_RANKS = 2  # ranks of the two ranks phases
RANK_TIMEOUT = 600.0  # seconds a ranks phase's processes may take, all together
BENCH_TIMEOUT = 400.0  # seconds a `python -m infinitam_tpu_torch.bench` process may take
# the keys of the JSON line of the JAX package's bench.py, in order: the
# default mode's and the `replay` mode's
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "ate_rmse_m", "rot_rmse_deg", "fps_1cm_voxel",
              "ate_rmse_1cm_m", "rot_rmse_1cm_deg", "fps_1cm_rgb_fusion", "ate_rmse_rgb_m", "swap_fps_ratio")
REPLAY_KEYS = ("metric", "value", "unit", "vs_baseline", "t_err_mm", "frames")
REPO = Path(__file__).resolve().parent
SYNC_MSG = "called a synchronizing CUDA operation"

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet): HBM3 at
# 3.35 TB/s, float32 outside the tensor cores at 67 TFLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_BF16_PER_S = 989.4e12  # dense bf16 on the tensor cores: the probes' P5
# the designs a redesigned probe kernel is timed beside (probe_checks): the
# ones P2-P6 replaced
DESIGNS = ("simple_", "wmma_")
# the other keys of a probe site carried into the kernels line: P3's and
# P6's L2 floor
EXTRAS = ("l2_",)
# float32 operations per element, counted from the kernels' sources
ICP_OPS_PIXEL = 116  # csrc/icp.cu: back-projection, two transforms, projection, the point tap, the gate
ICP_OPS_VALID = 121  # a valid pixel's normal tap, b, A and its 29 products and sums
ICP_OPS_WEIGHT = 7  # the weighted variant's ω·A and ω·b
INTEGRATE_OPS_VOXEL = 37  # csrc/integrate.cu: centre, transform, projection, depth tap, η and its gate
INTEGRATE_OPS_UPDATE = 12  # an updated voxel's running average and quantisation
INTEGRATE_OPS_COLOR = 100  # a colour voxel's transform, projection, bilinear tap and colour average
INTEGRATE_OPS_DENSE_UPDATE = 8  # K2d's updated voxel: the running average, no quantisation
RAYCAST_OPS_RAY = 80  # csrc/raycast.cu: the ray from the pixel and its two depth bounds
# a march step of csrc/raycast.cu by its branch (a multiply-add counts 2):
RAYCAST_OPS_READ = 10  # every step: + 0.5, floor and convert per axis, the sdf ≤ 0 test
RAYCAST_OPS_DECODE = 2  # a block reader's found voxel: the int16 sdf's convert and scale (K3, K3h)
RAYCAST_OPS_FOUND = 10  # a found voxel's step: s·step_scale, max(·, 1), the position's 3 multiply-adds, total's add and test
RAYCAST_OPS_EMPTY = 34  # an empty voxel's DDA step: 7 a axis (·1/S, floor, + u, ·S, − p, ÷ d, the tiny select), 2 mins, + 0.01, max, min, then the position and total
RAYCAST_OPS_HIT = 95  # a hit's secant step and two trilinear refinements


def reference_settings(cfg):
    """The reference's default operating point, field for field as the JAX
    package's bench.py:52-75 reference_settings(): voxel 5 mm, mu 2 cm,
    5-level ICP, 96×96×80 block grid, 65,536 voxel blocks. The raycast page
    fields configure only the Pallas kernel and are ignored by the port."""
    return cfg.Settings(
        scene=cfg.SceneParams(voxel_size=0.005, mu=0.02, view_frustum_min=0.35, view_frustum_max=3.0),
        hashing=cfg.VoxelBlockHashParams(),
        tracking=cfg.TrackingParams(),
        block_grid=cfg.BlockGridParams(dims=(96, 96, 80), origin=(-48, -48, 0)),
        alloc_subsample=3,
        max_fused_blocks=16384,
        max_render_blocks=16384,
        raycast_page_blocks=12288,
        raycast_pages_per_tile=64,
        raycast_pages_small=24,
    )


def teddy_1cm_settings(cfg):
    """bench.py:78-92 teddy_1cm_settings(): voxel 1 cm, mu 4 cm."""
    return cfg.Settings(
        scene=cfg.SceneParams(voxel_size=0.01, mu=0.04, view_frustum_min=0.35, view_frustum_max=3.0),
        hashing=cfg.VoxelBlockHashParams(max_visible_blocks=0x2000),
        tracking=cfg.TrackingParams(),
        alloc_subsample=4,
    )


def color_settings(cfg):
    """bench.py:107-112's third configuration: 1 cm with colour fusion."""
    return teddy_1cm_settings(cfg).replace(use_color=True)


def wicp_settings(cfg):
    """The reference operating point with the weighted ICP tracker and its
    inputs: the 5× bilateral filter and the sensor-noise model."""
    return reference_settings(cfg).replace(tracker_type=cfg.TrackerType.WICP, model_sensor_noise=True,
                                           use_bilateral_filter=True)


def ren_settings(cfg):
    """The reference operating point with the composite ICP → Ren tracker
    (ICP at levels 4..1, then the SDF refinement against the volume)."""
    return reference_settings(cfg).replace(tracker_type=cfg.TrackerType.REN)


def approx_settings(cfg):
    """The reference operating point with the approximate raycast: the
    tracking maps are refreshed only when the camera is far from them."""
    return reference_settings(cfg).replace(use_approximate_raycast=True)


def dense_settings(cfg):
    """The reference's plain-voxel-array configuration (ITMPlainVoxelArray,
    its default 512³ voxels at offset (−256, −256, 0): 1 GiB of float32 sdf
    and int32 weight on the card) with reference_settings()' scene and
    tracking."""
    return reference_settings(cfg).replace(plain=cfg.PlainVoxelArrayParams())


def hashprobe_settings(cfg):
    """The reference operating point read through the hash table (the
    reference's own per-voxel hash lookup, ITMRepresentationAccess.h)
    instead of the block grid: the raycast is kernel K3h."""
    return reference_settings(cfg).replace(use_block_grid=False)


def coarse_settings(cfg):
    """The reference operating point with the JAX package's hierarchical
    raycast: a 320×240 pre-pass tightens the ranges of the full raycast."""
    return reference_settings(cfg).replace(raycast_coarse_factor=2)


def swap_settings(settings):
    """A configuration with the host swap tier on (reference
    ITMLibSettings::swappingMode, the JAX bench's swap point at 1 cm,
    bench.py:169-204): blocks that leave the view stream to a host store of
    1.81 GB (every hash entry's 512 voxels as int16 sdf and uint8 weight) and
    back when they return."""
    return settings.replace(swapping_mode=type(settings.swapping_mode).ENABLED)


# kernels each replay's path must launch, by launch-counter name
DEPTH_PATH = ("icp", "integrate", "raycast")
RGB_PATH = ("icp", "integrate_color", "raycast")
WICP_PATH = ("icp_weighted", "integrate", "raycast")
DENSE_PATH = ("icp", "integrate_dense", "raycast_dense")
HASHPROBE_PATH = ("icp", "integrate", "raycast_hash")
# the JSON name of each kernel → its launch counter
COUNTERS = ("n_alloc_overflow", "n_render_overflow", "n_pool_overflow", "n_too_big_blocks", "n_window_clipped")
COUNTER = {"icp_reduce": "icp", "icp_reduce_weighted": "icp_weighted", "integrate_depth": "integrate",
           "integrate_color": "integrate_color", "raycast_grid": "raycast", "raycast_hash_probe": "raycast_hash",
           **{k: k for k in ("integrate_dense", "raycast_dense", "probe_gather", "probe_rows", "probe_page_sum",
                             "probe_scale", "probe_gemm", "probe_window_sums")}}


# a raycast kernel's reader in its mangled name, and the kernel of each
# (reader, LA): the names of ops/kernels/raycast.py OCCUPANCY_KERNELS
RAYCAST_READERS = ("ItpuHashIndexSerial", "ItpuHashIndex", "ItpuGridIndex", "ItpuDenseReader")
RAYCAST_KERNELS = {("ItpuGridIndex", 1): "raycast", ("ItpuHashIndex", 1): "raycast_hash",
                   ("ItpuHashIndexSerial", 1): "raycast_hash_lockstep", ("ItpuDenseReader", 2): "raycast_dense",
                   ("ItpuDenseReader", 1): "raycast_dense_lockstep"}
RAYCAST_TEMPLATE = re.compile(r"Lb([01])ELi(\d+)E")  # LANES, LA


def raycast_registers(ptxas_report: dict) -> dict:
    """{(kernel, lanes): registers} of the raycast kernels in the build's
    ptxas output (`build.ptxas_report`), kernel as in RAYCAST_KERNELS."""
    regs = {}
    for report in ptxas_report.values():
        kernel = None
        for line in report.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1] if "'" in line else None
            elif kernel and "itpu_raycast_kernel" in kernel and "Used" in line:
                m = RAYCAST_TEMPLATE.search(kernel)
                reader = next(r for r in RAYCAST_READERS if r in kernel)
                key = (RAYCAST_KERNELS[reader, int(m.group(2))], bool(int(m.group(1))))
                regs[key] = int(re.search(r"Used (\d+) registers", line).group(1))
                kernel = None
    return regs


def kernel_resources(ptxas_report: dict, symbol: str) -> dict:
    """{"registers": n, "spills": ptxas's stack and spill line} of the
    first kernel whose name holds `symbol`, from the build's ptxas output."""
    out = {}
    for report in ptxas_report.values():
        kernel = None
        for line in report.splitlines():
            if "Compiling entry function" in line or "Function properties for" in line:
                kernel = line.split("'")[1] if "'" in line else line.rsplit(" ", 1)[-1]
            elif kernel and symbol in kernel and "spill" in line:
                out["spills"] = line.strip()
            elif kernel and symbol in kernel and "Used" in line:
                out["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
        if out:
            return out
    return out


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Call time: CUDA events around `reps` back-to-back calls of `fn` after
    one warm-up call, per call. While the host issues a call's work more
    slowly than the card runs it, this times the host."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


class L2Flush:
    """A 128 MB scratch buffer, 2.5× the H100's 50 MB L2: writing it before
    a call leaves none of the call's inputs in the cache (a cold call)."""

    def __init__(self, device):
        self.buf = torch.empty(32 * 2**20, dtype=torch.int32, device=device)
        self._names = None

    def __call__(self):
        self.buf.fill_(1)

    def names(self) -> set:
        """The names of the device ops a flush runs, from a profile of one
        flush taken at the first call (after the repo's kernels are loaded)."""
        if self._names is None:
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity
            from torch.profiler import profile as torch_profile

            self()
            torch.cuda.synchronize()
            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                self()
                torch.cuda.synchronize()
            self._names = {e.name for e in prof.events() if e.device_type == DeviceType.CUDA}
        return self._names


def device_ms(fn, reps: int, flush: L2Flush | None = None, match: str = "itpu_"):
    """(device ms, matched kernels, other device ops) per call of `fn`, from
    a torch.profiler window of `reps` calls after one warm-up call: the mean
    duration of the kernels whose name holds `match` (the repo's own,
    itpu_*, by default; "" matches every device op, as for a library call)
    times the kernels a call launches, and the device operations of any
    other kind a call ran. With `flush`, the L2 is flushed before each call
    (a cold time); the flush's device ops are left out of both counts. The
    profiler may lose an event at the window's edge, so the kernel count is
    rounded and the time is a mean over the kernels it saw; it has also
    lost a whole window's device events on the card. So a window in which
    it saw less than half a kernel a call, or device ops that are not a
    whole number a call (an event lost), is taken again, twice at most, and
    its counts are printed; the last window counts. The device ms is None
    when the profiler saw none of the matched kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    skip = set() if flush is None else flush.names()
    for window in range(3):
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        on_device = [e for e in prof.events() if e.device_type == DeviceType.CUDA and e.name not in skip]
        ours = [e for e in on_device if match in e.name]
        per_call = round(len(ours) / reps)
        if per_call > 0 and len(ours) % reps == 0 and len(on_device) % reps == 0:
            break
        print(f"  (profiler window {window + 1} of 3 lost events: {len(ours)} matched kernels and {len(on_device)} "
              f"device ops over {reps} calls; " + ("taken again)" if window < 2 else "kept as the last)"))
    others = (len(on_device) - len(ours)) / reps
    if per_call == 0:
        return None, per_call, others
    us = sum(e.time_range.end - e.time_range.start for e in ours)
    return us / 1000 / len(ours) * per_call, per_call, others


def bound(n_bytes: float, n_ops: float, peak_ops: float = PEAK_F32_PER_S) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over their rate (float32 unless
    `peak_ops` names another)."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, n_ops / peak_ops * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=int(n_bytes), bound_ops=int(n_ops))


def distinct(idx: torch.Tensor) -> int:
    """How many distinct values `idx` holds."""
    return int(torch.unique(idx).numel())


def sectors(offsets: torch.Tensor) -> int:
    """Bytes of the distinct 32-byte sectors the byte offsets fall in."""
    return 32 * distinct(offsets // 32)


def row_sectors(offsets: torch.Tensor) -> int:
    """Bytes of the 32-byte sector requests of a kernel that reads each row
    of `offsets` [rows, n] (byte offsets) once: the distinct sectors of each
    row, summed over the rows (a sector two rows share counts twice)."""
    s = torch.sort(offsets // 32, dim=1).values
    return 32 * int(s.shape[0] + (s[:, 1:] != s[:, :-1]).sum())


def bilinear_corners(u: torch.Tensor, v: torch.Tensor, width: int) -> torch.Tensor:
    """Flat indices of the 4 pixels a bilinear tap at (u, v) reads; (u, v)
    lie inside the 1 px margin, so no corner is clamped."""
    x0, y0 = torch.floor(u).long(), torch.floor(v).long()
    return torch.cat([(y0 + dy) * width + x0 + dx for dy in (0, 1) for dx in (0, 1)])


def ratio(a, b) -> str:
    return "n/a" if None in (a, b) else f"{a / b:.3f}"


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def timing_line(dev, per_call, others, b, call, plain) -> str:
    share = "n/a" if dev is None else f"{100 * b['bound_ms'] / dev:.1f}%"
    return (f"device {fmt_ms(dev)} ({per_call} kernel(s) and {others:g} other device op(s) per call), bound "
            f"{b['bound_ms'] * 1000:.2f} µs ({b['bound_bytes'] / 1e6:.2f} MB, {b['bound_ops'] / 1e6:.1f} Mop, "
            f"{b['bound_by']}), {share} of the bound, call {call:.4f} ms, plain {plain:.4f} ms")


def frame_errors(poses: np.ndarray, gt: np.ndarray):
    """Per frame, the camera centre's distance from the truth in metres and
    the rotation's angle from it in degrees (two arrays)."""
    t_err, r_err = [], []
    for p, g in zip(poses, gt):
        t_err.append(np.linalg.norm(np.linalg.inv(p)[:3, 3] - np.linalg.inv(g)[:3, 3]))
        dR = p[:3, :3] @ g[:3, :3].T
        r_err.append(np.degrees(np.arccos(np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0))))
    return np.array(t_err), np.array(r_err)


def trajectory_errors(poses: np.ndarray, gt: np.ndarray):
    """(ATE RMSE in metres, rotation RMSE in degrees) over frames 1..N-1, as
    the JAX package's bench.py:140-152 computes them (frame 0 is not
    tracked)."""
    t_err, r_err = frame_errors(poses, gt)
    return float(np.sqrt(np.mean(t_err[1:] ** 2))), float(np.sqrt(np.mean(r_err[1:] ** 2)))


def repo_stack(frames) -> str:
    """The repo's own frames of a stack, innermost first, as file:line."""
    sites = []
    for f in reversed(frames):
        path = Path(f.filename).resolve()
        if path.is_relative_to(REPO):
            sites.append(f"{path.relative_to(REPO)}:{f.lineno}")
    return " < ".join(sites[:6])


@contextlib.contextmanager
def flag_syncs(sites: list):
    """torch's sync debug mode over the block: the repo's source lines on the
    stack of each host sync it reports are appended to `sites` (the mode's
    one-time "prototype feature" notice is not a sync)."""
    def on_warning(message, *_args, **_kw):
        if SYNC_MSG in str(message):
            sites.append(repo_stack(traceback.extract_stack()[:-1]))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = on_warning
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield sites
        finally:
            torch.cuda.set_sync_debug_mode("default")


def back_pose() -> np.ndarray:
    """A camera behind the synthetic scene looking back at it: 3.2 m along
    z, turned 180° about y (tests/test_freeview_swap.py:53-73)."""
    R = np.array([[-1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, -1.0]])
    M = np.eye(4, dtype=np.float32)
    M[:3, :3] = R
    M[:3, 3] = -R @ np.array([0.0, 0.0, 3.2])
    return M


def filled(img: np.ndarray) -> float:
    """The share of an image's pixels with any non-zero channel."""
    return float((img.reshape(img.shape[0], img.shape[1], -1) > 0).any(-1).mean())


def gh_errors(a, b):
    """(largest relative difference of H, ∇ and f, largest absolute
    difference of the normalised system H/N, ∇/N, f) between two GHResults."""
    def rel(x, y):
        return float((x - y).abs().max() / y.abs().max().clamp(min=1e-30))

    def system(g):
        n = g.num_valid.clamp(min=1).to(torch.float32)
        return torch.cat([g.hessian.reshape(-1) / n, g.nabla / n, g.f.reshape(1)])
    return (max(rel(a.hessian, b.hessian), rel(a.nabla, b.nabla), rel(a.f, b.f)),
            float((system(a) - system(b)).abs().max()))


def camera_centres(poses: np.ndarray) -> np.ndarray:
    """The camera centres [..., 3] of world-to-camera poses [..., 4, 4]."""
    return np.linalg.inv(poses.astype(np.float64))[..., :3, 3]


# the state tensors of a MainEngine, which its frame step writes in place
ENGINE_STATE = ("vol", "render_state", "tracking_state")


def rank_phase(kind: str, settings, depth_file: str, proj: np.ndarray, share_card: bool) -> dict:
    """One rank of a ranks phase, in its own process (parallel/ranks.spawn
    sets the environment make_mesh reads). This rank's lanes of the fleet's
    frames (an .npy file of [steps, B, H, W] depth) go through the sharded
    batched step of `kind` ("batched" or "batched_dense"), captured (the
    all-reduce after each replay): a correctness run (poses, counters, the
    fleet metrics of every step, peak device memory; it captures the
    graph), a run under the sync debug mode (each host sync's source lines
    and the all-reduce calls), then N_TIMED timed runs, each from fresh
    maps written into the correctness run's tensors before a barrier that
    starts the ranks together (the first counts the kernel launches).
    Returns numpy arrays and plain values."""
    import torch.distributed as dist
    from infinitam_tpu_torch.engine import captured
    from infinitam_tpu_torch.engine.view_builder import View
    from infinitam_tpu_torch.ops.kernels import build
    from infinitam_tpu_torch.parallel import batch

    mesh = batch.make_mesh(share_card=share_card)
    torch.cuda.set_device(mesh.device)
    fleet = np.load(depth_file, mmap_mode="r")
    B = fleet.shape[1]
    lanes = mesh.lane_range(B)
    depths = torch.from_numpy(np.ascontiguousarray(fleet[:, lanes.start:lanes.stop])).to(mesh.device)
    proj = torch.as_tensor(proj, device=mesh.device)
    dense = kind == "batched_dense"
    fresh = batch.batched_state_dense if dense else batch.batched_state_hash
    step = (batch.make_batched_step_dense if dense else batch.make_batched_step)(settings, mesh)
    keys = ("mean_f", "mean_valid") + (() if dense else ("total_visible",))

    def run(state):
        poses, diags, metrics = [], [], []
        for d in depths:
            *state, m = step(*state, View(depth=d), proj)
            poses.append(state[-1].pose.clone())
            diags.append(m["diag"])
            metrics.append(m)
        return state, poses, diags, metrics

    torch.cuda.reset_peak_memory_stats()
    live, poses, diags, metrics = run(fresh(settings, IMG, B, mesh=mesh))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    syncs, reductions, all_reduce = [], [0], dist.all_reduce

    def counted_all_reduce(*args, **kwargs):  # batch.py reaches it through the module
        reductions[0] += 1
        return all_reduce(*args, **kwargs)

    captured.refill(live, fresh(settings, IMG, B, mesh=mesh))
    torch.cuda.synchronize()
    dist.all_reduce = counted_all_reduce
    try:
        with flag_syncs(syncs):
            run(live)
        torch.cuda.synchronize()
    finally:
        dist.all_reduce = all_reduce
    counters = {k: torch.stack([getattr(d, k) for d in diags]).amax(0).tolist() for k in COUNTERS
                if hasattr(diags[0], k)}
    unplaced = (torch.stack([d.n_alloc_unplaced for d in diags]).sum(0).tolist()
                if hasattr(diags[0], "n_alloc_unplaced") else None)
    out = dict(lanes=(lanes.start, lanes.stop), backend=dist.get_backend(), device=str(mesh.device),
               unplaced=unplaced, poses=torch.stack(poses).cpu().numpy(), counters=counters, keys=keys,
               metrics=np.array([[m[k].item() for k in keys] for m in metrics]), syncs=syncs,
               reductions=reductions[0], peak=peak)
    del poses, diags, metrics
    times = []
    for rep in range(N_TIMED):
        captured.refill(live, fresh(settings, IMG, B, mesh=mesh))
        torch.cuda.synchronize()
        dist.barrier()
        if rep == 0:
            build.reset_launch_counts()
        t0 = time.perf_counter()
        run(live)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if rep == 0:
            out["launches"] = build.launch_counts()
    out["times"] = times
    out["jax_modules"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "infinitam_tpu"))
    return out


class Smoke:
    def __init__(self):
        from infinitam_tpu_torch import calib, config
        from infinitam_tpu_torch.engine import captured, dense_pipeline, hash_pipeline, spans, trackers, volume
        from infinitam_tpu_torch.engine.main_engine import MainEngine
        from infinitam_tpu_torch.engine.view_builder import View, build_view_from_metric_depth
        from infinitam_tpu_torch.io import sources, synth
        from infinitam_tpu_torch.ops import hashing
        from infinitam_tpu_torch.ops import icp as icp_ops
        from infinitam_tpu_torch.ops import pyramid
        from infinitam_tpu_torch.ops import raycast as raycast_ops
        from infinitam_tpu_torch.ops.kernels import build, icp, integrate, raycast
        from infinitam_tpu_torch.utils import se3

        self.cfg, self.hp, self.trackers, self.synth, self.se3 = config, hash_pipeline, trackers, synth, se3
        self.captured, self.spans = captured, spans
        self.dp, self.vol_mod, self.hashing = dense_pipeline, volume, hashing
        self.pyramid, self.icp_ops, self.raycast_ops = pyramid, icp_ops, raycast_ops
        self.build, self.k_icp, self.k_int, self.k_ray = build, icp, integrate, raycast
        self.build_view = build_view_from_metric_depth
        self.View = View
        self.MainEngine, self.sources = MainEngine, sources
        self.dev = torch.device("cuda", 0)
        self.calib = calib.default_calib(IMG[1], IMG[0])
        self.proj = torch.as_tensor(self.calib.intrinsics_d.vector, device=self.dev)
        # as bench.py:107-112 passes them: rgb intrinsics and extrinsic of the calibration
        self.proj_rgb = torch.as_tensor(self.calib.intrinsics_rgb.vector, device=self.dev)
        self.rgb_to_depth = torch.as_tensor(self.calib.rgb_to_depth, device=self.dev)
        self.flush = L2Flush(self.dev)
        self.failures: list[str] = []
        self.poses: dict = {}  # each replay's correctness-run poses (numpy), by name
        self.ates: dict = {}  # each replay's ATE RMSE in metres, by name
        self.k3_points = None  # K3's points in the last k3_check, for K3h's comparison
        self.captures: dict = {}  # each replay's captured graphs (captured.graphs()), by name

    def gate(self, ok: bool, what: str) -> None:
        print(f"  gate {'PASS' if ok else 'FAIL'}: {what}")
        if not ok:
            self.failures.append(what)

    def frames(self):
        """(depth frames, rgb frames, ground-truth poses), rendered on the card."""
        src = self.synth.SyntheticSource(self.calib, n_frames=N_FRAMES, img_size=IMG, with_rgb=True, device=self.dev)
        frames = [src.get_images() for _ in range(N_FRAMES)]
        torch.cuda.synchronize()
        return [f[0] for f in frames], [f[1] for f in frames], src.gt_poses

    def fresh_state(self, settings):
        return self.hp.create_engine_state(settings, IMG, device=self.dev)

    def run_frames(self, settings, frames, state=None, capture=True):
        """The port's main path: view → process_frame_hash, frame by frame,
        from `state` (vol, render state, tracking state) or a fresh map,
        each frame a CUDA graph replay (`capture`; False: op by op). `frames`
        is (depths, rgbs); the rgb frames go
        into the view only when the settings use colour. `self.ages` keeps
        the tracking maps' age after each frame (device tensors, copies; 0:
        the maps were raycast anew)."""
        vol, rs, st = state or self.fresh_state(settings)
        depths, rgbs = frames
        poses, diags = [], []
        self.ages = []
        for d, rgb in zip(depths, rgbs):
            view = self.build_view(d, settings, self.calib, rgb=rgb if settings.use_color else None)
            vol, rs, st, diag = self.hp.process_frame_hash(vol, rs, st, view, self.proj, settings,
                                                           proj_rgb=self.proj_rgb, rgb_to_depth=self.rgb_to_depth,
                                                           capture=capture)
            poses.append(st.pose.clone())
            diags.append(diag)
            self.ages.append(st.age.clone())
        return vol, rs, st, poses, diags

    def fresh_engine(self, settings):
        return self.MainEngine(settings, self.calib, IMG, device=self.dev)

    def run_engine(self, settings, frames, engine=None, capture=True):
        """The path a user calls: MainEngine.process_frame on each frame,
        from `engine` or a fresh one (`capture` as in run_frames). Returns
        (engine, poses, diagnostics), device tensors all: nothing is read
        back in the loop. `self.ages` as in run_frames."""
        engine = engine or self.fresh_engine(settings)
        poses, diags = [], []
        self.ages = []
        for d, rgb in zip(*frames):
            diag = engine.process_frame(metric_depth=d, rgb=rgb if settings.use_color else None, capture=capture)
            poses.append(engine.tracking_state.pose.clone())
            diags.append(diag.device)
            self.ages.append(engine.tracking_state.age.clone())
        return engine, poses, diags

    def fused(self, settings, frames):
        """State after N_CHECK_FRAMES fused frames and the next frame's view."""
        depths, rgbs = frames
        vol, rs, st, _p, _d = self.run_frames(settings, (depths[:N_CHECK_FRAMES], rgbs[:N_CHECK_FRAMES]))
        view = self.build_view(depths[N_CHECK_FRAMES], settings, self.calib, rgb=rgbs[N_CHECK_FRAMES])
        return vol, rs, st, view

    def fresh_dense(self, settings):
        return self.dp.create_engine_state(settings, IMG, device=self.dev)

    def run_dense(self, settings, frames, state=None, capture=True):
        """The dense voxel array's path: view → process_frame_dense, frame by
        frame, from `state` (volume, tracking state) or a fresh 512³ volume.
        Returns (volume, tracking state, poses, diagnostics); `capture` and
        `self.ages` as in run_frames."""
        vol, st = state or self.fresh_dense(settings)
        poses, diags = [], []
        self.ages = []
        for d in frames[0]:
            view = self.build_view(d, settings, self.calib)
            vol, st, diag = self.dp.process_frame_dense(vol, st, view, self.proj, settings, capture=capture)
            poses.append(st.pose.clone())
            diags.append(diag)
            self.ages.append(st.age.clone())
        return vol, st, poses, diags

    def fresh_gridless(self, settings):
        """A fresh map whose render state has no claim plane (the trick of
        tests/test_hash_pipeline.py:188): process_frame_hash then takes the
        legacy allocator."""
        vol, rs, st = self.fresh_state(settings)
        return vol, rs._replace(cell_claim=None, entry_epoch=None, epoch=None), st

    @property
    def batch(self):
        """parallel/batch.py, imported on first use (tools/ probes time older
        checkouts, which lack it, through this class)."""
        from infinitam_tpu_torch.parallel import batch

        return batch

    def fresh_batched(self, settings, n_lanes: int = BATCH_LANES):
        return self.batch.batched_state_hash(settings, IMG, n_lanes, device=self.dev)

    def fresh_batched_dense(self, settings, n_lanes: int = DENSE_LANES):
        return self.batch.batched_state_dense(settings, IMG, n_lanes, device=self.dev)

    def run_batched(self, settings, frames, state=None, capture=True):
        """B sequences through parallel/batch.py's batched hash step:
        frames[0][f] is step f's depth of every lane [B, H, W]. Returns (vol,
        rs, tracking state, poses [B, 4, 4] a step, diagnostics with [B]
        fields a step); `capture` and `self.ages` as in run_frames."""
        vol, rs, st = state or self.fresh_batched(settings, frames[0][0].shape[0])
        step = self.batch.make_batched_step(settings)
        poses, diags = [], []
        self.ages = []
        for d in frames[0]:
            vol, rs, st, metrics = step(vol, rs, st, self.View(depth=d), self.proj, capture=capture)
            poses.append(st.pose.clone())
            diags.append(metrics["diag"])
            self.ages.append(st.age.clone())
        return vol, rs, st, poses, diags

    def run_batched_dense(self, settings, frames, state=None, capture=True):
        """B sequences through the batched dense step (as run_batched)."""
        vol, st = state or self.fresh_batched_dense(settings, frames[0][0].shape[0])
        step = self.batch.make_batched_step_dense(settings)
        poses, diags = [], []
        self.ages = []
        for d in frames[0]:
            vol, st, metrics = step(vol, st, self.View(depth=d), self.proj, capture=capture)
            poses.append(st.pose.clone())
            diags.append(metrics["diag"])
            self.ages.append(st.age.clone())
        return vol, st, poses, diags

    def runner(self, kind: str):
        """(run, fresh) of a replay kind: "frames" (process_frame_hash),
        "engine" (MainEngine.process_frame), "dense" (process_frame_dense),
        "gridless" (process_frame_hash on a state that takes the legacy
        allocator), "batched" or "batched_dense" (parallel/batch.py, lane
        frames)."""
        return {"frames": (self.run_frames, self.fresh_state), "engine": (self.run_engine, self.fresh_engine),
                "dense": (self.run_dense, self.fresh_dense), "gridless": (self.run_frames, self.fresh_gridless),
                "batched": (self.run_batched, self.fresh_batched),
                "batched_dense": (self.run_batched_dense, self.fresh_batched_dense)}[kind]

    def lane_frames(self, frames, gt, n_lanes: int):
        """Lane frames for a batched replay: lane 0 replays the smoke's own
        frames, lane b = 1.. make_trajectory(N_FRAMES, scale=1 − 0.15·b),
        rendered on the card. Returns ((per step [B, H, W] depths, Nones),
        the lanes' ground-truth poses)."""
        gts = [gt] + [self.synth.make_trajectory(N_FRAMES, scale=1.0 - 0.15 * b) for b in range(1, n_lanes)]
        steps = [torch.stack([frames[0][f]] + [self.synth.render_depth(torch.as_tensor(g[f], device=self.dev),
                                                                        self.proj, IMG) for g in gts[1:]])
                 for f in range(N_FRAMES)]
        torch.cuda.synchronize()
        return (steps, [None] * N_FRAMES), gts

    def inside_share(self, settings, frames, gt) -> float:
        """The share of valid depth pixels, over all frames, whose surface
        point at the true pose lies inside the dense array."""
        p = settings.plain
        lo = torch.tensor(p.offset, device=self.dev)
        hi = lo + torch.tensor(p.size, device=self.dev)
        fx, fy, cx, cy = self.proj
        h, w = IMG
        xs = torch.arange(w, dtype=torch.float32, device=self.dev)[None, :].expand(h, w)
        ys = torch.arange(h, dtype=torch.float32, device=self.dev)[:, None].expand(h, w)
        n_in = n_valid = 0
        for d, g in zip(frames[0], gt):
            inv = self.se3.invert(torch.as_tensor(g, device=self.dev))
            pw = self.se3.apply_planes(inv, (xs - cx) / fx * d, (ys - cy) / fy * d, d)
            vox = torch.floor(torch.stack(pw, -1) / settings.scene.voxel_size + 0.5)
            valid = d > 0
            inside = valid & ((vox >= lo) & (vox < hi)).all(-1)
            n_in, n_valid = n_in + int(inside.sum()), n_valid + int(valid.sum())
        return n_in / max(n_valid, 1)

    # --- what each kernel must move on its inputs -------------------------
    # The bound counts the distinct words a kernel reads and writes on this
    # run's inputs, found through its plain version's gates: 4 bytes a word,
    # not rounded to 32-byte sectors, so the bound is a least time.
    def icp_bytes(self, depth, view_proj, points_map, normals_map, scene_proj, inv_pose, scene_pose,
                  dist_thresh) -> int:
        """K1: every depth pixel; the distinct points-map pixels that the
        in-frame pixels' bilinear taps read and the distinct normals-map
        pixels of the pixels that pass the point gates (ops/icp.py
        compute_residuals); both intrinsics, both poses' rows 0-2 and the
        44-word result."""
        h, w = depth.shape
        hs, ws = points_map.shape[:2]
        vfx, vfy, vcx, vcy = view_proj
        sfx, sfy, scx, scy = scene_proj
        xs = torch.arange(w, dtype=torch.float32, device=self.dev)[None, :].expand(h, w)
        ys = torch.arange(h, dtype=torch.float32, device=self.dev)[:, None].expand(h, w)
        front = depth > 1e-8
        d = torch.where(front, depth, torch.ones_like(depth))
        p = self.se3.apply_planes(inv_pose, d * (xs - vcx) / vfx, d * (ys - vcy) / vfy, d)
        qx, qy, qz = self.se3.apply_planes(scene_pose, *p)
        front = front & (qz > 0)
        zs = torch.where(front, qz, torch.ones_like(qz))
        u, v = sfx * qx / zs + scx, sfy * qy / zs + scy
        inside = front & (u >= 0) & (u <= ws - 2) & (v >= 0) & (v <= hs - 2)
        passed = self.icp_ops.compute_residuals(depth, view_proj, points_map, normals_map, scene_proj, inv_pose,
                                                scene_pose, dist_thresh)[2]
        n_taps = distinct(bilinear_corners(u[inside], v[inside], ws)) + distinct(
            bilinear_corners(u[passed], v[passed], ws))
        return h * w * 4 + 16 * n_taps + 2 * 16 + 2 * 48 + 44 * 4

    def integrate_traffic(self, settings, vox, ids, entry_ptr, entry_pos, depth, pose, color=None):
        """(bytes, float32 operations) of K2 on these inputs, from the gates
        of its plain version (ops/tsdf.py): the fused rows of the visible
        list, the entry_ptr word of each row with an id and the three
        entry_pos words of each row with a block, the distinct depth pixels
        the in-frame voxels tap, each voxel that passes the η gate read and,
        unless frozen at max_w, updated and written. With `color` (rgb,
        M_rgb, proj_rgb), K2c adds the distinct rgb pixels of the colour
        voxels' bilinear taps and each colour voxel's vox_rgb word read and
        written."""
        sp, S = settings.scene, settings.hashing.block_size
        n_rows = self.k_int.n_rows(ids, settings.max_fused_blocks)
        ptrs, bpos = self.k_int.lookup_rows(ids, entry_ptr, entry_pos, settings.max_fused_blocks)
        valid, rows, pt = self.k_int._gather_rows(vox, ptrs, bpos, sp.voxel_size, S)
        live = valid[:, None].expand(-1, S**3)
        h, w = depth.shape
        fx, fy, cx, cy = self.proj
        px, py, pz = self.se3.apply_planes(pose, *pt)
        front = live & (pz > 0)
        zs = torch.where(front, pz, torch.ones_like(pz))
        u, v = fx * px / zs + cx, fy * py / zs + cy
        inside = front & (u >= 1) & (u <= w - 2) & (v >= 1) & (v <= h - 2)
        pix = (v + 0.5).to(torch.int32).clamp(0, h - 1) * w + (u + 0.5).to(torch.int32).clamp(0, w - 1)
        dm = depth.reshape(-1)[pix.long()]
        eta = dm - pz
        upd = inside & (dm > 0) & (eta >= -sp.mu)
        written = upd
        if sp.stop_integrating_at_max_w:
            written = upd & (self.hp.hv.vox_w(vox[rows]) < sp.max_w)
        n_written = int(written.sum())
        n_list = n_rows + int((ids[:n_rows] >= 0).sum()) + 3 * int(valid.sum())  # ids, entry_ptr, entry_pos words
        n_bytes = (4 * n_list + 64 + 1 + distinct(pix[inside]) * 4 + 4 * (int(upd.sum()) + n_written))
        n_ops = int(live.sum()) * INTEGRATE_OPS_VOXEL + n_written * INTEGRATE_OPS_UPDATE
        if color is not None:
            rgb, M_rgb, proj_rgb = color
            rh, rw = rgb.shape[:2]
            rfx, rfy, rcx, rcy = proj_rgb
            band = written & (eta <= sp.mu) & ((eta / sp.mu).abs() <= 0.25)
            qx, qy, qz = self.se3.apply_planes(M_rgb, *pt)
            zr = torch.where(qz == 0, torch.full_like(qz, 1e-6), qz)
            ur, vr = rfx * qx / zr + rcx, rfy * qy / zr + rcy
            col = band & (ur >= 1) & (ur <= rw - 2) & (vr >= 1) & (vr <= rh - 2)
            n_col = int(col.sum())
            n_bytes += 64 + distinct(bilinear_corners(ur[col], vr[col], rw)) * 12 + 8 * n_col
            n_ops += n_col * INTEGRATE_OPS_COLOR
        return n_bytes, n_ops

    def dense_integrate_traffic(self, settings, vol, depth, pose):
        """(bytes, float32 operations) of K2d on these inputs, from the gates
        of its plain version (ops/tsdf.py), a slab of z at a time: the
        distinct depth pixels the in-frame voxels tap, each voxel that
        passes the η gate read (sdf and weight) and, unless frozen at
        max_w, written; the three axes, the pose's rows and the
        intrinsics. Operations: every in-frame voxel's centre, transform,
        projection, tap and gates, and each written voxel's average."""
        sp, p = settings.scene, settings.plain
        xs, ys, zs = self.vol_mod.voxel_world_coords(p, sp.voxel_size, device=self.dev)
        h, w = depth.shape
        fx, fy, cx, cy = self.proj
        taps, n_in, n_pass, n_written = [], 0, 0, 0
        for z0 in range(0, zs.shape[0], 32):
            px, py, pz = self.se3.apply_planes(pose, xs, ys, zs[z0:z0 + 32])
            front = pz > 0
            zz = torch.where(front, pz, torch.ones_like(pz))
            u, v = fx * px / zz + cx, fy * py / zz + cy
            inside = front & (u >= 1) & (u <= w - 2) & (v >= 1) & (v <= h - 2)
            pix = (v + 0.5).to(torch.int32).clamp(0, h - 1) * w + (u + 0.5).to(torch.int32).clamp(0, w - 1)
            dm = depth.reshape(-1)[pix.long()]
            upd = inside & (dm > 0) & (dm - pz >= -sp.mu)
            written = upd & (vol.w_depth[z0:z0 + 32] < sp.max_w) if sp.stop_integrating_at_max_w else upd
            taps.append(torch.unique(pix[inside]))
            n_in, n_pass, n_written = n_in + int(inside.sum()), n_pass + int(upd.sum()), n_written + int(written.sum())
        n_bytes = 4 * distinct(torch.cat(taps)) + 8 * (n_pass + n_written) + 4 * sum(p.size) + 48 + 16
        return n_bytes, n_in * INTEGRATE_OPS_VOXEL + n_written * INTEGRATE_OPS_DENSE_UPDATE

    def k2d_check(self, settings, vol, st, view):
        """K2d on the dense 512³ array after N_CHECK_FRAMES dense frames,
        fusing the next frame at the last pose with the arguments
        integrate_frame_dense passes, against its plain twin run on the CPU
        (IEEE division, as the kernel's), bit for bit; the same twin run
        in torch ops on the card gives the plain time, and its difference
        is printed. Timed warm and cold (the L2 flushed before each call),
        with the share of tiles it culled."""
        sp = settings.scene
        axes = tuple(a.reshape(-1) for a in self.vol_mod.voxel_world_coords(settings.plain, sp.voxel_size,
                                                                            device=self.dev))
        kargs = (*axes, view.depth, st.pose, self.proj, sp.voxel_size, sp.mu, sp.max_w,
                 sp.stop_integrating_at_max_w)
        sk, wk = vol.sdf.clone(), vol.w_depth.clone()
        culled = torch.zeros((), dtype=torch.int64, device=self.dev)
        self.k_int.integrate_dense(sk, wk, *kargs, culled)
        n_tiles = self.k_int.dense_tiles(settings.plain.size)
        share = int(culled) / n_tiles
        ps, pw = (t.to("cpu", copy=True) for t in (vol.sdf, vol.w_depth))
        t0 = time.perf_counter()
        self.k_int.integrate_dense_plain(ps, pw, *(a.cpu() if torch.is_tensor(a) else a for a in kargs))
        cpu_s = time.perf_counter() - t0
        ndiff = int((sk.cpu() != ps).sum()) + int((wk.cpu() != pw).sum())
        changed = int((pw != vol.w_depth.cpu()).sum())
        cs, cw = vol.sdf.clone(), vol.w_depth.clone()
        self.k_int.integrate_dense_plain(cs, cw, *kargs)
        card_diff = int((cs.cpu() != ps).sum()) + int((cw.cpu() != pw).sum())
        card_err = float((cs.cpu() - ps).abs().max())
        del ps, pw
        b = bound(*self.dense_integrate_traffic(settings, vol, view.depth, st.pose))
        dev, per_call, others = device_ms(lambda: self.k_int.integrate_dense(sk, wk, *kargs), 50)
        cold, cold_per_call, cold_others = device_ms(lambda: self.k_int.integrate_dense(sk, wk, *kargs), 50,
                                                     self.flush)
        call = cuda_ms(lambda: self.k_int.integrate_dense(sk, wk, *kargs), 20)
        plain = cuda_ms(lambda: self.k_int.integrate_dense_plain(cs, cw, *kargs), 5)
        res = kernel_resources(self.build.ptxas_report, "itpu_integrate_dense_kernel")
        print(f"K2d integrate (dense {settings.plain.size}), 5 mm: {changed} voxels' weights changed, {ndiff} "
              f"sdf and weight words differ from the plain twin on the CPU ({cpu_s:.1f} s there); the twin in torch "
              f"ops on the card differs in {card_diff} (max {card_err:.3g}); {int(culled)} of {n_tiles} tiles "
              f"culled ({100 * share:.2f}%); ptxas {res}; " + timing_line(dev, per_call, others, b, call, plain))
        print(f"  K2d cold (L2 flushed before each call): device {fmt_ms(cold)}, "
              + ("n/a" if cold is None else f"{100 * b['bound_ms'] / cold:.1f}%") + " of the bound")
        self.gate(changed > 1000000 and 0 < int(culled) < n_tiles,
                  "K2d fused millions of voxels and culled some of the array's tiles, not all")
        self.gate(ndiff == 0, "K2d bit-identical to its plain twin at 512³")
        self.gate(per_call == 1 and others == 0 and cold_per_call == 1 and cold_others == 0,
                  "K2d: one device kernel per call, no other device op")
        return dict(name="integrate_dense", route="cuda", source="infinitam_tpu_torch/csrc/integrate.cu",
                    replaces="none (the JAX package's XLA fusion, infinitam_tpu/engine/dense_pipeline.py "
                             "integrate_frame_dense)", max_abs_err=0.0, ms=dev, cold_ms=cold, call_ms=call,
                    plain_ms=plain, library_ms=None, culled_share=share, registers=res.get("registers"), **b)

    def raycast_traffic(self, settings, read, touched, tables, inv_M, zmin, zmax, decode_ops):
        """(bytes, float32 operations, march steps by branch, sectors) of a K3 variant
        on these inputs. The plain march runs through `read` while `touched(pts)` logs,
        for each read of integer voxel points [..., 3], the entry of each
        table the kernel loads for it ({table: index [...] or [..., k], −1
        for none}); `tables` gives each table's (entries, bytes an entry).
        The kernel makes the march reads of the rays still active (a ray is
        active in its first `steps` reads, each logged as [H, W]) and the two
        trilinear refinement reads of the hits (each logged as one [8, H, W]
        read of its corners). Bytes: zmin, zmax, the points out, the distinct
        table entries loaded, inv_M's rows 0-2, proj (and, printed beside the
        bound, the distinct 32-byte sectors of the 4-byte word tables).
        Operations: each ray's
        set-up, each march step by the branch its read takes ("found": a
        found voxel with sdf > 0, "empty": a voxel not found, "stop": a found
        voxel with sdf ≤ 0, which ends the march) plus `decode_ops` for
        each found read, and each hit's refinement."""
        sp = settings.scene
        log = []

        def logged_read(pts):
            out = read(pts)
            log.append((pts.dim() == 3, touched(pts), out))
            return out

        res = self.raycast_ops.generic_raycast(logged_read, inv_M, self.proj, IMG, 1.0 / sp.voxel_size, sp.mu, zmin,
                                               zmax, block_size=settings.hashing.block_size)
        hit = res.points[..., 3] > 0
        seen = {k: torch.zeros(n, dtype=torch.bool, device=self.dev) for k, (n, _b) in tables.items()}
        steps = dict(found=0, empty=0, stop=0)
        for i, (march, idx, (s, found)) in enumerate(log):
            if march:
                active = res.steps > i
                steps["found"] += int((active & found & (s > 0)).sum())
                steps["empty"] += int((active & ~found).sum())
                steps["stop"] += int((active & found & (s <= 0)).sum())
            for k, ix in idx.items():
                keep = res.steps > i if march else hit[None]
                keep = keep.reshape(keep.shape + (1,) * (ix.dim() - keep.dim())).expand_as(ix)
                sel = ix[keep]
                seen[k][sel[sel >= 0].long()] = True
        n_rays = IMG[0] * IMG[1]
        assert sum(steps.values()) == int(res.steps.sum())
        # the 32-byte sectors of the 4-byte word tables the loads touch: what
        # the memory moves at least, where the bound counts the words
        sectors = sum(int(torch.cat([seen[k], seen[k].new_zeros(-seen[k].numel() % 8)]).view(-1, 8).any(1).sum())
                      for k, (_n, b) in tables.items() if b == 4)
        n_bytes = (n_rays * (4 + 4 + 16) + sum(int(seen[k].sum()) * b for k, (_n, b) in tables.items()) + 48 + 16)
        n_ops = (n_rays * RAYCAST_OPS_RAY + sum(steps.values()) * RAYCAST_OPS_READ
                 + (steps["found"] + steps["stop"]) * decode_ops + steps["found"] * RAYCAST_OPS_FOUND
                 + steps["empty"] * RAYCAST_OPS_EMPTY + int(hit.sum()) * RAYCAST_OPS_HIT)
        return n_bytes, n_ops, steps, sectors

    def grid_touched(self, settings, vol, grid):
        """K3's loads: the grid cell of the block and the voxel word."""
        gp, hp = settings.block_grid, settings.hashing
        hv = self.hp.hv
        flat_grid = grid.reshape(-1)
        dims = torch.tensor(gp.dims, device=self.dev)
        origin = torch.tensor(gp.origin, device=self.dev)

        def touched(pts):
            block, lin = hv.point_to_block(pts, hp.block_size)
            g = block - origin
            inb = ((g >= 0) & (g < dims)).all(dim=-1)
            cell = torch.where(inb, (g[..., 0] * gp.dims[1] + g[..., 1]) * gp.dims[2] + g[..., 2], -1)
            ptr = torch.where(inb, flat_grid[cell.clamp(min=0).long()], -1)
            return {"cell": cell, "word": torch.where(ptr >= 0, ptr * hp.block_volume + lin, -1)}

        return touched, {"cell": (flat_grid.numel(), 4), "word": (vol.vox.numel(), 4)}

    def hash_touched(self, settings, vol):
        """K3h's loads: the entries its walk of the block's hash chain reads
        (pos 12 B, ptr 4 B, offset 4 B: hash_volume.probe with
        include_swapped=False, at most MAX_PROBE) and the voxel word."""
        hp = settings.hashing
        hv = self.hp.hv

        def touched(pts):
            block, lin = hv.point_to_block(pts, hp.block_size)
            cur = self.hashing.hash_index(block, hp.hash_mask)
            alive = torch.ones(cur.shape, dtype=torch.bool, device=self.dev)
            walked = []
            for _k in range(hv.MAX_PROBE):
                walked.append(torch.where(alive, cur, -1))
                c = cur.long()
                match = (vol.entry_pos[c] == block).all(dim=-1) & (vol.entry_ptr[c] >= 0)
                off = vol.entry_offset[c]
                alive = alive & ~match & (off >= 1)
                cur = torch.where(alive, hp.n_buckets + off - 1, cur)
            pr = hv.probe(vol, block, hp, include_swapped=False)
            word = torch.where(pr.found, pr.entry_ptr.long() * hp.block_volume + lin, -1)
            return {"entry": torch.stack(walked, dim=-1), "word": word}

        return touched, {"entry": (hp.n_entries, 20), "word": (vol.vox.numel(), 4)}

    def dense_touched(self, settings, vol):
        """K3d's loads: the float32 sdf word of each voxel inside the array."""
        def touched(pts):
            idx, inb = self.vol_mod._flat_index(settings.plain, pts)
            return {"sdf": torch.where(inb, idx, -1)}

        return touched, {"sdf": (vol.sdf.numel(), 4)}

    # --- kernel checks ----------------------------------------------------
    def k1_check(self, settings, st, depth, weights=None):
        """K1 at each pyramid level's view depth against the full-resolution
        maps, from the last tracked pose (a Gauss-Newton start), as
        trackers.track_depth calls it, weighted by `weights` (the tracker's
        ω pyramid) when given; then two launches on the same input, which
        must agree bit for bit."""
        tp = settings.tracking
        depths = self.pyramid.build_depth_pyramid(depth, tp.n_levels)
        dists = self.trackers.level_dist_thresh(tp)
        iters = self.trackers.level_iterations(tp)
        inv = self.se3.invert(st.pose)
        label = "K1" if weights is None else "K1 weighted"
        levels = []
        for lvl in range(tp.n_levels):
            d = depths[lvl]
            omega = None if weights is None else weights[lvl]
            args = (d, self.trackers.scale_proj(self.proj, lvl), st.points_map, st.normals_map, self.proj, inv,
                    st.pose_point_cloud, dists[lvl], tp.min_valid_points)

            def kernel(args=args, omega=omega):
                return self.k_icp.icp_gh(*args, weights=omega)

            gk, gp = kernel(), self.k_icp.icp_gh_plain(*args, weights=omega)
            nk, np_ = int(gk.num_valid), int(gp.num_valid)
            rel, err = gh_errors(gk, gp)
            h, w = d.shape
            n_bytes = self.icp_bytes(*args[:8]) + (0 if omega is None else 4 * h * w)  # + the weight map
            n_ops = h * w * ICP_OPS_PIXEL + np_ * (ICP_OPS_VALID + (0 if omega is None else ICP_OPS_WEIGHT))
            b = bound(n_bytes, n_ops)
            dev, per_call, others = device_ms(kernel, 100)
            call = cuda_ms(kernel, 50)
            plain = cuda_ms(lambda: self.k_icp.icp_gh_plain(*args, weights=omega), 10)
            print(f"{label} icp level {lvl} ({w}×{h} px, {iters[lvl]} launches a frame): valid {nk} vs plain {np_}, "
                  f"H/∇/f max rel err {rel:.3e}, max abs err of (H/N, ∇/N, f) {err:.3e}; "
                  + timing_line(dev, per_call, others, b, call, plain))
            self.gate(nk == np_ and (lvl > 0 or np_ > 10000), f"{label} level {lvl} valid count equal to plain")
            self.gate(rel < 1e-4, f"{label} level {lvl} H, ∇, f within relative 1e-4 of plain")
            self.gate(per_call == 1 and others == 0,
                      f"{label} level {lvl}: one device kernel per call, no other device op")
            levels.append(dict(kernel=kernel, err=err, ms=dev, call_ms=call, plain_ms=plain, iters=iters[lvl], **b))
        frame_ms = (None if any(l["ms"] is None for l in levels)
                    else sum(l["iters"] * l["ms"] for l in levels))
        frame_bound = sum(l["iters"] * l["bound_ms"] for l in levels)
        print(f"{label} over a frame ({sum(iters)} launches): device {fmt_ms(frame_ms)}, bound "
              f"{frame_bound * 1000:.2f} µs, call {sum(l['iters'] * l['call_ms'] for l in levels):.4f} ms")
        a, b2 = levels[0]["kernel"](), levels[0]["kernel"]()
        same = all(torch.equal(x, y) for x, y in zip(a, b2))
        self.gate(same, f"{label} two launches on the same input bitwise equal")
        top = levels[0]
        name = "icp_reduce" if weights is None else "icp_reduce_weighted"
        return dict(name=name, route="cuda", source="infinitam_tpu_torch/csrc/icp.cu",
                    replaces="infinitam_tpu/ops/pallas/icp_kernel.py:261", max_abs_err=max(l["err"] for l in levels),
                    ms=top["ms"], call_ms=top["call_ms"], plain_ms=top["plain_ms"], library_ms=None,
                    **{k: top[k] for k in ("bound_ms", "bound_by", "bound_bytes", "bound_ops")},
                    frame_ms=frame_ms, frame_bound_ms=frame_bound,
                    level_ms=[l["ms"] for l in levels], level_bound_ms=[l["bound_ms"] for l in levels])

    def k2_check(self, label, settings, vol, rs, st, view):
        """K2 on the visible list of the next frame, from identical voxels,
        with the arguments integrate_into_scene passes; timed warm and cold
        (the L2 flushed before each call)."""
        sp = settings.scene
        depth = view.depth
        enable = torch.ones((), dtype=torch.bool, device=self.dev)
        kargs = (rs.visible_ids, vol.entry_ptr, vol.entry_pos, depth, st.pose, self.proj, enable, sp.voxel_size,
                 sp.mu, sp.max_w, sp.stop_integrating_at_max_w, settings.hashing.block_size, settings.max_fused_blocks)
        vox0 = vol.vox.clone()
        vk, vp = vox0.clone(), vox0.clone()
        self.k_int.integrate_depth(vk, *kargs)
        self.k_int.integrate_depth_plain(vp, *kargs)
        changed = int((vp != vox0).sum())
        ndiff = int((vk != vp).sum())
        lsb = int(((vk >> 16) - (vp >> 16)).abs().max())
        n_list = self.k_int.n_rows(rs.visible_ids, settings.max_fused_blocks)
        n_rows = int((self.k_int.lookup_rows(*kargs[:3], settings.max_fused_blocks)[0] >= 0).sum())
        b = bound(*self.integrate_traffic(settings, vox0, *kargs[:5]))
        dev, per_call, others = device_ms(lambda: self.k_int.integrate_depth(vk, *kargs), 50)
        cold, cold_per_call, cold_others = device_ms(lambda: self.k_int.integrate_depth(vk, *kargs), 50, self.flush)
        call = cuda_ms(lambda: self.k_int.integrate_depth(vk, *kargs), 20)
        plain = cuda_ms(lambda: self.k_int.integrate_depth_plain(vp, *kargs), 5)
        print(f"K2 integrate, {label}: {n_rows} visible blocks in a list of {n_list} rows, {changed} voxels updated, "
              f"{ndiff} differ from plain (max {lsb} LSB); " + timing_line(dev, per_call, others, b, call, plain))
        print(f"  K2 {label} cold (L2 flushed before each call): device {fmt_ms(cold)}, "
              + ("n/a" if cold is None else f"{100 * b['bound_ms'] / cold:.1f}%") + " of the bound")
        self.gate(n_rows >= 1000 and changed > 100000, f"K2 {label} fused thousands of blocks")
        # built with -fmad=false and the plain version's float64 camera
        # transform, so every voxel must match
        self.gate(ndiff == 0, f"K2 {label} bit-identical to plain")
        self.gate(per_call == 1 and others == 0 and cold_per_call == 1 and cold_others == 0,
                  f"K2 {label}: one device kernel per call, no other device op")
        return dict(name="integrate_depth", route="cuda", source="infinitam_tpu_torch/csrc/integrate.cu",
                    replaces="infinitam_tpu/ops/pallas/integrate_kernel.py:256", max_abs_err=lsb / 32767.0, ms=dev,
                    cold_ms=cold, call_ms=call, plain_ms=plain, library_ms=None, **b)

    def raycast_check(self, label, kernel, plain, args, traffic):
        """A K3 variant against its plain twin, both called with `args` (the
        main path's inputs): the hit mask equal and the points within 4e-6
        voxel; one device kernel and no other device op a call, warm and cold
        (the L2 flushed before each call); with the enable flag false the
        output keeps what it held, true the points equal the call without a
        flag. Returns the numbers of the JSON entry and the points."""
        pk = kernel(*args).points
        pp = plain(*args).points
        n_bytes, n_ops, steps, sectors = traffic
        n_steps = sum(steps.values())
        fk, fp = pk[..., 3] > 0, pp[..., 3] > 0
        n_mismatch = int((fk != fp).sum())
        both = fk & fp
        d = (pk[..., :3] - pp[..., :3]).norm(dim=-1)[both]
        n_hits = int(fp.sum())
        if not int(both.sum()):  # nothing to compare; the hits gate below fails
            d = torch.full((1,), float("nan"), device=self.dev)
        med, p95 = float(d.median()), float(torch.quantile(d, 0.95))
        err = float((pk[..., :3] - pp[..., :3]).abs()[both].max()) if int(both.sum()) else float("nan")
        b = bound(n_bytes, n_ops)
        dev, per_call, others = device_ms(lambda: kernel(*args), 50)
        cold, cold_per_call, cold_others = device_ms(lambda: kernel(*args), 50, self.flush)
        call = cuda_ms(lambda: kernel(*args), 20)
        plain_ms = cuda_ms(lambda: plain(*args), 2)
        print(f"{label}: {n_hits} plain hits, {n_mismatch} hit/miss mismatches, offset max {err:.3e} voxels, "
              f"{n_steps} march steps ({steps['found']} found, {steps['empty']} empty, {steps['stop']} at a hit); "
              + timing_line(dev, per_call, others, b, call, plain_ms))
        print(f"  {label} cold (L2 flushed before each call): device {fmt_ms(cold)} ({cold_per_call} kernel(s) "
              f"and {cold_others:g} other device op(s) per call), "
              + ("n/a" if cold is None else f"{100 * b['bound_ms'] / cold:.1f}%") + " of the bound")
        sector_ms = sectors * 32 / PEAK_BYTES_PER_S * 1e3
        print(f"  {label}: its loads touch {sectors} distinct 32-byte sectors of its word tables "
              f"({sectors * 32 / 1e6:.2f} MB, {sector_ms * 1000:.2f} µs at the memory rate; not the bound, which "
              "counts the words)")
        # for reading only: the bars the JAX package holds its Pallas raycast to
        print(f"  (Pallas-vs-XLA bars, not gated: agreement {1 - n_mismatch / fp.numel():.6f} > 0.93, "
              f"median offset {med:.3e} < 0.5, p95 {p95:.3e} < 2 voxels)")
        self.gate(int(both.sum()) > 100000, f"{label} hits most of the frame")
        # same march and refinement as the plain version in the same float32
        # ops: hits must agree ray for ray and points to a few 1e-6 voxel
        # (below one float32 ulp beyond 32 voxels, so there they are equal)
        self.gate(n_mismatch == 0 and err <= 4e-6, f"{label} hit mask equal to plain, points within 4e-6 voxel")
        self.gate(per_call == 1 and others == 0 and cold_per_call == 1 and cold_others == 0,
                  f"{label}: one device kernel per call, no other device op")
        # the device-side enable flag (the approximate raycast): false, no
        # ray is marched and the output keeps what it held; true, the
        # points are those of the call without a flag
        on, off = (torch.full((), v, dtype=torch.bool, device=self.dev) for v in (True, False))
        sentinel = torch.full((*IMG, 4), -7.0, device=self.dev)
        kept = kernel(*args, enable=off, out=sentinel.clone()).points
        same = kernel(*args, enable=on).points
        buf = torch.empty_like(sentinel)
        dev_off, per_call_off, others_off = device_ms(lambda: kernel(*args, enable=off, out=buf), 50)
        print(f"  {label} with its enable flag: false → output untouched {torch.equal(kept, sentinel)}, device "
              f"{fmt_ms(dev_off)} ({per_call_off} kernel(s), {others_off:g} other op(s) a call) against "
              f"{fmt_ms(dev)} with the flag true; true → equal to the call without a flag {torch.equal(same, pk)}")
        self.gate(torch.equal(kept, sentinel), f"{label} flag false leaves the output untouched")
        self.gate(torch.equal(same, pk), f"{label} flag true equal to the call without a flag")
        self.gate(per_call_off == 1 and others_off == 0, f"{label} flag false: one device kernel, no other op")
        return dict(max_abs_err=err, ms=dev, cold_ms=cold, call_ms=call, plain_ms=plain_ms, library_ms=None,
                    flag_false_ms=dev_off, march_steps=n_steps, march_steps_found=steps["found"],
                    march_steps_empty=steps["empty"], **b), pk

    def design_lines(self, kernel: str) -> tuple:
        """(registers from ptxas, resident CTAs per SM, waves of a frame's
        16×8 tiles) of a raycast kernel (ops/kernels/raycast.py
        OCCUPANCY_KERNELS) at B = 1."""
        regs = raycast_registers(self.build.ptxas_report).get((kernel, False))
        ctas, sms = self.k_ray.occupancy(kernel)
        tiles = ((IMG[1] + 15) // 16) * ((IMG[0] + 7) // 8)
        return regs, ctas, tiles / max(ctas * sms, 1)

    def lockstep_check(self, label, kernel, design, lockstep_fn, args, points, entry):
        """The lock-step design the kernel replaced (LA 1 and, for K3h, the
        serial walk of a hash level) on the main path's inputs: its points
        must equal the main path design's (`design`, so both hold the plain
        twin's bar), and both designs' device times, warm and cold in this
        call, are printed with their registers, resident CTAs per SM, waves
        and share of the bound. Adds them to `entry`."""
        lock = lockstep_fn(*args).points
        same = torch.equal(lock, points)
        dev, per_call, others = device_ms(lambda: lockstep_fn(*args), 50)
        cold, _pc, _o = device_ms(lambda: lockstep_fn(*args), 50, self.flush)
        m_regs, m_ctas, m_waves = self.design_lines(kernel)
        l_regs, l_ctas, l_waves = self.design_lines(kernel + "_lockstep")

        def share(ms):
            return "n/a" if ms is None else f"{100 * entry['bound_ms'] / ms:.1f}%"

        print(f"  {label}, main path design ({design}): {m_regs} registers, {m_ctas} CTAs per SM, {m_waves:.2f} "
              f"waves; device warm {fmt_ms(entry['ms'])} ({share(entry['ms'])} of the bound), cold "
              f"{fmt_ms(entry['cold_ms'])}")
        print(f"  {label}, the lock-step design on the same inputs: points equal to the main path design's {same}; "
              f"{l_regs} registers, {l_ctas} CTAs per SM, {l_waves:.2f} waves; device warm {fmt_ms(dev)} "
              f"({share(dev)} of the bound; {per_call} kernel(s), {others:g} other op(s) a call), cold "
              f"{fmt_ms(cold)}; main path ÷ lock-step warm "
              + ("n/a" if None in (dev, entry["ms"]) else f"{entry['ms'] / dev:.3f}"))
        self.gate(same, f"{label}: the lock-step design's points equal the main path design's")
        entry.update(registers=m_regs, ctas_per_sm=m_ctas, lockstep_ms=dev, lockstep_cold_ms=cold,
                     lockstep_registers=l_regs, lockstep_ctas_per_sm=l_ctas)

    def k3_check(self, label, settings, vol, rs, st):
        """K3 from the last pose over the fused volume, against the plain
        lock-step march on the same ranges."""
        sp = settings.scene
        zmin, zmax, _ = self.hp.expected_depth_ranges(vol, rs, st.pose, self.proj, IMG, settings)
        grid = self.hp.hv.get_block_grid(vol, settings.block_grid)
        rargs = (vol, grid, settings.block_grid, settings.hashing, self.se3.invert(st.pose), self.proj, IMG,
                 1.0 / sp.voxel_size, sp.mu, zmin, zmax)
        read = self.hp.hv.make_grid_reader(vol, grid, settings.block_grid, settings.hashing)
        traffic = self.raycast_traffic(settings, read, *self.grid_touched(settings, vol, grid), rargs[4], zmin, zmax,
                                       RAYCAST_OPS_DECODE)
        n_rows = int(self.hp._visible_rows(vol, rs, 0)[3].sum())
        print(f"K3 raycast, {label}: {n_rows} visible blocks")
        entry, points = self.raycast_check(f"K3 {label}", self.k_ray.raycast_grid, self.k_ray.raycast_grid_plain,
                                           rargs, traffic)
        regs, ctas, waves = self.design_lines("raycast")
        print(f"  K3 {label}: {regs} registers, {ctas} CTAs per SM, {waves:.2f} waves of a frame's tiles")
        entry.update(registers=regs, ctas_per_sm=ctas)
        self.k3_points = points
        return dict(name="raycast_grid", route="cuda", source="infinitam_tpu_torch/csrc/raycast.cu",
                    replaces="infinitam_tpu/ops/pallas/raycast_kernel.py:500", **entry)

    def k3h_check(self, settings, vol, rs, st):
        """K3h from the last pose over the fused 5 mm volume, read through the
        hash table, against its plain twin (the march over make_hash_reader)
        on the ranges of the main path; its points against K3's on the same
        map are printed (the map lies inside the grid's window)."""
        sp, hp = settings.scene, settings.hashing
        zmin, zmax, _ = self.hp.expected_depth_ranges(vol, rs, st.pose, self.proj, IMG, settings)
        rargs = (vol, hp, self.se3.invert(st.pose), self.proj, IMG, 1.0 / sp.voxel_size, sp.mu, zmin, zmax)
        traffic = self.raycast_traffic(settings, self.hp.hv.make_hash_reader(vol, hp),
                                       *self.hash_touched(settings, vol), rargs[2], zmin, zmax,
                                       RAYCAST_OPS_DECODE)
        entry, points = self.raycast_check("K3h raycast (hash probe), 5 mm", self.k_ray.raycast_hash_probe,
                                           self.k_ray.raycast_hash_probe_plain, rargs, traffic)
        self.lockstep_check("K3h", "raycast_hash", "LA 1, a hash level in one round trip",
                            self.k_ray.raycast_hash_probe_lockstep, rargs, points, entry)
        print(f"  K3h against K3 on the same map and ranges: equal {torch.equal(points, self.k3_points)}")
        return dict(name="raycast_hash_probe", route="cuda", source="infinitam_tpu_torch/csrc/raycast.cu",
                    replaces="infinitam_tpu/ops/pallas/raycast_kernel.py:500",
                    stands_for="infinitam_tpu/engine/hash_pipeline.py:1162 (the XLA march over "
                               "hash_volume.make_hash_reader)", **entry)

    def k3d_check(self, settings, vol, st):
        """K3d from the last pose over the dense 512³ volume after
        N_CHECK_FRAMES dense frames, against its plain twin (the march over
        volume.make_dense_reader) over the frustum's depth range, as
        dense_pipeline.raycast_dense passes it."""
        sp = settings.scene
        zmin = torch.full(IMG, sp.view_frustum_min, dtype=torch.float32, device=self.dev)
        zmax = torch.full(IMG, sp.view_frustum_max, dtype=torch.float32, device=self.dev)
        rargs = (vol, settings.plain, self.se3.invert(st.pose), self.proj, IMG, 1.0 / sp.voxel_size, sp.mu, zmin,
                 zmax)
        read = self.vol_mod.make_dense_reader(vol, settings.plain)
        traffic = self.raycast_traffic(settings, read, *self.dense_touched(settings, vol), rargs[2], zmin, zmax,
                                       0)
        entry, points = self.raycast_check("K3d raycast (dense 512³), 5 mm", self.k_ray.raycast_dense,
                                           self.k_ray.raycast_dense_plain, rargs, traffic)
        self.lockstep_check("K3d", "raycast_dense", "LA 2", self.k_ray.raycast_dense_lockstep, rargs, points,
                            entry)
        return dict(name="raycast_dense", route="cuda", source="infinitam_tpu_torch/csrc/raycast.cu",
                    replaces="infinitam_tpu/ops/pallas/raycast_kernel.py:500",
                    stands_for="infinitam_tpu/engine/dense_pipeline.py:93 (the XLA march over "
                               "volume.make_dense_reader)", **entry)

    def color_kernel_check(self, settings, vol, rs, frames, gt):
        """K2 with its colour half against its plain version on the 1 cm RGB
        volume after N_CHECK_FRAMES fused frames. The next N_CHAIN_FRAMES
        RGB-D frames are fused at their true poses into that volume's visible
        blocks, by the kernel into one copy and by the plain version into
        another; each copy carries its own result into the next frame, and
        the two are compared word for word after every frame. Done with the
        calibration's extrinsic and again with a non-identity one (rgb camera
        2.5 cm along x, turned 1.5° about y, other intrinsics), so the RGB
        projection is exercised."""
        depths, rgbs = frames
        chain = range(N_CHECK_FRAMES, N_CHECK_FRAMES + N_CHAIN_FRAMES)
        views = [self.build_view(depths[i], settings, self.calib, rgb=rgbs[i]) for i in chain]
        poses = [torch.as_tensor(gt[i], device=self.dev) for i in chain]
        sp = settings.scene
        rows = (rs.visible_ids, vol.entry_ptr, vol.entry_pos)
        fuse = (torch.ones((), dtype=torch.bool, device=self.dev), sp.voxel_size, sp.mu, sp.max_w,
                sp.stop_integrating_at_max_w, settings.hashing.block_size, settings.max_fused_blocks)
        other_r2d = self.se3.se3_exp(torch.tensor([0.025, 0.0, 0.0, 0.0, float(np.radians(1.5)), 0.0],
                                                  device=self.dev))
        other_proj = self.proj_rgb * torch.tensor([1.04, 1.03, 1.0, 1.0], device=self.dev) + torch.tensor(
            [0.0, 0.0, 1.5, -1.0], device=self.dev)
        n_rows = int((self.k_int.lookup_rows(*rows, settings.max_fused_blocks)[0] >= 0).sum())
        entry = None
        for label, r2d, proj_rgb in (("calibration extrinsic", self.rgb_to_depth, self.proj_rgb),
                                     ("2.5 cm / 1.5° extrinsic", other_r2d, other_proj)):
            k = (vol.vox.clone(), vol.vox_rgb.clone())
            p = (vol.vox.clone(), vol.vox_rgb.clone())
            chain_args = [(*rows, view.depth, view.rgb, pose, self.proj,
                           (self.se3.invert(r2d) @ pose).contiguous(), proj_rgb, *fuse)
                          for view, pose in zip(views, poses)]
            n_depth, n_color, nd_vox, nd_rgb, lsb = [], [], 0, 0, 0
            for kargs in chain_args:
                before = (p[0].clone(), p[1].clone())
                self.k_int.integrate_rgbd(*k, *kargs)
                self.k_int.integrate_rgbd_plain(*p, *kargs)
                n_depth.append(int((p[0] != before[0]).sum()))
                n_color.append(int((p[1] != before[1]).sum()))
                nd_vox += int((k[0] != p[0]).sum())
                nd_rgb += int((k[1] != p[1]).sum())
                ch = [((k[1] >> s) & 0xFF) - ((p[1] >> s) & 0xFF) for s in (24, 16, 8)]
                lsb = max(lsb, int(max(c.abs().max() for c in ch)))
            print(f"K2 integrate + colour, {label}: {n_rows} visible blocks, {N_CHAIN_FRAMES} chained "
                  f"frames updated {'+'.join(map(str, n_depth))} depth and {'+'.join(map(str, n_color))} = "
                  f"{sum(n_color)} colour voxels, {nd_vox} vox and {nd_rgb} vox_rgb words differ from plain over "
                  f"the chain (max {lsb} LSB)")
            # the ±μ/4 colour band holds ~80-90 k voxels a frame at 1 cm
            self.gate(sum(n_color) > 100000, f"K2 colour ({label}) made more than 100,000 colour-voxel updates")
            # the plain version's op order in -fmad=false float32: every word equal
            self.gate(nd_vox == 0 and nd_rgb == 0, f"K2 colour ({label}) bit-identical to plain")
            if entry is None:
                # timed on the first frame of the chain, over the chain's result
                depth, rgb, pose, _proj, M_rgb, rgb_proj = chain_args[0][3:9]
                b = bound(*self.integrate_traffic(settings, k[0], *rows, depth, pose, color=(rgb, M_rgb, rgb_proj)))
                dev, per_call, others = device_ms(lambda: self.k_int.integrate_rgbd(*k, *chain_args[0]), 50)
                cold, cold_per_call, cold_others = device_ms(
                    lambda: self.k_int.integrate_rgbd(*k, *chain_args[0]), 50, self.flush)
                call = cuda_ms(lambda: self.k_int.integrate_rgbd(*k, *chain_args[0]), 20)
                plain = cuda_ms(lambda: self.k_int.integrate_rgbd_plain(*p, *chain_args[0]), 5)
                print("  K2c (first frame of the chain): " + timing_line(dev, per_call, others, b, call, plain))
                print(f"  K2c cold (L2 flushed before each call): device {fmt_ms(cold)}, "
                      + ("n/a" if cold is None else f"{100 * b['bound_ms'] / cold:.1f}%") + " of the bound")
                self.gate(per_call == 1 and others == 0 and cold_per_call == 1 and cold_others == 0,
                          "K2c: one device kernel per call, no other device op")
                entry = dict(name="integrate_color", route="cuda", source="infinitam_tpu_torch/csrc/integrate.cu",
                             replaces="infinitam_tpu/ops/pallas/integrate_kernel.py:256", max_abs_err=lsb / 255.0,
                             ms=dev, cold_ms=cold, call_ms=call, plain_ms=plain, library_ms=None, **b)
        return entry

    # --- replays ------------------------------------------------------------
    def replay(self, name, settings, frames, gt, path, kind="frames", expected=None):
        """Replay `frames` through the hash frame step, through MainEngine or
        through the dense frame step (`kind`, see runner), each frame a CUDA
        graph replay:
        an uncaptured run op by op (the reference), a captured correctness
        run (poses against the reference's, counters, peak device memory,
        the graphs it captured), N_TIMED timed runs (the first one counts
        kernel launches), a captured run under the sync debug mode, each
        from a fresh map written into the correctness run's tensors (the
        graph stays), an uncaptured run under the sync debug mode, and the
        phase table from two captured runs with the spans on (phase_table).
        `expected` maps launch counters to the launches each frame must
        make. Returns the launch counts, the correctness run's final state
        (its engine through MainEngine, else its volume) and (frames/s of
        the timed runs, the marked replays' begin-to-end ms a frame).
        With swapping it prints the exchange's counts and host waits."""
        depths = frames[0]
        run, fresh = self.runner(kind)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # 0) the uncaptured run: the reference for the captured poses
        ref = torch.stack(run(settings, frames, fresh(settings), capture=False)[-2]).cpu().numpy()
        self.captured.clear()  # the graphs of earlier phases: what follows counts this replay's
        torch.cuda.synchronize()
        peak_eager = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        # 1) correctness run, captured: poses, counters (read after the loop)
        t0 = time.perf_counter()
        final, *rest, poses, diags = run(settings, frames, fresh(settings))
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        graphs = self.captured.graphs()
        live = final if kind == "engine" else (final, *rest)
        del rest
        swap = kind == "engine" and final.swapping
        waits = []  # the exchange's host waits in each timed run, then the uncaptured run
        poses_np = torch.stack(poses).cpu().numpy()
        ate, rot = trajectory_errors(poses_np.astype(np.float64), gt.astype(np.float64))
        self.poses[name], self.ates[name] = poses_np.astype(np.float64), ate
        # the counters the path has (the dense path's diagnostics have none)
        counters = {k: int(torch.stack([getattr(d, k) for d in diags]).max()) for k in COUNTERS
                    if hasattr(diags[0], k)}
        n_vis = int(diags[-1].n_visible) if hasattr(diags[-1], "n_visible") else "n/a"
        # the hash paths' wanted blocks that no insert round placed in their
        # frame (retried the next one): printed, not gated
        unplaced = (torch.stack([d.n_alloc_unplaced for d in diags]).tolist()
                    if hasattr(diags[0], "n_alloc_unplaced") else None)
        # frames whose maps were raycast anew (age 0), a device count read
        # after the replay
        n_full = int((torch.stack(self.ages) == 0).sum())

        # 2) timed runs, each from a fresh map written into the correctness
        #    run's tensors before its clock starts (host-clock times spread:
        #    the card's host is shared); the launch counts cover exactly the
        #    first run
        times = []
        for rep in range(N_TIMED):
            state = self.refill(kind, live, settings)
            torch.cuda.synchronize()
            if rep == 0:
                self.build.reset_launch_counts()
            t0 = time.perf_counter()
            run(settings, frames, state)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if rep == 0:
                launches = self.build.launch_counts()
            if swap:
                waits.append(state.swap_exchange.n_waits)
        dt = float(np.median(times))
        # the captured replays under torch's sync debug mode
        captured_syncs = []
        state = self.refill(kind, live, settings)
        torch.cuda.synchronize()
        with flag_syncs(captured_syncs):
            run(settings, frames, state)
        torch.cuda.synchronize()

        # 3) the uncaptured run under the sync debug mode: torch reports each
        #    host sync the frame loop issues, and the repo's source lines on
        #    the stack of each report are kept
        syncs = []
        state = fresh(settings)
        torch.cuda.synchronize()
        with flag_syncs(syncs):
            run(settings, frames, state, capture=False)
        torch.cuda.synchronize()
        if swap:
            waits.append(state.swap_exchange.n_waits)
        del state
        n_syncs = len(syncs)
        # 4) the phase table, from the marks of a captured run with the spans on
        table, frame_ms, dropped = self.phase_table(kind, live, settings, frames)

        fps = len(depths) / dt
        departs = float(np.abs(poses_np.astype(np.float64) - ref.astype(np.float64)).max())
        self.captures[name] = graphs
        print(f"{name}: {fps:.2f} frames/s over {len(depths)} frames, captured (median of {N_TIMED} replays; "
              "ms/frame " + ", ".join(f"{t * 1000 / len(depths):.2f}" for t in times)
              + f"), ATE RMSE {ate * 1000:.3f} mm, rotation RMSE {rot:.4f} deg, n_visible(last) {n_vis}")
        print(f"  counters (max over frames): {json.dumps(counters)}; frames with a full raycast: {n_full}; peak "
              f"device memory of the captured correctness run {peak / 2**30:.3f} GiB, of the uncaptured run "
              f"{peak_eager / 2**30:.3f} GiB (torch.cuda.max_memory_allocated)")
        if graphs:
            print(f"  graphs: {len(graphs)} captured in the correctness run (its wall {first_s:.3f} s, capture "
                  "included); " + "; ".join(
                      f"{g['name']}: {g['nodes']} nodes ({g['kernel_nodes']} kernels), capture {g['capture_s']:.3f} "
                      f"s, pool {g['pool_bytes'] / 2**30:.3f} GiB, launches a replay {json.dumps(g['launches'])} "
                      "(its hand kernel nodes)"
                      for g in graphs))
        else:
            print("  graphs: none (this path runs op by op)")
        print(f"  captured poses against the uncaptured run's: {'bit-equal' if departs == 0 else 'differ'} "
              f"(largest element difference {departs:.3e})")
        if unplaced is not None:
            print(f"  n_alloc_unplaced (not gated): {sum(unplaced)} over the replay, max {max(unplaced)} a frame, in "
                  f"{sum(u > 0 for u in unplaced)} of {len(unplaced)} frames")
        print(f"  kernel launches in the timed replay: {json.dumps(launches)}; per frame: "
              + json.dumps({k: v / len(depths) for k, v in launches.items()}))
        print(f"  host syncs flagged in the captured run: {len(captured_syncs)}, in the uncaptured run: {n_syncs}")
        for site in sorted(set(captured_syncs + syncs)):
            print(f"    {(captured_syncs + syncs).count(site)}× at {site}")
        print("  phase table of the captured frame (device time between the spans' marks, ms/frame): "
              + ", ".join(f"{k} {v:.3f} ({100 * v / frame_ms:.1f}%)" for k, v in table.items())
              + f"; begin to end {frame_ms:.3f}; the timed frame {1000 / fps:.3f} ms; marks dropped {dropped}")
        if swap:
            ex = final.swap_exchange
            print(f"  swap exchange of the correctness run (host halves done, two frames behind): {ex.n_evicted} "
                  f"blocks evicted to the host store, {ex.n_listed} needed-list entries resolved, {ex.n_merged} "
                  f"of them merged with stored data; the store holds {int(final.global_cache.has_stored.sum())} "
                  f"blocks; host waits on a copy: {ex.n_waits} in that run, {waits[:-1]} in the timed runs, "
                  f"{waits[-1]} in the uncaptured run")
        if swap:
            # captured, the host may wait for the card on a frame's copy
            # (backpressure), at most once a frame whose host half runs
            most = len(depths) - final.swap_exchange.PIPE_DEPTH
            self.gate(all(w <= most for w in [final.swap_exchange.n_waits] + waits[:-1]),
                      f"{name} host waits on the exchange ≤ {most} in each captured run (one a frame at most)")
        self.gate(ate < 0.01, f"{name} ATE RMSE < 1 cm")
        self.gate(rot < 1.0, f"{name} rotation RMSE < 1 deg")
        self.gate(all(v == 0 for v in counters.values()), f"{name} every counter of its path 0 ({len(counters)})")
        self.gate(all(launches[k] > 0 for k in path), f"{name} every kernel of its path launched: {', '.join(path)}")
        self.gate(departs == 0, f"{name} captured poses bit-equal to the uncaptured run's")
        self.gate(all(g["launches"] == g["tally"] for g in graphs),
                  f"{name} each graph's hand kernel nodes equal the launches its wrappers counted in capture")
        # the swap step: one graph for each set of merge inputs and slab rows
        self.gate(1 <= len(graphs) <= (6 if swap else 1), f"{name} {'1-6 graphs' if swap else 'one graph'} captured")
        if "integrate_color" in path:
            self.gate(launches["integrate_color"] == len(depths), f"{name} colour kernel launched on every frame")
        if "icp_weighted" in path:
            per_frame = sum(self.trackers.level_iterations(settings.tracking))
            self.gate(launches["icp_weighted"] == per_frame * len(depths) and launches["icp"] == 0,
                      f"{name} weighted K1 launched {per_frame} times a frame, the unweighted one never")
        for k, n in (expected or {}).items():
            self.gate(launches[k] == n * len(depths), f"{name} {k} launched {n} time(s) a frame")
        if settings.use_approximate_raycast:
            self.gate(0 < n_full < len(depths), f"{name} both raycast branches ran (0 < full frames < {len(depths)})")
        self.gate(n_syncs == 0 and not captured_syncs, f"{name} frame loop issued no host sync, captured or not")
        self.gate(dropped == 0 and frame_ms > 0, f"{name} phase marks: none dropped, each replay timed")
        return launches, final, (fps, frame_ms)

    def phase_table(self, kind, live, settings, frames):
        """({phase: device ms a step}, begin to end ms a step, marks
        dropped) of a captured run of `kind` from a fresh map written into
        `live`, read from the phase marks (engine/spans.py): a first run
        with the spans on captures the graphs with marks, a second one
        replays them. A capture's warm-up frame runs with the marks paused,
        so every frame the ring holds is a replay. MainEngine's `view` mark
        lies outside the frame graph and is left out."""
        self.spans.enable(self.dev)
        try:
            run = self.runner(kind)[0]
            run(settings, frames, self.refill(kind, live, settings))
            self.spans.reset()
            run(settings, frames, self.refill(kind, live, settings))
            torch.cuda.synchronize()
            s = self.spans.summary()
        finally:
            self.spans.disable()
        steps = max(len(s["frames"]), 1)
        table = {}
        for f in s["frames"]:
            for k, ns in f["phases"].items():
                table[k] = table.get(k, 0.0) + ns * 1e-6 / steps
        frame_ms = sum(f["end_ns"] - f["begin_ns"] for f in s["frames"]) * 1e-6 / steps
        return table, frame_ms, s["dropped"] + (0 if len(s["frames"]) == len(frames[0]) else 1)

    def refill(self, kind, live, settings):
        """A fresh map for the next run of a replay of `kind`, written into
        `live`'s tensors (the state a run ended with, or its engine), so that
        the run replays the graphs those tensors were captured with (a
        swapping engine also takes a fresh host store and exchange). Returns
        the run's `state` argument."""
        fresh = self.runner(kind)[1]
        if kind == "engine":
            new = fresh(settings)
            fields = ENGINE_STATE + (("swap_states",) if live.swapping else ())
            self.captured.refill([getattr(live, k) for k in fields], [getattr(new, k) for k in fields])
            # the host store and the exchange are the host's: a new engine's
            live.global_cache, live.swap_exchange, live.frame_no = new.global_cache, new.swap_exchange, 0
            return live
        if kind.startswith("batched"):  # the lane count leads every tensor
            self.captured.refill(live, fresh(settings, self.captured.leaves(live)[0].shape[0]))
        else:
            self.captured.refill(live, fresh(settings))
        return live

    def get_image_check(self, engine, settings, frames, rgb_settings):
        """Every get_image type from a replay's last engine, a freeview
        image from behind the scene among them, and the colour image of an
        engine of `rgb_settings` after N_CHECK_FRAMES frames. Each image is
        gated on its shape, dtype and filled share; the live raycast image
        also on the same render of the plain raycast twin."""
        depths, rgbs = frames
        H, W = IMG
        shapes = {"raycast": (H, W), "normals": (H, W, 3), "depth": (H, W, 4), "weight": (H, W, 4),
                  "colour": (H, W, 3)}
        cases = [("raycast", {}), ("normals", {}), ("depth", {}), ("depth", dict(view=depths[-1])),
                 ("weight", {}), ("raycast", dict(pose=back_pose()))]
        images = {}
        for which, kw in cases:
            label = which + (" of the input view" if "view" in kw else "") + (" freeview" if "pose" in kw else "")
            t0 = time.perf_counter()
            img = engine.get_image(which, **kw)
            ms = (time.perf_counter() - t0) * 1000
            images[label] = img
            share = filled(img)
            print(f"get_image {label}: {img.shape} {img.dtype}, {100 * share:.1f}% filled, {ms:.1f} ms (host clock)")
            self.gate(img.shape == shapes[which] and img.dtype == np.uint8, f"get_image {label} shape and dtype")
            self.gate(share > (0.3 if label == "raycast" else 0.05 if "freeview" not in label else 0.01),
                      f"get_image {label} filled")
        # the live raycast render against the plain raycast twin's
        sp, pose = settings.scene, engine.tracking_state.pose
        inv = self.se3.invert(pose)
        zmin, zmax, _ = self.hp.expected_depth_ranges(engine.vol, engine.render_state, pose, self.proj, IMG,
                                                      settings)
        grid = self.hp.hv.get_block_grid(engine.vol, settings.block_grid)
        res = self.k_ray.raycast_grid_plain(engine.vol, grid, settings.block_grid, settings.hashing, inv, self.proj,
                                            IMG, 1.0 / sp.voxel_size, sp.mu, zmin, zmax)
        ref = self.raycast_ops.render_grey(res, sp.voxel_size, inv).cpu().numpy()
        lsb = np.abs(images["raycast"].astype(np.int32) - ref.astype(np.int32))
        within = float((lsb <= 1).mean())
        print(f"get_image raycast vs the plain raycast's render: {100 * within:.3f}% of pixels within 1 LSB, "
              f"max {int(lsb.max())} LSB")
        self.gate(within >= 0.999, "get_image raycast within 1 LSB of the plain raycast's render on ≥ 99.9%")
        rgb_engine, _p, _d = self.run_engine(rgb_settings, (depths[:N_CHECK_FRAMES], rgbs[:N_CHECK_FRAMES]))
        img = rgb_engine.get_image("colour")
        print(f"get_image colour (1cm_rgb, {N_CHECK_FRAMES} frames): {img.shape} {img.dtype}, "
              f"{100 * filled(img):.1f}% filled")
        self.gate(img.shape == shapes["colour"] and img.dtype == np.uint8 and filled(img) > 0.3,
                  "get_image colour shape, dtype and filled")

    def mesh_check(self, settings, vol):
        """The map's mesh after a replay, on the card: the blocks, triangles
        and seconds of mesh_scene_hash (what MainEngine.update_mesh runs);
        gated on 0 dropped triangles, two chunk sizes giving identical
        triangles, the host syncs not growing with the chunks, the vertices
        inside the synthetic scene and on its surface, and a 256-block subset
        meshed by the same code on a CPU copy of the volume."""
        from infinitam_tpu_torch.engine import meshing_engine
        from infinitam_tpu_torch.ops import meshing

        sp, hp = settings.scene, settings.hashing
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh = meshing_engine.mesh_scene_hash(vol, settings)
        secs = time.perf_counter() - t0
        ids = torch.nonzero(vol.entry_ptr >= 0).squeeze(1)
        read = self.hp.hv.make_hash_reader(vol, hp)
        bpos = vol.entry_pos[ids]
        tris, n_valid = meshing.extract_mesh(read, bpos, hp.block_size, sp.voxel_size)
        small, _n = meshing.extract_mesh(read, bpos, hp.block_size, sp.voxel_size,
                                         chunk_blocks=meshing.CHUNK_BLOCKS // 8)
        n_tri, n_valid = tris.shape[0], int(n_valid)
        print(f"mesh of the map: {ids.shape[0]} allocated blocks, {mesh.n_triangles} triangles, {secs:.3f} s "
              f"(host clock, with the copy to the host); the emit pass found {n_valid} valid (voxel, slot) pairs")
        self.gate(mesh.n_triangles == n_tri == n_valid > 100000,
                  "mesh: the triangle count equals the device's count of valid (voxel, slot) pairs (0 dropped)")
        self.gate(torch.equal(tris, small) and np.array_equal(mesh.triangles, tris.cpu().numpy()),
                  f"mesh: chunks of {meshing.CHUNK_BLOCKS} and {meshing.CHUNK_BLOCKS // 8} blocks give identical "
                  "triangles")
        counts = []
        for chunk in (meshing.CHUNK_BLOCKS, meshing.CHUNK_BLOCKS // 8):
            with flag_syncs([]) as syncs:
                meshing_engine.mesh_scene_hash(vol, settings, chunk_blocks=chunk)
            counts.append(len(syncs))
        n_chunks = [(ids.shape[0] + c - 1) // c for c in (meshing.CHUNK_BLOCKS, meshing.CHUNK_BLOCKS // 8)]
        print(f"  host syncs of mesh_scene_hash: {counts[0]} with {n_chunks[0]} chunks, {counts[1]} with "
              f"{n_chunks[1]} chunks")
        self.gate(counts[0] == counts[1], "mesh: host syncs do not grow with the number of chunks")
        v = tris.reshape(-1, 3)
        lo, hi = v.amin(0).tolist(), v.amax(0).tolist()
        signed = self.synth.scene_sdf(v)
        surf = signed.abs()
        med = float(surf.median())
        print(f"  vertices in x {lo[0]:.3f}..{hi[0]:.3f}, y {lo[1]:.3f}..{hi[1]:.3f}, z {lo[2]:.3f}..{hi[2]:.3f} m; "
              f"scene sdf at the vertices: median {float(signed.median()) * 1000:.3f} mm, |·| 99th percentile "
              f"{float(torch.quantile(surf[:: max(1, surf.numel() // 1000000)], 0.99)) * 1000:.3f} mm")
        self.gate(all(abs(x) < 3.0 for x in lo[:2] + hi[:2]) and lo[2] > sp.view_frustum_min
                  and hi[2] < 2.3 + sp.mu + sp.voxel_size,
                  "mesh: vertices inside the synthetic scene (|x|, |y| < 3 m, z before the wall at 2.3 m + μ)")
        # the synthetic depth lies up to ~8 mm behind the analytic surface
        # (io/synth.py's sphere tracer keeps taking its 0.09 mm least step
        # once it has converged), and the map follows the depth
        self.gate(med < 2 * sp.voxel_size, "mesh: median distance of the vertices from the scene's surface < 2 voxels")
        cpu_vol = type(vol)(*(None if t is None else t.cpu() for t in vol))
        sub = bpos[:256]
        on_card, _n = meshing.extract_mesh(read, sub, hp.block_size, sp.voxel_size)
        on_cpu, _n = meshing.extract_mesh(self.hp.hv.make_hash_reader(cpu_vol, hp), sub.cpu(), hp.block_size,
                                          sp.voxel_size)
        diff = float((on_card.cpu() - on_cpu).abs().max()) if on_cpu.shape == on_card.shape and on_cpu.numel() else 0.0
        print(f"  256-block subset: {on_card.shape[0]} triangles on the card, {on_cpu.shape[0]} on the CPU, "
              f"max difference {diff:.3e} m")
        self.gate(on_card.shape == on_cpu.shape and on_cpu.shape[0] > 0 and diff <= 1e-6,
                  "mesh: a 256-block subset on the card equals the same code on the CPU within 1e-6 m")

    def dense_mesh_check(self, settings, vol):
        """The dense map's mesh after its replay, on the card: the occupied
        virtual blocks, the triangles and seconds of mesh_scene_dense; gated
        on 0 dropped triangles and the vertices on the synthetic scene's
        surface."""
        from infinitam_tpu_torch.engine import meshing_engine
        from infinitam_tpu_torch.ops import meshing

        sp = settings.scene
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh = meshing_engine.mesh_scene_dense(vol, settings)
        secs = time.perf_counter() - t0
        blocks = meshing_engine.dense_blocks(vol, settings.plain)
        tris, n_valid = meshing.extract_mesh(self.vol_mod.make_dense_reader(vol, settings.plain), blocks,
                                             self.vol_mod.VIRTUAL_BLOCK, sp.voxel_size)
        n_valid = int(n_valid)
        signed = self.synth.scene_sdf(tris.reshape(-1, 3))
        med = float(signed.abs().median())
        print(f"mesh of the dense map: {blocks.shape[0]} occupied 8³ blocks of {settings.plain.size}, "
              f"{mesh.n_triangles} triangles, {secs:.3f} s (host clock, with the copy to the host); the emit pass "
              f"found {n_valid} valid (voxel, slot) pairs; scene sdf at the vertices: median |·| {med * 1000:.3f} mm")
        self.gate(mesh.n_triangles == tris.shape[0] == n_valid > 100000,
                  "dense mesh: the triangle count equals the device's count of valid (voxel, slot) pairs (0 dropped)")
        self.gate(med < 2 * sp.voxel_size, "dense mesh: median distance of the vertices from the scene's surface "
                  "< 2 voxels")

    def cli_check(self):
        """The headless runner in-process on the card: N_FRAMES synthetic
        640×480 frames with a raycast dump after each, and the map's mesh as
        binary STL after the loop."""
        from infinitam_tpu_torch.apps import cli
        from infinitam_tpu_torch.utils.image_io import read_image

        with tempfile.TemporaryDirectory() as tmp, tempfile.TemporaryDirectory() as mesh_dir:
            mask = os.path.join(tmp, "r_%04i.png")
            stl = os.path.join(mesh_dir, "scene.stl")
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli.main(["--synthetic", "--frames", str(N_FRAMES), "--out-render", mask, "--out-mesh", stl])
            wall = time.perf_counter() - t0
            text = out.getvalue()
            files = sorted(os.listdir(tmp))
            last = read_image(os.path.join(tmp, files[-1])) if files else np.zeros((1, 1, 3), np.uint8)
            stl_bytes = os.path.getsize(stl) if os.path.exists(stl) else 0
            n_stl = int.from_bytes(open(stl, "rb").read()[80:84], "little") if stl_bytes >= 84 else 0
        for line in text.splitlines():
            print(f"  cli: {line}")
        print(f"cli --synthetic --frames {N_FRAMES} --out-render --out-mesh (STL): rc {rc}, {len(files)} images, "
              f"last {last.shape} {100 * filled(last):.1f}% filled, mesh {n_stl} triangles in {stl_bytes} bytes, "
              f"{wall:.1f} s wall")
        self.gate(rc == 0 and f"processed {N_FRAMES} frames" in text, f"cli returned 0 and processed {N_FRAMES} frames")
        self.gate(len(files) == N_FRAMES and last.shape == (*IMG, 3) and filled(last) > 0.3,
                  f"cli wrote {N_FRAMES} renders, the last one filled")
        self.gate(f"mesh saved to {stl}" in text and n_stl > 100000 and stl_bytes == 84 + 50 * n_stl,
                  "cli --out-mesh wrote an STL of 84 + 50·T bytes")

    def fixture_check(self):
        """The committed PGM fixture (raw mm depth) through the port's
        ImageFileReader, DeviceFrameFeed and MainEngine on the card."""
        fix = REPO / "tests" / "fixtures" / "replay"
        src = self.sources.DeviceFrameFeed(self.sources.ImageFileReader(
            str(fix / "calib.txt"), "", str(fix / "depth_%04i.pgm")), device=self.dev)
        gt = np.load(fix / "gt_poses.npy")
        img = (src.calib.intrinsics_d.height, src.calib.intrinsics_d.width)
        engine = self.MainEngine(self.cfg.tiny_test_settings(), src.calib, img, device=self.dev)
        n, on_card = 0, True
        while src.has_more_images():
            raw = src.get_images()[0]
            on_card &= torch.is_tensor(raw) and raw.device.type == "cuda" and not raw.is_floating_point()
            engine.process_frame(raw_depth=raw)
            n += 1
        t_err, r_err = frame_errors(engine.get_pose()[None].astype(np.float64), gt[-1:].astype(np.float64))
        print(f"PGM fixture replay ({n} frames, {img[1]}×{img[0]}): final pose {t_err[0] * 1000:.3f} mm, "
              f"{r_err[0]:.4f} deg from the recorded trajectory")
        self.gate(n == gt.shape[0] and on_card, "PGM fixture: every frame uploaded to the card as raw depth")
        self.gate(t_err[0] < 0.01 and r_err[0] < 1.0, "PGM fixture final pose within 1 cm and 1 deg")

    def bench_check(self, timing: dict, card: str) -> dict:
        """The port's bench (infinitam_tpu_torch/bench.py). In process:
        run_config at 5 mm, which raises if a graph was captured inside its
        timed replay or that replay's poses differ from its correctness
        replay's, gated on exact launches of K1, K2 and K3 and on its
        accuracy and counters. Then `python -m infinitam_tpu_torch.bench`,
        the default mode and ITPU_BENCH_CONFIG=replay, in subprocesses:
        their last lines gated on bench.py's keys, accuracy and counters,
        each frames/s within [0.5, 2]× the smoke's captured replay of the
        same config in this call (`timing`). Returns the in-process run's
        launch counts."""
        from infinitam_tpu_torch import bench

        self.captured.clear()  # the replays' graphs and their pools
        iters = sum(self.trackers.level_iterations(self.cfg.TrackingParams()))
        self.build.reset_launch_counts()
        try:
            fps, ate, rot, diag = bench.run_config(reference_settings(self.cfg), device=self.dev)
            error = None
        except RuntimeError as e:
            fps, ate, rot, diag, error = 0.0, 1.0, 180.0, "", e
        launches = self.build.launch_counts()
        self.captured.clear()
        print(f"bench.run_config(5mm) in process ({card}): {fps:.2f} frames/s against the smoke's captured "
              f"{timing['5mm'][0]:.2f} ({fps / timing['5mm'][0]:.3f}×), ATE RMSE {ate * 1000:.3f} mm, rotation RMSE "
              f"{rot:.4f} deg, {diag}; launches {json.dumps({k: n for k, n in launches.items() if n})}"
              + (f"; raised: {error}" if error else ""))
        self.gate(error is None, "bench 5mm: run_config's timed replay captured no graph and gave the correctness "
                                 "replay's poses bit for bit")
        per_frame = dict(icp=iters, integrate=1, integrate_color=0, raycast=1)
        self.gate(all(launches[k] == 2 * bench.N_FRAMES * n for k, n in per_frame.items()),
                  f"bench 5mm: {', '.join(DEPTH_PATH)} launched on each of the 2 × {bench.N_FRAMES} frames "
                  f"({json.dumps(per_frame)} a frame)")
        self.gate(ate < 0.01 and rot < 1.0 and all(c.endswith("=0") for c in diag.split()[1:]),
                  "bench 5mm: ATE < 1 cm, rotation < 1 deg, every counter 0")

        for mode, keys in (("", BENCH_KEYS), ("replay", REPLAY_KEYS)):
            env = {k: v for k, v in os.environ.items() if k != "ITPU_BENCH_CONFIG"}
            if mode:
                env["ITPU_BENCH_CONFIG"] = mode
            t0 = time.perf_counter()
            res = subprocess.run([sys.executable, "-m", "infinitam_tpu_torch.bench"], cwd=REPO, env=env,
                                 capture_output=True, text=True, timeout=BENCH_TIMEOUT)
            label = f"python -m infinitam_tpu_torch.bench ({'ITPU_BENCH_CONFIG=' + mode if mode else 'default'})"
            print(f"{label}: exit {res.returncode} in {time.perf_counter() - t0:.1f} s")
            err = res.stderr.splitlines()
            for e in err[-40:]:
                print(f"  stderr: {e}")
            out = res.stdout.strip().splitlines()
            print(f"  last line: {out[-1] if out else '(none)'}")
            try:
                line = json.loads(out[-1])
            except (IndexError, json.JSONDecodeError):
                line = {}
            self.gate(res.returncode == 0 and list(line) == list(keys), f"{label}: exit 0, bench.py's keys")
            first_number = next((i for i, e in enumerate(err) if e.startswith(("diag(", "swap("))), len(err))
            self.gate(any(e.startswith("card: ") for e in err[:first_number]),
                      f"{label}: the card's line before any number on stderr")
            self.gate(line.get("value", 0) > 0, f"{label}: value > 0")
            if mode == "replay":
                self.gate(line.get("frames") == 10 and line.get("t_err_mm", 1e9) < 10,
                          f"{label}: 10 frames, final pose within 1 cm of the recorded trajectory")
                continue
            diags = [e for e in err if e.startswith("diag(")]
            maxima = [int(v) for d in diags for v in re.findall(r"max_\w+=(-?\d+)", d)]
            self.gate(len(diags) == 3 and len(maxima) == 15 and not any(maxima),
                      f"{label}: three diag lines, every max_* counter 0")
            self.gate(all(line.get(k, 1.0) < 0.01 for k in ("ate_rmse_m", "ate_rmse_1cm_m", "ate_rmse_rgb_m"))
                      and line.get("rot_rmse_deg", 9.0) < 1.0 and line.get("rot_rmse_1cm_deg", 9.0) < 1.0,
                      f"{label}: every ATE RMSE < 1 cm, every rotation RMSE < 1 deg")
            self.gate(np.isfinite(line.get("swap_fps_ratio", np.nan)), f"{label}: a finite swap_fps_ratio")
            for key, config in (("value", "5mm"), ("fps_1cm_voxel", "1cm"), ("fps_1cm_rgb_fusion", "1cm_rgb")):
                smoke_fps = timing[config][0]
                ratio_ = line.get(key, 0.0) / smoke_fps
                print(f"  {key} {line.get(key)} frames/s against the smoke's captured {config} replay "
                      f"{smoke_fps:.2f} frames/s in this call ({card}): {ratio_:.3f}×")
                self.gate(0.5 <= ratio_ <= 2.0, f"{label}: {key} within [0.5, 2]× the smoke's {config} frames/s")
            smoke_ratio = timing["1cm_swap"][0] / timing["1cm"][0]
            print(f"  swap_fps_ratio {line.get('swap_fps_ratio')} against the smoke's 1cm_swap / 1cm "
                  f"{smoke_ratio:.3f} (not gated)")
        return launches

    def swap_return_check(self, settings, engine, frames, gt, noswap_settings):
        """The swapping engine after its replay looks away for one frame (the
        pose turned π about the camera's y axis, depth rendered there, maps
        stale), then comes back to frame 0's pose (maps stale) and replays
        frames 0..N_BACK-1, under the sync debug mode: blocks go out to the
        host store and their stored data merges back. Gated on evictions
        and merges with data in the phase, the ATE over frames 1..N_BACK-1 of
        the return, the counters and no host sync; then on flush_swap leaving
        no backlog and losing no block. Prints, ungated, the difference from
        a no-swap engine that ran the same frames."""
        depths = frames[0]
        dev = self.dev
        away = self.se3.se3_exp(torch.tensor([0.0, 0.0, 0.0, 0.0, float(np.pi), 0.0], device=dev))
        far = self.synth.render_depth(away, self.proj, IMG)
        start = torch.as_tensor(gt[0], device=dev)
        stale = torch.full((), -1, dtype=torch.int32, device=dev)

        def look_away_and_back(eng):
            # a copy each time: a captured step writes the state's age in place
            eng.set_pose(away)
            eng.tracking_state = eng.tracking_state._replace(age=stale.clone())
            diags = [eng.process_frame(metric_depth=far).device]
            eng.set_pose(start)
            eng.tracking_state = eng.tracking_state._replace(age=stale.clone())
            poses = []
            for d in depths[:N_BACK]:
                diags.append(eng.process_frame(metric_depth=d).device)
                poses.append(eng.tracking_state.pose.clone())
            return poses, diags

        ex = engine.swap_exchange
        before = (ex.n_evicted, ex.n_listed, ex.n_merged, int(engine.global_cache.has_stored.sum()))
        torch.cuda.synchronize()
        with flag_syncs([]) as syncs:
            poses, diags = look_away_and_back(engine)
        torch.cuda.synchronize()
        evicted, listed, merged = ex.n_evicted - before[0], ex.n_listed - before[1], ex.n_merged - before[2]
        ate, rot = trajectory_errors(torch.stack(poses).cpu().numpy().astype(np.float64),
                                     gt[:N_BACK].astype(np.float64))
        counters = {k: int(torch.stack([getattr(d, k) for d in diags]).max()) for k in COUNTERS}

        def backlog(eng):
            from infinitam_tpu_torch.engine import swapping

            return int(swapping.eviction_backlog(eng.vol, eng.swap_states, eng.render_state.visible_type))

        pending = backlog(engine)
        t0 = time.perf_counter()
        engine.flush_swap()
        torch.cuda.synchronize()
        flush_s = time.perf_counter() - t0
        ptr = engine.vol.entry_ptr
        stored = torch.from_numpy(engine.global_cache.has_stored).to(dev)
        lost = int(((ptr == -1) & ~stored).sum())
        n_alloc, n_res = int((ptr >= -1).sum()), int((ptr >= 0).sum())
        print(f"5mm_swap return phase (1 frame looking away, then frames 0-{N_BACK - 1} from frame 0's pose): "
              f"{evicted} blocks evicted, {listed} needed-list entries resolved, {merged} merged with stored data, "
              f"the store {before[3]} → {int(engine.global_cache.has_stored.sum())} blocks before the flush; ATE "
              f"RMSE over frames 1-{N_BACK - 1} {ate * 1000:.3f} mm, rotation {rot:.4f} deg; counters "
              f"{json.dumps(counters)}; host syncs flagged {len(syncs)}; host waits on a copy "
              f"{ex.n_waits} in the engine's life")
        for site in sorted(set(syncs)):
            print(f"    {syncs.count(site)}× at {site}")
        print(f"  flush_swap: backlog {pending} → {backlog(engine)} (state 2, resident, not visible), "
              f"{flush_s:.3f} s; {n_alloc} allocated entries, {n_res} resident, {int(stored.sum())} stored, {lost} neither")
        self.gate(evicted > 0 and merged > 0, "5mm_swap return: blocks evicted and merged back with stored data")
        self.gate(ate < 0.01, "5mm_swap return: ATE RMSE < 1 cm over frames 1-9")
        self.gate(all(v == 0 for v in counters.values()), "5mm_swap return: all five counters 0")
        self.gate(len(syncs) == 0, "5mm_swap return: no host sync")
        self.gate(backlog(engine) == 0, "5mm_swap flush_swap: no eviction backlog")
        self.gate(lost == 0, "5mm_swap flush_swap: every allocated block resident or stored")

        # the same frames through a no-swap engine, compared over the blocks
        # resident in both (not gated)
        ref, _p, _d = self.run_engine(noswap_settings, frames)
        look_away_and_back(ref)

        def resident(eng):
            ids = torch.nonzero(eng.vol.entry_ptr >= 0).squeeze(1)
            pos = eng.vol.entry_pos[ids].cpu().numpy().astype(np.int64) + 2**20
            return (pos[:, 0] << 42) | (pos[:, 1] << 21) | pos[:, 2], eng.vol.entry_ptr[ids]

        (ka, pa), (kb, pb) = resident(engine), resident(ref)
        _common, ia, ib = np.intersect1d(ka, kb, return_indices=True)
        va = engine.vol.vox[pa[torch.from_numpy(ia).to(dev)].long()]
        vb = ref.vol.vox[pb[torch.from_numpy(ib).to(dev)].long()]
        dsdf = ((va >> 16) - (vb >> 16)).abs().cpu().numpy() / 32767.0
        same_w = float((((va >> 8) & 0xFF) == ((vb >> 8) & 0xFF)).float().mean())
        print(f"  against a no-swap engine over the same {N_FRAMES + 1 + N_BACK} frames (not gated): {len(ia)} blocks "
              f"resident in both (of {len(ka)} and {len(kb)}); |Δsdf| median {np.median(dsdf):.6f}, 99th percentile "
              f"{np.percentile(dsdf, 99):.6f} (×μ: {np.median(dsdf) * settings.scene.mu * 1000:.4f} / "
              f"{np.percentile(dsdf, 99) * settings.scene.mu * 1000:.4f} mm); equal weight on {100 * same_w:.2f}% "
              "of the voxels")

    def checkpoint_check(self, settings, engine, frames, tmp) -> str:
        """save_engine of the swapping engine and load_engine into a fresh
        one (made before the clock starts), on the card; gated on the live
        raycast image byte-equal and the next frame's pose equal. Returns the
        snapshot's path."""
        from infinitam_tpu_torch.utils import checkpoint

        path = os.path.join(tmp, "snap.npz")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save_engine(path, engine)
        save_s = time.perf_counter() - t0
        sizes = os.path.getsize(path), os.path.getsize(path + ".cache.npz")
        loaded = self.fresh_engine(settings)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.load_engine(path, loaded)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        a, b = engine.get_image("raycast"), loaded.get_image("raycast")
        nxt = frames[0][N_BACK]
        engine.process_frame(metric_depth=nxt)
        loaded.process_frame(metric_depth=nxt)
        same_pose = np.array_equal(engine.get_pose(), loaded.get_pose())
        print(f"checkpoint of the 5mm_swap engine: save_engine {save_s:.2f} s ({sizes[0]} bytes of state, "
              f"{sizes[1]} bytes of host store, compressed), load_engine {load_s:.2f} s; live raycast image "
              f"byte-equal {a.tobytes() == b.tobytes()} ({100 * filled(a):.1f}% filled); next frame's pose equal "
              f"{same_pose}")
        self.gate(a.tobytes() == b.tobytes() and filled(a) > 0.3, "checkpoint: the live raycast image byte-equal")
        self.gate(same_pose, "checkpoint: the next frame's pose equal")
        return path

    def viewer_check(self, settings, snapshot: str) -> None:
        """apps/viewer.py in-process: a 4-image orbit from the snapshot, with
        its settings, on the card."""
        from infinitam_tpu_torch.apps import viewer
        from infinitam_tpu_torch.utils.image_io import read_image

        sp, gp = settings.scene, settings.block_grid
        with tempfile.TemporaryDirectory() as out_dir:
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = viewer.main(["--snapshot", snapshot, "--orbit", "4", "--out", out_dir, "--voxel-size",
                                  str(sp.voxel_size), "--mu", str(sp.mu), "--grid-dims", *map(str, gp.dims),
                                  "--grid-origin", *map(str, gp.origin)])
            wall = time.perf_counter() - t0
            files = sorted(os.listdir(out_dir))
            fills = [filled(read_image(os.path.join(out_dir, f))) for f in files if f.endswith(".png")]
        for line in out.getvalue().splitlines():
            print(f"  viewer: {line}")
        print(f"viewer --snapshot --orbit 4: rc {rc}, {files}, filled " + ", ".join(f"{100 * f:.1f}%" for f in fills)
              + f", {wall:.1f} s wall")
        self.gate(rc == 0 and files == ["index.html"] + [f"orbit_{k:04d}.png" for k in range(4)],
                  "viewer wrote 4 orbit PNGs and index.html")
        self.gate(max(fills, default=0.0) > 0.01, "viewer: an orbit image more than 1% filled")

    def batched_replay(self, name, settings, frames, gts, kind, expected, single):
        """A batched replay (`kind` "batched" or "batched_dense", `frames`
        from lane_frames): an uncaptured run (the reference), a captured
        correctness run (each lane's ATE and rotation, its counters, peak
        device memory, poses against the reference's, the graph), N_TIMED
        timed runs (the first counts kernel launches, which must be
        `expected` a step, whatever the lane count) and a captured run under
        the sync debug mode, each from a fresh map written into the
        correctness run's tensors, the phase table (phase_table) and an
        uncaptured run under the sync debug mode. `single`:
        (name, frames/s) of the unbatched replay of lane 0's frames in this
        call, for lane 0's poses against it and the batch efficiency.
        Returns (launches, (steps/s, frames/s summed over the lanes, the
        marked replays' begin-to-end ms a step))."""
        depths = frames[0]
        n, B = len(depths), depths[0].shape[0]
        run, fresh = self.runner(kind)
        ref = torch.stack(run(settings, frames, capture=False)[-2]).cpu().numpy()
        self.captured.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        *live, poses, diags = run(settings, frames)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        graphs = self.captured.graphs()
        self.captures[name] = graphs
        P = torch.stack(poses).cpu().numpy()  # [steps, B, 4, 4]
        departs = float(np.abs(P.astype(np.float64) - ref.astype(np.float64)).max())
        P = P.astype(np.float64)
        errs = [trajectory_errors(P[:, b], gts[b][:n].astype(np.float64)) for b in range(B)]
        counters = {k: torch.stack([getattr(d, k) for d in diags]).amax(0).tolist() for k in COUNTERS
                    if hasattr(diags[0], k)}
        unplaced = (torch.stack([d.n_alloc_unplaced for d in diags]).sum(0).tolist()
                    if hasattr(diags[0], "n_alloc_unplaced") else None)
        self.poses[name] = P
        ref_name, ref_fps = single
        centre = [np.array([np.linalg.inv(p)[:3, 3] for p in x]) for x in (P[:, 0], self.poses[ref_name][:n])]
        lane0_diff = float(np.linalg.norm(centre[0] - centre[1], axis=1).max())
        times = []
        for rep in range(N_TIMED):
            state = self.refill(kind, live, settings)
            torch.cuda.synchronize()
            if rep == 0:
                self.build.reset_launch_counts()
            t0 = time.perf_counter()
            run(settings, frames, state)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if rep == 0:
                launches = self.build.launch_counts()
        dt = float(np.median(times))
        captured_syncs = []
        state = self.refill(kind, live, settings)
        torch.cuda.synchronize()
        with flag_syncs(captured_syncs):
            run(settings, frames, state)
        torch.cuda.synchronize()
        table, step_ms, dropped = self.phase_table(kind, live, settings, frames)
        del state, live
        syncs = []
        state = fresh(settings, B)
        torch.cuda.synchronize()
        with flag_syncs(syncs):
            run(settings, frames, state, capture=False)
        torch.cuda.synchronize()
        del state
        steps_s = n / dt
        fps = B * steps_s
        efficiency = fps / (B * ref_fps)
        print(f"{name}: {B} lanes × {n} steps, {steps_s:.3f} steps/s, {fps:.2f} frames/s summed over the lanes "
              f"(captured, median of {N_TIMED} replays; ms/step " + ", ".join(f"{t * 1000 / n:.2f}" for t in times)
              + f"), batch_efficiency {efficiency:.3f} (frames/s ÷ ({B} × {ref_name}'s {ref_fps:.2f} frames/s in "
              f"this call)); peak device memory of the correctness run {peak / 2**30:.3f} GiB")
        for b, (ate, rot) in enumerate(errs):
            print(f"  lane {b}: ATE RMSE {ate * 1000:.3f} mm, rotation RMSE {rot:.4f} deg")
        print(f"  lane 0 against the {ref_name} replay of the same frames: largest per-frame camera-centre "
              f"difference {lane0_diff * 1000:.4f} mm")
        print(f"  counters per lane (max over steps): {json.dumps(counters)}")
        print("  graphs: " + "; ".join(
            f"{g['name']}: {g['nodes']} nodes ({g['kernel_nodes']} kernels), capture {g['capture_s']:.3f} s, pool "
            f"{g['pool_bytes'] / 2**30:.3f} GiB, launches a replay {json.dumps(g['launches'])} (its hand kernel "
            "nodes)" for g in graphs))
        print(f"  captured poses against the uncaptured run's: {'bit-equal' if departs == 0 else 'differ'} "
              f"(largest element difference {departs:.3e})")
        if unplaced is not None:
            print(f"  n_alloc_unplaced per lane, summed over the steps (not gated): {unplaced}")
        print(f"  kernel launches in the timed replay: {json.dumps(launches)}; per step: "
              + json.dumps({k: v / n for k, v in launches.items()}))
        print(f"  host syncs flagged in the captured run: {len(captured_syncs)}, in the uncaptured run: "
              f"{len(syncs)}")
        for site in sorted(set(captured_syncs + syncs)):
            print(f"    {(captured_syncs + syncs).count(site)}× at {site}")
        print("  phase table of the captured step (device time between the spans' marks, ms/step): "
              + ", ".join(f"{k} {v:.3f} ({100 * v / step_ms:.1f}%)" for k, v in table.items())
              + f"; begin to end {step_ms:.3f}; the timed step {1000 / steps_s:.3f} ms; marks dropped {dropped}")
        for b, (ate, rot) in enumerate(errs):
            self.gate(ate < 0.01 and rot < 1.0, f"{name} lane {b} ATE RMSE < 1 cm and rotation RMSE < 1 deg")
        self.gate(all(v == 0 for lanes in counters.values() for v in lanes),
                  f"{name} every counter of every lane 0 ({len(counters)} a lane)")
        self.gate(launches == dict.fromkeys(self.build.KERNELS, 0) | {k: v * n for k, v in expected.items()},
                  f"{name} launches exactly {expected} a step (one launch for all {B} lanes)")
        self.gate(len(syncs) == 0 and not captured_syncs, f"{name} step loop issued no host sync, captured or not")
        self.gate(dropped == 0 and step_ms > 0, f"{name} phase marks: none dropped, each replay timed")
        self.gate(departs == 0, f"{name} captured poses bit-equal to the uncaptured run's")
        self.gate(len(graphs) == 1, f"{name} one graph captured for the replay")
        self.gate(all(g["launches"] == g["tally"] for g in graphs),
                  f"{name} the graph's hand kernel nodes equal the launches its wrappers counted in capture")
        return launches, (steps_s, fps, step_ms), efficiency

    def ranks_replay(self, name, settings, frames, gts, kind, expected, one_process):
        """The lanes of a batched replay (`kind`, `frames` and `gts` as in
        batched_replay) as N_RANKS ranks, one process each (rank_phase):
        with one rank a card on a machine with that many cards (NCCL), else
        sharing card 0 (gloo: NCCL refuses two ranks on one device), said on
        a line of its own. `one_process`: (name, frames/s summed) of the
        one-process batched replay of the same lanes in this call. The
        one-process step also replays each rank's lanes alone, with the
        rank's lane count: the B-lane replay rounds otherwise where the
        rank's count is 1 (cuBLAS and cuSOLVER take their one-matrix kernels
        for a batch of one). Gated: each lane's ATE and rotation, its
        counters, its poses within 1e-6 m of the one-process lane's with the
        rank's lane count (the difference from the B-lane replay printed),
        the fleet metrics equal on every rank,
        `expected` launches a step in every rank, no host sync but those of
        the all-reduce, no module of JAX in a rank. Returns (launches summed
        over the ranks, one rank's launches, (steps/s, frames/s summed over
        the ranks, ratio to the one-process frames/s))."""
        from infinitam_tpu_torch.parallel import ranks

        depths = frames[0]
        n, B = len(depths), depths[0].shape[0]
        cards = torch.cuda.device_count()
        share = cards < N_RANKS
        if share:
            print(f"{name}: the multi-card run (NCCL, one rank a card) needs >= {N_RANKS} cards and this machine has "
                  f"{cards}: the {N_RANKS} ranks share card 0 through gloo (NCCL refuses two ranks on one device)")
        run, _fresh = self.runner(kind)
        per_rank = B // N_RANKS
        alone = []
        for r in range(N_RANKS):
            lanes = slice(r * per_rank, (r + 1) * per_rank)
            *_state, poses, _diags = run(settings, ([d[lanes] for d in depths], frames[1]))
            alone.append(torch.stack(poses).cpu().numpy())
            del _state, _diags, poses
        alone = np.concatenate(alone, axis=1)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # the ranks' maps come out of the same card's memory
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "depths.npy")
            np.save(path, torch.stack(depths).cpu().numpy())
            out = ranks.spawn(rank_phase, N_RANKS, args=(kind, settings, path, self.proj.cpu().numpy(), share),
                              timeout=RANK_TIMEOUT)
        wall = time.perf_counter() - t0
        P = np.concatenate([r["poses"] for r in out], axis=1).astype(np.float64)  # [steps, B, 4, 4]
        errs = [trajectory_errors(P[:, b], gts[b][:n].astype(np.float64)) for b in range(B)]
        diff = np.linalg.norm(camera_centres(P) - camera_centres(alone), axis=-1).max(0)
        diff_b = np.linalg.norm(camera_centres(P) - camera_centres(self.poses[one_process[0]][:n]), axis=-1).max(0)
        fleet_times = np.max([r["times"] for r in out], axis=0)  # each timed run ends with its slowest rank
        steps_s = n / float(np.median(fleet_times))
        fps = B * steps_s
        ratio = fps / one_process[1]
        source = (REPO / "infinitam_tpu_torch" / "parallel" / "batch.py").read_text().splitlines()
        reduce_site = "infinitam_tpu_torch/parallel/batch.py:" + str(
            next(i for i, line in enumerate(source, 1) if "dist.all_reduce(" in line))
        staged = out[0]["backend"] == "gloo"
        print(f"{name}: {N_RANKS} ranks × {per_rank} lanes ({out[0]['backend']}, devices "
              f"{[r['device'] for r in out]}), {steps_s:.3f} steps/s, {fps:.2f} frames/s summed over the ranks "
              f"(median of {N_TIMED} replays, each timed to its slowest rank; ms/step "
              + ", ".join(f"{t * 1000 / n:.2f}" for t in fleet_times)
              + f"), ratio {ratio:.3f} to {one_process[0]}'s {one_process[1]:.2f} frames/s in this call; "
              f"{wall:.1f} s wall for the phase, process starts included")
        for r in out:
            print(f"  rank lanes {r['lanes']}: peak device memory of its correctness run {r['peak'] / 2**30:.3f} GiB "
                  f"(torch.cuda.max_memory_allocated), ms/step " + ", ".join(f"{t * 1000 / n:.2f}" for t in r["times"]))
        for b, (ate, rot) in enumerate(errs):
            print(f"  lane {b}: ATE RMSE {ate * 1000:.3f} mm, rotation RMSE {rot:.4f} deg, largest per-step camera-"
                  f"centre difference from the one-process lane with {per_rank} lane(s) a step {diff[b] * 1000:.6f} mm, "
                  f"from the {one_process[0]} lane ({B} lanes a step) {diff_b[b] * 1000:.6f} mm")
        print(f"  counters per lane (max over steps): {[r['counters'] for r in out]}")
        if out[0]["unplaced"] is not None:
            print(f"  n_alloc_unplaced per lane, summed over the steps (not gated): {[r['unplaced'] for r in out]}")
        print(f"  kernel launches of each rank in its first timed replay: {[r['launches'] for r in out]}")
        print(f"  all-reduce calls in each rank's sync-checked run: {[r['reductions'] for r in out]} over {n} steps"
              + (" (gloo stages a CUDA all-reduce through host memory: each is a host wait on the card)"
                 if staged else ""))
        for r in out:
            print(f"  host syncs flagged in rank {r['lanes']}'s sync-checked run: {len(r['syncs'])}")
            for site in sorted(set(r["syncs"])):
                print(f"    {r['syncs'].count(site)}× at {site}")
        for b, (ate, rot) in enumerate(errs):
            self.gate(ate < 0.01 and rot < 1.0, f"{name} lane {b} ATE RMSE < 1 cm and rotation RMSE < 1 deg")
        self.gate(all(v == 0 for r in out for lanes in r["counters"].values() for v in lanes),
                  f"{name} every counter of every lane 0")
        self.gate(float(diff.max()) < 1e-6, f"{name} every lane within 1e-6 m of the one-process lane ({per_rank} a step)")
        self.gate(all(np.array_equal(r["metrics"], out[0]["metrics"]) for r in out),
                  f"{name} fleet metrics {out[0]['keys']} equal on every rank at every step")
        want = dict.fromkeys(self.build.KERNELS, 0) | {k: v * n for k, v in expected.items()}
        self.gate(all(r["launches"] == want for r in out), f"{name} every rank launches exactly {expected} a step")
        self.gate(all(r["reductions"] == n for r in out), f"{name} one all-reduce a step in every rank")
        self.gate(all(reduce_site in s for r in out for s in r["syncs"]),
                  f"{name} no host sync in the step loop outside the all-reduce ({reduce_site})")
        self.gate(not any(r["jax_modules"] for r in out), f"{name} no module of JAX or of the JAX package in a rank")
        total = {k: sum(r["launches"][k] for r in out) for k in self.build.KERNELS}
        return total, out[0]["launches"], (steps_s, fps, ratio)

    def lane_checks(self, settings, vol, rs, st, view, dense_settings, dvol, dst):
        """The lane-indexed launches at B = LANE_CHECK under torch.vmap, at
        the main path's shapes: K1 at each level, K2 and K3 on copies of the
        5 mm volume, K3d on copies of the 512³ array, each lane with its own
        tensors (copies) and its own pose, ~1 mm / 0.06° apart; the
        intrinsics shared (stride 0). Each is held to the B single-lane
        launches (K1 and K2 bit-identical, K3 and K3d equal) and to the
        plain twin (as the single-lane checks hold it), and timed: the B = 3
        launch's device time beside the single launch's. Returns {kernel
        JSON name: (B = 3 ms, single-lane ms)}."""
        B = LANE_CHECK
        d6 = torch.tensor([[0.0] * 6, [0.001, -0.001, 0.0005, 0.001, 0.0, -0.001],
                           [-0.0008, 0.0005, 0.001, -0.001, 0.001, 0.0]], device=self.dev)

        def lanes(x):
            return torch.stack([x.clone() for _ in range(B)])

        def poses(p):
            return torch.stack([self.se3.se3_exp(d6[b]) @ p for b in range(B)])

        out = {}

        def timed(label, batched, single_call):
            dev_b, per_b, oth_b = device_ms(batched, 30)
            dev_1, per_1, oth_1 = device_ms(single_call, 30)
            print(f"  {label} at B = {B}: device {fmt_ms(dev_b)} ({per_b} kernel(s), {oth_b:g} other op(s) a call) "
                  f"against 3 × {fmt_ms(dev_1)} = {fmt_ms(None if dev_1 is None else 3 * dev_1)} for {B} single "
                  f"launches")
            self.gate(per_b == 1 and oth_b == 0, f"{label} at B = {B}: one launch for the {B} lanes, no other op")
            return dev_b, dev_1

        # K1 at each pyramid level
        tp = settings.tracking
        depths = self.pyramid.build_depth_pyramid(view.depth, tp.n_levels)
        dists = self.trackers.level_dist_thresh(tp)
        pm, nm, spc = lanes(st.points_map), lanes(st.normals_map), lanes(st.pose_point_cloud)
        inv = torch.stack([self.se3.invert(p) for p in poses(st.pose)])
        k1 = []
        for lvl in range(tp.n_levels):
            vproj = self.trackers.scale_proj(self.proj, lvl)
            dl = lanes(depths[lvl])

            def fn(d, p, n_, ip, sp_, vproj=vproj, lvl=lvl):
                return self.k_icp.icp_gh(d, vproj, p, n_, self.proj, ip, sp_, dists[lvl], tp.min_valid_points)

            got = torch.vmap(fn)(dl, pm, nm, inv, spc)
            same, rel = True, 0.0
            for b in range(B):
                one = fn(dl[b], pm[b], nm[b], inv[b], spc[b])
                same &= all(torch.equal(x[b], y) for x, y in zip(got, one))
                p = self.k_icp.icp_gh_plain(dl[b], vproj, pm[b], nm[b], self.proj, inv[b], spc[b], dists[lvl],
                                            tp.min_valid_points)
                rel = max(rel, gh_errors(one, p)[0])
                same &= int(one.num_valid) == int(p.num_valid)
            print(f"K1 level {lvl}, {B} lanes in one launch: each lane bit-identical to its single launch {same}, "
                  f"single launches within {rel:.3e} relative of plain")
            self.gate(same and rel < 1e-4, f"K1 level {lvl} at B = {B}: lanes bit-identical to single launches, "
                                           "plain within 1e-4")
            k1.append(timed(f"K1 level {lvl}", lambda fn=fn, dl=dl: torch.vmap(fn)(dl, pm, nm, inv, spc),
                            lambda fn=fn, dl=dl: fn(dl[0], pm[0], nm[0], inv[0], spc[0])))
        out["icp_reduce"] = k1[0]
        out["icp_reduce_level_ms"] = k1
        del pm, nm, spc

        # K2 on copies of the volume and its visible list
        sp = settings.scene
        fuse = (sp.voxel_size, sp.mu, sp.max_w, sp.stop_integrating_at_max_w, settings.hashing.block_size,
                settings.max_fused_blocks)
        args = (lanes(rs.visible_ids), lanes(vol.entry_ptr), lanes(vol.entry_pos), lanes(view.depth),
                poses(st.pose), torch.ones((B,), dtype=torch.bool, device=self.dev))

        def k2(vx, ids, ep, epos, d, pose, en):
            self.k_int.integrate_depth(vx, ids, ep, epos, d, pose, self.proj, en, *fuse)
            return vx

        vk = lanes(vol.vox)
        torch.vmap(k2)(vk, *args)
        same = True
        for b in range(B):
            one, plain = vol.vox.clone(), vol.vox.clone()
            k2(one, *(a[b] for a in args))
            self.k_int.integrate_depth_plain(plain, args[0][b], args[1][b], args[2][b], args[3][b], args[4][b],
                                             self.proj, args[5][b], *fuse)
            same &= torch.equal(vk[b], one) and torch.equal(one, plain) and not torch.equal(one, vol.vox)
        print(f"K2, {B} lanes in one launch: each lane bit-identical to its single launch and to plain {same}")
        self.gate(same, f"K2 at B = {B}: lanes bit-identical to single launches and to plain")
        out["integrate_depth"] = timed("K2", lambda: torch.vmap(k2)(vk, *args),
                                       lambda: k2(one, *(a[0] for a in args)))
        del args, one, plain

        # K3 on the updated copies, through each lane's grid
        zmin, zmax, _ = self.hp.expected_depth_ranges(vol, rs, st.pose, self.proj, IMG, settings)
        gp, hp_ = settings.block_grid, settings.hashing
        grid = lanes(self.hp.hv.get_block_grid(vol, gp).reshape(-1))
        z0, z1 = lanes(zmin), lanes(zmax)
        inv = torch.stack([self.se3.invert(p) for p in poses(st.pose)])

        def k3(vx, g, im, a, b_):
            return self.k_ray.raycast_grid(vol._replace(vox=vx), g, gp, hp_, im, self.proj, IMG, 1.0 / sp.voxel_size,
                                           sp.mu, a, b_).points

        def k3_plain(b):
            return self.k_ray.raycast_grid_plain(vol._replace(vox=vk[b]), grid[b], gp, hp_, inv[b], self.proj, IMG,
                                                 1.0 / sp.voxel_size, sp.mu, z0[b], z1[b]).points

        out["raycast_grid"] = self.lane_raycast("K3", k3, k3_plain, (vk, grid, inv, z0, z1), timed)
        del vk, grid, z0, z1

        # K3d on copies of the dense array
        sd = dense_settings.scene
        zmin = torch.full(IMG, sd.view_frustum_min, device=self.dev)
        zmax = torch.full(IMG, sd.view_frustum_max, device=self.dev)
        sdf = lanes(dvol.sdf)
        inv = torch.stack([self.se3.invert(p) for p in poses(dst.pose)])

        def k3d(s_, im):
            return self.k_ray.raycast_dense(dvol._replace(sdf=s_), dense_settings.plain, im, self.proj, IMG,
                                            1.0 / sd.voxel_size, sd.mu, zmin, zmax).points

        def k3d_plain(b):
            return self.k_ray.raycast_dense_plain(dvol._replace(sdf=sdf[b]), dense_settings.plain, inv[b], self.proj,
                                                  IMG, 1.0 / sd.voxel_size, sd.mu, zmin, zmax).points

        out["raycast_dense"] = self.lane_raycast("K3d", k3d, k3d_plain, (sdf, inv), timed)
        return out

    def lane_raycast(self, label, kernel, plain, args, timed):
        """A raycast variant at B = LANE_CHECK: the batched launch, each lane
        equal to its single launch and held to its plain twin (hit mask
        equal, points within 4e-6 voxel); then timed."""
        B = LANE_CHECK
        got = torch.vmap(kernel)(*args)
        same, ok = True, True
        for b in range(B):
            one = kernel(*(a[b] for a in args))
            p = plain(b)
            same &= torch.equal(got[b], one)
            fk, fp = one[..., 3] > 0, p[..., 3] > 0
            ok &= torch.equal(fk, fp) and int(fp.sum()) > 100000 and float(
                (one[..., :3] - p[..., :3]).abs()[fp].max()) <= 4e-6
        print(f"{label}, {B} lanes in one launch: each lane equal to its single launch {same}, single launches "
              f"within the plain twin's bar (hit mask equal, 4e-6 voxel) {ok}")
        self.gate(same and ok, f"{label} at B = {B}: lanes equal to single launches, plain within its bar")
        return timed(label, lambda: torch.vmap(kernel)(*args), lambda: kernel(*(a[0] for a in args)))

    # --- the probes' kernels, P1-P6 (csrc/probes.cu) -----------------------
    def l2_floor(self, l2_bytes: int) -> dict:
        """The L2 floor of a site that requests `l2_bytes` of sectors: the
        warm time of a plain read of an L2-resident float32 buffer of as many
        bytes, to 4 KB (`kp.l2_read`, 8 float4 loads in flight a thread, launch
        included), the least over 1, 2, 4 and 8 CTAs an SM; its sums are gated
        exact. Beside it, for reference, a warm `torch.sum` of the same
        buffer (the faster of the whole sum and sums of rows of 1,024; every
        device op of the call), whose reduction reads the L2 more slowly."""
        from infinitam_tpu_torch.ops.kernels import probes as kp

        if l2_bytes > 40e6:
            raise ValueError(f"{l2_bytes} bytes do not stay in the 50 MB L2")
        buf = torch.ones(l2_bytes // 4096 * 1024, dtype=torch.float32, device=self.dev)  # rows of 1,024
        sms = torch.cuda.get_device_properties(self.dev).multi_processor_count
        reads = {}
        for n_ctas in (sms, 2 * sms, 4 * sms, 8 * sms):
            self.gate(float(kp.l2_read(buf, n_ctas).double().sum()) == buf.numel(),
                      f"l2_read in {n_ctas} CTAs: its sums add up to the buffer's")
            reads[n_ctas] = device_ms(lambda: kp.l2_read(buf, n_ctas), 50)[0]
        read = min(t for t in reads.values() if t is not None)
        ref = min(device_ms(lambda: torch.sum(buf), 50, match="")[0],
                  device_ms(lambda: torch.sum(buf.view(-1, 1024), 1), 50, match="")[0])
        n = 4 * buf.numel()
        print(f"  L2 read of {n / 1e6:.2f} MB: " + ", ".join(
            f"{c} CTAs {fmt_ms(t)} ({n / (t * 1e9):.2f} TB/s)" for c, t in reads.items())
              + f"; torch.sum {fmt_ms(ref)} ({n / (ref * 1e9):.2f} TB/s)")
        return dict(l2_bytes=int(l2_bytes), l2_floor_ms=read * l2_bytes / n, l2_rate_tbps=n / (read * 1e9),
                    l2_sum_ms=ref * l2_bytes / n, l2_sum_tbps=n / (ref * 1e9))

    def probe_site(self, counter, label, make, kernel, plain_fn, compare, traffic, library=None,
                   peak_ops=PEAK_F32_PER_S, l2_bytes=None):
        """One probe site at its full shape: `kernel(*make())` held to
        `plain_fn(*make())` by `compare(got, want)` → (ok, max abs error,
        what), with the bound of `traffic` (bytes, operations) over the
        memory rate and `peak_ops`. Timed on the device cold (the L2 flushed
        before each call) and warm, by call, the plain version's call and,
        with `library` (a function of the same arguments), the library
        call's device time cold and warm (every device op it runs). The
        share of the bound reads the cold time: most sites' working sets fit
        the 50 MB L2, where a warm call reads them at more than the memory
        rate the bound assumes. With `l2_bytes` (the sector requests the
        site makes), also its L2 floor (`l2_floor`) and the share of it."""
        got, want = kernel(*make()), plain_fn(*make())
        torch.cuda.synchronize()
        ok, err, what = compare(got, want)
        del got, want
        args = make()
        b = bound(*traffic, peak_ops)
        cold, per_call, others = device_ms(lambda: kernel(*args), 20, self.flush)
        warm = device_ms(lambda: kernel(*args), 50)[0]
        call = cuda_ms(lambda: kernel(*args), 50)
        plain = cuda_ms(lambda: plain_fn(*args), 5)
        lib = lib_warm = None
        if library is not None:
            lib = device_ms(lambda: library(*args), 20, self.flush, match="")[0]
            lib_warm = device_ms(lambda: library(*args), 50, match="")[0]
        l2 = {} if l2_bytes is None else self.l2_floor(l2_bytes)
        print(f"{counter} {label}: {what}; cold " + timing_line(cold, per_call, others, b, call, plain)
              + f", warm {fmt_ms(warm)}"
              + ("" if library is None else f", library cold {fmt_ms(lib)} warm {fmt_ms(lib_warm)}")
              + ("" if not l2 else
                 f"; L2 floor {l2['l2_floor_ms'] * 1000:.2f} µs ({l2['l2_bytes'] / 1e6:.2f} MB of sector requests "
                 f"at {l2['l2_rate_tbps']:.2f} TB/s, a plain read of as many bytes), share "
                 f"{100 * l2['l2_floor_ms'] / cold:.1f}% cold, {100 * l2['l2_floor_ms'] / warm:.1f}% warm "
                 f"(torch.sum of those bytes {l2['l2_sum_ms'] * 1000:.2f} µs)"))
        self.gate(ok, f"{counter} {label}: {what}")
        self.gate(per_call == 1 and others == 0, f"{counter} {label}: one device kernel a call, no other device op")
        return dict(label=label, max_abs_err=err, ms=cold, cold_ms=cold, warm_ms=warm, call_ms=call,
                    plain_ms=plain, library_ms=lib, library_warm_ms=lib_warm, **b, **l2)

    def probe_checks(self) -> list:
        """Each of the 16 probe sites of tools/ at the script's full shape,
        its kernel (P1-P6) held to its plain twin and timed
        (`probe_site`), each site run through its probe module's own site
        function with the kernel's wrapper and with its plain twin; returns
        the `kernels` entries of P1-P6, the first site of each the headline,
        every site listed under "sites"."""
        from infinitam_tpu_torch.ops.kernels import probes as kp
        from infinitam_tpu_torch.probes import plain as pp
        from infinitam_tpu_torch.probes import (probe2, probe6, probe7, probe8, probe9, probe10, probe11, probe12,
                                                probe13)

        def on(*arrays):
            return [torch.from_numpy(np.array(a)).to(self.dev) for a in arrays]

        def compare(tol=0.0, rows=None):
            def cmp(got, want):
                g, w = (got, want) if rows is None else (got[rows], want[rows])
                err = float((g.float() - w.float()).abs().max())
                where = "" if rows is None else f" on the {g.shape[0]} written rows"
                if tol == 0.0:
                    return torch.equal(g, w), err, f"bit-equal to plain{where} (max abs err {err:.3e})"
                return err <= tol, err, f"within {tol:g} of plain{where} (max abs err {err:.3e})"
            return cmp

        def recorded(call, *args):
            """The arguments a site function `call(fn, *args)` gives its
            kernel: (positional, keyword)."""
            seen = []

            def record(*a, **kw):
                seen.append((a, kw))
                return a[0]

            call(record, *args)
            return seen[0]

        found: dict = {c: [] for c in kp.COUNTERS.values()}

        def add(counter, site, row):
            found[counter].append(dict(row, site=site))

        def designs(entry, make, kernel, others, check):
            """The other designs of a redesigned kernel (`others`: name →
            function of the site's arguments) on the site's inputs in this
            call (`make()`: fresh ones, as an update in place changes them):
            each held by `check(got)` → (ok, what) and timed cold and warm in
            turns with `kernel` (the kernel's own times, then the design
            twice, then the kernel again, so that a drift of the card between
            the timings cancels in the means); the design's means join
            `entry` as `{name}_ms` (cold) and `{name}_warm_ms`, the kernel's
            as `{name}_turns_ms` and `{name}_turns_warm_ms`."""
            for name, fn in others.items():
                args = make()
                ok, what = check(fn(*args))
                times = [device_ms(lambda: fn(*args), reps, flush)[0] for flush, reps in
                         ((self.flush, 20), (None, 50), (self.flush, 20), (None, 50))]
                again = (device_ms(lambda: kernel(*args), 20, self.flush)[0],
                         device_ms(lambda: kernel(*args), 50)[0])
                if None in times + list(again):
                    cold = warm = k_cold = k_warm = None
                else:
                    cold, warm = (times[0] + times[2]) / 2, (times[1] + times[3]) / 2
                    k_cold, k_warm = (entry["cold_ms"] + again[0]) / 2, (entry["warm_ms"] + again[1]) / 2
                print(f"  {entry['label']}, the {name} design on the same inputs: {what}; cold {fmt_ms(cold)}, warm "
                      f"{fmt_ms(warm)} (means of two, between two of the kernel's: cold {fmt_ms(k_cold)}, warm "
                      f"{fmt_ms(k_warm)}); the kernel's time over its, cold {ratio(k_cold, cold)}, warm "
                      f"{ratio(k_warm, warm)}")
                self.gate(ok, f"{entry['label']}: the {name} design {what}")
                entry[f"{name}_ms"], entry[f"{name}_warm_ms"] = cold, warm
                entry[f"{name}_turns_ms"], entry[f"{name}_turns_warm_ms"] = k_cold, k_warm

        def faster(entry, name):
            """Whether the kernel ran faster than the `name` design, cold and
            warm, in the means of their turns."""
            times = (entry[f"{name}_turns_ms"], entry[f"{name}_ms"], entry[f"{name}_turns_warm_ms"],
                     entry[f"{name}_warm_ms"])
            return None not in times and times[0] < times[1] and times[2] < times[3]

        # P1: take and take_along_axis; library torch.take / torch.gather
        def gather_site(site, label, tab, idx, axis=None):
            e, i = tab.element_size(), idx.long()
            if axis is None:
                flat = i.reshape(-1)
            elif axis == 0:
                flat = i * tab.shape[1] + torch.arange(idx.shape[1], device=self.dev)[None, :]
            else:
                flat = torch.arange(idx.shape[0], device=self.dev)[:, None] * tab.shape[1] + i
            traffic = (sectors(flat * e) + idx.numel() * (4 + e), 0)
            # the library calls take int64 indices: made once, outside the timed call
            library = ((lambda t, _x: torch.take(t, i)) if axis is None else (lambda t, _x: torch.gather(t, axis, i)))
            add("probe_gather", site, self.probe_site(
                "probe_gather", f"{site} {label}", lambda: (tab, idx), lambda t, x: kp.gather(t, x, axis),
                lambda t, x: pp.gather(t, x, axis), compare(), traffic, library))

        for name, n_tab, dtype, n_range in probe2.TAKES:
            gather_site("tools/probe2.py:27", name[3:], *on(*probe2.make_take(n_tab, dtype, n_range)))
        gather_site("tools/probe2.py:47", "take_along_axis ax0 [1024,128] by [8,128]", *on(*probe2.make_along()), 0)
        # a table past the 50 MB L2: probe 6's take of 307 k from the 134 MB
        # int32 table (its XLA menu, which P1 runs on the probes' path)
        n_tab, n_idx, name = probe6.TAKES[1]
        gather_site("tools/probe6.py:42", f"take {n_idx // 1000}k from {name} int32 (the table past the L2)",
                    *on(*probe6.make_take(n_tab, n_idx)))
        for rows, cols, dtype, axis, name in probe6.MATRIX:
            tab, idx = probe6.make_dg(rows, cols, dtype, axis)
            gather_site("tools/probe6.py:42", f"dg {name} [{rows},{cols}] {dtype} axis{axis}",
                        probe6.to_table(tab, dtype, self.dev), *on(idx), axis)

        # P2: the row update; one library call computes it only at probe 10's
        # static-map copies (`library`). `call(fn, vba)` is the site through
        # fn (kp.row_update or pp.row_update) on rows vba. Beside the design
        # it replaced (`simple`), gated on being faster at the headline sites.
        def rows_site(site, label, vba, call, tol, library=None, headline=False):
            (_v, ptr), kw = recorded(call, vba)
            nv, row_len = ptr.numel(), vba.shape[1]
            p, steps = ptr.long(), torch.arange(nv, device=self.dev)
            gate, tap, in_place = kw.get("gate", "none"), kw.get("tap", "none"), kw.get("in_place", True)
            if gate == "ptr":
                steps = steps[p >= 0]
            elif gate == "first":
                steps = pp.first_steps(p)
            # the steps that change their row; in place, a step the valid gate keeps moves nothing
            changed = steps if gate != "valid" else steps[kw["valid"].long()[steps] > 0]
            moved = changed if in_place else steps
            src = p[moved] if kw.get("src_ptr", True) else moved
            dst = p[moved] if kw.get("dst_ptr", True) else moved
            n_bytes = 4 * nv + row_len * vba.element_size() * (distinct(src) + distinct(dst))
            n_ops = changed.numel() * row_len * (1 if tap == "none" else 3)  # · mul (int8: + 1); + tap · s, +
            if gate == "valid":
                n_bytes += 4 * nv
            if tap != "none":
                n_bytes += 8 * nv
                wv, wu = kw["wv"].long()[changed][:, None], kw["wu"].long()[changed][:, None]
                if tap == "sum":
                    n_bytes += distinct(wv * 64 + wu) * pp.WIN * pp.WIN * 4
                    n_ops += changed.numel() * pp.WIN * pp.WIN
                else:
                    dv = (3 * torch.arange(row_len, device=self.dev)[None, :] + changed[:, None]) % pp.WIN
                    du, w = (7 * dv) % pp.WIN, kw["img"].shape[1]
                    flat = ((wv * pp.WIN + dv) * w + wu * pp.WIN + du if tap == "bf16"
                            else (wu * pp.WIN + du) * w + wv * pp.WIN + dv)
                    n_bytes += sectors(flat * 4)
            written = None if in_place else (p[steps] if kw.get("dst_ptr", True) else steps)
            make = (lambda: (vba.clone(),)) if in_place else (lambda: (vba,))
            row = self.probe_site(
                "probe_rows", f"{site} {label}", make, lambda v: call(kp.row_update, v),
                lambda v: call(pp.row_update, v), compare(tol, written), (n_bytes, n_ops), library)
            want = call(pp.row_update, vba.clone())
            designs(row, make, lambda v: call(kp.row_update, v), {"simple": lambda v: call(kp.row_update_simple, v)},
                    lambda got: (lambda ok, _err, what: (ok, what))(*compare(tol, written)(got, want)))
            if headline:
                self.gate(faster(row, "simple"), f"probe_rows {row['label']}: faster than the simple design, "
                                                 f"cold and warm")
            add("probe_rows", site, row)
            if tap != "none":  # on zero rows the output is the scaled tap itself (1e-9 · tap vanishes beside a row)
                z = torch.zeros_like(vba)
                listed = p[steps] if kw.get("dst_ptr", True) else steps
                got, want = call(kp.row_update, z.clone())[listed], call(pp.row_update, z.clone())[listed]
                err, top = float((got - want).abs().max()), float(want.abs().max())
                ok = top > 0 and (err <= 1e-5 * top if tap == "sum" else torch.equal(got, want))
                self.gate(ok, f"probe_rows {site} {label} on zero rows: the scaled taps "
                              + ("within 1e-5 of their largest" if tap == "sum" else "bit-equal to plain")
                              + f" (max abs err {err:.3e}, largest {top:.3e})")

        vba, depth, ptr, wv, wu, valid = on(*probe7.make(*probe7.FULL))
        rows_site("tools/probe7.py:77", f"mini-integrate {ptr.numel()} blocks, bf16 tap, valid, in place", vba,
                  lambda fn, v: probe7.update(fn, v, depth, ptr, wv, wu, valid), 1e-6, headline=True)
        vba, depth, ptr, wv, wu = on(*probe8.make(*probe8.FULL))
        for name, kw, tol in probe8.ATTEMPTS:
            rows_site("tools/probe8.py:28", name, vba,
                      lambda fn, v, kw=kw: probe8.attempt(fn, v, depth, ptr, wv, wu, **kw), tol,
                      headline=kw.get("tap") == "sum")
        vba, depth_t, ptr, wv, wu, valid = on(*probe9.make(*probe9.FULL))
        rows_site("tools/probe9.py:53", f"integrate-pattern {ptr.numel()} blocks, f32 tap, valid, in place", vba,
                  lambda fn, v: probe9.update(fn, v, depth_t, ptr, wv, wu, valid), 1e-6)
        vba, depth_t, ptr, seq, wv, wu = on(*probe10.make(*probe10.FULL))
        for name, flags in probe10.ATTEMPTS:
            library = probe10.LIBRARY.get(name)
            rows_site("tools/probe10.py:69", name, vba,
                      lambda fn, v, flags=flags: probe10.attempt(fn, v, depth_t, ptr, seq, wv, wu, *flags),
                      1e-6 if flags[2] else 0.0, library and (lambda v, f=library: f(v, ptr.numel())),
                      headline=name == "copy dyn-in dyn-out alias")
        rows_site("tools/probe12.py:105", f"dyn-row integrate {ptr.numel()} blocks, not aliased", vba,
                  lambda fn, v: probe12.integ(fn, v, depth_t, ptr, wv, wu), 1e-6)
        vol, _pid = on(*probe13.make_volume())
        (rows,) = on(probe13.make_rows())
        rows_site("tools/probe13.py:113", f"int8 +1 on {rows.numel()} listed rows ({distinct(rows)} distinct)", vol,
                  lambda fn, v: probe13.row_stores(fn, v, rows), 0.0, headline=True)
        del vba, depth, depth_t, ptr, seq, wv, wu, valid, vol, rows

        # P3: the page gather-sum. At probe9's float32 page accumulator one
        # library call computes it, F.embedding_bag(ids, pages, mode="sum"),
        # held bit-equal to plain; at probe13's int8 raycast skeleton none:
        # embedding_bag takes float weights only, and the hashed columns are
        # a second gather. Beside the design it replaced (`simple`), gated on
        # being faster at both sites.
        def page_site(site, label, pages, ids, call, bag=False):
            (_q, ids_2d, k, n_cols), kw = recorded(call, pages, ids)
            hashed = kw.get("hashed", False)
            nt, row_len, e = ids_2d.shape[0], pages.shape[1], pages.element_size()
            c = torch.arange(n_cols, device=self.dev)[None, :]
            sel = (17 * c + torch.arange(nt, device=self.dev)[:, None]) % row_len if hashed else c
            flat = ids_2d[:, :k].long()[:, :, None] * row_len + sel[:, None, :]
            io = 4 * nt * k + 4 * nt * n_cols
            traffic = (sectors(flat * e) + io, nt * n_cols * (k + 1))
            bag_ids = ids_2d[:, :k].long()  # the library call takes int64 ids: made once, outside the timed call
            library = (lambda q, _i: torch.nn.functional.embedding_bag(bag_ids, q, mode="sum")) if bag else None
            row = self.probe_site(
                "probe_page_sum", f"{site} {label}", lambda: (pages, ids), lambda q, i: call(kp.page_sum, q, i),
                lambda q, i: call(pp.page_sum, q, i), compare(), traffic, library,
                l2_bytes=row_sectors(flat.reshape(nt * k, n_cols) * e) + io)
            want = call(pp.page_sum, pages, ids)
            if bag:
                self.gate(torch.equal(library(pages, ids), want),
                          f"probe_page_sum {row['label']}: F.embedding_bag bit-equal to plain")
            designs(row, lambda: (pages, ids), lambda q, i: call(kp.page_sum, q, i),
                    {"simple": lambda q, i: call(kp.page_sum_simple, q, i)},
                    lambda got: (torch.equal(got, want), "bit-equal to plain"))
            self.gate(faster(row, "simple"), f"probe_page_sum {row['label']}: faster than the simple design, "
                                             f"cold and warm")
            add("probe_page_sum", site, row)

        vol, pid = on(*probe13.make_volume())
        page_site("tools/probe13.py:51", f"raycast skeleton, int8, {pid.shape[0]} tiles × {probe13.KP} pages", vol,
                  pid, probe13.raycast_skeleton)
        pages, p = on(*probe9.make_pages())
        page_site("tools/probe9.py:115", f"page accumulator, f32, {p.numel() // probe9.K} tiles × {probe9.K} pages",
                  pages, p, probe9.accumulate, bag=True)
        del vol, pid, pages, p

        # P4: the scaled copy; library torch.mul; beside the design it replaced
        # (`simple`)
        def copy_site(site, x, rows_per_cta):
            n_ctas = x.shape[0] // rows_per_cta
            row = self.probe_site(
                "probe_scale", f"{site} [{x.shape[0]}, {x.shape[1]}] in {n_ctas} CTAs of {rows_per_cta} rows",
                lambda: (x,), lambda y: kp.scaled_copy(y, rows_per_cta), lambda y: pp.scaled_copy(y, rows_per_cta),
                compare(), (8 * x.numel(), x.numel()), lambda y: torch.mul(y, 1.000001))
            want = pp.scaled_copy(x, rows_per_cta)
            designs(row, lambda: (x,), lambda y: kp.scaled_copy(y, rows_per_cta),
                    {"simple": lambda y: kp.scaled_copy_simple(y, rows_per_cta)},
                    lambda got: (torch.equal(got, want), "bit-equal to plain"))
            if n_ctas <= 96:  # the decompositions of few CTAs, which the ring is for
                self.gate(faster(row, "simple"), f"probe_scale {row['label']}: faster than the simple design, "
                                                 f"cold and warm")
            add("probe_scale", site, row)

        rows, cols, ctas = probe11.COPY
        (x,) = on(probe11.make_copy(rows, cols))
        copy_site("tools/probe11.py:58", x, rows // ctas)
        (x,) = on(probe11.make_copy(*probe11.TINY, seed=1))
        copy_site("tools/probe11.py:73", x, 1)
        (x,) = on(probe12.make_copy(seed=2))
        for _ctas, per_cta in probe12.DECOMPOSITIONS:
            copy_site("tools/probe12.py:59", x, per_cta)
        del x

        # P5: the bf16 product; library torch.matmul on the same bf16 inputs;
        # beside the design it replaced (`wmma`)
        a, b = (probe11.to_bf16(t, self.dev) for t in probe11.make_mm())
        m, k = a.shape
        n = b.shape[1]

        def ulps(got, want):
            kernel_bound, plain_bound = pp.bf16_product_bound(got, a, b), pp.bf16_product_bound(want, a, b)
            g, w = got.float(), want.float()
            far = (g - w).abs() > pp.bf16_ulp(torch.maximum(g.abs(), w.abs()))
            exact = (a.double() @ b.double()).abs()
            return (float(kernel_bound.max()) <= 1.0, float((g - w).abs().max()),
                    f"within the float32 summation bound of the exact product, rounded to bf16 (max "
                    f"{float(kernel_bound.max()):.4f} of it; plain {float(plain_bound.max()):.4f}); "
                    f"{int(far.sum())} of {got.numel()} elements > 1 bf16 ulp from plain, all with |exact| ≤ "
                    f"{float(exact[far].max()) if far.any() else 0.0:.3e}")

        row = self.probe_site(
            "probe_gemm", f"tools/probe11.py:31 {m}×{n}×{k} bf16", lambda: (a, b), kp.gemm_bf16, pp.gemm_bf16, ulps,
            (2 * (m * k + k * n + m * n), 2 * m * n * k), torch.matmul, peak_ops=PEAK_BF16_PER_S)
        designs(row, lambda: (a, b), kp.gemm_bf16, {"wmma": kp.gemm_bf16_wmma},
                lambda got: (float(pp.bf16_product_bound(got, a, b).max()) <= 1.0,
                             f"within the float32 summation bound (max "
                             f"{float(pp.bf16_product_bound(got, a, b).max()):.4f} of it)"))
        self.gate(faster(row, "wmma"), f"probe_gemm {row['label']}: faster than the wmma design, cold and warm")
        add("probe_gemm", "tools/probe11.py:31", row)
        ai, bi = (torch.from_numpy(np.random.default_rng(s).integers(-8, 9, (2048, 2048)).astype(np.float32))
                  .to(self.dev).to(torch.bfloat16) for s in (3, 4))
        same = torch.equal(kp.gemm_bf16(ai, bi), pp.gemm_bf16(ai, bi))
        self.gate(same, "probe_gemm on integer inputs in [-8, 8] (every partial sum exact in float32): bit-equal "
                        "to plain")
        del a, b, ai, bi

        # P6: the window column sums. No library call: no one PyTorch call
        # sums the columns of 1,200 windows at data-dependent starts without
        # copying them out of the image (conv2d with a 64×1 filter of ones
        # sums the windows at every start, 449×768 of them, and a second
        # call would pick the 1,200). Beside the design it replaced
        # (`simple`), gated on being faster.
        img, starts = on(*probe13.make_window())
        nt, st = starts.shape[0], starts.reshape(starts.shape[0], -1)
        r = torch.arange(64, device=self.dev)
        flat = ((st[:, 0].long()[:, None, None] + r[None, :, None]) * img.shape[1] + st[:, 1].long()[:, None, None]
                + r[None, None, :])
        io = 32 * nt + 4 * nt * 128
        row = self.probe_site(
            "probe_window_sums", f"tools/probe13.py:85 {nt} tiles of 64×64", lambda: (img, starts),
            lambda i, t: probe13.window_sums(kp.window_sums, i, t),
            lambda i, t: probe13.window_sums(pp.window_sums, i, t), compare(), (sectors(flat * 4) + io, nt * 64 * 64),
            l2_bytes=row_sectors(flat.reshape(nt * 64, 64) * 4) + io)
        want = probe13.window_sums(pp.window_sums, img, starts)
        designs(row, lambda: (img, starts), lambda i, t: probe13.window_sums(kp.window_sums, i, t),
                {"simple": lambda i, t: probe13.window_sums(kp.window_sums_simple, i, t)},
                lambda got: (torch.equal(got, want), "bit-equal to plain"))
        self.gate(faster(row, "simple"), f"probe_window_sums {row['label']}: faster than the simple design, cold and "
                                         f"warm")
        add("probe_window_sums", "tools/probe13.py:85", row)

        kernels = []
        for counter, rows in found.items():
            head = rows[0]
            sites = [site for site in kp.SITES if any(r["site"] == site for r in rows)]
            kernels.append(dict(
                name=counter, route="cuda", source="infinitam_tpu_torch/csrc/probes.cu", replaces=", ".join(sites),
                max_abs_err=max(r["max_abs_err"] for r in rows), headline=head["label"],
                **{key: head[key] for key in ("ms", "cold_ms", "warm_ms", "call_ms", "plain_ms", "library_ms",
                                              "library_warm_ms", "bound_ms", "bound_by", "bound_bytes", "bound_ops")},
                **{key: v for key, v in head.items() if key.startswith(DESIGNS + EXTRAS)},
                sites=[{key: r[key] for key in ("label", "ms", "warm_ms", "call_ms", "plain_ms", "library_ms",
                                                "library_warm_ms", "bound_ms", "bound_by", "max_abs_err")}
                       | {key: v for key, v in r.items() if key.startswith(DESIGNS + EXTRAS)} for r in rows]))
        return kernels

    def probes_main_path(self) -> dict:
        """This slice's path: `python -m infinitam_tpu_torch.probes` (its
        main(), all nine probes, on the card), with the launch counts set to 0
        just before and read just after; each of P1-P6 must launch."""
        from infinitam_tpu_torch.ops.kernels import probes as kp
        from infinitam_tpu_torch.probes import __main__ as probes_main

        self.build.reset_launch_counts()
        t0 = time.perf_counter()
        results = probes_main.main([])
        torch.cuda.synchronize()
        counts = {c: self.build.launch_counts()[c] for c in kp.COUNTERS.values()}
        print(f"probes main path (python -m infinitam_tpu_torch.probes, all nine probes): "
              f"{time.perf_counter() - t0:.1f} s, launches {counts}")
        for c, n in counts.items():
            self.gate(n > 0, f"{c} launched on the probes' main path ({n} launches)")
        self.gate(all(r["ok"] for r in results["probe8"]), "probe8: every body equal to its plain twin on the card")
        timed = [r for rs in results.values() for r in rs if r["name"].startswith("P")]
        self.gate(all(r["device_ms"] is not None for r in timed),
                  f"the probes' {len(timed)} kernel lines each have a device time")
        return counts

    def profile(self, name, settings, frames, kind="frames", capture=True):
        """torch.profiler over the last PROFILE_FRAMES frames of a replay on a
        fresh map (the frames before them warm the map up, unprofiled, and
        capture the graph), captured or op by op (`capture`)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        n = PROFILE_FRAMES
        depths, rgbs = frames
        run, _fresh = self.runner(kind)
        warm = run(settings, (depths[:-n], rgbs[:-n]), capture=capture)
        # the state a run continues from: the engine, or the volume and states
        state = warm[0] if kind == "engine" else warm[:-2]
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(settings, (depths[-n:], rgbs[-n:]), state, capture=capture)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        how = "captured" if capture else "uncaptured"
        self.captured.clear()
        if not spans:
            print(f"{name} profile ({how}): the profiler saw no device activity; device busy not measured")
            return None
        busy, end, by_name = 0.0, float("-inf"), {}
        for s, e, op in spans:  # union of the intervals, in µs
            busy += max(0.0, e - max(s, end))
            end = max(end, e)
            by_name[op] = by_name.get(op, 0.0) + (e - s)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        unit = "step" if kind.startswith("batched") else "frame"
        print(f"{name} profile ({how}) over the last {n} of {len(depths)} {unit}s: device busy {busy / 1000 / n:.3f} "
              f"ms/{unit} (union of device intervals), {len(spans) / n:.1f} device ops/{unit}, wall "
              f"{wall * 1000 / n:.3f} ms/{unit} under the profiler, device idle {100 * (1 - busy / 1e6 / wall):.1f}% "
              "of that wall")
        for op, us in top:
            print(f"    {us / 1000 / n:8.3f} ms/{unit}  {op[:110]}")
        return len(spans) / n


def smoke_configs(smoke):
    """The replayed configurations: (name, settings, kernels of its path,
    replay kind (Smoke.runner), launches a frame or None)."""
    from infinitam_tpu_torch.ops.kernels import build

    iters = smoke.trackers.level_iterations(smoke.cfg.TrackingParams())
    every_frame = dict(icp=sum(iters), integrate=1, raycast=1)
    none = dict.fromkeys(build.KERNELS, 0)
    return [
        ("5mm", reference_settings(smoke.cfg), DEPTH_PATH, "frames", None),
        # each swap replay right after its config without swapping: the
        # ratio of their frames/s compares two replays minutes apart
        ("5mm_swap", swap_settings(reference_settings(smoke.cfg)), DEPTH_PATH, "engine", every_frame),
        ("1cm", teddy_1cm_settings(smoke.cfg), DEPTH_PATH, "frames", None),
        ("1cm_swap", swap_settings(teddy_1cm_settings(smoke.cfg)), DEPTH_PATH, "engine", every_frame),
        ("1cm_rgb", color_settings(smoke.cfg), RGB_PATH, "frames", None),
        ("5mm_wicp", wicp_settings(smoke.cfg), WICP_PATH, "engine", None),
        # Ren's ICP pre-step stops above level 0
        ("5mm_ren", ren_settings(smoke.cfg), DEPTH_PATH, "engine",
         dict(icp=sum(iters[1:]), integrate=1, raycast=1)),
        # K3 runs on every frame, marching only on the frames that refresh
        ("5mm_approx", approx_settings(smoke.cfg), DEPTH_PATH, "frames", every_frame),
        # the dense 512³ array: ICP, K2d and K3d (no K2)
        ("dense_5mm", dense_settings(smoke.cfg), DENSE_PATH, "dense",
         none | dict(icp=sum(iters), integrate_dense=1, raycast_dense=1)),
        # the hash table instead of the block grid: K3h instead of K3
        ("5mm_hashprobe", hashprobe_settings(smoke.cfg), HASHPROBE_PATH, "frames",
         none | dict(icp=sum(iters), integrate=1, raycast_hash=1)),
        # the coarse pre-pass: K3 twice a frame
        ("5mm_coarse2", coarse_settings(smoke.cfg), DEPTH_PATH, "frames",
         none | dict(icp=sum(iters), integrate=1, raycast=2)),
    ]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", nargs="*", metavar="CONFIG",
                    help="add a torch.profiler window per config, captured and op by op (device busy, ops, top "
                         "consumers), for each config or the ones named")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this run measures the port on an NVIDIA GPU", file=sys.stderr)
        return 1
    if not (REPO / "infinitam_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))

    t_start = time.perf_counter()
    card = card_line()
    print(card)
    smoke = Smoke()
    from infinitam_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    build.library()
    print(f"kernel build + load: {time.perf_counter() - t0:.1f} s (nvcc {build.last_build_seconds:.1f} s)")
    for source, report in build.ptxas_report.items():  # registers, stack and spills of each kernel
        kernel = None
        for line in report.splitlines():
            if "Compiling entry function" in line or "Function properties for" in line:
                kernel = line.split("'")[1] if "'" in line else line.rsplit(" ", 1)[-1]
            elif kernel and ("Used" in line or "spill" in line):
                print(f"  ptxas, {source} {kernel}: {line.split(':', 1)[-1].strip()}")

    from infinitam_tpu_torch.utils import native

    smoke.gate(native.get_lib() is not None and native.library_path().exists(),
               f"native/itpu_io.cpp built with g++ into {native.library_path().relative_to(REPO)} and loaded")

    depths, rgbs, gt = smoke.frames()
    frames = (depths, rgbs)
    iters = smoke.trackers.level_iterations(smoke.cfg.TrackingParams())
    every_frame = dict(icp=sum(iters), integrate=1, raycast=1)
    configs = smoke_configs(smoke)
    by_name = {c[0]: c[1] for c in configs}
    for name, settings, *_rest in configs:  # as bench.py:96-99 checks its configs
        try:
            smoke.cfg.assert_alloc_stride_safe(settings, smoke.calib.intrinsics_d.fx)
            safe = True
        except ValueError as e:
            print(f"{name}: {e}")
            safe = False
        smoke.gate(safe, f"{name} alloc_subsample {settings.alloc_subsample} within the safe stride "
                         f"{smoke.cfg.safe_alloc_stride(settings, smoke.calib.intrinsics_d.fx)}")
    s5, s1d, s1, s5w, sd = (by_name[k] for k in ("5mm", "1cm", "1cm_rgb", "5mm_wicp", "dense_5mm"))
    vol, rs, st, view = smoke.fused(s5, frames)
    k2 = smoke.k2_check("5 mm", s5, vol, rs, st, view)
    kernels = [smoke.k1_check(s5, st, view.depth), k2]
    # the weighted K1 on the same volume, with the weighted tracker's view of
    # the next frame (filtered depth) and its ω pyramid
    wview = smoke.build_view(depths[N_CHECK_FRAMES], s5w, smoke.calib)
    omega = smoke.trackers.weight_pyramid(wview.depth_uncertainty, s5w.tracking.n_levels)
    kernels.insert(1, smoke.k1_check(s5w, st, wview.depth, weights=omega))
    kernels.append(smoke.k3_check("5 mm", s5, vol, rs, st))
    kernels.append(smoke.k3h_check(by_name["5mm_hashprobe"], vol, rs, st))
    del wview, omega
    dvol, dst, _p, _d = smoke.run_dense(sd, (depths[:N_CHECK_FRAMES], rgbs[:N_CHECK_FRAMES]))
    kernels.insert(3, smoke.k2d_check(sd, dvol, dst, smoke.build_view(depths[N_CHECK_FRAMES], sd, smoke.calib)))
    kernels.append(smoke.k3d_check(sd, dvol, dst))
    lanes = smoke.lane_checks(s5, vol, rs, st, view, sd, dvol, dst)
    for k in kernels:
        if k["name"] in lanes:
            k["lanes3_ms"], k["lanes3_single_ms"] = lanes[k["name"]]
            k["lanes3_bound_ms"] = LANE_CHECK * k["bound_ms"]
        if k["name"] == "icp_reduce":
            k["lanes3_level_ms"] = [list(t) for t in lanes["icp_reduce_level_ms"]]
    del vol, rs, st, view, dvol, dst
    k2_1cm = smoke.k2_check("1 cm", s1d, *smoke.fused(s1d, frames))
    k2.update({f"{k}_1cm": k2_1cm[k] for k in ("ms", "cold_ms", "call_ms", "plain_ms", "bound_ms", "bound_by")})
    vol, rs, st, _view = smoke.fused(s1, frames)
    smoke.k3_check("1 cm", s1, vol, rs, st)
    kernels.insert(3, smoke.color_kernel_check(s1, vol, rs, frames, gt))
    del vol, rs, st
    # the probes' kernels: each site of tools/ at full shape, then the
    # probes' entry point, the path of their launch counts
    kernels += smoke.probe_checks()
    probe_launches = smoke.probes_main_path()
    # launches per kernel summed over the replays' counted runs (each run's
    # counts are reset just before it and read just after), and per frame of
    # each replay
    launches = dict.fromkeys(build.KERNELS, 0) | probe_launches
    per_frame, per_step, timing, efficiency = {}, {}, {}, {}

    def batched(name, settings, kind, n_lanes, expected, single):
        """A batched replay right after the unbatched replay of its lane 0,
        then the same lanes as N_RANKS ranks (`{name}_ranks`)."""
        bframes, bgts = smoke.lane_frames(frames, gt, n_lanes)
        counts, timing[name], efficiency[name] = smoke.batched_replay(name, settings, bframes, bgts, kind, expected,
                                                                      (single, timing[single][0]))
        per_step[name] = {k: n / N_FRAMES for k, n in counts.items()}
        per_frame[name] = {k: n / (N_FRAMES * n_lanes) for k, n in counts.items()}
        for k, n in counts.items():
            launches[k] += n
        ranked = f"{name}_ranks"
        counts, one_rank, timing[ranked] = smoke.ranks_replay(ranked, settings, bframes, bgts, kind, expected,
                                                              (name, timing[name][1]))
        per_step[ranked] = {k: n / N_FRAMES for k, n in one_rank.items()}  # a step of one rank
        per_frame[ranked] = {k: n / (N_FRAMES * n_lanes) for k, n in counts.items()}
        for k, n in counts.items():
            launches[k] += n

    for name, settings, path, kind, expected in configs:
        counts, final, timing[name] = smoke.replay(name, settings, frames, gt, path, kind, expected)
        per_frame[name] = {k: n / N_FRAMES for k, n in counts.items()}
        for k, n in counts.items():
            launches[k] += n
        if name == "5mm":
            smoke.mesh_check(settings, final)
            del final
            batched("batched_5mm", settings, "batched", BATCH_LANES, every_frame, "5mm")
            # the legacy allocator on the card: a render state without its claim plane
            sub = (depths[:N_GRIDLESS], rgbs[:N_GRIDLESS])
            counts, final, timing["5mm_gridless"] = smoke.replay("5mm_gridless", settings, sub, gt[:N_GRIDLESS],
                                                                 DEPTH_PATH, "gridless", every_frame)
            per_frame["5mm_gridless"] = {k: n / N_GRIDLESS for k, n in counts.items()}
            for k, n in counts.items():
                launches[k] += n
            compact = smoke.run_frames(settings, sub)[0]
            sets = [set(map(tuple, v.entry_pos[v.entry_ptr >= 0].tolist())) for v in (final, compact)]
            print(f"5mm_gridless: final block set {len(sets[0])} blocks, the compact allocator's over the same "
                  f"{N_GRIDLESS} frames {len(sets[1])}, symmetric difference {len(sets[0] ^ sets[1])} blocks")
            del compact
        if name == "5mm_wicp":
            smoke.get_image_check(final, settings, frames, s1)
        if name == "5mm_swap":
            smoke.swap_return_check(settings, final, frames, gt, s5)
            with tempfile.TemporaryDirectory() as tmp:
                smoke.viewer_check(settings, smoke.checkpoint_check(settings, final, frames, tmp))
        if name == "dense_5mm":
            print(f"dense_5mm: {100 * smoke.inside_share(settings, frames, gt):.2f}% of the valid depth pixels "
                  f"({N_FRAMES} frames, true poses) have their surface point inside the {settings.plain.size} array")
            smoke.dense_mesh_check(settings, final)
            del final
            batched("batched_dense_5mm", settings, "batched_dense", DENSE_LANES,
                    dict(icp=sum(iters), integrate_dense=1, raycast_dense=1), "dense_5mm")
        final = None
    # expectations, printed and not gated: the map lies inside the block
    # grid's window, so both readers find the same blocks
    centre = {k: np.array([np.linalg.inv(p)[:3, 3] for p in v]) for k, v in smoke.poses.items()}
    for name in ("5mm_hashprobe", "5mm_coarse2", "dense_5mm"):
        diff = np.linalg.norm(centre[name] - centre["5mm"], axis=1)
        print(f"{name} against 5mm: largest per-frame camera-centre difference {diff.max() * 1000:.4f} mm, ATE "
              f"{smoke.ates[name] * 1000:.3f} mm against {smoke.ates['5mm'] * 1000:.3f} mm")
    for size in ("5mm", "1cm"):
        (fps, frame_ms), (fps_sw, frame_ms_sw) = timing[size], timing[f"{size}_swap"]
        print(f"swap ratio, {size}_swap against {size} ({card}): frames/s with swapping over frames/s without "
              f"{fps_sw / fps:.3f} ({fps_sw:.2f} / {fps:.2f}, timed replays); frame time without over frame "
              f"time with {frame_ms / frame_ms_sw:.3f} ({frame_ms:.3f} / {frame_ms_sw:.3f} ms, begin to end of the "
              "marked replays)")
    for k, n in smoke.bench_check(timing, card).items():
        launches[k] += n
    smoke.cli_check()
    smoke.fixture_check()
    if args.profile is not None:
        ops = {}
        bframes = {"batched_5mm": (s5, "batched", BATCH_LANES),
                   "batched_dense_5mm": (sd, "batched_dense", DENSE_LANES)}
        known = [c[0] for c in configs] + list(bframes)
        wanted = set(args.profile or known)
        smoke.gate(wanted <= set(known), f"--profile names known configs ({', '.join(sorted(wanted))})")
        bframes = {name: (settings, smoke.lane_frames(frames, gt, n_lanes)[0], kind)
                   for name, (settings, kind, n_lanes) in bframes.items() if name in wanted}
        for capture in (True, False):  # the uncaptured profile gives the device ops and top consumers op by op
            for name, settings, _path, kind, _expected in configs:
                if name in wanted:
                    ops[name] = smoke.profile(name, settings, frames, kind, capture)
            for name, (settings, bf, kind) in bframes.items():
                ops[name] = smoke.profile(name, settings, bf, kind, capture)
        for name, single in (("batched_5mm", "5mm"), ("batched_dense_5mm", "dense_5mm")):
            if name not in ops:
                continue
            if ops[name] is None or ops.get(single) is None:
                print(f"{name}: device ops per step not measured")
                continue
            print(f"{name}: {ops[name]:.1f} device ops a step against {ops[single]:.1f} a frame of {single} "
                  f"({ops[name] / ops[single]:.3f}×)")
            smoke.gate(ops[name] < 2 * ops[single], f"{name} device ops a step < 2× {single}'s a frame")
    smoke.gate(not any(m.split(".")[0] in ("jax", "jaxlib", "infinitam_tpu") for m in sys.modules),
               "no module of JAX or of the JAX package was imported")
    print(f"chip_smoke wall time: {time.perf_counter() - t_start:.1f} s")

    if smoke.failures:
        print(f"chip_smoke: {len(smoke.failures)} gate(s) failed: {smoke.failures}", file=sys.stderr)
        return 1
    for k in kernels:
        k["bound_share"] = None if k["ms"] is None else k["bound_ms"] / k["ms"]
        k["launches"] = launches[COUNTER[k["name"]]]
        k["launches_per_frame"] = {name: pf[COUNTER[k["name"]]] for name, pf in per_frame.items()}
        k["launches_per_step"] = {name: ps[COUNTER[k["name"]]] for name, ps in per_step.items()}
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
