"""Benchmark: fused+tracked 640×480 frames/s on a Teddy-like replay, the port's
counterpart of the JAX package's bench.py.

    python -m infinitam_tpu_torch.bench [--device cuda|cpu]

Runs the flagship voxel-block-hash pipeline at the REFERENCE default
operating point — voxel 5 mm, mu 2 cm, 640×480, 5-level ICP pyramid
(reference: ITMLibSettings.cpp:10) — over a synthetic Teddy-like sequence
(the reference repo ships only Teddy's calibration, not its frames), on the
card. A second config at voxel 1 cm / mu 4 cm (same mu/voxel ratio) and the
1 cm point with colour fusion are reported alongside, with the swap tier's
frames/s ratio at 1 cm.

The replay runs through hash_pipeline.process_sequence_hash: on the card one
captured CUDA graph of the frame step (engine/captured.py), replayed once a
frame with no host sync in the frame loop. The timed replay starts from a
fresh map written into the tensors the correctness replay's graph was
captured with, so no capture falls inside the clock.

`ITPU_BENCH_CONFIG` picks one part (`5mm`, `1cm`, `color`, `swap`, or
`replay`: the committed PGM fixture through ImageFileReader and MainEngine);
unset, all but `replay` run. Prints ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": "frames/s", "vs_baseline": N/100, ...}
vs_baseline is against BASELINE.json's ≥100 frames/s target. The card's name
and power limit (nvidia-smi) and each config's `diag(...)` line go to
stderr. Without a card it raises unless `--device cpu` is passed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from infinitam_tpu_torch.calib import default_calib
from infinitam_tpu_torch.config import (
    BlockGridParams,
    SceneParams,
    Settings,
    SwappingMode,
    TrackingParams,
    VoxelBlockHashParams,
    assert_alloc_stride_safe,
    tiny_test_settings,
)
from infinitam_tpu_torch.engine import captured
from infinitam_tpu_torch.engine import hash_pipeline as hp
from infinitam_tpu_torch.engine.main_engine import MainEngine
from infinitam_tpu_torch.io import synth
from infinitam_tpu_torch.io.sources import ImageFileReader
from infinitam_tpu_torch.utils import se3

IMG = (480, 640)
N_FRAMES = 30
N_WARM = 2
FIXTURE = Path(__file__).resolve().parents[1] / "tests" / "fixtures" / "replay"
COUNTERS = ("n_alloc_overflow", "n_render_overflow", "n_pool_overflow", "n_too_big_blocks", "n_window_clipped")


def reference_settings() -> Settings:
    """The reference's default operating point (ITMLibSettings.cpp:10):
    voxel 5 mm, mu 2 cm, frustum 0.35-3 m. Capacity notes: 4 cm blocks →
    the 64³ working grid would cover only ±1.28 m laterally, so the grid
    widens to 96×96×80 (±1.92 m × 3.2 m — the full frustum); visibility
    runs ~4× the 1 cm block count, so the render/fuse windows double. The
    raycast page fields size only the JAX package's Pallas raycast; the
    port's raycast (K3) does not read them."""
    return Settings(
        scene=SceneParams(voxel_size=0.005, mu=0.02, view_frustum_min=0.35,
                          view_frustum_max=3.0),
        hashing=VoxelBlockHashParams(),
        tracking=TrackingParams(),
        block_grid=BlockGridParams(dims=(96, 96, 80), origin=(-48, -48, 0)),
        alloc_subsample=3,  # 4 cm blocks span ≥7 px at 3 m → stride ≤3 taps each
        max_fused_blocks=16384,
        max_render_blocks=16384,
        # above worst-case visibility (8403 measured; 8192 silently dropped
        # 211 blocks — n_render_overflow)
        raycast_page_blocks=12288,
        # tiered pages: p80 page count ~23 → small tier 24; the tail tier
        # keeps the worst-case 64 (48 dropped up to ~50 page-tile pairs a
        # frame late in the replay — n_pool_overflow)
        raycast_pages_per_tile=64,
        raycast_pages_small=24,
    )


def teddy_1cm_settings() -> Settings:
    """The 1 cm operating point: voxel 1 cm / mu 4 cm (same mu/voxel ratio
    as the reference default at a volume the synthetic scene fills)."""
    return Settings(
        scene=SceneParams(voxel_size=0.01, mu=0.04, view_frustum_min=0.35,
                          view_frustum_max=3.0),
        # ~2 k visible blocks at 1 cm — an 8 k visible-list cap keeps the
        # compaction/recheck passes (cost ∝ static cap) at 4× headroom
        hashing=VoxelBlockHashParams(max_visible_blocks=0x2000),
        tracking=TrackingParams(),
        # safe_alloc_stride allows 7, but the coarser allocation sampling
        # measurably degrades map completeness at silhouettes (ATE 8.9 →
        # 11.1 mm at stride 6); stay at the denser stride
        alloc_subsample=4,
    )


def _sync(device) -> None:
    """Wait for the work queued on the card (the JAX bench's
    block_until_ready); on the CPU every op has finished already."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _graphs() -> list:
    """Each live graph's name and capture seconds: a capture between two
    reads shows as an entry the first read lacks."""
    return [(g["name"], g["capture_s"]) for g in captured.graphs()]


def run_config(settings: Settings, with_color: bool = False, *, img=IMG, n_frames=N_FRAMES, device="cuda"):
    """A correctness replay of `n_frames` synthetic frames from a fresh map,
    then a timed replay from a fresh map in the same tensors. Returns
    (frames/s, ATE RMSE in metres, rotation RMSE in degrees, the diag
    string: n_visible of the last frame and the five silent-cap counters'
    maxima over the replay). Raises if a graph was captured inside the
    timed replay, or if its poses differ from the correctness replay's."""
    calib = default_calib(img[1], img[0])
    assert_alloc_stride_safe(settings, calib.intrinsics_d.fx)
    proj = torch.as_tensor(calib.intrinsics_d.vector, device=device)
    src = synth.SyntheticSource(calib, n_frames=n_frames, img_size=img, with_rgb=with_color, device=device)
    frames = [src.get_images() for _ in range(n_frames)]
    depths = torch.stack([d for d, _r, _g in frames])
    kw = {}
    if with_color:
        kw = dict(
            rgbs=torch.stack([r for _d, r, _g in frames]),
            proj_rgb=torch.as_tensor(calib.intrinsics_rgb.vector, device=device),
            rgb_to_depth=torch.as_tensor(calib.rgb_to_depth, device=device),
        )

    # correctness + capture run: the full replay from a fresh map
    vol, rs, state = hp.create_engine_state(settings, img, device=device)
    vol, rs, state, poses, diags = hp.process_sequence_hash(vol, rs, state, depths, proj, settings, **kw)
    _sync(device)
    poses_np = poses.cpu().numpy()
    diags_np = {k: getattr(diags, k).cpu().numpy() for k in ("n_visible",) + COUNTERS}

    # timed run: the same graph (its key holds the state tensors' addresses,
    # so the fresh map is written into them), a fresh map — measures the
    # steady replay including first-frame allocation bursts
    captured.refill((vol, rs, state), hp.create_engine_state(settings, img, device=device))
    _sync(device)
    before = _graphs()
    t0 = time.perf_counter()
    *_state, poses2, _d2 = hp.process_sequence_hash(vol, rs, state, depths, proj, settings, **kw)
    _sync(device)
    dt = time.perf_counter() - t0
    fps = n_frames / dt
    new = set(_graphs()) - set(before)
    if new:
        raise RuntimeError(f"graph(s) captured inside the timed replay: {sorted(new)}")
    if not np.array_equal(poses2.cpu().numpy(), poses_np):
        raise RuntimeError("the timed replay's poses differ from the correctness replay's")

    # Accuracy gate: full-trajectory ATE-RMSE vs ground truth at the 1 cm bar
    # (BASELINE.md: "ATE within 1 cm of reference trajectory"; the synthetic
    # sequence's exact ground truth stands in for the reference trajectory).
    # Frame 0 has no tracking yet (age<0) and is skipped, like the
    # reference's first frame. A rotation-error RMSE (deg) gates alongside:
    # a rotation drift must not hide behind close camera centres.
    errs = []
    rerrs = []
    for i in range(1, n_frames):
        gt = frames[i][2].cpu()
        c_est = np.linalg.inv(poses_np[i])[:3, 3]
        c_gt = se3.invert(gt).numpy()[:3, 3]
        errs.append(np.sum((c_est - c_gt) ** 2))
        dR = poses_np[i][:3, :3] @ gt.numpy()[:3, :3].T
        ang = np.arccos(np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0))
        rerrs.append(ang**2)
    ate_rmse = float(np.sqrt(np.mean(errs)))
    rot_rmse_deg = float(np.degrees(np.sqrt(np.mean(rerrs))))

    # silent-cap counters: MAX over the whole replay (a burst on frame 1
    # would print nothing if only the last frame were inspected), plus the
    # last frame's visibility
    n_vis_last = int(diags_np["n_visible"][-1])
    diag_str = f"n_visible(last)={n_vis_last} " + " ".join(f"max_{k}={int(diags_np[k].max())}" for k in COUNTERS)
    return fps, ate_rmse, rot_rmse_deg, diag_str


def run_swap_ratio(*, img=IMG, n_frames=46, n_warm=14, window=8, device="cuda"):
    """Swap-tier overhead: frames/s of MainEngine.process_frame with and
    without the host swap exchange at the 1 cm operating point, the median
    of `window`-frame windows after `n_warm` warm-up frames. Returns
    (ratio, frames/s without, frames/s with). A stderr line per mode gives
    the windows that held a graph capture (the swap step captures one graph
    for each set of merge inputs and slab size)."""
    calib = default_calib(img[1], img[0])
    res = {}
    for tag, mode in (("noswap", SwappingMode.DISABLED), ("swap", SwappingMode.ENABLED)):
        settings = teddy_1cm_settings().replace(swapping_mode=mode)
        eng = MainEngine(settings, calib, img, device=device)
        src = synth.SyntheticSource(calib, n_frames=n_frames, img_size=img, device=device)
        frames = [src.get_images() for _ in range(n_frames)]
        # long warm-up: covers the exchange's graph variants
        for d, _r, _g in frames[:n_warm]:
            eng.process_frame(metric_depth=d)
        _sync(device)
        # windowed timing: syncing every frame would serialize the pipelined
        # exchange (its host halves overlap later frames' device work);
        # windows keep the pipeline intact and the median window rejects
        # host hiccups and a graph captured late
        times = []
        captures = []
        rest = frames[n_warm:]
        for w0 in range(0, len(rest) - window + 1, window):
            before = _graphs()
            t0 = time.perf_counter()
            for d, _r, _g in rest[w0:w0 + window]:
                eng.process_frame(metric_depth=d)
            _sync(device)
            times.append((time.perf_counter() - t0) / window)
            captures.append(len(set(_graphs()) - set(before)))
        res[tag] = 1.0 / float(np.median(times))
        print(f"swap({tag}): {res[tag]:.2f} frames/s, the median of {len(times)} windows of {window} frames; "
              f"graphs captured inside each window: {captures}", file=sys.stderr)
        del eng, src, frames, rest  # this engine's map and graphs go before the next one's are made
    return res["swap"] / res["noswap"], res["noswap"], res["swap"]


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return "card: none (--device cpu: the plain versions on the CPU, host times)"
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
        return f"card: {res.stdout.strip().splitlines()[0]}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"card: {torch.cuda.get_device_name(device)}, power limit not read ({e})"


def _replay(device):
    """The committed PGM fixture through ImageFileReader → raw-depth
    conversion → MainEngine (the reference's own validation workflow): the
    JSON line of the `replay` mode."""
    src = ImageFileReader(str(FIXTURE / "calib.txt"), "", str(FIXTURE / "depth_%04i.pgm"))
    gt = np.load(FIXTURE / "gt_poses.npy")
    img = (src.calib.intrinsics_d.height, src.calib.intrinsics_d.width)
    eng = MainEngine(tiny_test_settings(), src.calib, img, device=device)
    n = 0
    t0 = time.perf_counter()
    while src.has_more_images():
        depth, _rgb = src.get_images()
        eng.process_frame(raw_depth=depth)
        n += 1
    _sync(device)
    dt = time.perf_counter() - t0
    err = se3.se3_log(torch.as_tensor(eng.get_pose()) @ se3.invert(torch.as_tensor(gt[-1], dtype=torch.float32)))
    return {"metric": "file replay smoke (dev)",
            "value": round(n / dt, 2), "unit": "frames/s",
            "vs_baseline": 1.0,
            "t_err_mm": round(float(np.linalg.norm(err.numpy()[:3])) * 1e3, 2),
            "frames": n}


def _dev_line(metric, fps, ate, rot):
    return {"metric": metric, "value": round(fps, 2), "unit": "frames/s", "vs_baseline": round(fps / 100, 3),
            "ate_rmse_m": round(ate, 5), "rot_rmse_deg": round(rot, 3)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m infinitam_tpu_torch.bench", description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="the device the bench runs on: cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the bench runs on a CUDA device and none is available (--device cpu runs it on the CPU)")
    print(card_line(device), file=sys.stderr, flush=True)

    only = os.environ.get("ITPU_BENCH_CONFIG", "")  # dev: 5mm|1cm|color|swap|replay
    if only == "swap":
        ratio, fps_ns, fps_sw = run_swap_ratio(device=device)
        print(json.dumps({"metric": "swap-mode fps ratio (dev)",
                          "value": round(ratio, 3), "unit": "x",
                          "vs_baseline": round(ratio / 0.85, 3),
                          "fps_noswap": round(fps_ns, 2),
                          "fps_swap": round(fps_sw, 2)}))
        return
    if only == "replay":
        print(json.dumps(_replay(device)))
        return
    if only == "color":
        fps_c, ate_c, rot_c, diag_c = run_config(teddy_1cm_settings().replace(use_color=True), with_color=True,
                                                 device=device)
        print(f"diag(color): {diag_c}", file=sys.stderr)
        print(json.dumps(_dev_line("fps @1cm+RGB fusion (dev)", fps_c, ate_c, rot_c)))
        return
    if only == "1cm":
        fps_1cm, ate_1cm, rot_1cm, diag_1cm = run_config(teddy_1cm_settings(), device=device)
        print(f"diag(1cm): {diag_1cm}", file=sys.stderr)
        print(json.dumps(_dev_line("fps @1cm (dev)", fps_1cm, ate_1cm, rot_1cm)))
        return
    if only == "5mm":
        fps_ref, ate_ref, rot_ref, diag_ref = run_config(reference_settings(), device=device)
        print(f"diag(5mm): {diag_ref}", file=sys.stderr)
        print(json.dumps(_dev_line("fps @5mm (dev)", fps_ref, ate_ref, rot_ref)))
        return
    fps_ref, ate_ref, rot_ref, diag_ref = run_config(reference_settings(), device=device)
    print(f"diag(5mm): {diag_ref}", file=sys.stderr)
    fps_1cm, ate_1cm, rot_1cm, diag_1cm = run_config(teddy_1cm_settings(), device=device)
    print(f"diag(1cm): {diag_1cm}", file=sys.stderr)
    fps_c, ate_c, _rot_c, diag_c = run_config(teddy_1cm_settings().replace(use_color=True), with_color=True,
                                              device=device)
    print(f"diag(1cm+rgb): {diag_c}", file=sys.stderr)
    swap_ratio, _fns, _fsw = run_swap_ratio(device=device)

    diverged = not (ate_ref < 0.01 and rot_ref < 1.0)
    print(json.dumps({
        "metric": "fused+tracked 640x480 frames/s/chip @ reference 5mm/2cm"
        + (" (ATE>1cm or rot>1deg: FAILED)" if diverged else ""),
        "value": 0.0 if diverged else round(fps_ref, 2),
        "unit": "frames/s",
        "vs_baseline": 0.0 if diverged else round(fps_ref / 100.0, 3),
        "ate_rmse_m": round(ate_ref, 5),
        "rot_rmse_deg": round(rot_ref, 3),
        "fps_1cm_voxel": round(fps_1cm, 2),
        "ate_rmse_1cm_m": round(ate_1cm, 5),
        "rot_rmse_1cm_deg": round(rot_1cm, 3),
        "fps_1cm_rgb_fusion": round(fps_c, 2),
        "ate_rmse_rgb_m": round(ate_c, 5),
        "swap_fps_ratio": round(swap_ratio, 3),
    }))


if __name__ == "__main__":
    main()
