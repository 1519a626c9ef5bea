"""Headless SLAM runner, the reference's InfiniTAM_cli, on the port
(counterpart of infinitam_tpu/apps/cli.py; reference Engine/CLIEngine.cpp:50-99
getImages → ProcessFrame loop, InfiniTAM.cpp:21-87 source fallback chain,
UIEngine.cpp:498-508 input recording as --record / --replay).

Usage:
    python -m infinitam_tpu_torch.apps.cli <calib.txt> [<rgb_mask> <depth_mask>]
        [--frames N] [--synthetic] [--tum ROOT] [--out-mesh scene.stl]
        [--out-render render_%04i.png] [--record DIR] [--replay DIR]
        [--tracker icp|wicp|color|ren|external] [--swapping] [--voxel-size 0.005] [--mu 0.02] [--cpu]

It runs on the card (there is no fallback: without one it fails), or on the
CPU with --cpu. The frame loop reads nothing back to the host except once
every 10 frames for the statistics line; --out-render renders and writes
the raycast after every frame, which waits for the card; --out-mesh writes
the map's mesh after the last frame (OBJ for a .obj path, else binary STL).
--swapping streams blocks that leave the view to a host store and back (the
mesh then covers the resident blocks, as in the JAX package). As in the JAX
package, --tracker wicp does not turn on the sensor-noise model, so without
it the weighted tracker runs unweighted (ROADMAP Queue 3).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

STAT_EVERY = 10  # frames per statistics line: one host read per window


def _is_metric(depth) -> bool:
    """Float frames are metric depth; integer frames are raw sensor values."""
    if torch.is_tensor(depth):
        return depth.is_floating_point()
    return np.asarray(depth).dtype.kind == "f"


def main(argv=None):
    ap = argparse.ArgumentParser(description="dense RGB-D SLAM on PyTorch + CUDA (headless)")
    ap.add_argument("calib", nargs="?", help="calibration text file")
    ap.add_argument("rgb_mask", nargs="?", help="printf mask for rgb frames (%%04i.ppm)")
    ap.add_argument("depth_mask", nargs="?", help="printf mask for depth frames (%%04i.pgm)")
    ap.add_argument("--synthetic", action="store_true", help="replay the synthetic scene")
    ap.add_argument("--tum", default=None, help="TUM-RGBD sequence root (associations.txt)")
    ap.add_argument("--record", default=None, help="record the raw input stream to DIR")
    ap.add_argument("--replay", default=None, help="replay a --record DIR deterministically")
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--voxel-size", type=float, default=0.005)
    ap.add_argument("--mu", type=float, default=0.02)
    ap.add_argument("--tracker", default="icp", choices=["icp", "wicp", "color", "ren", "external"])
    ap.add_argument("--swapping", action="store_true")
    ap.add_argument("--out-mesh", default=None)
    ap.add_argument("--out-render", default=None, help="printf mask for raycast dumps (.ppm or .png)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    from infinitam_tpu_torch.calib import default_calib, read_rgbd_calib
    from infinitam_tpu_torch.config import SceneParams, Settings, SwappingMode, TrackerType
    from infinitam_tpu_torch.engine.main_engine import MainEngine
    from infinitam_tpu_torch.io import sources as srcs
    from infinitam_tpu_torch.utils.image_io import expand_printf_mask, write_image

    device = torch.device("cpu" if args.cpu else "cuda")
    settings = Settings(
        scene=SceneParams(voxel_size=args.voxel_size, mu=args.mu),
        tracker_type=TrackerType(args.tracker),
        swapping_mode=SwappingMode.ENABLED if args.swapping else SwappingMode.DISABLED,
        use_color=args.tracker == "color",
    )

    if args.replay:
        calib = read_rgbd_calib(args.calib) if args.calib else default_calib(args.width, args.height)
        src = srcs.ReplaySource(args.replay, calib)
        synthetic = False
    elif args.synthetic:
        from infinitam_tpu_torch.io import synth

        calib = default_calib(args.width, args.height)
        src = synth.SyntheticSource(calib, n_frames=args.frames, img_size=(args.height, args.width),
                                    with_rgb=args.tracker == "color", device=device)
        synthetic = True
    else:
        src, synthetic = srcs.make_source(
            calib_path=args.calib, rgb_mask=args.rgb_mask, depth_mask=args.depth_mask, tum_root=args.tum,
            img_size=(args.height, args.width), n_frames=args.frames, with_rgb=args.tracker == "color",
            device=device,
        )
        calib = src.calib
    img_size = (calib.intrinsics_d.height, calib.intrinsics_d.width)
    # made before the first frame is read
    engine = MainEngine(settings, calib, img_size, device=device)
    if args.record:
        src = srcs.RecordingSource(src, args.record)
    # pinned ring feed: the next frames upload while the current one computes
    src = srcs.DeviceFrameFeed(src, device=device)

    total_ms = 0.0
    n = 0
    win_t0 = time.perf_counter()
    while src.has_more_images() and n < args.frames:
        out = src.get_images()
        depth, rgb = out[0], out[1]
        if synthetic or (depth is not None and _is_metric(depth)):
            diag = engine.process_frame(metric_depth=depth, rgb=rgb)
        else:
            diag = engine.process_frame(raw_depth=depth, rgb=rgb)
        n += 1
        if n % STAT_EVERY == 0 or not src.has_more_images():
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            win_ms = (time.perf_counter() - win_t0) * 1e3
            frames_in_win = STAT_EVERY if n % STAT_EVERY == 0 else n % STAT_EVERY
            total_ms += win_ms
            print(f"frame {n:4d}: {win_ms / frames_in_win:7.1f} ms/frame (avg {total_ms / n:7.1f})  "
                  f"inliers={diag.get('num_valid', 0):6d} visible={diag.get('n_visible', 0):5d}", flush=True)
            win_t0 = time.perf_counter()
        if args.out_render:
            img = engine.get_image("raycast")
            write_image(expand_printf_mask(args.out_render, n), np.stack([img] * 3, axis=-1))

    if args.out_mesh:
        engine.save_scene_to_mesh(args.out_mesh)
        print(f"mesh saved to {args.out_mesh}")
    print(f"processed {n} frames, avg {total_ms / max(n, 1):.1f} ms/frame")
    return 0


if __name__ == "__main__":
    sys.exit(main())
