"""Where a cold start of the bench's `replay` mode spends its time: the
committed PGM fixture through ImageFileReader and MainEngine at
tiny_test_settings(), as `ITPU_BENCH_CONFIG=replay python -m
infinitam_tpu_torch.bench` runs it, with each step timed alone.

    python -m infinitam_tpu_torch.cold_start [--device cuda|cpu]

Steps, each ended by a device sync: the CUDA context; the kernel library
(built by nvcc when this checkout has none yet, else loaded); the engine;
frame 0 op by op, so it holds the first use of every op, and its phases
(the view, then process_frame_hash's: track, alloc, integrate, raycast,
then the rest up to the sync) from the host issue times of the spans'
phase calls (engine/spans.py); frame 1 op by op; frame 2 captured (a warm-up
frame, the capture and one replay; the capture's own seconds are the
graph's); frame 3, a replay.
The bench's replay mode captures on its first frame, so its first frame
holds the library, the warm-up (frame 0's first uses) and the capture.
Prints a line a step and, last, one JSON object of the seconds. Without a
card it raises unless `--device cpu` is passed.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from infinitam_tpu_torch import bench
from infinitam_tpu_torch.config import tiny_test_settings
from infinitam_tpu_torch.engine import captured, spans
from infinitam_tpu_torch.engine.main_engine import MainEngine
from infinitam_tpu_torch.io.sources import ImageFileReader


def cold_start(device) -> dict:
    """The seconds of each step of a cold start on `device`."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    steps = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        if on_card:
            torch.cuda.synchronize(device)
        steps[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    if on_card:
        torch.empty(1, device=device)
        lap("cuda_context")
        from infinitam_tpu_torch.ops.kernels import build

        build.library()
        lap("kernel_library")
        steps["nvcc"] = build.last_build_seconds
    src = ImageFileReader(str(bench.FIXTURE / "calib.txt"), "", str(bench.FIXTURE / "depth_%04i.pgm"))
    img = (src.calib.intrinsics_d.height, src.calib.intrinsics_d.width)
    eng = MainEngine(tiny_test_settings(), src.calib, img, device=device)
    lap("engine")
    depths = [src.get_images()[0] for _ in range(4)]
    spans.enable(device)
    start = time.perf_counter_ns()
    eng.process_frame(raw_depth=depths[0], capture=False)
    if on_card:
        torch.cuda.synchronize(device)
    end = time.perf_counter_ns()
    issues = spans.summary()["issues"]
    spans.disable()
    laps = [(name, t) for name, _step, t in issues] + [("rest", end)]
    for (name, t), prev in zip(laps, [start] + [t for _n, t in laps]):
        steps[f"frame0_{name}"] = (t - prev) * 1e-9
    steps["frame0"] = (end - start) * 1e-9
    t0 = time.perf_counter()
    eng.process_frame(raw_depth=depths[1], capture=False)
    lap("frame1")
    eng.process_frame(raw_depth=depths[2])
    lap("frame2_captured")
    steps["frame2_capture"] = sum(g["capture_s"] for g in captured.graphs()) if on_card else 0.0
    eng.process_frame(raw_depth=depths[3])
    lap("frame3")
    return steps


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m infinitam_tpu_torch.cold_start",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="the device it runs on: cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the cold start runs on a CUDA device and none is available (--device cpu runs it on "
                           "the CPU)")
    print(bench.card_line(device), flush=True)
    steps = cold_start(device)
    for name, s in steps.items():
        print(f"{name}: {s:.3f} s")
    print(json.dumps({k: float(np.round(s, 6)) for k, s in steps.items()}))


if __name__ == "__main__":
    main()
