#!/usr/bin/env python3
"""Replay the 1 cm colour-tracker configuration at 640×480 through the JAX
package or through the PyTorch port, from the same numpy frames, and compare
the two trajectories frame by frame.

The configuration is the JAX benchmark's 1 cm point (bench.py:78-92
teddy_1cm_settings) with colour fusion and the colour tracker
(`use_color=True`, `tracker_type=COLOR`), the calibration's RGB intrinsics
and extrinsic, as bench.py:95-112 passes them. Each implementation is run in
its own process on the CPU and imports only its own package (the settings
and the trajectory errors come from chip_smoke.py, which loads torch):

    python tools/color_tracker_replay.py jax   --frames F.npz --out J.npz
    python tools/color_tracker_replay.py torch --frames F.npz --out T.npz
    python tools/color_tracker_replay.py compare J.npz T.npz

`jax` renders the synthetic RGB-D frames with the JAX package's source and
writes them to --frames when that file does not exist yet; `torch` reads
them from there. Each run writes per-frame poses, tracker energy and point
count, and prints ATE RMSE and rotation RMSE over frames 1..N−1 (frame 0 is
not tracked), as bench.py:140-152 computes them. `compare` prints both
trajectories' errors and the per-frame pose difference between them.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the repository root

from chip_smoke import IMG, color_settings, frame_errors, trajectory_errors  # noqa: E402


def settings_for(cfg):
    """bench.py:78-92 teddy_1cm_settings() with colour fusion and the colour
    tracker, field for field, from either package's config module."""
    return color_settings(cfg).replace(tracker_type=cfg.TrackerType.COLOR)


def run_jax(frames_path: Path, n_frames: int):
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from infinitam_tpu import config as cfg
    from infinitam_tpu.calib import default_calib
    from infinitam_tpu.engine import hash_pipeline as hp
    from infinitam_tpu.engine.view_builder import build_view_from_metric_depth
    from infinitam_tpu.io import synth

    calib = default_calib(IMG[1], IMG[0])
    if not frames_path.exists():
        src = synth.SyntheticSource(calib, n_frames=n_frames, img_size=IMG, with_rgb=True)
        fr = [src.get_images() for _ in range(n_frames)]
        np.savez(frames_path, depth=np.stack([np.asarray(f[0]) for f in fr]),
                 rgb=np.stack([np.asarray(f[1]) for f in fr]), gt=np.asarray(src.gt_poses[:n_frames]))
    data = np.load(frames_path)
    settings = settings_for(cfg)
    proj = jnp.asarray(calib.intrinsics_d.vector)
    kw = dict(proj_rgb=jnp.asarray(calib.intrinsics_rgb.vector), rgb_to_depth=jnp.asarray(calib.rgb_to_depth))
    vol, rs, st = hp.create_engine_state(settings, IMG)
    out = []
    for i in range(n_frames):
        view = build_view_from_metric_depth(jnp.asarray(data["depth"][i]), settings, calib,
                                            rgb=jnp.asarray(data["rgb"][i]))
        vol, rs, st, diag = hp.process_frame_hash(vol, rs, st, view, proj, settings, **kw)
        out.append((np.asarray(st.pose), float(diag.f), int(diag.num_valid)))
    return data, out


def run_torch(frames_path: Path, n_frames: int):
    import torch

    from infinitam_tpu_torch import config as cfg
    from infinitam_tpu_torch.calib import default_calib
    from infinitam_tpu_torch.engine import hash_pipeline as hp
    from infinitam_tpu_torch.engine.view_builder import build_view_from_metric_depth

    calib = default_calib(IMG[1], IMG[0])
    data = np.load(frames_path)
    settings = settings_for(cfg)
    dev = torch.device("cpu")
    proj = torch.as_tensor(calib.intrinsics_d.vector, device=dev)
    kw = dict(proj_rgb=torch.as_tensor(calib.intrinsics_rgb.vector, device=dev),
              rgb_to_depth=torch.as_tensor(calib.rgb_to_depth, device=dev))
    vol, rs, st = hp.create_engine_state(settings, IMG, device=dev)
    out = []
    for i in range(n_frames):
        view = build_view_from_metric_depth(torch.as_tensor(data["depth"][i], device=dev), settings, calib,
                                            rgb=torch.as_tensor(data["rgb"][i], device=dev))
        vol, rs, st, diag = hp.process_frame_hash(vol, rs, st, view, proj, settings, **kw)
        out.append((st.pose.cpu().numpy(), float(diag.f), int(diag.num_valid)))
    return data, out


def report(name: str, poses: np.ndarray, gt: np.ndarray) -> None:
    poses, gt = poses.astype(np.float64), gt.astype(np.float64)
    t_err = frame_errors(poses, gt)[0]
    ate, rot = trajectory_errors(poses, gt)
    print(f"{name}: ATE RMSE {ate * 1000:.3f} mm, rotation RMSE {rot:.4f} deg over frames 1..{len(poses) - 1}")
    print(f"  per-frame centre error (mm): {' '.join(f'{e * 1000:.3f}' for e in t_err)}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("impl", choices=("jax", "torch", "compare"))
    ap.add_argument("files", nargs="*", help="compare: the two result files")
    ap.add_argument("--frames", type=Path, help="numpy frames (written by `jax` if missing)")
    ap.add_argument("--out", type=Path, help="result file")
    ap.add_argument("--n-frames", type=int, default=12)
    args = ap.parse_args()

    if args.impl == "compare":
        a, b = (np.load(f) for f in args.files)
        for name, r in zip(args.files, (a, b)):
            report(name, r["poses"], r["gt"])
        for i, (pa, pb) in enumerate(zip(a["poses"], b["poses"])):
            ca, cb = (np.linalg.inv(p.astype(np.float64))[:3, 3] for p in (pa, pb))
            dc = np.linalg.norm(ca - cb)
            print(f"  frame {i}: centres {dc * 1000:.4f} mm apart, f {a['f'][i]:.3f} / {b['f'][i]:.3f}, "
                  f"points {a['num_valid'][i]} / {b['num_valid'][i]}")
        return 0

    t0 = time.perf_counter()
    if args.impl == "jax":
        data, out = run_jax(args.frames, args.n_frames)
    else:
        data, out = run_torch(args.frames, args.n_frames)
    poses = np.stack([o[0] for o in out])
    gt = data["gt"][: args.n_frames]
    np.savez(args.out, poses=poses, gt=gt, f=np.array([o[1] for o in out]),
             num_valid=np.array([o[2] for o in out]))
    report(args.impl, poses, gt)
    print(f"wall {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
