"""Offline viewer: orbit ("turntable") freeview renders of a fused scene, on
the port (counterpart of infinitam_tpu/apps/viewer.py; the stand-in for the
reference's GLUT UIEngine freeview pane, Engine/UIEngine.cpp, which renders
through FindVisibleBlocks → raycast, ITMMainEngine.cpp:176-182).

It replays the synthetic sequence (or restores a checkpoint) and renders N
freeview images on a circle around the scene through
`MainEngine.get_image(pose=)`, as PNG (or PPM), plus an HTML strip.

Usage:
    # fuse the synthetic sequence, then render a 24-frame orbit
    python -m infinitam_tpu_torch.apps.viewer --synthetic --frames 12 --orbit 24 --out /tmp/orbit
    # restore a checkpoint of either package instead of replaying; the map's
    # settings are those the flags give (--grid-dims and --grid-origin for a
    # block grid other than the default)
    python -m infinitam_tpu_torch.apps.viewer --snapshot snap.npz --out /tmp/orbit

It runs on the card (there is no fallback: without one it fails), or on the
CPU with --cpu. A snapshot of a swapping engine renders its resident blocks:
the viewer's engine does not swap, so the host store is not read.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def orbit_pose(center: np.ndarray, radius: float, theta: float, height: float) -> np.ndarray:
    """world→camera pose on a circle around `center`, looking at it."""
    C = center + np.array([radius * np.sin(theta), height, radius * np.cos(theta)])
    fwd = center - C
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    up2 = np.cross(fwd, right)
    R = np.stack([right, up2, fwd])  # rows: camera axes in world
    M = np.eye(4, dtype=np.float32)
    M[:3, :3] = R
    M[:3, 3] = -R @ C
    return M


def main(argv=None):
    ap = argparse.ArgumentParser(description="orbit-render a fused scene")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--snapshot", default=None, help="engine checkpoint (.npz)")
    ap.add_argument("--frames", type=int, default=12, help="frames to fuse first")
    ap.add_argument("--orbit", type=int, default=24, help="orbit render count")
    ap.add_argument("--radius", type=float, default=2.0)
    ap.add_argument("--center", type=float, nargs=3, default=[0.0, 0.0, 1.5])
    ap.add_argument("--mode", default="raycast", choices=["raycast", "normals", "depth", "weight", "colour"])
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--voxel-size", type=float, default=0.01)
    ap.add_argument("--mu", type=float, default=0.04)
    ap.add_argument("--grid-dims", type=int, nargs=3, default=None, help="block grid dims (default 64 64 64)")
    ap.add_argument("--grid-origin", type=int, nargs=3, default=None, help="block grid origin (default -32 -32 0)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    from infinitam_tpu_torch.calib import default_calib
    from infinitam_tpu_torch.config import BlockGridParams, SceneParams, Settings
    from infinitam_tpu_torch.engine.main_engine import MainEngine
    from infinitam_tpu_torch.io import synth
    from infinitam_tpu_torch.utils import checkpoint as ckpt
    from infinitam_tpu_torch.utils.image_io import write_image

    device = torch.device("cpu" if args.cpu else "cuda")
    calib = default_calib(args.width, args.height)
    default = BlockGridParams()
    grid = BlockGridParams(dims=tuple(args.grid_dims or default.dims),
                           origin=tuple(args.grid_origin or default.origin))
    settings = Settings(scene=SceneParams(voxel_size=args.voxel_size, mu=args.mu), block_grid=grid)
    engine = MainEngine(settings, calib, (args.height, args.width), device=device)

    if args.snapshot:
        ckpt.load_engine(args.snapshot, engine)
        print(f"restored snapshot at frame {engine.frame_no}")
    else:
        src = synth.SyntheticSource(calib, n_frames=args.frames, img_size=(args.height, args.width), device=device)
        for i in range(args.frames):
            d = engine.process_frame(metric_depth=src.get_images()[0])
            print(f"fused frame {i}: inliers={d.get('num_valid', 0)}")

    os.makedirs(args.out, exist_ok=True)
    names = []
    center = np.asarray(args.center)
    for k in range(args.orbit):
        theta = 2.0 * np.pi * k / max(args.orbit, 1)
        img = engine.get_image(args.mode, pose=orbit_pose(center, args.radius, theta, height=0.0))
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        name = f"orbit_{k:04d}.png"
        write_image(os.path.join(args.out, name), img[..., :3].astype(np.uint8))
        names.append(name)
        print(f"rendered {name} ({(img > 0).mean():.2%} coverage)")

    with open(os.path.join(args.out, "index.html"), "w") as f:
        f.write("<html><body style='background:#111'>\n")
        for n in names:
            f.write(f"<img src='{n}' style='width:240px;margin:2px'>\n")
        f.write("</body></html>\n")
    print(f"orbit written to {args.out}/index.html")
    return 0


if __name__ == "__main__":
    sys.exit(main())
