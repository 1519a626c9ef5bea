#!/usr/bin/env python3
"""Time the single-lane (B = 1) launches of kernels K1, K2, K3 and K3d of
one checkout of the PyTorch port on the card, so that two checkouts (say a
change and its parent) can be compared in one run on one card.

    python tools/lane_kernel_probe.py [--repo DIR] [--tag NAME] [--out FILE]

The inputs are chip_smoke.py's main-path shapes: the reference settings (5
mm voxels, 640×480), 3 synthetic frames fused on the card, then K1 at
pyramid level 0 of the 4th frame from the last pose, K2 fusing the 4th frame
into a copy of the volume, K3 from the last pose over the block grid, and
K3d over chip_smoke.py's 512³ dense array after 3 dense frames. Each device
time is chip_smoke.py's `device_ms` (the mean duration of the repo's own
kernels in a torch.profiler window of 100 calls, warm).

`--repo` names the checkout whose `infinitam_tpu_torch` is imported
(default: this one); the frames, settings and timers come from this
checkout's chip_smoke.py. It prints the card's name and power limit, a line
per kernel and, last, a JSON object of the times in ms (also written to
--out). Needs an NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", type=Path, default=HERE, help="checkout whose infinitam_tpu_torch is timed")
    ap.add_argument("--tag", default="", help="a name for the checkout in the output")
    ap.add_argument("--out", type=Path, default=None, help="also write the JSON result here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lane_kernel_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.repo.resolve()))
    # this checkout's chip_smoke.py, by path: the other checkout has its own
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    smoke = cs.Smoke()
    print(cs.card_line())
    s5 = cs.reference_settings(smoke.cfg)
    sd = cs.dense_settings(smoke.cfg)
    depths, rgbs, _gt = smoke.frames()
    vol, rs, st, view = smoke.fused(s5, (depths, rgbs))
    sp = s5.scene
    tp = s5.tracking
    inv = smoke.se3.invert(st.pose)
    k1 = (view.depth, smoke.proj, st.points_map, st.normals_map, smoke.proj, inv, st.pose_point_cloud,
          smoke.trackers.level_dist_thresh(tp)[0], tp.min_valid_points)
    enable = torch.ones((), dtype=torch.bool, device=smoke.dev)
    k2 = (rs.visible_ids, vol.entry_ptr, vol.entry_pos, view.depth, st.pose, smoke.proj, enable, sp.voxel_size, sp.mu,
          sp.max_w, sp.stop_integrating_at_max_w, s5.hashing.block_size, s5.max_fused_blocks)
    vk = vol.vox.clone()
    zmin, zmax, _ = smoke.hp.expected_depth_ranges(vol, rs, st.pose, smoke.proj, cs.IMG, s5)
    k3 = (vol, smoke.hp.hv.get_block_grid(vol, s5.block_grid), s5.block_grid, s5.hashing, inv, smoke.proj, cs.IMG,
          1.0 / sp.voxel_size, sp.mu, zmin, zmax)
    calls = {
        "K1 level 0": lambda: smoke.k_icp.icp_gh(*k1),
        "K2": lambda: smoke.k_int.integrate_depth(vk, *k2),
        "K3": lambda: smoke.k_ray.raycast_grid(*k3),
    }
    times = {}
    for name, fn in calls.items():
        times[name] = cs.device_ms(fn, 100)[0]
    del vol, rs, st, view, vk, k1, k2, k3
    dvol, dst, _p, _d = smoke.run_dense(sd, (depths[:cs.N_CHECK_FRAMES], rgbs[:cs.N_CHECK_FRAMES]))
    sdd = sd.scene
    zmin = torch.full(cs.IMG, sdd.view_frustum_min, device=smoke.dev)
    zmax = torch.full(cs.IMG, sdd.view_frustum_max, device=smoke.dev)
    k3d = (dvol, sd.plain, smoke.se3.invert(dst.pose), smoke.proj, cs.IMG, 1.0 / sdd.voxel_size, sdd.mu, zmin, zmax)
    times["K3d"] = cs.device_ms(lambda: smoke.k_ray.raycast_dense(*k3d), 100)[0]
    for name, ms in times.items():
        print(f"{args.tag or args.repo}: {name} device {cs.fmt_ms(ms)}")
    result = {"tag": args.tag, "repo": str(args.repo), "ms": times}
    if args.out is not None:
        args.out.write_text(json.dumps(result) + "\n")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
