"""How a lane's result depends on its batch size in the port's batched step.

    python tools/batch_size_probe.py [--cpu]

On the card (the default) or the CPU:

1. The small torch ops of the frame step under torch.vmap at B = 1, 2 and 4
   lanes, lanes 0-1 given the same inputs: the largest difference of lane
   0 between B = 1 and B = 2, and of lanes 0-1 between B = 2 and B = 4.
2. The hash and dense batched steps over 3 synthetic 120×160 frames at
   tests/test_torch_kernels_cuda.py's settings (a 4,096-bucket table, a
   128³ array), B = 1, 2 and 4 from fresh maps, lanes 0-1 replaying the
   same frames: each frame's largest pose difference between batch sizes,
   and for the hash step between two runs at B = 1 and between two runs at
   B = 4, with whether the allocated and visible block sets agree.

It changes nothing; it prints one line a comparison.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from infinitam_tpu_torch.calib import default_calib  # noqa: E402
from infinitam_tpu_torch.config import PlainVoxelArrayParams, TrackingParams, tiny_test_settings  # noqa: E402
from infinitam_tpu_torch.engine.view_builder import View  # noqa: E402
from infinitam_tpu_torch.io import synth  # noqa: E402
from infinitam_tpu_torch.ops import icp as icp_ops  # noqa: E402
from infinitam_tpu_torch.ops import pyramid  # noqa: E402
from infinitam_tpu_torch.parallel import batch as pb  # noqa: E402
from infinitam_tpu_torch.utils import se3  # noqa: E402

IMG = (120, 160)
N_FRAMES = 3


def op_lines(dev):
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.rand(*shape, generator=gen).to(dev)

    def check(name, fn, *args):
        out = {}
        for B in (1, 2, 4):
            r = torch.vmap(fn)(*(a[:B] for a in args))
            out[B] = r[0] if isinstance(r, tuple) else r
        d12 = float((out[1][0] - out[2][0]).abs().max())
        d24 = float((out[2][:2] - out[4][:2]).abs().max())
        print(f"{name}: lane 0 at B = 1 against B = 2 {d12:.3e}, lanes 0-1 at B = 2 against B = 4 {d24:.3e}")

    a = rnd(4, 6, 30)
    spd = a @ a.transpose(1, 2) + 0.1 * torch.eye(6, device=dev)
    m, n = rnd(4, 4, 4), rnd(4, 4, 4)
    check("cholesky_ex", lambda x: torch.linalg.cholesky_ex(x)[0], spd)
    check("solve_psd", icp_ops.solve_psd, spd, rnd(4, 6))
    check("4x4 product", lambda x, y: x @ y, m, n)
    check("se3.coerce", se3.coerce, m)
    check("se3.invert", se3.invert, se3.se3_exp(rnd(4, 6) * 0.1))
    check("apply_delta", icp_ops.apply_delta, se3.se3_exp(rnd(4, 6) * 0.1), rnd(4, 6) * 0.01)
    check("subsample_with_holes", pyramid.subsample_with_holes, rnd(4, *IMG))


def block_sets(vol, rs, b):
    pos, ptr, ids = vol.entry_pos[b].cpu(), vol.entry_ptr[b].cpu(), rs.visible_ids[b].cpu()
    return set(map(tuple, pos[ptr >= 0].tolist())), set(map(tuple, pos[ids[ids >= 0].long()].tolist()))


def step_lines(dev):
    settings = tiny_test_settings().replace(tracking=TrackingParams(n_levels=3, min_valid_points=50),
                                            plain=PlainVoxelArrayParams(size=(128, 128, 128), offset=(-64, -64, 0)))
    proj = torch.as_tensor(default_calib(IMG[1], IMG[0]).intrinsics_d.vector, device=dev)
    trajs = [torch.as_tensor(synth.make_trajectory(N_FRAMES, scale=1.0 - 0.15 * b), device=dev)
             for b in range(4)]
    depths = torch.stack([torch.stack([synth.render_depth(trajs[b][f], proj, IMG) for b in range(4)])
                          for f in range(N_FRAMES)])
    for dense in (False, True):
        fresh = pb.batched_state_dense if dense else pb.batched_state_hash
        step = (pb.make_batched_step_dense if dense else pb.make_batched_step)(settings)

        def run(B):
            state, poses, sets = fresh(settings, IMG, B, device=dev), [], []
            for d in depths[:, :B]:
                *state, _m = step(*state, View(depth=d), proj)
                poses.append(state[-1].pose.clone())
                if not dense:
                    sets.append([block_sets(state[0], state[1], b) for b in range(min(B, 2))])
            return torch.stack(poses), sets

        runs = {"B = 1": run(1), "B = 1 again": run(1), "B = 2": run(2), "B = 4": run(4), "B = 4 again": run(4)}
        pairs = (("B = 1", "B = 2"), ("B = 2", "B = 4")) + (
            () if dense else (("B = 1", "B = 1 again"), ("B = 4", "B = 4 again")))
        for x, y in pairs:
            k = min(runs[x][0].shape[1], runs[y][0].shape[1], 2)
            diff = (runs[x][0][:, :k] - runs[y][0][:, :k]).abs().amax(dim=(1, 2, 3)).tolist()
            line = f"{'dense' if dense else 'hash'} step, lanes 0-{k - 1} at {x} against {y}: pose per frame " + \
                   ", ".join(f"{d:.3e}" for d in diff)
            if not dense:
                same = [all(a == b for a, b in zip(sx[:k], sy[:k])) for sx, sy in zip(runs[x][1], runs[y][1])]
                line += f"; block and visible sets equal per frame {same}"
            print(line)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = ap.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        print("batch_size_probe: no CUDA device (pass --cpu for the CPU)", file=sys.stderr)
        return 1
    dev = torch.device("cpu" if args.cpu else "cuda")
    if not args.cpu:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip())
    op_lines(dev)
    step_lines(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
