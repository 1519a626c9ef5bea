"""Readings for the limits of `correct`, many seeds in one process.

    python3 -m perfbench.calibrate --workload <cell> --seeds 1,2,3 --mode program|control

`program`: set-up once, then for each seed the cell's inputs made anew (its
kind's `frames`) and one pass of the program from a fresh map (its graph
captured in set-up, so no capture here), judged as a run judges its last
pass. `control`: for each seed the reference itself in bfloat16, run on its
own in the program's place over each lane's depth frames
(perfbench/compare.py free_run), judged the same way. Prints one JSON line
a seed: the compared numbers. Not run by the benchmark's runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from perfbench import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", choices=("program", "control"), required=True)
    args = ap.parse_args(argv)
    run.point_caches()
    import numpy as np
    import torch

    from perfbench import compare, registry

    bench = registry.load_benchmark()
    cell = registry.cell(bench, args.workload)
    cfg = registry.config(bench, cell["config"])
    tr = registry.traffic(cell["traffic"])
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    lanes, n = tr["lanes"], tr["frames"]
    img, proj = tuple(tr["image"]), tr["intrinsics"]
    kind = registry.kind(cfg["kind"])
    system = None
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        gt, inputs = kind.frames(tr, seed, dev)
        if args.mode == "program":
            if system is None:
                system = kind.System(cfg, tr, dev)
                system.run_pass(inputs)
            rec = system.new_record(n)
            system.run_pass(inputs, rec)
            outputs = system.outputs()
            poses = rec["poses"][None].cpu().numpy()
            counters = rec["counters"][None].cpu().numpy() if kind.COUNTERS else None
        else:
            outputs, plist = [], []
            for b in range(lanes):
                p, vmap, maps = compare.free_run(cfg, inputs[b], img, proj, dev, torch.bfloat16)
                outputs.append((vmap, maps))
                plist.append(p)
            poses = np.stack(plist, 1)[None]
            counters = None
        nums, failed = kind.judge(cfg, inputs, gt, poses, outputs, counters, img, proj, dev)
        print(json.dumps({"seed": seed, "mode": args.mode, "failed": failed, "seconds": time.perf_counter() - t}
                         | nums), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
