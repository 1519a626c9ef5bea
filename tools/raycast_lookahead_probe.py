#!/usr/bin/env python3
"""Time kernels K3h and K3d on the card beside the lock-step design they
replaced, at chip_smoke.py's main-path shapes, at B = 1 and B = 2 lanes.

    python tools/raycast_lookahead_probe.py [--reps N] [--out FILE]

The inputs are chip_smoke.py's: K3h over the 5 mm volume after 3 frames of
`5mm_hashprobe` (the reference settings read through the hash table) on the
main path's ranges, K3d over the 512³ array after 3 frames of `dense_5mm`
over the frustum's range, each from the last pose, at 640×480. The main
path's design is K3h at LA 1 with a hash level in one round trip and K3d at
LA 2 (reads in flight a ray); the lock-step design is LA 1 and, for K3h,
the serial walk of a hash level (csrc/raycast.cu). In the order lock-step,
main, lock-step, it prints for each design whether its points equal the
lock-step design's (which is held to the plain march first), its
registers (ptxas; None when the library was built by an earlier process),
its resident CTAs per SM and the waves of a frame's tiles, and its device
time warm and cold (chip_smoke.py's `device_ms`; cold: the L2 flushed
before each call); then both designs at B = 2 lanes (copies of the inputs,
lane 1's pose moved by 1 mm), warm. It prints the card's name and power
limit first and, last, a JSON object of the results (also written to
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


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50, help="calls in each profiler window")
    ap.add_argument("--out", type=Path, default=None, help="also write the JSON result here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("raycast_lookahead_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    cs = load_smoke()
    smoke = cs.Smoke()
    card = cs.card_line()
    print(card)
    k = smoke.k_ray
    smoke.build.library()
    regs = cs.raycast_registers(smoke.build.ptxas_report)
    depths, rgbs, _gt = smoke.frames()
    frames = (depths[:cs.N_CHECK_FRAMES + 1], rgbs[:cs.N_CHECK_FRAMES + 1])
    IMG = cs.IMG
    tiles = ((IMG[1] + 15) // 16) * ((IMG[0] + 7) // 8)

    sh = cs.hashprobe_settings(smoke.cfg)
    vol, rs, st, _view = smoke.fused(sh, frames)
    sp = sh.scene
    zmin, zmax, _ = smoke.hp.expected_depth_ranges(vol, rs, st.pose, smoke.proj, IMG, sh)
    hargs = (vol, sh.hashing, smoke.se3.invert(st.pose), smoke.proj, IMG, 1.0 / sp.voxel_size, sp.mu, zmin, zmax)
    sd = cs.dense_settings(smoke.cfg)
    dvol, dst, _p, _d = smoke.run_dense(sd, frames)
    del _p, _d
    sdd = sd.scene
    zf = torch.full(IMG, sdd.view_frustum_min, device=smoke.dev)
    zF = torch.full(IMG, sdd.view_frustum_max, device=smoke.dev)
    dargs = (dvol, sd.plain, smoke.se3.invert(dst.pose), smoke.proj, IMG, 1.0 / sdd.voxel_size, sdd.mu, zf, zF)

    kernels = {
        "raycast_hash": (k.raycast_hash_probe, k.raycast_hash_probe_lockstep, k.raycast_hash_probe_plain, hargs),
        "raycast_dense": (k.raycast_dense, k.raycast_dense_lockstep, k.raycast_dense_plain, dargs),
    }
    result = {"card": card, "designs": []}
    ok = True
    for name, (main_fn, lock_fn, plain_fn, rargs) in kernels.items():
        plain = plain_fn(*rargs).points
        ref = lock_fn(*rargs).points
        fk, fp = ref[..., 3] > 0, plain[..., 3] > 0
        err = float((ref[..., :3] - plain[..., :3]).abs()[fp].max())
        ok &= torch.equal(fk, fp) and err <= 4e-6
        print(f"{name}: lock-step design against the plain march: hit mask equal {torch.equal(fk, fp)} "
              f"({int(fp.sum())} hits), points within {err:.3e} voxel")
        designs = (("lock-step", name + "_lockstep", lock_fn), ("main path", name, main_fn),
                   ("lock-step", name + "_lockstep", lock_fn))
        for tag, kernel, fn in designs:
            same = torch.equal(fn(*rargs).points, ref)
            ok &= same
            ctas, sms = k.occupancy(kernel)
            warm = cs.device_ms(lambda f=fn: f(*rargs), args.reps)
            cold = cs.device_ms(lambda f=fn: f(*rargs), args.reps, smoke.flush)
            r = regs.get((kernel, False))
            print(f"  {name}, {tag} design: equal to the lock-step design {same}; {r} registers, {ctas} CTAs per SM "
                  f"× {sms} SMs, {tiles / max(ctas * sms, 1):.2f} waves of {tiles} tiles; device warm "
                  f"{cs.fmt_ms(warm[0])} ({warm[1]} kernel(s), {warm[2]:g} other op(s) a call), cold "
                  f"{cs.fmt_ms(cold[0])}")
            result["designs"].append(dict(kernel=kernel, lanes=1, equal=same, registers=r, ctas_per_sm=ctas, sms=sms,
                                          warm_ms=warm[0], cold_ms=cold[0]))
        # B = 2: copies of the inputs, lane 1 moved by 1 mm; the main path's
        # design through its vmap rule (one launch), the lock-step design
        # through its `lanes` argument
        pose2 = torch.stack([rargs[2]] * 2)
        pose2[1, :3, 3] += 0.001
        v = rargs[0]
        field = "vox" if name == "raycast_hash" else "sdf"
        vox2 = torch.stack([getattr(v, field)] * 2)
        v2 = v._replace(**{field: vox2})
        if name == "raycast_hash":
            v2 = v2._replace(entry_pos=torch.stack([v.entry_pos] * 2), entry_ptr=torch.stack([v.entry_ptr] * 2),
                             entry_offset=torch.stack([v.entry_offset] * 2))
        lane_args = (v2, rargs[1], pose2, *rargs[3:7], torch.stack([rargs[7]] * 2), torch.stack([rargs[8]] * 2))

        def one(vx, m, o, fn=main_fn, v=v, field=field, rargs=rargs):
            return fn(v._replace(**{field: vx}), rargs[1], m, *rargs[3:], out=o).points

        outs = {}
        for tag, kernel, fn in designs:
            out = torch.empty((2, *IMG, 4), device=smoke.dev)
            if fn is main_fn:
                def call(o=out):
                    return torch.vmap(one)(vox2, pose2, o)
            else:
                def call(o=out, f=fn):
                    return f(*lane_args, out=o, lanes=2)
            call()
            outs.setdefault(tag, out)
            same = torch.equal(out, outs["lock-step"]) and torch.equal(out[0], ref)
            ok &= same
            ctas, _sms = k.occupancy(kernel, n_lanes=2)
            warm = cs.device_ms(call, args.reps)
            r = regs.get((kernel, True))
            print(f"  {name} at B = 2, {tag} design: lanes equal to the lock-step design's and lane 0 to B = 1 "
                  f"{same}; {r} registers, {ctas} CTAs per SM; device warm {cs.fmt_ms(warm[0])}")
            result["designs"].append(dict(kernel=kernel, lanes=2, equal=same, registers=r, ctas_per_sm=ctas,
                                          warm_ms=warm[0]))
        del v2, vox2, lane_args, outs
    result["ok"] = bool(ok)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result) + "\n")
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
