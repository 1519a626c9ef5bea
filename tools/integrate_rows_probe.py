#!/usr/bin/env python3
"""Time kernel K2 (TSDF integration, depth half) of one checkout of the
PyTorch port on the 5 mm volume, on several visible lists, to separate what
the empty rows of the list cost from what the live rows cost.

    python tools/integrate_rows_probe.py [--repo DIR] [--out FILE]

The volume is chip_smoke.py's: the reference settings (5 mm, 16,384 fused
rows), 3 synthetic 640×480 frames fused on the card, the 4th frame's depth
fused by the timed calls. The lists:

- `full`: the capped visible list, as integrate_into_scene passes it;
- `live_prefix`: the same list cut after its last live row;
- `all_empty`: as many rows as `full`, every one −1;
- `half_live`, `quarter_live`: the first half and quarter of the live prefix.

Then K2 with its colour half (K2c) on chip_smoke.py's 1 cm RGB volume, the
next frame fused with the calibration's extrinsic.

`--repo` names the checkout whose `infinitam_tpu_torch` is imported (default:
this one), so that two checkouts can be timed in one run on one card;
the frames, settings and timers come from this checkout's chip_smoke.py. A
checkout whose K2 takes VBA rows and block coordinates (`ptrs`, `bpos`) is
given the rows `hash_pipeline._visible_rows` computes from the same list.
It prints what `nvcc -Xptxas -v` reports for the checkout's
csrc/integrate.cu, then per list the rows, the live rows, the device time
warm (50 calls in a torch.profiler window) and cold (the L2 flushed before
each call) and whether the kernel's voxels equal the plain version's word
for word; the last line is a JSON object of the same, also written to
--out. Needs an NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]


def ptxas_report(repo: Path) -> str:
    """What ptxas says of the checkout's integrate.cu, compiled alone."""
    from infinitam_tpu_torch.ops.kernels import build

    out = repo / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    src = repo / "infinitam_tpu_torch" / "csrc" / "integrate.cu"
    cmd = [build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
           "-Xptxas", "-v", "-c", "-o", str(out / "integrate.o"), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return "\n".join(l for l in (res.stdout + res.stderr).splitlines() if "ptxas" in l or "spill" in l)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", type=Path, default=HERE, help="checkout whose infinitam_tpu_torch is timed")
    ap.add_argument("--out", type=Path, default=None, help="also write the JSON result here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("integrate_rows_probe: no CUDA device", file=sys.stderr)
        return 1
    repo = args.repo.resolve()
    sys.path.insert(0, str(repo))
    # this checkout's chip_smoke.py, by path: the other checkout has its own
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    smoke = cs.Smoke()
    from infinitam_tpu_torch.ops.kernels import integrate

    print(cs.card_line())
    ptxas = ptxas_report(repo)
    print(ptxas)
    settings = cs.reference_settings(smoke.cfg)
    depths, rgbs, _gt = smoke.frames()
    vol, rs, st, view = smoke.fused(settings, (depths, rgbs))
    sp = settings.scene
    ids = rs.visible_ids[: settings.max_fused_blocks or None].contiguous()
    V = ids.numel()
    ptr = vol.entry_ptr[ids.clamp(min=0).long()]
    live = (ids >= 0) & (ptr >= 0)
    n_prefix = int(torch.nonzero(live).max()) + 1
    lists = {"full": ids, "live_prefix": ids[:n_prefix].contiguous(), "all_empty": torch.full_like(ids, -1),
             "half_live": ids[: n_prefix // 2].contiguous(), "quarter_live": ids[: n_prefix // 4].contiguous()}
    enable = torch.ones((), dtype=torch.bool, device=smoke.dev)
    new_interface = "visible_ids" in inspect.signature(integrate.integrate_depth).parameters
    result = {"repo": str(repo), "card": cs.card_line(), "interface": "visible list" if new_interface else "rows",
              "ptxas": ptxas, "cases": {}}
    for name, lst in lists.items():
        if new_interface:
            kargs = (lst, vol.entry_ptr, vol.entry_pos, view.depth, st.pose, smoke.proj, enable, sp.voxel_size,
                     sp.mu, sp.max_w, sp.stop_integrating_at_max_w, 8, 0)
        else:
            rows = rs._replace(visible_ids=lst)
            _i, p, bpos, valid = smoke.hp._visible_rows(vol, rows, settings, 0)
            kargs = (torch.where(valid, p, -1).contiguous(), bpos.contiguous(), view.depth, st.pose, smoke.proj,
                     enable, sp.voxel_size, sp.mu, sp.max_w, sp.stop_integrating_at_max_w, 8)
        vk, vp = vol.vox.clone(), vol.vox.clone()
        integrate.integrate_depth(vk, *kargs)
        integrate.integrate_depth_plain(vp, *kargs)
        equal = bool(torch.equal(vk, vp))
        warm, per_call, others = cs.device_ms(lambda: integrate.integrate_depth(vk, *kargs), 50)
        cold, _n, _o = cs.device_ms(lambda: integrate.integrate_depth(vk, *kargs), 50, flush=smoke.flush)
        n_live = int(live[: lst.numel()].sum()) if name != "all_empty" else 0
        case = dict(rows=lst.numel(), live=n_live, warm_ms=warm, cold_ms=cold, kernels=per_call,
                    other_ops=others, equal_to_plain=equal)
        result["cases"][name] = case
        print(f"K2 5 mm, {name}: {lst.numel()} rows, {n_live} live; device warm {cs.fmt_ms(warm)}, cold "
              f"{cs.fmt_ms(cold)} ({per_call} kernel(s), {others:g} other device op(s) a call); "
              f"{'equal to' if equal else 'DIFFERS from'} plain")
    # K2c: the 1 cm RGB volume, the next frame fused with the calibration's extrinsic
    s1 = cs.color_settings(smoke.cfg)
    vol, rs, st, view = smoke.fused(s1, (depths, rgbs))
    sp = s1.scene
    M_rgb = (smoke.se3.invert(smoke.rgb_to_depth) @ st.pose).contiguous()
    if new_interface:
        cargs = (rs.visible_ids, vol.entry_ptr, vol.entry_pos, view.depth, view.rgb, st.pose, smoke.proj, M_rgb,
                 smoke.proj_rgb, enable, sp.voxel_size, sp.mu, sp.max_w, sp.stop_integrating_at_max_w, 8,
                 s1.max_fused_blocks)
    else:
        _i, p, bpos, valid = smoke.hp._visible_rows(vol, rs, s1, s1.max_fused_blocks)
        cargs = (torch.where(valid, p, -1).contiguous(), bpos.contiguous(), view.depth, view.rgb, st.pose,
                 smoke.proj, M_rgb, smoke.proj_rgb, enable, sp.voxel_size, sp.mu, sp.max_w,
                 sp.stop_integrating_at_max_w, 8)
    k = (vol.vox.clone(), vol.vox_rgb.clone())
    pl = (vol.vox.clone(), vol.vox_rgb.clone())
    integrate.integrate_rgbd(*k, *cargs)
    integrate.integrate_rgbd_plain(*pl, *cargs)
    equal = bool(torch.equal(k[0], pl[0]) and torch.equal(k[1], pl[1]))
    warm, per_call, others = cs.device_ms(lambda: integrate.integrate_rgbd(*k, *cargs), 50)
    cold, _n, _o = cs.device_ms(lambda: integrate.integrate_rgbd(*k, *cargs), 50, flush=smoke.flush)
    result["cases"]["color_1cm"] = dict(warm_ms=warm, cold_ms=cold, kernels=per_call, other_ops=others,
                                        equal_to_plain=equal)
    print(f"K2c 1 cm: device warm {cs.fmt_ms(warm)}, cold {cs.fmt_ms(cold)} ({per_call} kernel(s), {others:g} "
          f"other device op(s) a call); {'equal to' if equal else 'DIFFERS from'} plain")
    line = json.dumps(result)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0 if all(c["equal_to_plain"] for c in result["cases"].values()) and V > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
