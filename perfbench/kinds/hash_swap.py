"""The voxel-block hash with InfiniTAM's host swap tier (`useSwapping`): a
configuration of kind `hash_swap`.

One lane steps through hash_pipeline.step_frame_swap, with the exchange's
host half (swapping.SwapExchange.after_frame) after each step, as
MainEngine runs them, once the harness has kept its queue of steps on the
card (perfbench/system.py IN_FLIGHT); a step's issue seconds hold both. A
pass starts from a fresh map, fresh swap states, an emptied host store and
exchange (reset in place: the 1.81 GB store is made once) and ends as a
user's session ends (MainEngine.flush_swap: swapping.end_session, the
exchange flushed and one full-scan eviction). Each frame records the hash
kind's five silent-cap counters and the swap step's four
(hash_pipeline.SWAP_COUNTERS). The first pass (set-up: every graph
captured) ends with a full collection of Python's cyclic collector and
gc.freeze(), so that no later full collection walks the objects set-up
left (the first pass's two took 102 and 143 ms on the H100's host, 5-7%
of a 2.06 s pass). Without it, 2 of 12 windows' first passes ran 3.0-3.7%
slower than the rest; with it, none of 12 ran more than 0.5% slower. A
process without it showed no full collection after its first pass, so
the cause of those two is not established.

The map as the comparison reads it (`outputs`, after the window, outside
the timed passes): the read-back first completes the drain, as the
reference's synchronous tier leaves its map (`complete`: every entry still
to be merged with the store merged, every invisible device-newest block
evicted, n_transfer_blocks a call), then takes the resident blocks and the
stored blocks that are not resident, by block coordinate, as the hash
kind's sorted keys, int16 sdf values and weights. Judged against
perfbench/reference_swap.py, the hash reference with upstream's
synchronous swap tier: the compared numbers of perfbench/compare.py, the
gates (the hash five at 0), and

- swap_lost_blocks: blocks of the reference's map that the drained program
  holds neither resident nor stored, from the two maps alone. Its limit
  lies between the program's readings (a block whose corner the two
  sides' ray bands tie on, as in the hash cell) and the control's;
- swap_backlog_drained: what the completion left (`pending`: the eviction
  backlog and every entry still to be merged or in flight), where a
  synchronous call stops making progress.

The traffic's camera pans away from part of the scene and back
(`yaw_knots_deg`: the yaw in degrees at frame i is the knots' line at i),
on the path and through the scene of perfbench/scene.py, the path's y
turn replaced by the pan. At the ends of the pan the view reaches past
the block grid's edge, where the allocator's out-of-grid path
(hash_pipeline.oog_cap) takes the back wall's blocks.

The control readings for the limits (the reference in bfloat16 in the
program's place; perfbench/calibrate.py's control runs the hash reference
only, and its `--mode program` runs this kind as it is):

    python3 -m perfbench.kinds.hash_swap --workload hash5mm.swap --seeds 1,2,3
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time

import numpy as np
import torch

from infinitam_tpu_torch.config import SwappingMode
from infinitam_tpu_torch.engine import captured
from infinitam_tpu_torch.engine import hash_pipeline as hp
from infinitam_tpu_torch.engine import hash_volume as hv
from infinitam_tpu_torch.engine import swapping as sw
from infinitam_tpu_torch.engine.view_builder import View
from perfbench import compare, reference_swap, scene
from perfbench.kinds import hash as hash_kind
from perfbench.reference import pack_keys

KERNELS = hash_kind.KERNELS
COUNTERS = hash_kind.COUNTERS + hp.SWAP_COUNTERS


def yaw_path_deg(knots, n_frames: int) -> np.ndarray:
    """The pan's yaw in degrees at each frame: the knots' ([frame, degrees])
    piecewise line."""
    f, deg = zip(*knots)
    return np.interp(np.arange(n_frames), f, deg)


def trajectory(n_frames: int, seed: int, yaw_deg) -> np.ndarray:
    """World→camera poses [N, 4, 4] float32: scene.trajectory's seeded
    translation and x and z turn, with its y turn replaced by the pan."""
    amp, signs = scene.seed_shape(seed)
    poses = []
    for i in range(n_frames):
        s = i * 0.01
        t = np.array([0.25 * math.sin(2 * math.pi * s), signs[0] * 0.12 * math.sin(4 * math.pi * s), 0.18 * s])
        w = np.array([0.10 * math.sin(2 * math.pi * s) * amp[3], math.radians(yaw_deg[i]),
                      signs[1] * 0.06 * math.sin(2 * math.pi * s) * amp[5]])
        poses.append(scene._se3_exp(t * amp[:3], w))
    return np.stack(poses).astype(np.float32)


def frames(traffic: dict, seed: int, dev):
    """The pan's true poses [1, N, 4, 4] (numpy) and its depth frames [1, N,
    H, W] rendered on `dev`."""
    n = traffic["frames"]
    if traffic["lanes"] != 1 or traffic["yaw_knots_deg"][-1][0] != n:
        raise ValueError("a swap traffic mix is one lane whose last yaw knot is at its frame count")
    gt = trajectory(n, seed, yaw_path_deg(traffic["yaw_knots_deg"], n))[None]
    depths = scene.render_depths(torch.as_tensor(gt[0], device=dev), traffic["intrinsics"], tuple(traffic["image"]))
    return gt, depths[None]


def pending(vol, swap_states, visible_type) -> int:
    """What a drain leaves undone, read to the host: the eviction backlog
    and every entry still to be merged with the store or in flight (state
    1 or 3, visible or not)."""
    return int(sw.eviction_backlog(vol, swap_states, visible_type)) + int(((swap_states == 1)
                                                                             | (swap_states == sw.SWAP_IN_FLIGHT)).sum())


class System(hash_kind.System):
    """The swap step's program: the hash state and its swap states, the host
    store and the exchange. `passes` keeps, for each pass, what the
    exchange's host halves did in it (blocks evicted into the store,
    needed-list entries resolved, of them merged with stored data, and the
    waits on copies that had not landed), the end of the session left out."""

    COUNTERS = COUNTERS

    def __init__(self, cfg: dict, traffic: dict, device):
        if not cfg.get("use_swapping") or traffic["lanes"] != 1:
            raise ValueError("a hash_swap configuration has use_swapping true and runs one lane")
        super().__init__(cfg, traffic, device)
        self.cache = sw.GlobalCache.create(self.settings)
        self.exchange = sw.SwapExchange(self.settings, False, device=self.dev)
        self.passes: list = []

    def fresh_state(self):
        """(vol, render state, tracking state, swap states) of a fresh map,
        under the configuration's settings with the swap tier on."""
        self.settings = self.settings.replace(swapping_mode=SwappingMode.ENABLED)
        return (*hp.create_engine_state(self.settings, self.img, device=self.dev),
                sw.create_swap_states(self.settings, device=self.dev))

    def reset(self) -> None:
        super().reset()
        self.cache.reset()
        self.exchange.reset()

    def step(self, depth):
        """The frame step, its exchange outputs kept for after_frame."""
        flips, slab = self.exchange.merge_args()
        *state, diag, in_meta, pack = hp.step_frame_swap(*self.state, View(depth=depth), self.proj, self.settings,
                                                         merge_flips=flips, merge_slab=slab)
        self.state = tuple(state)
        self._exchange_out = (in_meta, pack)
        pose = self.state[2].pose.reshape(-1, 4, 4)
        return pose, torch.stack([getattr(diag, k).to(torch.int32).reshape(-1) for k in self.COUNTERS], -1)

    def frame(self, depths, i: int, record=None) -> float:
        """Step frame i (system.System.frame, which keeps at most IN_FLIGHT
        steps queued on the card), then the exchange's host half. Its
        seconds count with the step's: the host's own work a frame, with
        no wait for the card in it but the exchange's own (`n_waits`)."""
        issue = super().frame(depths, i, record)
        t0 = time.perf_counter()
        self.exchange.after_frame(*self._exchange_out, self.cache)
        issue += time.perf_counter() - t0
        self._exchange_out = None
        for k, v in self.exchange.frame_counts.items():
            self._counts[k] += v
        return issue

    def run_pass(self, depths, record=None):
        """One pass from a fresh map, ended as a session ends (module docstring).
        Returns the host seconds of each step's call and its after_frame."""
        self.reset()
        self._counts = dict.fromkeys(self.exchange.frame_counts, 0)
        issue = [self.frame(depths, i, record) for i in range(depths.shape[1])]
        self.passes.append(self._counts)
        vol, rs, st, states = self.state
        vol, states = sw.end_session(self.exchange, vol, states, rs, self.cache, self.settings)
        captured.copy_back(self.state, (vol, rs, st, states))
        if len(self.passes) == 1:
            gc.collect()
            gc.freeze()
        return issue

    def complete(self) -> int:
        """The drain's completion (module docstring): swap_in while entries
        wait for the store (the frame lists only visible ones, the reference
        every one), then swap_out while invisible device-newest blocks stay,
        each until a call leaves no fewer. Returns `pending` after it."""
        vol, rs, st, states = self.state
        for call, left in ((lambda v, s: sw.swap_in(v, s, self.cache, self.settings),
                            lambda v, s: int((s == 1).sum())),
                           (lambda v, s: sw.swap_out(v, s, rs, self.cache, self.settings),
                            lambda v, s: int(sw.eviction_backlog(v, s, rs.visible_type)))):
            n = left(vol, states)
            while n:
                vol, states = call(vol, states)
                n, before = left(vol, states), n
                if n >= before:
                    break
        captured.copy_back(self.state, (vol, rs, st, states))
        return pending(vol, states, rs.visible_type)

    def outputs(self) -> list:
        """[(the drained map, (points, normals) of the last raycast, {"backlog":
        what the completion left})]."""
        backlog = self.complete()
        vol, rs, st, states = self.state

        def keys_of(mask):
            pos = vol.entry_pos[mask].long()
            return pack_keys(pos[:, 0], pos[:, 1], pos[:, 2])

        resident = vol.entry_ptr >= 0
        stored = (vol.entry_ptr == hv.SWAPPED_PTR) & torch.from_numpy(self.cache.has_stored).to(self.dev)
        keys = torch.cat([keys_of(resident), keys_of(stored)])
        vox = vol.vox[vol.entry_ptr[resident].long()]
        ids = torch.nonzero(stored)[:, 0].cpu().numpy()
        q = torch.cat([(vox >> 16).to(torch.int32),
                       torch.from_numpy(self.cache.stored_sdf[ids].astype(np.int32)).to(self.dev)])
        w = torch.cat([((vox >> 8) & 0xFF).to(torch.int32),
                       torch.from_numpy(self.cache.stored_w[ids].astype(np.int32)).to(self.dev)])
        order = torch.argsort(keys)
        return [((keys[order], q[order], w[order]), (st.points_map.clone(), st.normals_map.clone()), {"backlog": backlog})]

    def close(self) -> None:
        """Logs each pass's exchange counts (stderr), then frees the state."""
        if self.passes:
            last = self.passes[-1]
            print("swap_exchange " + json.dumps({"passes": len(self.passes), "last_pass": last,
                                                  "waits_all_passes": sum(p["waits"] for p in self.passes)}),
                  file=sys.stderr, flush=True)
        self.cache = self.exchange = None
        super().close()


def judge(cfg, inputs, gt, pass_poses, outputs, counters, img, proj, dev, counts=None):
    """The compared numbers (module docstring) against
    perfbench/reference_swap.py, and the frames whose pose gap failed."""
    lane_counts = None if counts is None else []
    ref_poses, ref_map, ref_maps, _ref = reference_swap.reference_lane(cfg, inputs[0], pass_poses[-1][:, 0], img,
                                                                       proj, dev, counts=lane_counts)
    if counts is not None:
        counts.append(lane_counts)
    P = pass_poses[:, :, 0].astype(np.float64)
    R = ref_poses.astype(np.float64)
    gap_t = np.nan_to_num(np.linalg.norm(compare.centre(P) - compare.centre(R), axis=-1) * 1e3, nan=math.inf)
    gap_r = np.nan_to_num(compare.rot_angle_deg(P, R), nan=math.inf)
    ate, rot = compare.trajectory_errors(pass_poses[-1][:, 0], gt[0])
    prog_map, prog_maps, drained = outputs[0]
    nums = {"pose_gap_mm": float(gap_t.max()), "pose_gap_deg": float(gap_r.max()),
            "voxel_mismatch": compare.voxel_mismatch("hash", prog_map, ref_map),
            "map_mismatch": compare.map_mismatch(prog_maps, ref_maps),
            "ate_mm": ate if math.isfinite(ate) else math.inf,
            "rot_rmse_deg": rot if math.isfinite(rot) else math.inf}
    if counters is not None:
        nums["cap_counters"] = float(counters[..., :len(hash_kind.COUNTERS)].max())
    _pos, held = reference_swap.find_keys(ref_map[0], prog_map[0])
    nums["swap_lost_blocks"] = float((~held).sum())
    nums["swap_backlog_drained"] = float(drained["backlog"])
    return nums, int((gap_t.max(axis=0) > cfg["limits"]["pose_gap_mm"]).sum())


def main(argv=None) -> int:
    """The control readings (module docstring): one JSON line a seed."""
    from perfbench import registry, run

    ap = argparse.ArgumentParser(prog="python3 -m perfbench.kinds.hash_swap")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    run.point_caches()
    bench = registry.load_benchmark()
    cell = registry.cell(bench, args.workload)
    cfg, tr = registry.config(bench, cell["config"]), registry.traffic(cell["traffic"])
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    img, proj = tuple(tr["image"]), tr["intrinsics"]
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        gt, inputs = frames(tr, seed, dev)
        poses, vmap, maps = reference_swap.free_run(cfg, inputs[0], img, proj, dev, torch.bfloat16)
        nums, failed = judge(cfg, inputs, gt, poses[:, None][None], [(vmap, maps, {"backlog": 0})], None, img, proj,
                             dev)
        print(json.dumps({"seed": seed, "mode": "control", "failed": failed, "seconds": time.perf_counter() - t}
                         | nums), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
