"""The system under test: the port's frame steps, driven pass by pass.

This is the only file of the benchmark that imports the program
(`infinitam_tpu_torch`). It builds the port's Settings from a configuration
file, makes the live state and a fresh copy of it, and runs one pass of the
cell's traffic through the captured frame step of the configuration's kind:

- hash, one lane: hash_pipeline.process_frame_hash, a graph replay a frame;
- dense, one lane: dense_pipeline.process_frame_dense;
- hash or dense, B lanes: parallel/batch.py make_batched_step(_dense), one
  graph replay a step for all lanes.

Every pass starts from a fresh map, written into the live state's tensors
(`captured.refill`: a graph's key holds their addresses), and records each
frame's pose and the five silent-cap counters on the device. The host clock
around each step call (its input copies, the replay and the output
copy-out) is kept as the step's issue time.
"""

from __future__ import annotations

import collections
import time

import torch

from infinitam_tpu_torch import config as itpu_config
from infinitam_tpu_torch.engine import captured
from infinitam_tpu_torch.engine import dense_pipeline as dp
from infinitam_tpu_torch.engine import hash_pipeline as hp
from infinitam_tpu_torch.engine.view_builder import View
from infinitam_tpu_torch.ops.kernels import build
from infinitam_tpu_torch.parallel import batch
from perfbench.reference import pack_keys

COUNTERS = ("n_alloc_overflow", "n_render_overflow", "n_pool_overflow", "n_too_big_blocks", "n_window_clipped")
# steps queued on the card ahead of the one running: enough that the card
# never waits for the host, few enough that a step's call never waits for
# room in the launch queue (a frame's graph holds ~6,000 kernels)
IN_FLIGHT = 2
KERNELS = {"icp": "itpu_icp_kernel", "integrate": "itpu_integrate_kernel", "raycast": "itpu_raycast_kernel"}


def settings_of(cfg: dict) -> itpu_config.Settings:
    """The port's Settings from a configuration file's `settings` group."""
    s = cfg["settings"]

    def group(cls, d):
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})

    top = {k: v for k, v in s.items() if not isinstance(v, dict)}
    return itpu_config.Settings(
        scene=group(itpu_config.SceneParams, s["scene"]),
        hashing=group(itpu_config.VoxelBlockHashParams, s["hashing"]),
        plain=group(itpu_config.PlainVoxelArrayParams, s["plain"]),
        block_grid=group(itpu_config.BlockGridParams, s["block_grid"]),
        tracking=group(itpu_config.TrackingParams, s["tracking"]),
        **top,
    )


class System:
    """One cell's program: its settings, live and fresh state, and step."""

    def __init__(self, cfg: dict, lanes: int, img_size, proj, device):
        self.kind = cfg["kind"]
        self.settings = settings_of(cfg)
        self.lanes = lanes
        self.img = tuple(img_size)
        self.dev = torch.device(device)
        self.proj = torch.tensor(proj, dtype=torch.float32, device=self.dev)
        self._in_flight = collections.deque()
        self.state = self._fresh()
        self.fresh = self._fresh()
        if lanes > 1:
            make = batch.make_batched_step if self.kind == "hash" else batch.make_batched_step_dense
            self._batched = make(self.settings)

    def _fresh(self):
        if self.lanes > 1:
            if self.kind == "hash":
                return batch.batched_state_hash(self.settings, self.img, self.lanes, device=self.dev)
            return batch.batched_state_dense(self.settings, self.img, self.lanes, device=self.dev)
        if self.kind == "hash":
            return hp.create_engine_state(self.settings, self.img, device=self.dev)
        return dp.create_engine_state(self.settings, self.img, device=self.dev)

    def step(self, depth):
        """One frame (a [B, H, W] step for B lanes) → (pose [B, 4, 4],
        counters [B, 5] int32 or None for the dense array)."""
        view = View(depth=depth)
        if self.lanes > 1:
            *state, metrics = self._batched(*self.state, view, self.proj)
            self.state = tuple(state)
            diag = metrics["diag"]
        elif self.kind == "hash":
            vol, rs, st, diag = hp.process_frame_hash(*self.state, view, self.proj, self.settings)
            self.state = (vol, rs, st)
        else:
            vol, st, diag = dp.process_frame_dense(*self.state, view, self.proj, self.settings)
            self.state = (vol, st)
        pose = self.state[-1].pose
        if self.kind != "hash":
            return pose.reshape(-1, 4, 4), None
        counters = torch.stack([getattr(diag, k).to(torch.int32).reshape(-1) for k in COUNTERS], -1)
        return pose.reshape(-1, 4, 4), counters

    def run_pass(self, depths, record=None):
        """One pass of the sequence from a fresh map: depths [B, N, H, W].
        Returns the host seconds each step's call took. With `record`, a
        dict, its "poses" [N, B, 4, 4] and "counters" [N, B, 5] are written
        on the device."""
        captured.refill(self.state, self.fresh)
        n = depths.shape[1]
        issue = []
        for i in range(n):
            d = depths[:, i] if self.lanes > 1 else depths[0, i]
            t0 = time.perf_counter()
            pose, counters = self.step(d)
            issue.append(time.perf_counter() - t0)
            if record is not None:
                record["poses"][i].copy_(pose)
                if counters is not None:
                    record["counters"][i].copy_(counters)
            if self.dev.type == "cuda":
                self._in_flight.append(torch.cuda.Event())
                self._in_flight[-1].record()
                if len(self._in_flight) > IN_FLIGHT:
                    self._in_flight.popleft().synchronize()
        return issue

    def new_record(self, n_frames: int) -> dict:
        return {"poses": torch.empty((n_frames, self.lanes, 4, 4), dtype=torch.float32, device=self.dev),
                "counters": torch.zeros((n_frames, self.lanes, len(COUNTERS)), dtype=torch.int32, device=self.dev)}

    def graphs(self) -> list:
        """(name, capture seconds) of every live graph: a capture shows as a
        new entry."""
        return [(g["name"], g["capture_s"]) for g in captured.graphs()]

    def launches_per_replay(self) -> float:
        """Hand-kernel launches that one replay of the step's graph makes,
        read from the graph's own kernel nodes."""
        return float(sum(sum(g["launches"].values()) for g in captured.graphs()))

    def build_seconds(self) -> float:
        return build.last_build_seconds

    def outputs(self) -> list:
        """Each lane's map and last maps as the comparison reads them:
        hash: (sorted block keys, sdf int16 values, weights) of the resident
        blocks; dense: (sdf, w) of the array; with (points, normals)
        [H, W, 4] of the last raycast. Copies, so the program's state can go."""
        out = []
        for b in range(self.lanes):
            lane = self.state
            if self.lanes > 1:
                lane = [type(x)(*(None if f is None else f[b] for f in x)) for x in self.state]
            st = lane[-1]
            maps = (st.points_map.clone(), st.normals_map.clone())
            if self.kind == "hash":
                vol = lane[0]
                live = vol.entry_ptr >= 0
                pos = vol.entry_pos[live].long()
                rows = vol.entry_ptr[live].long()
                keys = pack_keys(pos[:, 0], pos[:, 1], pos[:, 2])
                order = torch.argsort(keys)
                vox = vol.vox[rows[order]]
                out.append(((keys[order], (vox >> 16).to(torch.int32), ((vox >> 8) & 0xFF).to(torch.int32)), maps))
            else:
                vol = lane[0]
                out.append(((vol.sdf.clone(), vol.w_depth.clone()), maps))
        return out

    def close(self) -> None:
        """Free the program's state and its graphs."""
        self.state = self.fresh = None
        self._batched = None
        captured.clear()
        torch.cuda.empty_cache()
