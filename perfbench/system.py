"""The shared driver of the port's captured frame steps, pass by pass.

With perfbench/kinds/, this is the only place of the benchmark that imports
the program (`infinitam_tpu_torch`). It builds the port's Settings from a
configuration file, makes the live state and a fresh copy of it, and runs
one pass of the cell's traffic through the captured frame step that the
configuration's kind chooses (a subclass in perfbench/kinds/<kind>.py):
one lane through the kind's `frame_step`, B lanes through its
`batched_step`, one graph replay a step for all lanes.

Every pass starts from a fresh map, written into the live state's tensors
(`captured.refill`: a graph's key holds their addresses), and records each
frame's pose and the kind's per-frame counters on the device. The host
clock around each step call (its input copies, the replay and the output
copy-out) is kept as the step's issue time.
"""

from __future__ import annotations

import collections
import time

import torch

from infinitam_tpu_torch import config as itpu_config
from infinitam_tpu_torch.engine import captured
from infinitam_tpu_torch.engine.view_builder import View
from infinitam_tpu_torch.ops.kernels import build

# steps queued on the card ahead of the one running: enough that the card
# never waits for the host, few enough that a step's call never waits for
# room in the launch queue (a frame's graph holds ~6,000 kernels)
IN_FLIGHT = 2


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
    """One cell's program: its settings, live and fresh state, and step.

    A kind's subclass gives `COUNTERS` (the frame diagnostics' fields it
    records), `fresh_state()`, `frame_step(state, view)` → (state, diag),
    `batched_step()` (the B-lane step's maker) and `lane_map(lane)`."""

    COUNTERS: tuple = ()

    def __init__(self, cfg: dict, traffic: dict, device):
        self.settings = settings_of(cfg)
        self.lanes, self.n_frames = traffic["lanes"], traffic["frames"]
        self.img = tuple(traffic["image"])
        self.dev = torch.device(device)
        self.proj = torch.tensor(traffic["intrinsics"], dtype=torch.float32, device=self.dev)
        self._in_flight = collections.deque()
        self.state = self.fresh_state()
        self.fresh = self.fresh_state()
        self._batched = self.batched_step() if self.lanes > 1 else None

    def step(self, depth):
        """One frame (a [B, H, W] step for B lanes) → (pose [B, 4, 4],
        counters [B, len(COUNTERS)] int32, or None for a kind without)."""
        view = View(depth=depth)
        if self.lanes > 1:
            *state, metrics = self._batched(*self.state, view, self.proj)
            self.state = tuple(state)
            diag = metrics["diag"]
        else:
            self.state, diag = self.frame_step(self.state, view)
        pose = self.state[-1].pose.reshape(-1, 4, 4)
        if not self.COUNTERS:
            return pose, None
        return pose, torch.stack([getattr(diag, k).to(torch.int32).reshape(-1) for k in self.COUNTERS], -1)

    def run_pass(self, depths, record=None):
        """One pass of the sequence from a fresh map: depths [B, N, H, W].
        Returns the host seconds each step's call took. With `record`, a
        dict, its "poses" [N, B, 4, 4] and "counters" [N, B, len(COUNTERS)]
        are written on the device."""
        self.reset()
        return [self.frame(depths, i, record) for i in range(depths.shape[1])]

    def reset(self) -> None:
        """The fresh map written into the live state."""
        captured.refill(self.state, self.fresh)

    def frame(self, depths, i: int, record=None) -> float:
        """Step frame i of the pass and record it; returns the step call's
        host seconds. Keeps at most IN_FLIGHT steps queued on the card."""
        d = depths[:, i] if self.lanes > 1 else depths[0, i]
        t0 = time.perf_counter()
        pose, counters = self.step(d)
        issue = time.perf_counter() - t0
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
        shape = (n_frames, self.lanes)
        return {"poses": torch.empty(shape + (4, 4), dtype=torch.float32, device=self.dev),
                "counters": torch.zeros(shape + (len(self.COUNTERS),), dtype=torch.int32, device=self.dev)}

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
        """Each lane's (map, (points, normals) [H, W, 4] of the last
        raycast): the map as the kind's `lane_map` reads it. Copies, so the
        program's state can go."""
        out = []
        for b in range(self.lanes):
            lane = self.state
            if self.lanes > 1:
                lane = [type(x)(*(None if f is None else f[b] for f in x)) for x in self.state]
            st = lane[-1]
            maps = (st.points_map.clone(), st.normals_map.clone())
            out.append((self.lane_map(lane), maps))
        return out

    def close(self) -> None:
        """Free the program's state and its graphs."""
        self.state = self.fresh = None
        self._batched = None
        captured.clear()
        torch.cuda.empty_cache()
