"""Start the ranks of a mesh (parallel/batch.py) and replay a fleet on them.

`spawn(fn, n_ranks, args)` starts n processes with the spawn start method
(each a fresh interpreter that imports only what `fn`'s module needs), sets
in each the environment torchrun would (RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE, MASTER_ADDR 127.0.0.1 and a free MASTER_PORT), runs
`fn(*args)` there and returns each rank's result, in rank order. A rank
that raises, dies or outlives `timeout` fails the call, and every rank
still running is killed: there is no fallback. The same `fn` runs under
`torchrun --nproc-per-node=N`, which sets the same variables.

`replay` is such an `fn`: one rank's part of a fleet replay through the
sharded batched step.

Build the CUDA kernels once before the ranks start (the kernel library's
build holds a file lock, so ranks that start together wait for one build
instead of each running nvcc).
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import socket
import time
import traceback
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from infinitam_tpu_torch import convert
from infinitam_tpu_torch.config import Settings
from infinitam_tpu_torch.engine import hash_volume as hv
from infinitam_tpu_torch.engine import volume as vol_mod
from infinitam_tpu_torch.engine.tracking_state import TrackingState
from infinitam_tpu_torch.engine.view_builder import View
from infinitam_tpu_torch.ops.kernels import build
from infinitam_tpu_torch.parallel import batch


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, n_ranks: int, port: int, args: tuple, results) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n_ranks), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(n_ranks), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    try:
        results.put((rank, True, fn(*args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, n_ranks: int, args: tuple = (), timeout: float = 600.0) -> list:
    """`fn(*args)` on `n_ranks` spawned processes; their results in rank
    order. `fn` and `args` are pickled (a function by its import path), and
    so is each result. Raises RuntimeError when a rank raises or dies, and
    TimeoutError after `timeout` seconds; either way every rank still
    running is killed first."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, n_ranks, port, args, results), daemon=True)
             for r in range(n_ranks)]
    deadline = time.monotonic() + timeout
    out: dict = {}
    try:
        for p in procs:
            p.start()
        while len(out) < n_ranks:  # drain the queue before joining (a full pipe blocks its writer)
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{n_ranks} ranks of {fn.__name__}: {sorted(out)} done after {timeout} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} of {fn.__name__} died without a result (exit codes "
                                       f"{[procs[r].exitcode for r in dead]})")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {fn.__name__} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        codes = [p.exitcode for p in procs]
        if codes != [0] * n_ranks:
            raise RuntimeError(f"ranks of {fn.__name__} exited with {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
    return [out[r] for r in range(n_ranks)]


def replay(settings: Settings, depths: np.ndarray, proj: np.ndarray, dense: bool = False,
           state: Optional[tuple] = None, device: Optional[str] = None, share_card: bool = False) -> dict:
    """One rank's part of a fleet replay: the mesh of this process (from the
    environment; `device` and `share_card` as in make_mesh), this rank's
    lanes of `depths` [steps, B, H, W] and of `state` (the fleet's [B]
    state as `convert.to_numpy` dicts: (volume, render state, tracking
    state), or (dense volume, tracking state) with `dense`; None for fresh
    maps), then the sharded batched step over the steps with `proj` [4]
    shared. Returns `device` (this rank's) and numpy: `lanes` (first, end),
    `poses` [steps, b, 4, 4], the fleet metrics a step (`mean_f`,
    `mean_valid` and, on the hash volume, `total_visible`), on the hash
    volume `n_visible` [steps, b], `launches` (the kernel launches of the
    steps, all 0 on the CPU) and `state`, the final local state as
    `convert.to_numpy` dicts."""
    mesh = batch.make_mesh(device=device, share_card=share_card)
    B = depths.shape[1]
    lanes = mesh.lane_range(B)
    kinds = (vol_mod.DenseVolume, TrackingState) if dense else (hv.HashVolume, hv.RenderStateVH, TrackingState)
    if state is None:
        fresh = batch.batched_state_dense if dense else batch.batched_state_hash
        state = fresh(settings, depths.shape[2:], B, mesh=mesh)
    else:
        state = batch.shard_batch(tuple(convert.from_numpy(k, s, device="cpu") for k, s in zip(kinds, state)), mesh)
    step = (batch.make_batched_step_dense if dense else batch.make_batched_step)(settings, mesh)
    frames = torch.from_numpy(np.ascontiguousarray(depths[:, lanes.start:lanes.stop])).to(mesh.device)
    proj = torch.as_tensor(proj, device=mesh.device)
    keys = ("mean_f", "mean_valid") if dense else ("mean_f", "mean_valid", "total_visible")
    poses, n_visible, metrics = [], [], {k: [] for k in keys}
    build.reset_launch_counts()
    for depth in frames:
        *state, m = step(*state, View(depth=depth), proj)
        poses.append(state[-1].pose.clone())
        if not dense:
            n_visible.append(m["diag"].n_visible)
        for k in keys:
            metrics[k].append(m[k])
    out = {"device": str(mesh.device), "lanes": (lanes.start, lanes.stop), "launches": build.launch_counts(),
           "poses": torch.stack(poses).cpu().numpy(), "state": tuple(convert.to_numpy(s) for s in state)}
    out.update({k: torch.stack(v).cpu().numpy() for k, v in metrics.items()})
    if not dense:
        out["n_visible"] = torch.stack(n_visible).cpu().numpy()
    return out
