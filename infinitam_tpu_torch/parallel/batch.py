"""Batched multi-sequence SLAM: B independent RGB-D sequences in one step,
split over a mesh of ranks.

Counterpart of infinitam_tpu/parallel/batch.py. Every state tensor gets a
leading [B] dim and the per-frame step runs under `torch.vmap`, so each
torch op of the step does the work of all B lanes. The kernels K1, K2 and
K3 (K3d on the dense array) are custom ops whose vmap rules make ONE
lane-indexed launch for the B lanes (ops/kernels/build.py), so a batched
step launches each kernel as often as an unbatched one. Fleet metrics
(mean tracker energy and inliers, total visible blocks) reduce over the
batch.

The JAX package shards B over a `jax.sharding.Mesh` from one controller.
Here a mesh is n ranks, one process each, under `torch.distributed`: rank r
holds the contiguous lane range [r·B/n, (r+1)·B/n) on its own card, runs
the vmapped step over those lanes, and the fleet metrics are all-reduced
over the ranks (NCCL between cards, gloo on the CPU or when ranks share a
card), so every rank holds the same values, as JAX's replicated outputs.
Each rank's host issues only its own card's work. Start the ranks with
`torchrun --nproc-per-node=N` or `parallel.ranks.spawn`; `make_mesh` reads
the environment either sets. A one-rank mesh is the path without a mesh:
no process group, no collective.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from infinitam_tpu_torch.config import Settings
from infinitam_tpu_torch.engine import captured
from infinitam_tpu_torch.engine import dense_pipeline as dp
from infinitam_tpu_torch.engine import hash_pipeline as hp


class Mesh(NamedTuple):
    """n ranks over the batch's data axis, this process being `rank`, its
    lanes on `device`; `group` is the process group the fleet metrics
    reduce over (None for one rank)."""

    n: int
    rank: int
    device: torch.device
    group: Optional[object] = None

    def lane_range(self, batch: int) -> range:
        """This rank's lanes of a batch of `batch`: the contiguous range
        [rank·batch/n, (rank+1)·batch/n). The batch must split evenly, as
        JAX's sharding of the data axis requires."""
        if batch % self.n:
            raise ValueError(f"a batch of {batch} lanes does not split evenly over a mesh of {self.n} ranks")
        k = batch // self.n
        return range(self.rank * k, (self.rank + 1) * k)


def make_mesh(n_devices: Optional[int] = None, *, rank: Optional[int] = None, init_method: Optional[str] = None,
              device: torch.device | str | None = None, share_card: bool = False) -> Mesh:
    """The mesh of this process: `n_devices` ranks (None: the process
    group's size, else the environment's WORLD_SIZE, else 1), this one
    `rank` (else the group's, else RANK). A mesh of more than one rank joins
    the default process group, initialising it when needed from
    `init_method` (default "env://": MASTER_ADDR and MASTER_PORT, as
    torchrun and `ranks.spawn` set them). Its device is `device`, else card
    LOCAL_RANK (default: the rank). More ranks on this machine
    (LOCAL_WORLD_SIZE, default n) than it has cards raise, unless
    `share_card` lets them share the cards round robin. The backend is NCCL
    between cards and gloo on the CPU or on a shared card (NCCL refuses two
    ranks on one device). A one-rank mesh creates no process group."""
    env = os.environ
    if dist.is_available() and dist.is_initialized():
        n, rank = dist.get_world_size(), dist.get_rank()
        if n_devices not in (None, n):
            raise ValueError(f"a mesh of {n_devices} ranks asked for in a process group of {n}")
    else:
        n = n_devices or int(env.get("WORLD_SIZE", 1))
        if rank is None:
            if n > 1 and "RANK" not in env:
                raise ValueError(f"a mesh of {n} ranks needs one process a rank: start them with torchrun or "
                                 "parallel.ranks.spawn, or pass rank and init_method")
            rank = int(env.get("RANK", 0))
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} outside a mesh of {n}")
    local_rank = int(env.get("LOCAL_RANK", rank))
    on_this_machine = int(env.get("LOCAL_WORLD_SIZE", n))
    shared = False
    if device is None or torch.device(device).type == "cuda":
        cards = torch.cuda.device_count()
        shared = on_this_machine > cards
        if shared and not (share_card and cards > 0):
            raise ValueError(f"{on_this_machine} ranks on this machine, which has {cards} card(s): a mesh is not "
                             "folded onto fewer cards unless share_card=True lets ranks share one")
        device = torch.device("cuda", local_rank % cards) if device is None else torch.device(device)
    device = torch.device(device)
    if n == 1:
        return Mesh(1, 0, device)
    if not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" and not shared else "gloo"
        if backend == "nccl":
            torch.cuda.set_device(device)
        dist.init_process_group(backend, init_method=init_method or "env://", world_size=n, rank=rank)
    return Mesh(n, rank, device, dist.group.WORLD)


def _stack(states):
    """One NamedTuple of [B]-stacked tensors from B of the same type (a None
    field stays None)."""
    first = states[0]
    return type(first)(*(None if getattr(first, k) is None else torch.stack([getattr(s, k) for s in states])
                         for k in first._fields))


def _local_lanes(batch: int, device, mesh: Optional[Mesh]):
    """(lanes to build, device): this rank's share of `batch` on its card
    with a mesh, all of them on `device` without one."""
    return (batch, device) if mesh is None else (len(mesh.lane_range(batch)), mesh.device)


def batched_state_hash(settings: Settings, img_size: Tuple[int, int], batch: int,
                       device: torch.device | str = "cuda", mesh: Optional[Mesh] = None):
    """[B]-leading (HashVolume, RenderStateVH, TrackingState) of `batch`
    fresh maps on `device` (the card unless the caller passes "cpu"). With
    a mesh, only this rank's lanes, on the mesh's device."""
    n, device = _local_lanes(batch, device, mesh)
    lanes = [hp.create_engine_state(settings, img_size, device=device) for _ in range(n)]
    return tuple(_stack([lane[i] for lane in lanes]) for i in range(3))


def batched_state_dense(settings: Settings, img_size: Tuple[int, int], batch: int,
                        device: torch.device | str = "cuda", mesh: Optional[Mesh] = None):
    """[B]-leading (DenseVolume, TrackingState) of `batch` fresh dense
    arrays on `device`; with a mesh only this rank's lanes (a lane at the
    default 512³ is 1 GiB)."""
    n, device = _local_lanes(batch, device, mesh)
    lanes = [dp.create_engine_state(settings, img_size, device=device) for _ in range(n)]
    return tuple(_stack([lane[i] for lane in lanes]) for i in range(2))


def shard_batch(tree, mesh: Mesh):
    """This rank's lanes of every [B]-leading tensor of `tree` (nested
    tuples and NamedTuples of tensors and None), on the mesh's device; a
    None stays None. B not divisible by the mesh's ranks raises ValueError."""

    def put(x):
        if x is None:
            return None
        if torch.is_tensor(x):
            lanes = mesh.lane_range(x.shape[0])
            return x[lanes.start:lanes.stop].to(mesh.device)
        return type(x)(*map(put, x)) if hasattr(x, "_fields") else type(x)(map(put, x))

    return put(tree)


def _dims(tree):
    """vmap in/out dims of a state: 0 for a tensor, None for an absent field."""
    if hasattr(tree, "_fields"):
        return type(tree)(*(_dims(getattr(tree, k)) for k in tree._fields))
    return None if tree is None else 0


def _fleet_metrics(mesh: Optional[Mesh], st, n_visible=None) -> dict:
    """mean_f and mean_valid over every lane of the fleet, and total_visible
    (their visible blocks summed) when `n_visible` is given. Over several
    ranks the lanes' sums are all-reduced in one float64 collective, on the
    rank's device, and divided by the fleet's B: every rank gets the same
    values."""
    if mesh is None or mesh.n == 1:
        metrics = {"mean_f": st.f.mean(), "mean_valid": st.num_valid.to(torch.float32).mean()}
        if n_visible is not None:
            metrics["total_visible"] = n_visible.sum()
        return metrics
    sums = [st.f.sum(), st.num_valid.sum()] + ([] if n_visible is None else [n_visible.sum()])
    sums = torch.stack([s.to(torch.float64) for s in sums])
    dist.all_reduce(sums, group=mesh.group)
    fleet = st.f.shape[0] * mesh.n
    metrics = {"mean_f": (sums[0] / fleet).to(torch.float32), "mean_valid": (sums[1] / fleet).to(torch.float32)}
    if n_visible is not None:
        metrics["total_visible"] = sums[2].to(torch.int64)
    return metrics


def _batched(name: str, settings: Settings, mesh: Optional[Mesh], frame_step, n_state: int, fleet):
    """The batched step over `frame_step` (an unbatched step, capture=False,
    whose last output is the diagnostics), captured as one graph a lane
    count (engine/captured.py): torch.vmap is traced inside the capture,
    each kernel's vmap rule one launch for the lanes. Over several ranks
    the fleet metrics' all-reduce runs after the replay, outside the graph
    (gloo, on a shared card, stages through the host)."""
    reduce_after = mesh is not None and mesh.n > 1

    def step(*args, capture=True):
        state, view, proj = args[:n_state], args[n_state], args[n_state + 1]

        def body(state, frame):
            view, proj = frame

            def one_step(*a):
                return frame_step(*a[:n_state], a[n_state], a[n_state + 1], settings, capture=False)

            dims = tuple(_dims(s) for s in state)
            vstep = torch.vmap(one_step, in_dims=(*dims, _dims(view), 0 if proj.dim() == 2 else None),
                               out_dims=(*dims, 0))
            *new_state, diag = vstep(*state, view, proj)
            metrics = {} if reduce_after else fleet(None, new_state, diag)
            return tuple(new_state), metrics | {"diag": diag}

        if not capture:
            state, metrics = body(state, (view, proj))
        else:
            static = (settings, state[0][0].shape[0], reduce_after)
            state, out = captured.run(name, static, body, state, (view, proj))
            metrics = out.read()
        if reduce_after:
            metrics = fleet(mesh, state, metrics["diag"]) | metrics
        return (*state, metrics)

    return step


def make_batched_step(settings: Settings, mesh: Optional[Mesh] = None):
    """The [B]-batched hash-pipeline frame step: `step(vol, rs, state, view,
    proj) → (vol, rs, state, metrics)`, every argument with a leading [B]
    (`proj` may also be one [4] tensor all lanes share). metrics: mean_f,
    mean_valid (means over the lanes) and total_visible (their sum), device
    scalars, and `diag`, the lanes' FrameDiagnostics ([B] fields). The step
    runs as one CUDA graph replay on the card, as process_frame_hash does:
    the state comes back as the caller's tensors, written in place, and
    metrics are copies; `capture=False` runs it op by op (new state tensors,
    `vol.vox` updated in place); the spans' marks as in process_frame_hash,
    once a step for all lanes (inside the torch.vmap body). With a mesh of
    several ranks the arguments are this rank's lanes (shard_batch), the
    three fleet metrics cover every rank's lanes and are equal on every
    rank, and `diag` holds this rank's lanes only."""
    return _batched("batched_hash", settings, mesh, hp.process_frame_hash, 3,
                    lambda m, st, diag: _fleet_metrics(m, st[2], diag.n_visible))


def make_batched_step_dense(settings: Settings, mesh: Optional[Mesh] = None):
    """The dense-array variant: `step(vol, state, view, proj) → (vol, state,
    metrics)` with metrics mean_f, mean_valid and `diag`; `capture`, the
    spans' marks and the mesh as in make_batched_step (op by op the volume is

    updated in place, as process_frame_dense updates it)."""
    return _batched("batched_dense", settings, mesh, dp.process_frame_dense, 2,
                    lambda m, st, diag: _fleet_metrics(m, st[1]))
