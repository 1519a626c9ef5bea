"""Batched multi-sequence SLAM: B independent RGB-D sequences in one step.

Counterpart of infinitam_tpu/parallel/batch.py. Every state tensor gets a
leading [B] dim and the per-frame step runs under `torch.vmap`, so each
torch op of the step does the work of all B lanes. The kernels K1, K2 and
K3 (K3d on the dense array) are custom ops whose vmap rules make ONE
lane-indexed launch for the B lanes (ops/kernels/build.py), so a batched
step launches each kernel as often as an unbatched one. Fleet metrics
(mean tracker energy and inliers, total visible blocks) reduce over the
batch.

The JAX package shards B over a device mesh; here the mesh is a list of
CUDA devices and the batch stays on one card: a mesh of more than one card
raises (ROADMAP Queue 1, lanes over several cards).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from infinitam_tpu_torch.config import Settings
from infinitam_tpu_torch.engine import dense_pipeline as dp
from infinitam_tpu_torch.engine import hash_pipeline as hp
from infinitam_tpu_torch.engine import hash_volume as hv
from infinitam_tpu_torch.engine.tracking_state import create_tracking_state


def make_mesh(n_devices: Optional[int] = None) -> List[torch.device]:
    """The first `n_devices` CUDA devices (all of them when None)."""
    n = torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(n_devices or n)][:n]


def _stack(states):
    """One NamedTuple of [B]-stacked tensors from B of the same type (a None
    field stays None)."""
    first = states[0]
    return type(first)(*(None if getattr(first, k) is None else torch.stack([getattr(s, k) for s in states])
                         for k in first._fields))


def batched_state_hash(settings: Settings, img_size: Tuple[int, int], batch: int,
                       device: torch.device | str = "cuda"):
    """[B]-leading (HashVolume, RenderStateVH, TrackingState) of `batch`
    fresh maps on `device` (the card unless the caller passes "cpu")."""
    lanes = [hp.create_engine_state(settings, img_size, device=device) for _ in range(batch)]
    return tuple(_stack([lane[i] for lane in lanes]) for i in range(3))


def batched_state_dense(settings: Settings, img_size: Tuple[int, int], batch: int,
                        device: torch.device | str = "cuda"):
    """[B]-leading (DenseVolume, TrackingState) of `batch` fresh dense
    arrays on `device`."""
    lanes = [dp.create_engine_state(settings, img_size, device=device) for _ in range(batch)]
    return tuple(_stack([lane[i] for lane in lanes]) for i in range(2))


def _one_card(mesh: List[torch.device]) -> None:
    """The lanes share one card: a mesh of more than one is not served yet."""
    if len(mesh) != 1:
        raise NotImplementedError(
            f"a mesh of {len(mesh)} cards: the batch runs on one card (ROADMAP Queue 1: lanes over several cards)")


def shard_batch(tree, mesh: List[torch.device]):
    """Every tensor of `tree` (nested tuples of tensors and None) on the
    mesh's card. The lanes share that one card: a mesh of more than one
    card raises NotImplementedError (ROADMAP Queue 1, lanes over several
    cards)."""
    _one_card(mesh)

    def put(x):
        if x is None:
            return None
        if torch.is_tensor(x):
            return x.to(mesh[0])
        return type(x)(*map(put, x)) if hasattr(x, "_fields") else type(x)(map(put, x))

    return put(tree)


def _dims(tree):
    """vmap in/out dims of a state: 0 for a tensor, None for an absent field."""
    if hasattr(tree, "_fields"):
        return type(tree)(*(_dims(getattr(tree, k)) for k in tree._fields))
    return None if tree is None else 0


def make_batched_step(settings: Settings, mesh: Optional[List[torch.device]] = None):
    """The [B]-batched hash-pipeline frame step: `step(vol, rs, state, view,
    proj) → (vol, rs, state, metrics)`, every argument with a leading [B]
    (`proj` may also be one [4] tensor all lanes share). metrics: mean_f,
    mean_valid (means over the lanes) and total_visible (their sum), device
    scalars, and `diag`, the lanes' FrameDiagnostics ([B] fields). `vol.vox`
    is updated in place, as in process_frame_hash. `on_phase` as in
    process_frame_hash, called once a step for all lanes."""
    if mesh is not None:
        _one_card(mesh)

    def step(vol, rs, st, view, proj, on_phase=hp.no_phase):
        def one_step(vol, rs, st, view, proj):
            return hp.process_frame_hash(vol, rs, st, view, proj, settings, on_phase=on_phase)

        dims = (_dims(vol), _dims(rs), _dims(st))
        vstep = torch.vmap(one_step, in_dims=(*dims, _dims(view), 0 if proj.dim() == 2 else None),
                           out_dims=(*dims, 0))
        vol, rs, st, diag = vstep(vol, rs, st, view, proj)
        metrics = {
            "mean_f": st.f.mean(),
            "mean_valid": st.num_valid.to(torch.float32).mean(),
            "total_visible": diag.n_visible.sum(),
            "diag": diag,
        }
        return vol, rs, st, metrics

    return step


def make_batched_step_dense(settings: Settings, mesh: Optional[List[torch.device]] = None):
    """The dense-array variant: `step(vol, state, view, proj) → (vol, state,
    metrics)` with metrics mean_f, mean_valid and `diag`; `on_phase` as in
    make_batched_step."""
    if mesh is not None:
        _one_card(mesh)

    def step(vol, st, view, proj, on_phase=dp.no_phase):
        def one_step(vol, st, view, proj):
            return dp.process_frame_dense(vol, st, view, proj, settings, on_phase=on_phase)

        dims = (_dims(vol), _dims(st))
        vstep = torch.vmap(one_step, in_dims=(*dims, _dims(view), 0 if proj.dim() == 2 else None),
                           out_dims=(*dims, 0))
        vol, st, diag = vstep(vol, st, view, proj)
        metrics = {"mean_f": st.f.mean(), "mean_valid": st.num_valid.to(torch.float32).mean(), "diag": diag}
        return vol, st, metrics

    return step
