"""Tracking state (counterpart of infinitam_tpu/engine/tracking_state.py;
reference: ITMLib/Objects/ITMTrackingState.h:19)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class TrackingState(NamedTuple):
    pose: torch.Tensor  # [4,4] world→camera (pose_d)
    points_map: torch.Tensor  # [H,W,4] raycast scene points, metres, w=±1
    normals_map: torch.Tensor  # [H,W,4] scene normals, w=±1
    pose_point_cloud: torch.Tensor  # [4,4] pose at which the maps were raycast
    age: torch.Tensor  # int32: −1 = fresh (no maps yet)
    f: torch.Tensor  # last tracker energy
    num_valid: torch.Tensor  # int32 last tracker inlier count


def create_tracking_state(img_size: tuple[int, int], device: torch.device | str = "cuda") -> TrackingState:
    H, W = img_size
    empty = torch.cat(
        [torch.zeros((H, W, 3), dtype=torch.float32, device=device),
         torch.full((H, W, 1), -1.0, dtype=torch.float32, device=device)],
        dim=-1,
    )
    return TrackingState(
        pose=torch.eye(4, dtype=torch.float32, device=device),
        points_map=empty,
        normals_map=empty.clone(),
        pose_point_cloud=torch.eye(4, dtype=torch.float32, device=device),
        age=torch.full((), -1, dtype=torch.int32, device=device),
        f=torch.zeros((), dtype=torch.float32, device=device),
        num_valid=torch.zeros((), dtype=torch.int32, device=device),
    )
