"""End-to-end per-frame pipeline on the dense voxel-array volume.

Counterpart of infinitam_tpu/engine/dense_pipeline.py: the plain-voxel-array
configuration of the reference (ITMVoxelIndex = ITMPlainVoxelArray,
ITMLibDefines.h:211; ITMMainEngine::ProcessFrame → ITMDenseMapper, whose
plain-array branch allocates nothing and integrates the whole grid →
ITMTrackingController::Track / Prepare). Per frame: depth ICP (kernel K1,
30 launches at 5 levels) → integration of every voxel of the array (kernel
K2d, one launch; with colour, torch ops, as the JAX package leaves it to
XLA outside any Pallas kernel) → raycast over the frustum's depth range
(kernel K3d) → the next frame's tracking maps. Nothing is read back to the
host, so frames queue on the card without a sync.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from infinitam_tpu_torch.config import Settings
from infinitam_tpu_torch.engine import captured, spans
from infinitam_tpu_torch.engine import volume as vol_mod
from infinitam_tpu_torch.engine.tracking_state import TrackingState, create_tracking_state
from infinitam_tpu_torch.engine.trackers import TrackResult, track_depth
from infinitam_tpu_torch.engine.view_builder import View
from infinitam_tpu_torch.engine.volume import DenseVolume
from infinitam_tpu_torch.ops import raycast as rc
from infinitam_tpu_torch.ops import tsdf
from infinitam_tpu_torch.ops.kernels import integrate as integrate_kernel
from infinitam_tpu_torch.ops.kernels import raycast as raycast_kernel
from infinitam_tpu_torch.utils import se3


class FrameDiagnostics(NamedTuple):
    f: torch.Tensor
    num_valid: torch.Tensor


def integrate_frame_dense(
    vol: DenseVolume,
    view: View,
    pose: torch.Tensor,
    proj_d: torch.Tensor,
    settings: Settings,
    proj_rgb: torch.Tensor | None = None,
    rgb_to_depth: torch.Tensor | None = None,
) -> DenseVolume:
    """IntegrateIntoScene for the plain array: one elementwise pass over every
    voxel (reference ITMSceneReconstructionEngine plain-array overload),
    written into `vol`'s tensors in place (as K2 writes the hash volume's
    voxels), so no second array is made or copied back; the returned volume
    holds the same tensors. Without `use_color` the pass is kernel K2d
    (ops/kernels/integrate.py integrate_dense; its plain twin on the CPU).
    With it, and an rgb view, colour fuses too, in torch ops, through
    `proj_rgb` (default: `proj_d`) and the extrinsic `rgb_to_depth`
    (default: identity). The voxel centres are three broadcast planes, so
    no [Z, Y, X, 3] grid is built."""
    sp = settings.scene
    pts = vol_mod.voxel_world_coords(settings.plain, sp.voxel_size, device=vol.sdf.device)
    if not settings.use_color:
        integrate_kernel.integrate_dense(vol.sdf, vol.w_depth, *(p.reshape(-1) for p in pts), view.depth, pose,
                                         proj_d, sp.voxel_size, sp.mu, sp.max_w, sp.stop_integrating_at_max_w)
        return vol
    M_rgb = None
    rgb = None
    if view.rgb is not None:
        # reference: M_rgb = trafo_rgb_to_depth.calib_inv · M_d
        M_rgb = se3.invert(rgb_to_depth) @ pose if rgb_to_depth is not None else pose
        rgb = view.rgb
    sdf, w, clr, wc = tsdf.integrate_dense(
        vol.sdf,
        vol.w_depth,
        pts,
        pose,
        proj_d,
        view.depth,
        sp.mu,
        sp.max_w,
        stop_at_max_w=sp.stop_integrating_at_max_w,
        vol_clr=vol.clr,
        vol_wc=vol.w_color,
        M_rgb=M_rgb,
        proj_rgb=proj_rgb if proj_rgb is not None else proj_d,
        rgb=rgb,
        into=True,
    )
    return DenseVolume(sdf=sdf, w_depth=w, clr=clr, w_color=wc)


def raycast_dense(
    vol: DenseVolume,
    pose: torch.Tensor,
    proj_d: torch.Tensor,
    img_size: Tuple[int, int],
    settings: Settings,
) -> rc.RaycastResult:
    """Full-frame raycast (kernel K3d) over the camera frustum's depth range
    (reference: the plain array's CreateExpectedDepths fills the whole
    min/max image with the frustum)."""
    sp = settings.scene
    dev = vol.sdf.device
    zmin = torch.full(img_size, sp.view_frustum_min, dtype=torch.float32, device=dev)
    zmax = torch.full(img_size, sp.view_frustum_max, dtype=torch.float32, device=dev)
    return raycast_kernel.raycast_dense(vol, settings.plain, se3.invert(pose), proj_d, img_size, 1.0 / sp.voxel_size,
                                        sp.mu, zmin, zmax)


def prepare_tracking_maps(
    vol: DenseVolume,
    pose: torch.Tensor,
    proj_d: torch.Tensor,
    img_size: Tuple[int, int],
    settings: Settings,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """CreateICPMaps: raycast + image-space normals (reference
    ITMVisualisationEngine CreateICPMaps → renderICP)."""
    res = raycast_dense(vol, pose, proj_d, img_size, settings)
    return rc.make_icp_maps(res, settings.scene.voxel_size, se3.invert(pose))


def _frame_dense(vol, state, view, proj_d, settings, fusion_active=True):
    """process_frame_dense's step: new state tensors but the volume's, which
    the integration writes in place."""
    img_size = tuple(view.depth.shape)
    tr: TrackResult = track_depth(state.pose, view.depth, proj_d, state.points_map, state.normals_map,
                                  state.pose_point_cloud, settings.tracking)
    pose = torch.where(state.age >= 0, tr.pose, state.pose)
    spans.phase("track")
    if fusion_active:
        vol = integrate_frame_dense(vol, view, pose, proj_d, settings)
    spans.phase("integrate")
    points_map, normals_map = prepare_tracking_maps(vol, pose, proj_d, img_size, settings)
    spans.phase("raycast")
    new_state = TrackingState(
        pose=pose,
        points_map=points_map,
        normals_map=normals_map,
        pose_point_cloud=pose,
        age=torch.zeros((), dtype=torch.int32, device=pose.device),
        f=tr.f,
        num_valid=tr.num_valid,
    )
    return vol, new_state, FrameDiagnostics(f=tr.f, num_valid=tr.num_valid)


def process_frame_dense(
    vol: DenseVolume,
    state: TrackingState,
    view: View,
    proj_d: torch.Tensor,
    settings: Settings,
    fusion_active: bool = True,
    capture: bool = True,
) -> Tuple[DenseVolume, TrackingState, FrameDiagnostics]:
    """One frame: track → integrate → raycast the next frame's maps. On
    frame 0 (state.age == −1) the tracker runs but its pose is not taken, as
    in the JAX package (reference ITMTrackingController::Track gates on
    age_pointCloud == −1), so every frame launches the same kernels and
    nothing is read back. `capture` and the spans' marks ("track",
    "integrate", "raycast") as in hash_pipeline.process_frame_hash:
    captured, the caller's state tensors are written in place; op by op,
    the volume is updated in place (the integration writes it) and the
    tracking state is new."""
    if not capture:
        return _frame_dense(vol, state, view, proj_d, settings, fusion_active)


    def body(st, frame):
        vol, s, diag = _frame_dense(*st, *frame, settings, fusion_active)
        return (vol, s), diag

    (vol, state), out = captured.run("dense", (settings, fusion_active), body, (vol, state), (view, proj_d))
    return vol, state, out.read()


def create_engine_state(settings: Settings, img_size: Tuple[int, int], device: torch.device | str = "cuda"):
    """A fresh (DenseVolume, TrackingState) on `device`, the card unless the
    caller passes device="cpu" (reference ITMMainEngine constructor +
    ResetScene). At the default 512³ the volume takes 1 GiB."""
    vol = vol_mod.create_dense(settings.plain, with_color=settings.use_color, device=device)
    return vol, create_tracking_state(img_size, device=device)
