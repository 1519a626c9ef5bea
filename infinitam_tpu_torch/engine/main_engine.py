"""MainEngine façade: the reference's top-level API over the port's frame
step (counterpart of infinitam_tpu/engine/main_engine.py; reference
ITMLib/Engine/ITMMainEngine.{h,cpp}: owns the scene, the tracking state and
the render state; ProcessFrame = UpdateView → Track → Fuse → Prepare
(ITMMainEngine.cpp:111-127); GetImage renders the live, depth, weight and
freeview images (:134-192); UpdateMesh / SaveSceneToMesh; the fusion and
processing switches).

The state lives on `device`, the card unless the caller passes "cpu".
`process_frame` reads nothing back to the host: its diagnostics come back
as a `LazyDiag` over device tensors. `get_image` returns numpy and so waits
for the card, as the JAX package's does; it is not on the frame path, and
neither is the mesh, which reads back its block and triangle counts and
the triangles. With swapping, the frame runs as `step_frame_swap` and the
host halves of the exchange pipeline two frames behind it
(swapping.SwapExchange), so the frame still reads nothing back; the host
store is numpy (`global_cache`), and `flush_swap` drains the exchange.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from infinitam_tpu_torch.calib import RGBDCalib
from infinitam_tpu_torch.config import Settings, SwappingMode
from infinitam_tpu_torch.engine import captured, spans
from infinitam_tpu_torch.engine import hash_pipeline as hp
from infinitam_tpu_torch.engine import hash_volume as hv
from infinitam_tpu_torch.engine import swapping as sw
from infinitam_tpu_torch.engine.meshing_engine import Mesh, mesh_scene_hash
from infinitam_tpu_torch.engine.trackers import apply_imu_rotation
from infinitam_tpu_torch.engine.view_builder import build_view, build_view_from_metric_depth
from infinitam_tpu_torch.io.sources import frame_tensor
from infinitam_tpu_torch.ops import colormaps as cm
from infinitam_tpu_torch.ops import raycast as rc
from infinitam_tpu_torch.utils import se3


class LazyDiag:
    """Mapping view over a frame's FrameDiagnostics of device tensors: a
    value is read to the host only when it is accessed (`diag["num_valid"]`,
    `.get`, `.as_dict()`), so the frame path itself never waits for the
    card; `device` holds the tensors."""

    def __init__(self, d: hp.FrameDiagnostics):
        self.device = d

    def _host(self, k):
        v = getattr(self.device, k)
        return float(v) if k == "f" else int(v)

    def __getitem__(self, k):
        return self._host(k)

    def get(self, k, default=None):
        if k not in self.device._fields:
            return default
        return self._host(k)

    def keys(self):
        return self.device._fields

    def as_dict(self):
        return {k: self._host(k) for k in self.device._fields}


class MainEngine:
    """Stateful façade over the functional frame step: host-side switches
    and counters, device-side state."""

    def __init__(self, settings: Settings, calib: RGBDCalib, img_size: Tuple[int, int],
                 device: torch.device | str = "cuda"):
        self.settings = settings
        self.calib = calib
        self.img_size = tuple(img_size)
        self.device = torch.device(device)
        self.proj = torch.as_tensor(calib.intrinsics_d.vector, device=self.device)
        self.proj_rgb = torch.as_tensor(calib.intrinsics_rgb.vector, device=self.device)
        self.rgb_to_depth = torch.as_tensor(calib.rgb_to_depth, device=self.device)
        self.swapping = settings.swapping_mode.value == SwappingMode.ENABLED.value
        self.reset_scene()
        self.fusion_active = True  # reference: turnOnIntegration / turnOffIntegration
        self.main_processing = True
        self.frame_no = 0

    # ----- controls (reference: ITMMainEngine.h:95-117) ------------------
    def turn_on_integration(self):
        self.fusion_active = True

    def turn_off_integration(self):
        self.fusion_active = False

    def turn_on_main_processing(self):
        self.main_processing = True

    def turn_off_main_processing(self):
        self.main_processing = False

    def reset_scene(self):
        """A fresh map (and, with swapping, fresh swap states, and the host
        store and exchange emptied in place, or made on the first call)."""
        self.vol, self.render_state, self.tracking_state = hp.create_engine_state(self.settings, self.img_size,
                                                                                  device=self.device)
        cache, exchange = getattr(self, "global_cache", None), getattr(self, "swap_exchange", None)
        self.swap_states = self.global_cache = self.swap_exchange = None
        if self.swapping:
            self.swap_states = sw.create_swap_states(self.settings, device=self.device)
            if cache is None or exchange is None:
                cache = sw.GlobalCache.create(self.settings)
                exchange = sw.SwapExchange(self.settings, self.settings.use_color, device=self.device)
            cache.reset()
            exchange.reset()
            self.global_cache, self.swap_exchange = cache, exchange

    # ----- per frame -----------------------------------------------------
    def process_frame(self, raw_depth=None, rgb=None, metric_depth=None, imu_rotation=None, external_pose=None,
                      capture: bool = True):
        """UpdateView → Track → Fuse (→ swap) → Prepare. Frames are numpy arrays or
        tensors (moved to the engine's device); `imu_rotation` [3, 3] is a
        differential rotation applied to the pose before tracking,
        `external_pose` [4, 4] the pose the external tracker takes. The
        view is built op by op, as the JAX package's view builder is not
        jitted; the frame step (process_frame_hash, or step_frame_swap with
        swapping) runs as one CUDA graph replay on the card (`capture`) and
        writes the engine's state tensors in place; the exchange's host
        half runs between the replays. With spans on (engine/spans.py), a
        mark "view" once the view has been issued, then the frame step's.
        Returns the frame's LazyDiag ({} while main processing is off), over
        copies of the diagnostics."""
        if not self.main_processing:
            return {}
        dev = self.device
        rgb = frame_tensor(rgb, dev)
        if metric_depth is not None:
            view = build_view_from_metric_depth(frame_tensor(metric_depth, dev), self.settings, self.calib, rgb=rgb)
        else:
            view = build_view(frame_tensor(raw_depth, dev), self.calib, self.settings, rgb=rgb)
        spans.phase("view")
        if imu_rotation is not None:
            self._write_pose(apply_imu_rotation(self.tracking_state.pose, self._f32(imu_rotation)))
        if external_pose is not None:
            external_pose = self._f32(external_pose)
        if self.swapping:
            # the exchange's device half runs inside the frame step and its
            # host half two frames behind, on copies that have landed
            m_flips, m_slab = self.swap_exchange.merge_args()
            (self.vol, self.render_state, self.tracking_state, self.swap_states, d, in_meta,
             out_pack) = hp.step_frame_swap(
                self.vol, self.render_state, self.tracking_state, self.swap_states, view, self.proj, self.settings,
                fusion_active=self.fusion_active, proj_rgb=self.proj_rgb, rgb_to_depth=self.rgb_to_depth,
                external_pose=external_pose, merge_flips=m_flips, merge_slab=m_slab, capture=capture,
            )
            self.swap_exchange.after_frame(in_meta, out_pack, self.global_cache)
        else:
            self.vol, self.render_state, self.tracking_state, d = hp.process_frame_hash(
                self.vol, self.render_state, self.tracking_state, view, self.proj, self.settings,
                fusion_active=self.fusion_active, proj_rgb=self.proj_rgb, rgb_to_depth=self.rgb_to_depth,
                external_pose=external_pose, capture=capture,

            )
        self.frame_no += 1
        return LazyDiag(d)

    def flush_swap(self) -> None:
        """Drain the pipelined exchange (checkpoint save, shutdown): the
        pending host halves and merges, then one full-scan eviction (the
        frame scans a rotating window), so that the map and the host store
        hold every processed frame (swapping.end_session). It reads back to
        the host."""
        if not self.swapping:
            return
        self.vol, self.swap_states = sw.end_session(self.swap_exchange, self.vol, self.swap_states, self.render_state,
                                                    self.global_cache, self.settings)

    def _f32(self, a) -> torch.Tensor:
        """A pose, rotation or intrinsics (numpy or tensor) as float32 on the
        engine's device."""
        return frame_tensor(a, self.device).to(torch.float32)

    # ----- outputs (reference: GetImage) ---------------------------------
    def get_pose(self) -> np.ndarray:
        """The current pose, a copy (the next frame writes the state's)."""
        return self.tracking_state.pose.cpu().numpy().copy()

    def set_pose(self, pose) -> None:
        """External pose injection (reference: RosPoseSourceEngine writes
        trackingState->pose_d directly)."""
        self._write_pose(self._f32(pose))

    def _write_pose(self, pose: torch.Tensor) -> None:
        """Write the state's pose in place, as a captured step reads it where
        it lies (a new tensor would mean a new graph); a pose the state
        shares with another of its fields gets memory of its own first."""
        self.tracking_state = captured.unalias(self.tracking_state)
        self.tracking_state.pose.copy_(pose)

    def get_image(self, which: str = "raycast", pose=None, proj=None, view=None) -> np.ndarray:
        """Render an image (reference GetImage types): 'raycast' (grey
        shading from the current pose, [H, W] uint8), 'normals' ([H, W, 3]),
        'colour' ([H, W, 3]), 'depth' (rainbow colormap [H, W, 4] of the
        raycast depth; of `view`, an input depth map, when given: the
        reference's ORIGINAL_DEPTH) and 'weight' (fusion-confidence colormap
        [H, W, 4]); an explicit `pose` renders a freeview image through a
        visible list rebuilt for that pose."""
        dev = self.device
        if which == "depth" and view is not None:
            return cm.depth_to_uchar4(frame_tensor(view, dev)).cpu().numpy()
        freeview = pose is not None
        pose = self.tracking_state.pose if pose is None else self._f32(pose)
        proj = self.proj if proj is None else self._f32(proj)
        # the live list covers only the tracked camera's frustum (reference:
        # FindVisibleBlocks on a freeview render state, ITMMainEngine.cpp:176-182)
        rs = hp.find_visible_blocks(self.vol, pose, proj, self.img_size, self.settings) if freeview \
            else self.render_state
        res = hp.raycast_hash(self.vol, rs, pose, proj, self.img_size, self.settings)
        voxel_size = self.settings.scene.voxel_size
        inv = se3.invert(pose)
        if which == "normals":
            img = rc.render_normals(res, voxel_size, inv)
        elif which == "colour":
            img = rc.render_color(res, hv.make_hash_color_reader(self.vol, self.settings.hashing))
        elif which == "depth":
            # z of the raycast surface in the camera frame
            found = res.points[..., 3] > 0
            pw = res.points[..., :3] * voxel_size
            z = se3.apply_planes(pose, pw[..., 0], pw[..., 1], pw[..., 2])[2]
            img = cm.depth_to_uchar4(torch.where(found, z, torch.full_like(z, -1.0)))
        elif which == "weight":
            # fusion weight at the raycast surface (reference WeightToUchar4)
            if self.settings.use_block_grid:
                grid = hv.get_block_grid(self.vol, self.settings.block_grid)
                read_w = hv.make_grid_weight_reader(self.vol, grid, self.settings.block_grid,
                                                    self.settings.hashing)
            else:
                read_w = hv.make_hash_weight_reader(self.vol, self.settings.hashing)
            w, _found = read_w(torch.floor(res.points[..., :3] + 0.5).to(torch.int32))
            img = cm.weight_to_uchar4(torch.where(res.points[..., 3] > 0, w, torch.zeros_like(w)))
        else:
            img = rc.render_grey(res, voxel_size, inv)
        return img.cpu().numpy()

    def update_mesh(self) -> Mesh:
        """Every triangle of the map's resident blocks (reference UpdateMesh;
        with swapping, as in the JAX package, blocks in the host store are
        not meshed)."""
        return mesh_scene_hash(self.vol, self.settings)

    def save_scene_to_mesh(self, path: str) -> None:
        """The map's mesh as OBJ (a path ending in .obj) or binary STL."""
        mesh = self.update_mesh()
        if path.lower().endswith(".obj"):
            mesh.write_obj(path)
        else:
            mesh.write_stl(path)
