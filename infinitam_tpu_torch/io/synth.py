"""Synthetic RGB-D sequence: analytic-SDF scene with a procedural surface
colour + exact sphere-traced renderer (counterpart of
infinitam_tpu/io/synth.py). Renders on whatever device the source is given,
so a replay on the card needs no host frames."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from infinitam_tpu_torch.utils import se3

_C, _S = float(np.cos(0.5)), float(np.sin(0.5))


def _norm3(x, y, z):
    return torch.sqrt(x * x + y * y + z * z)


def scene_sdf(p: torch.Tensor) -> torch.Tensor:
    """Signed distance (metres) of the default test scene: two spheres, a box
    rotated 0.5 rad about y, and a back wall at z = 2.3. p: [..., 3] world.
    Written on component planes with Python-scalar constants, so rendering
    on the card copies nothing from the host."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    d_sphere = _norm3(x, y - 0.1, z - 1.5) - 0.35
    bx, by, bz = x + 0.55, y + 0.2, z - 1.8
    q = (_C * bx - _S * bz, by, _S * bx + _C * bz)
    dq = [torch.abs(qa) - h for qa, h in zip(q, (0.25, 0.3, 0.25))]
    d_box = _norm3(*(d.clamp(min=0.0) for d in dq)) + torch.maximum(torch.maximum(dq[0], dq[1]), dq[2]).clamp(max=0.0)
    d_sphere2 = _norm3(x - 0.55, y - 0.25, z - 1.35) - 0.2
    d_wall = 2.3 - z
    return torch.minimum(torch.minimum(d_sphere, d_box), torch.minimum(d_sphere2, d_wall))


def scene_color(p: torch.Tensor) -> torch.Tensor:
    """Procedural surface colour [..., 3] in 0..1: a high-contrast texture
    along every axis, so the photometric energy constrains all six pose
    DoF."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = 0.5 + 0.25 * torch.sin(x * 23.0 + z * 7.0) + 0.25 * torch.sin(y * 17.0)
    g = 0.5 + 0.25 * torch.sin(y * 19.0 - x * 11.0) + 0.25 * torch.cos(z * 13.0)
    b = 0.5 + 0.25 * torch.sin(z * 21.0 + y * 9.0) + 0.25 * torch.cos(x * 15.0)
    return torch.stack([r, g, b], dim=-1).clamp(0.0, 1.0)


def render_depth(
    pose: torch.Tensor,  # [4,4] world→camera
    proj: torch.Tensor,  # (fx, fy, cx, cy)
    img_size: Tuple[int, int],
    t_min: float = 0.2,
    t_max: float = 4.0,
    n_steps: int = 96,
) -> torch.Tensor:
    """Exact depth by sphere tracing the analytic SDF → [H, W] metric z-depth
    (not ray length) with −1 misses."""
    H, W = img_size
    dev = pose.device
    fx, fy, cx, cy = proj[0], proj[1], proj[2], proj[3]
    inv = se3.invert(pose)
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    dir_cam = torch.stack([(xs - cx) / fx, (ys - cy) / fy, torch.ones_like(xs)], dim=-1)
    ray_scale = torch.linalg.norm(dir_cam, dim=-1)
    origin = inv[:3, 3]
    dir_world = torch.einsum("ij,hwj->hwi", inv[:3, :3], dir_cam)
    dir_world = dir_world / torch.linalg.norm(dir_world, dim=-1, keepdim=True).clamp(min=1e-12)

    t = torch.full((H, W), t_min, dtype=torch.float32, device=dev)
    for _ in range(n_steps):
        d = scene_sdf(origin + t[..., None] * dir_world)
        t = torch.where(t < t_max, t + d.clamp(min=1e-4) * 0.9, t)
    hit = (scene_sdf(origin + t[..., None] * dir_world) < 5e-3) & (t < t_max)
    return torch.where(hit, t / ray_scale, torch.full_like(t, -1.0))


def render_rgbd(pose: torch.Tensor, proj: torch.Tensor, img_size: Tuple[int, int], t_min: float = 0.2,
                t_max: float = 4.0, n_steps: int = 96):
    """Depth [H, W] and colour [H, W, 3] (0..1, 0 at misses) seen by one
    camera: the colour of each depth pixel's back-projected hit point."""
    depth = render_depth(pose, proj, img_size, t_min, t_max, n_steps)
    H, W = img_size
    fx, fy, cx, cy = proj[0], proj[1], proj[2], proj[3]
    inv = se3.invert(pose)
    xs = torch.arange(W, dtype=torch.float32, device=pose.device)[None, :].expand(H, W)
    ys = torch.arange(H, dtype=torch.float32, device=pose.device)[:, None].expand(H, W)
    z = torch.where(depth > 0, depth, torch.ones_like(depth))
    p_cam = torch.stack([z * (xs - cx) / fx, z * (ys - cy) / fy, z], dim=-1)
    p_world = torch.einsum("ij,hwj->hwi", inv[:3, :3], p_cam) + inv[:3, 3]
    rgb = torch.where((depth > 0)[..., None], scene_color(p_world), torch.zeros_like(p_world))
    return depth, rgb


def make_trajectory(n_frames: int, scale: float = 1.0, step: float = 0.01) -> np.ndarray:
    """Smooth ground-truth world→camera poses [N, 4, 4] (float32): a slow arc
    with gentle rotation in all six DoF, ~1.5 cm / ~0.5° per frame."""
    poses = []
    for i in range(n_frames):
        s = i * step
        t = np.array(
            [0.25 * np.sin(2 * np.pi * s), 0.12 * np.sin(4 * np.pi * s), 0.18 * s],
            dtype=np.float32,
        ) * scale
        w = np.array(
            [0.10 * np.sin(2 * np.pi * s), 0.22 * s, 0.06 * np.sin(2 * np.pi * s)],
            dtype=np.float32,
        ) * scale
        poses.append(se3.se3_exp(torch.from_numpy(np.concatenate([t, w]))).numpy())
    return np.stack(poses)


class SyntheticSource:
    """Pull-style frame source (reference ImageSourceEngine contract) with
    ground-truth poses attached; frames render on `device` (the card unless
    the caller passes device="cpu"). With `with_rgb`
    the colour image is rendered from the depth camera (an identity
    rgb-to-depth extrinsic and the depth intrinsics)."""

    def __init__(self, calib, n_frames: int = 50, img_size=None, with_rgb: bool = False,
                 device: torch.device | str = "cuda"):
        self.calib = calib
        intr = calib.intrinsics_d
        self.img_size = img_size or (intr.height, intr.width)
        self.device = torch.device(device)
        self.proj = torch.as_tensor(intr.vector, device=self.device)
        self.gt_poses = make_trajectory(n_frames)
        self.n_frames = n_frames
        self.with_rgb = with_rgb
        self._i = 0

    def has_more_images(self) -> bool:
        return self._i < self.n_frames

    def get_images(self):
        """→ (depth [H, W] on the source's device, rgb [H, W, 3] or None,
        gt pose [4, 4])."""
        pose = torch.as_tensor(self.gt_poses[self._i], device=self.device)
        self._i += 1
        if self.with_rgb:
            depth, rgb = render_rgbd(pose, self.proj, self.img_size)
            return depth, rgb, pose
        return render_depth(pose, self.proj, self.img_size), None, pose
