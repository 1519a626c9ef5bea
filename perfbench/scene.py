"""The benchmark's synthetic desk scene, its camera paths and its depth
frames, made on the device from a seed.

A frozen copy of the port's synthetic source (infinitam_tpu_torch/io/synth.py):
the same analytic scene (two spheres, a box turned 0.5 rad about y, a back
wall at z = 2.3 m) and the same sphere tracer, rendering every frame of a
sequence in one batch. The seed varies the camera path only inside a band
around the port's `make_trajectory` where tracking stays within its gates
(ATE < 1 cm): each of the six motion amplitudes is scaled by a factor in
[0.9, 1.1], and the sign of the two smallest sinusoids (the y sway and the
z roll) is flipped by the seed. Every path starts at the identity, where the
map's frame is.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_C, _S = math.cos(0.5), math.sin(0.5)


def _norm3(x, y, z):
    return torch.sqrt(x * x + y * y + z * z)


def scene_sdf(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Signed distance in metres of the desk scene at world points given as
    component planes."""
    d_sphere = _norm3(x, y - 0.1, z - 1.5) - 0.35
    bx, by, bz = x + 0.55, y + 0.2, z - 1.8
    q = (_C * bx - _S * bz, by, _S * bx + _C * bz)
    dq = [torch.abs(qa) - h for qa, h in zip(q, (0.25, 0.3, 0.25))]
    d_box = _norm3(*(d.clamp(min=0.0) for d in dq)) + torch.maximum(torch.maximum(dq[0], dq[1]), dq[2]).clamp(max=0.0)
    d_sphere2 = _norm3(x - 0.55, y - 0.25, z - 1.35) - 0.2
    d_wall = 2.3 - z
    return torch.minimum(torch.minimum(d_sphere, d_box), torch.minimum(d_sphere2, d_wall))


def _so3_exp(w: np.ndarray) -> np.ndarray:
    th = float(np.linalg.norm(w))
    K = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
    if th < 1e-12:
        return np.eye(3) + K
    return np.eye(3) + math.sin(th) / th * K + (1 - math.cos(th)) / th**2 * K @ K


def _se3_exp(t: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Twist (t, ω) → 4×4, as the port's se3_exp (V·t for the translation)."""
    th = float(np.linalg.norm(w))
    K = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
    if th < 1e-12:
        V = np.eye(3) + 0.5 * K
    else:
        V = np.eye(3) + (1 - math.cos(th)) / th**2 * K + (th - math.sin(th)) / th**3 * K @ K
    M = np.eye(4)
    M[:3, :3] = _so3_exp(w)
    M[:3, 3] = V @ t
    return M


def seed_shape(seed: int) -> tuple:
    """(six amplitude factors in [0.9, 1.1], the two flipped signs) that a
    seed gives the camera path."""
    rng = np.random.default_rng(seed % (2**63))
    amp = 1.0 + 0.1 * (2.0 * rng.random(6) - 1.0)
    signs = np.where(rng.random(2) < 0.5, -1.0, 1.0)
    return amp, signs


def trajectory(n_frames: int, seed: int, scale: float = 1.0, step: float = 0.01) -> np.ndarray:
    """World→camera poses [N, 4, 4] float32 of a slow arc with a gentle turn
    in all six degrees of freedom, ~1.5 cm and ~0.5° a frame at scale 1."""
    amp, signs = seed_shape(seed)
    poses = []
    for i in range(n_frames):
        s = i * step
        t = np.array([0.25 * math.sin(2 * math.pi * s), signs[0] * 0.12 * math.sin(4 * math.pi * s), 0.18 * s])
        w = np.array([0.10 * math.sin(2 * math.pi * s), 0.22 * s, signs[1] * 0.06 * math.sin(2 * math.pi * s)])
        poses.append(_se3_exp(t * amp[:3] * scale, w * amp[3:] * scale))
    return np.stack(poses).astype(np.float32)


def render_depths(poses: torch.Tensor, proj, img_size, t_min: float = 0.2, t_max: float = 4.0,
                  n_steps: int = 96, chunk: int = 8) -> torch.Tensor:
    """Metric z-depth [N, H, W] (−1 where the ray misses) seen from each
    world→camera pose [N, 4, 4], by sphere tracing the scene, `chunk` frames
    a batch."""
    H, W = img_size
    fx, fy, cx, cy = (float(v) for v in proj)
    dev = poses.device
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    dir_cam = torch.stack([(xs - cx) / fx, (ys - cy) / fy, torch.ones_like(xs)], dim=-1)
    ray_scale = torch.linalg.norm(dir_cam, dim=-1)
    out = []
    for c0 in range(0, poses.shape[0], chunk):
        P = poses[c0:c0 + chunk]
        R, t = P[:, :3, :3], P[:, :3, 3]
        Rt = R.transpose(1, 2)
        origin = -(Rt @ t[..., None])[..., 0]  # [n, 3]
        d = torch.einsum("nij,hwj->nhwi", Rt, dir_cam)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True).clamp(min=1e-12)
        o = origin[:, None, None, :]
        tt = torch.full(d.shape[:-1], t_min, dtype=torch.float32, device=dev)
        for _ in range(n_steps):
            p = o + tt[..., None] * d
            s = scene_sdf(p[..., 0], p[..., 1], p[..., 2])
            tt = torch.where(tt < t_max, tt + s.clamp(min=1e-4) * 0.9, tt)
        p = o + tt[..., None] * d
        hit = (scene_sdf(p[..., 0], p[..., 1], p[..., 2]) < 5e-3) & (tt < t_max)
        out.append(torch.where(hit, tt / ray_scale, torch.full_like(tt, -1.0)))
    return torch.cat(out)


def frames(traffic: dict, seed: int, dev):
    """A traffic mix's true camera poses [B, N, 4, 4] (numpy) and its depth
    frames [B, N, H, W] rendered on `dev` from the seed: B = `lanes`
    sequences of `frames` frames, lane b on the path at scale
    1 − `lane_scale_step`·b."""
    lanes, n = traffic["lanes"], traffic["frames"]
    gt = np.stack([trajectory(n, seed, scale=1.0 - traffic["lane_scale_step"] * b) for b in range(lanes)])
    depths = torch.stack([render_depths(torch.as_tensor(g, device=dev), traffic["intrinsics"],
                                        tuple(traffic["image"])) for g in gt])
    return gt, depths
