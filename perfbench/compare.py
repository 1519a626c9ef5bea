"""The comparison that decides `correct`: what the timed path produced
against the plain reference run over the same frames with the program's
served poses (perfbench/reference.py), and against the ground truth of the
scene.

Numbers, each held to the configuration file's `limits` (a number at or
under its limit passes):

- pose_gap_mm, pose_gap_deg: the widest gap, over every frame of every pass
  of the window and every lane, between the program's pose and the one the
  reference's ICP finds for that frame from the program's previous pose,
  against its own raycast of its own map (camera centres in mm; rotation
  angle in degrees). This judges each frame's tracking one by one.
- voxel_mismatch: of the voxels that either side fused (weight > 0) in the
  last pass, the share whose weights differ or whose sdf differ by more than
  1e-3 (20 µm at μ = 2 cm). This judges allocation, visibility and fusion.
- map_mismatch: of the pixels that either side's last raycast found, the
  share where one side found none, or the points lie more than 1 mm apart,
  or the unit normals more than 0.05.
- ate_mm, rot_rmse_deg: the trajectory's RMSE against the scene's true
  poses over frames 1..N−1, the worst lane (the configuration's gates).
- cap_counters: the largest of the five silent-cap counters over every frame
  (hash volume only; the configuration's gate is 0).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference import SDF_SCALE, Reference

SDF_TOL = 1e-3
POINT_TOL_M = 1e-3
NORMAL_TOL = 0.05


def centre(M: np.ndarray) -> np.ndarray:
    """Camera centres of world→camera poses [..., 4, 4]."""
    R, t = M[..., :3, :3], M[..., :3, 3]
    return -np.einsum("...ji,...j->...i", R, t)


def rot_angle_deg(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """The angle of A·Bᵀ's rotation, from its antisymmetric part and its
    trace (atan2 stays exact at small angles, where arccos does not)."""
    dR = np.einsum("...ij,...kj->...ik", A[..., :3, :3], B[..., :3, :3])
    v = np.stack([dR[..., 2, 1] - dR[..., 1, 2], dR[..., 0, 2] - dR[..., 2, 0], dR[..., 1, 0] - dR[..., 0, 1]], -1)
    c = (np.trace(dR, axis1=-2, axis2=-1) - 1.0) / 2.0
    return np.degrees(np.arctan2(0.5 * np.linalg.norm(v, axis=-1), c))


def trajectory_errors(poses: np.ndarray, gt: np.ndarray):
    """(ATE RMSE in mm, rotation RMSE in degrees) over frames 1..N−1."""
    e = np.linalg.norm(centre(poses[1:].astype(np.float64)) - centre(gt[1:].astype(np.float64)), axis=-1)
    r = np.radians(rot_angle_deg(poses[1:].astype(np.float64), gt[1:].astype(np.float64)))
    return float(np.sqrt(np.mean(e**2)) * 1e3), float(np.degrees(np.sqrt(np.mean(r**2))))


def voxel_mismatch(kind: str, prog, ref) -> float:
    """The share of fused voxels on which the two maps disagree."""
    n_bad = n_fused = 0
    if kind == "dense":
        (s_a, w_a), (s_b, w_b) = prog, ref
        Z = s_a.shape[0]
        for z0 in range(0, Z, 32):
            sa, wa = s_a[z0:z0 + 32].float(), w_a[z0:z0 + 32]
            sb, wb = s_b[z0:z0 + 32].float(), w_b[z0:z0 + 32]
            fused = (wa > 0) | (wb > 0)
            bad = fused & ((wa != wb) | ((sa - sb).abs() > SDF_TOL))
            n_bad += int(bad.sum())
            n_fused += int(fused.sum())
        return n_bad / max(n_fused, 1)
    (k_a, q_a, w_a), (k_b, q_b, w_b) = prog, ref
    keys = torch.unique(torch.cat([k_a, k_b]))

    def spread(k, q, w):
        pos = torch.searchsorted(k, keys).clamp(max=max(k.numel() - 1, 0))
        found = (k[pos] == keys) if k.numel() else torch.zeros_like(keys, dtype=torch.bool)
        qq = torch.where(found[:, None], q[pos] if k.numel() else 0, int(SDF_SCALE))
        ww = torch.where(found[:, None], w[pos] if k.numel() else 0, 0)
        return qq, ww

    qa, wa = spread(k_a, q_a, w_a)
    qb, wb = spread(k_b, q_b, w_b)
    fused = (wa > 0) | (wb > 0)
    bad = fused & ((wa != wb) | ((qa - qb).abs().float() > SDF_TOL * SDF_SCALE))
    return int(bad.sum()) / max(int(fused.sum()), 1)


def map_mismatch(prog_maps, ref_maps) -> float:
    (pa, na), (pb, nb) = prog_maps, ref_maps
    va, vb = pa[..., 3] > 0, pb[..., 3] > 0
    either = va | vb
    dp = (pa[..., :3].float() - pb[..., :3].float()).norm(dim=-1)
    dn = (na[..., :3].float() - nb[..., :3].float()).norm(dim=-1)
    bad = either & ((va != vb) | (dp > POINT_TOL_M) | (dn > NORMAL_TOL))
    return int(bad.sum()) / max(int(either.sum()), 1)


def reference_lane(cfg, depths, poses, img_size, proj, device, dtype=torch.float32, counts=None):
    """Run the reference over one lane's frames [N, H, W] with the
    program's poses [N, 4, 4] of its last pass: (the reference's pose for
    each frame from the previous one [N, 4, 4] (frame 0: the identity),
    its map, its last maps)."""
    ref = Reference(cfg, img_size, proj, device, dtype=dtype, counts=counts)
    P = torch.as_tensor(poses, device=device)
    out = [torch.eye(4, dtype=torch.float32, device=device)]
    maps = None
    for i in range(depths.shape[0]):
        if counts is not None:
            counts.append({k: 0 for k in ("icp_bytes", "icp_ops", "integrate_bytes", "integrate_ops",
                                          "raycast_bytes", "raycast_ops")})
        d = depths[i].to(dtype)
        if i > 0:
            out.append(ref.track(P[i - 1].to(dtype), d, maps[0], maps[1], P[i - 1].to(dtype)).float())
        ref.integrate(d, P[i])
        maps = ref.maps(P[i])
    return torch.stack(out).cpu().numpy(), ref.voxels(), maps


def free_run(cfg, depths, img_size, proj, device, dtype):
    """The reference run on its own, tracking from its own poses: the
    control, put in the program's place at a lower precision. Returns
    (poses [N, 4, 4], map, last maps) as the program's outputs."""
    ref = Reference(cfg, img_size, proj, device, dtype=dtype)
    pose = torch.eye(4, dtype=dtype, device=device)
    poses, maps = [], None
    for i in range(depths.shape[0]):
        d = depths[i].to(dtype)
        if i > 0:
            pose = ref.track(pose, d, maps[0], maps[1], pose)
        poses.append(pose.float())
        ref.integrate(d, pose)
        maps = ref.maps(pose)
    return torch.stack(poses).cpu().numpy(), ref.voxels(), maps


def judge(cfg, kind, depths, gt, pass_poses, outputs, counters, img_size, proj, device, counts=None):
    """The numbers of one run. depths [B, N, H, W]; gt [B, N, 4, 4] (numpy);
    pass_poses [passes, N, B, 4, 4] (numpy); outputs: each lane's (map,
    maps) of the last pass; counters [passes, N, B, 5] or None. With
    `counts`, a list per lane of the reference's per-frame kernel traffic."""
    nums = {"pose_gap_mm": 0.0, "pose_gap_deg": 0.0, "voxel_mismatch": 0.0, "map_mismatch": 0.0,
            "ate_mm": 0.0, "rot_rmse_deg": 0.0}
    per_lane_fail = []
    for b in range(depths.shape[0]):
        lane_counts = None if counts is None else []
        ref_poses, ref_map, ref_maps = reference_lane(cfg, depths[b], pass_poses[-1][:, b], img_size, proj, device,
                                                      counts=lane_counts)
        if counts is not None:
            counts.append(lane_counts)
        P = pass_poses[:, :, b].astype(np.float64)
        gap_t = np.linalg.norm(centre(P) - centre(ref_poses.astype(np.float64)), axis=-1) * 1e3
        gap_r = rot_angle_deg(P, ref_poses.astype(np.float64))
        gap_t, gap_r = np.nan_to_num(gap_t, nan=math.inf), np.nan_to_num(gap_r, nan=math.inf)
        nums["pose_gap_mm"] = max(nums["pose_gap_mm"], float(gap_t.max()))
        nums["pose_gap_deg"] = max(nums["pose_gap_deg"], float(gap_r.max()))
        per_lane_fail.append(int((gap_t.max(axis=0) > cfg["limits"]["pose_gap_mm"]).sum()))
        nums["voxel_mismatch"] = max(nums["voxel_mismatch"], voxel_mismatch(kind, outputs[b][0], ref_map))
        nums["map_mismatch"] = max(nums["map_mismatch"], map_mismatch(outputs[b][1], ref_maps))
        ate, rot = trajectory_errors(pass_poses[-1][:, b], gt[b])
        nums["ate_mm"] = max(nums["ate_mm"], ate if math.isfinite(ate) else math.inf)
        nums["rot_rmse_deg"] = max(nums["rot_rmse_deg"], rot if math.isfinite(rot) else math.inf)
    if counters is not None:
        nums["cap_counters"] = float(counters.max())
    return nums, sum(per_lane_fail)


def limits_of(cfg: dict) -> dict:
    """Each compared number's limit: the configuration's measured limits and
    its stated gates."""
    lim = dict(cfg["limits"])
    lim.update(cfg["gates"])
    return lim


def verdict(nums: dict, limits: dict) -> bool:
    return all(math.isfinite(nums[k]) and nums[k] <= limits[k] for k in nums)
