"""Camera trackers: hierarchical Gauss-Newton depth ICP, also weighted per
pixel by the depth noise (reference ITMDepthTracker TrackCamera,
ITMWeightedICPTracker), the photometric colour tracker (reference
ITMColorTracker), the Ren SDF tracker (reference ITMRenTracker), the
external pose and the IMU prior (reference ITMExternalTracker,
ITMIMUTracker), and the approximate raycast's refresh test (reference
ITMTrackingState::TrackerFarFromPointCloud).

Counterpart of infinitam_tpu/engine/trackers.py. Each pyramid level (and
the Ren LM) runs a fixed number of iterations; once it has converged its
state is frozen by a mask, which gives the same result as the JAX
package's early-exit loops without reading the convergence flag back to
the host. ICP's per-iteration residual pass and 6×6 reduction is kernel K1
(ops/kernels/icp.py); the damped solves, pose updates and accept/reject
logic stay in PyTorch on [6, 6] / [6] / [4, 4] tensors.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from infinitam_tpu_torch.config import TrackingParams
from infinitam_tpu_torch.ops import color_tracking as ct
from infinitam_tpu_torch.ops import icp
from infinitam_tpu_torch.ops import ren_tracking as rt
from infinitam_tpu_torch.ops.kernels import icp as icp_kernel
from infinitam_tpu_torch.ops.pyramid import build_depth_pyramid, build_rgb_pyramid, gradient_x, gradient_y
from infinitam_tpu_torch.utils import se3


class TrackResult(NamedTuple):
    pose: torch.Tensor  # [4,4] world→camera
    f: torch.Tensor  # final energy at the finest level
    num_valid: torch.Tensor  # int32 valid points at the finest level


def level_modes(params: TrackingParams) -> List[str]:
    """Iteration type per level, index 0 = finest: both at the fine levels,
    rotation only at the `n_rotation_only_levels` coarsest."""
    return [
        icp.MODE_ROTATION if lvl >= params.n_levels - params.n_rotation_only_levels else icp.MODE_BOTH
        for lvl in range(params.n_levels)
    ]


def level_dist_thresh(params: TrackingParams) -> List[float]:
    """Per-level ICP gate, index 0 = finest: coarsest = dist_thresh, each
    finer level subtracts dist_thresh / n_levels."""
    n = params.n_levels
    step = params.dist_thresh / n
    out = [0.0] * n
    out[n - 1] = params.dist_thresh
    for lvl in range(n - 2, -1, -1):
        out[lvl] = out[lvl + 1] - step
    return out


def level_iterations(params: TrackingParams) -> List[int]:
    """Iterations per level, index 0 = finest; missing entries extend by +2."""
    out = list(params.iterations_per_level[: params.n_levels])
    while len(out) < params.n_levels:
        out.append((out[-1] if out else 0) + 2)
    return out


def scale_proj(proj: torch.Tensor, level: int) -> torch.Tensor:
    """Intrinsics at a pyramid level (halved per level)."""
    return proj * (0.5**level)


def weight_pyramid(sigma: torch.Tensor, n_levels: int) -> List[torch.Tensor]:
    """Per-level ICP weights from the view's σ_z map (reference
    ITMWeightedICPTracker_CPU.cpp:43): σ subsampled with holes, then
    ω = minσ/σ·0.5 + 0.5 ∈ (0.5, 1] where σ > 0, else 0; minσ is the level's
    least positive σ, a device reduction (no host read)."""
    sigma_pyr = build_depth_pyramid(sigma, n_levels)  # hole-aware 2× subsamples
    out = []
    for sig in sigma_pyr:
        pos = sig > 0
        min_sigma = torch.where(pos, sig, torch.full_like(sig, float("inf"))).amin()
        w = min_sigma / sig.clamp(min=1e-12) * 0.5 + 0.5
        out.append(torch.where(pos, w, torch.zeros_like(w)))
    return out


def track_depth(
    pose: torch.Tensor,  # [4,4] world→camera initial estimate
    depth: torch.Tensor,  # [H, W] metric depth, −1 invalid
    view_proj: torch.Tensor,  # (fx, fy, cx, cy) of the depth camera
    points_map: torch.Tensor,  # [H, W, 4] raycast scene points (metres)
    normals_map: torch.Tensor,  # [H, W, 4]
    scene_pose: torch.Tensor,  # [4,4] world→camera of the raycast maps
    params: TrackingParams,
    weights_map: Optional[torch.Tensor] = None,  # [H, W] σ_z of the view (weighted ICP)
) -> TrackResult:
    """Coarse→fine point-to-plane ICP with Levenberg accept/reject. The scene
    maps stay at full resolution for every level; only the view depth is
    subsampled (reference ITMDepthTracker.cpp:62-76). With `weights_map`
    each level's reduction is weighted per pixel (`weight_pyramid`)."""
    modes = level_modes(params)
    dists = level_dist_thresh(params)
    iters = level_iterations(params)
    depth_pyr = build_depth_pyramid(depth, params.n_levels)
    weight_pyr = [None] * params.n_levels if weights_map is None else weight_pyramid(weights_map, params.n_levels)
    dev = depth.device

    inv_pose = se3.invert(pose)
    f_final = torch.full((), 1e5, dtype=torch.float32, device=dev)
    n_final = torch.zeros((), dtype=torch.int32, device=dev)

    for lvl in range(params.n_levels - 1, params.no_icp_run_till_level - 1, -1):
        mode = modes[lvl]
        d_lvl = depth_pyr[lvl]
        vproj = scale_proj(view_proj, lvl)

        ip = inv_pose
        ip_good = inv_pose
        f_old = torch.full((), 1e20, dtype=torch.float32, device=dev)
        h_good = torch.zeros((6, 6), dtype=torch.float32, device=dev)
        g_good = torch.zeros((6,), dtype=torch.float32, device=dev)
        lam = torch.ones((), dtype=torch.float32, device=dev)
        done = torch.zeros((), dtype=torch.bool, device=dev)
        f_last = torch.full((), 1e5, dtype=torch.float32, device=dev)
        n_last = torch.zeros((), dtype=torch.int32, device=dev)

        for _ in range(iters[lvl]):
            gh = icp_kernel.icp_gh(
                d_lvl, vproj, points_map, normals_map,
                view_proj,  # scene maps are full resolution → level-0 intrinsics
                ip, scene_pose, dists[lvl], params.min_valid_points, weights=weight_pyr[lvl],
            )
            reject = (gh.num_valid <= 0) | (gh.f > f_old)
            nv = gh.num_valid.clamp(min=1).to(torch.float32)
            h_new = torch.where(reject, h_good, gh.hessian / nv)
            g_new = torch.where(reject, g_good, gh.nabla / nv)
            f_old_new = torch.where(reject, f_old, gh.f)
            lam_new = torch.where(reject, lam * 10.0, lam / 10.0)
            ip_base = torch.where(reject, ip_good, ip)

            step = icp.solve_delta(g_new, h_new, lam_new, mode)
            new_ip = se3.coerce(icp.apply_delta(ip_base, step))
            converged = icp.has_converged(step, params.termination_threshold)

            # a converged level keeps its state (the reference breaks out)
            frozen = done
            ip = torch.where(frozen, ip, new_ip)
            ip_good = torch.where(frozen, ip_good, ip_base)
            f_old = torch.where(frozen, f_old, f_old_new)
            h_good = torch.where(frozen, h_good, h_new)
            g_good = torch.where(frozen, g_good, g_new)
            lam = torch.where(frozen, lam, lam_new)
            f_last = torch.where(frozen, f_last, gh.f)
            n_last = torch.where(frozen, n_last, gh.num_valid)
            done = done | converged

        # the level hands its current pose to the next level
        inv_pose = ip
        f_final = f_last
        n_final = n_last

    return TrackResult(pose=se3.invert(se3.coerce(inv_pose)), f=f_final, num_valid=n_final)


# colour tracker LM constants (reference ITMColorTracker.cpp minimizeLM; the
# JAX package caps the steps per level at 50)
COLOR_MAX_STEPS = 50
COLOR_MIN_STEP = 5e-5
COLOR_MIN_DECREASE = 1e-5
COLOR_G1, COLOR_G2 = 0.75, 0.25


def track_color(
    pose: torch.Tensor,  # [4,4] world→depth camera (pose_d)
    rgb: torch.Tensor,  # [H, W, 3] observed rgb, 0..1
    proj_rgb: torch.Tensor,  # rgb intrinsics (level 0)
    locations: torch.Tensor,  # [Hs, Ws, 4] point-cloud world positions (w = ±1)
    colours: torch.Tensor,  # [Hs, Ws, 4] known colours (w = ±1)
    depth_to_rgb: torch.Tensor,  # [4,4] extrinsic (rgb_to_depth⁻¹)
    rgb_to_depth: torch.Tensor,  # [4,4] extrinsic
    params: TrackingParams,
    skip_points: bool = True,
) -> TrackResult:
    """Photometric LM tracker with trust-region λ control (reference
    minimizeLM: γ₁ = .75 / γ₂ = .25, λ ÷2 / ×4, MIN_STEP 5e-5, MIN_DECREASE
    1e-5), coarse→fine over an rgb pyramid against the full-resolution point
    cloud; the pose is optimised in the RGB frame (depth_to_rgb · pose).
    Each level runs COLOR_MAX_STEPS steps and freezes its state once done,
    as the JAX package's while_loop stops."""
    dev = rgb.device
    pyr = build_rgb_pyramid(rgb, params.color_n_levels)
    if skip_points:
        locations, colours = locations[::2, ::2], colours[::2, ::2]
    diag_idx = torch.eye(6, dtype=torch.bool, device=dev)

    M = depth_to_rgb @ pose
    f_last = torch.full((), 1e5, dtype=torch.float32, device=dev)
    for lvl in range(params.color_n_levels - 1, -1, -1):
        img = pyr[lvl]
        gx, gy = gradient_x(img), gradient_y(img)
        proj_l = proj_rgb * (0.5**lvl)
        f = torch.full((), float("inf"), dtype=torch.float32, device=dev)
        lam = torch.full((), 0.01, dtype=torch.float32, device=dev)
        done = torch.zeros((), dtype=torch.bool, device=dev)
        for _ in range(COLOR_MAX_STEPS):
            gh = ct.color_g(locations, colours, img, gx, gy, proj_l, M)
            d = torch.diagonal(gh.hessian)
            scaled = torch.where(d.abs() >= 1e-15, d * (1.0 + lam), lam * 1e-10)
            A = torch.where(diag_idx, torch.diag_embed(scaled), gh.hessian)
            step = -icp.solve_psd(A, gh.nabla)
            small = step.abs().amax() < COLOR_MIN_STEP

            M2 = se3.coerce(se3.se3_exp(step) @ M)
            f2, _n = ct.color_f(locations, colours, img, proj_l, M2)
            pred = -(gh.nabla @ step + 0.5 * step @ gh.hessian @ step)
            rho = (gh.f - f2) / torch.where(pred.abs() < 1e-20, torch.full_like(pred, 1e-20), pred.abs())
            success = rho > COLOR_G2
            lam_new = torch.where(rho > COLOR_G1, lam / 2.0, torch.where(success, lam, lam * 4.0))
            no_decrease = ~(f2 < gh.f - gh.f.abs() * COLOR_MIN_DECREASE)
            accept = success & ~small

            M = torch.where(done, M, torch.where(accept, M2, M))
            f = torch.where(done, f, torch.where(accept, f2, gh.f))
            lam = torch.where(done, lam, lam_new)
            done = done | small | (success & no_decrease)
        f_last = f

    n_last = (locations[..., 3] > 0).sum(dtype=torch.int32)
    return TrackResult(pose=se3.coerce(rgb_to_depth @ M), f=f_last, num_valid=n_last)


# Ren LM constants (reference ITMRenTracker.cpp:106-160; the JAX package
# caps the steps at 30)
REN_MAX_STEPS = 30
REN_MIN_STEP = 5e-5
REN_MIN_DECREASE = 1e-4


def track_ren(
    pose: torch.Tensor,  # [4,4] world→camera initial estimate
    depth: torch.Tensor,  # [H, W] metric depth
    proj: torch.Tensor,
    read,  # voxel SDF reader (int pts → (sdf, found))
    voxel_size: float,
    params: TrackingParams,
    max_steps: int = REN_MAX_STEPS,
) -> TrackResult:
    """Ren et al. SDF tracker: LM on the exp-SDF energy with MRP rotations
    at the finest level, as a refinement after ICP (reference
    ITMRenTracker.cpp:106-160: λ ×0.1 on accept, ×10 on reject, MIN_STEP
    5e-5, relative MIN_DECREASE 1e-4; the JAX package starts λ at 1).
    `max_steps` steps, each frozen once the LM is done, as the JAX
    package's while_loop stops; nothing is read back."""
    del params  # the JAX package's signature: the Ren LM has no tracking parameters
    dev = depth.device
    one_over_voxel = 1.0 / voxel_size
    diag_idx = torch.eye(6, dtype=torch.bool, device=dev)
    pts_cam = rt.unproject_view(depth, proj)
    inv = se3.invert(pose)
    f = rt.energy(read, pts_cam, inv, one_over_voxel)
    lam = torch.ones((), dtype=torch.float32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(max_steps):
        nabla, H = rt.gradient_hessian(read, pts_cam, inv, one_over_voxel)
        d = torch.diagonal(H)
        scaled = torch.where(d.abs() >= 1e-15, d * (1.0 + lam), lam * 1e-10)
        step = -icp.solve_psd(torch.where(diag_idx, torch.diag_embed(scaled), H), nabla)
        small = step.abs().amax() < REN_MIN_STEP

        inv2 = se3.coerce(rt.delta_matrix(step) @ inv)
        f2 = rt.energy(read, pts_cam, inv2, one_over_voxel)
        accept = f2 < f
        tiny = (f2 - f).abs() / f.abs().clamp(min=1e-12) < REN_MIN_DECREASE
        take = ~done & accept & ~small
        inv = torch.where(take, inv2, inv)
        f = torch.where(take, f2, f)
        lam = torch.where(done, lam, torch.where(accept, lam * 0.1, lam * 10.0))
        done = done | small | (accept & tiny)
    return TrackResult(pose=se3.invert(se3.coerce(inv)), f=f, num_valid=(depth > 0).sum(dtype=torch.int32))


def track_external(pose: torch.Tensor, external_pose: torch.Tensor) -> TrackResult:
    """External pose injection: the tracker passes the given pose through
    (reference ITMExternalTracker.cpp:27-30)."""
    del pose
    dev = external_pose.device
    return TrackResult(pose=external_pose, f=torch.zeros((), dtype=torch.float32, device=dev),
                       num_valid=torch.zeros((), dtype=torch.int32, device=dev))


def apply_imu_rotation(pose: torch.Tensor, delta_rot: torch.Tensor) -> torch.Tensor:
    """Pre-rotate the pose by a differential IMU rotation before ICP
    (reference ITMIMUTracker.cpp:17-22, the IMU→ICP composite)."""
    return se3.coerce(se3.pack_rt(pose[:3, :3] @ delta_rot, pose[:3, 3]))


def track_far_from_point_cloud(pose: torch.Tensor, pose_point_cloud: torch.Tensor, age: torch.Tensor) -> torch.Tensor:
    """Whether the tracking maps need a full raycast (reference
    ITMTrackingState::TrackerFarFromPointCloud: older than 5 frames, or the
    camera moved more than 0.0224 m since the last raycast); a device bool."""
    t1 = se3.invert(pose)[:3, 3]
    t2 = se3.invert(pose_point_cloud)[:3, 3]
    return (age > 5) | (torch.linalg.vector_norm(t1 - t2) > 0.02236068)
