"""Point-to-plane ICP: per-pixel residuals/Jacobians + Gauss-Newton helpers.

Counterpart of infinitam_tpu/ops/icp.py (reference: ITMDepthTracker.h:8-105,
ITMDepthTracker_CPU.cpp ComputeGandH, ITMDepthTracker.cpp ComputeDelta /
ApplyDelta). `compute_residuals` + `reduce_gh` is the plain version of kernel
K1 (ops/kernels/icp.py), which fuses both. The Gauss-Newton state is plain
[6, 6] / [6] / [4, 4] tensors; nothing here reads a value back to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from infinitam_tpu_torch.ops.pixel import bilinear_with_holes_vec
from infinitam_tpu_torch.utils import se3

MODE_ROTATION = "rotation"
MODE_TRANSLATION = "translation"
MODE_BOTH = "both"


class GHResult(NamedTuple):
    f: torch.Tensor  # scalar: √(Σb²)/N, or 1e5 when N ≤ min_valid
    nabla: torch.Tensor  # [6]
    hessian: torch.Tensor  # [6, 6]
    num_valid: torch.Tensor  # scalar int32


def compute_residuals(
    depth: torch.Tensor,  # [H, W] metric depth at the current pyramid level
    view_proj: torch.Tensor,  # (fx, fy, cx, cy) at this level
    points_map: torch.Tensor,  # [Hs, Ws, 4] scene points (metres, w=±1)
    normals_map: torch.Tensor,  # [Hs, Ws, 4] scene normals
    scene_proj: torch.Tensor,  # (fx, fy, cx, cy) of the maps
    approx_inv_pose: torch.Tensor,  # [4,4] camera→world, current estimate
    scene_pose: torch.Tensor,  # [4,4] world→camera of the raycast maps
    dist_thresh: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """All-pixel residuals b [H,W], Jacobian rows A [H,W,6] (A[0:3] = n×p,
    A[3:6] = n), valid mask and world point p [H,W,3]."""
    H, W = depth.shape
    Hs, Ws = points_map.shape[:2]
    dev = depth.device
    vfx, vfy, vcx, vcy = view_proj[0], view_proj[1], view_proj[2], view_proj[3]
    sfx, sfy, scx, scy = scene_proj[0], scene_proj[1], scene_proj[2], scene_proj[3]

    valid = depth > 1e-8
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    d = torch.where(valid, depth, torch.ones_like(depth))
    px, py, pz = se3.apply_planes(approx_inv_pose, d * (xs - vcx) / vfx, d * (ys - vcy) / vfy, d)
    qx, qy, qz = se3.apply_planes(scene_pose, px, py, pz)
    valid = valid & (qz > 0)
    zs = torch.where(valid, qz, torch.ones_like(qz))
    u = sfx * qx / zs + scx
    v = sfy * qy / zs + scy
    valid = valid & (u >= 0) & (u <= Ws - 2) & (v >= 0) & (v <= Hs - 2)

    uc = u.clamp(0.0, Ws - 2.0)
    vc = v.clamp(0.0, Hs - 2.0)
    target_pt, pt_ok = bilinear_with_holes_vec(points_map, uc, vc)
    valid = valid & pt_ok

    dx = target_pt[..., 0] - px
    dy = target_pt[..., 1] - py
    dz = target_pt[..., 2] - pz
    valid = valid & (dx * dx + dy * dy + dz * dz <= dist_thresh)

    # the normals' own hole flag is not consulted (reference parity)
    target_n, _n_ok = bilinear_with_holes_vec(normals_map, uc, vc)
    nx, ny, nz = target_n[..., 0], target_n[..., 1], target_n[..., 2]

    b = nx * dx + ny * dy + nz * dz
    A = torch.stack(
        [ny * pz - nz * py, nz * px - nx * pz, nx * py - ny * px, nx, ny, nz], dim=-1
    )
    return b, A, valid, torch.stack([px, py, pz], dim=-1)


def gh_from_sums(
    hessian: torch.Tensor, nabla: torch.Tensor, sum_f: torch.Tensor, n_valid: torch.Tensor, min_valid: int
) -> GHResult:
    """The reference's energy rule on reduced sums: f = √|Σb²|/N when
    N > min_valid, else the 1e5 divergence sentinel."""
    n_valid = n_valid.to(torch.int32)
    f = torch.where(
        n_valid > min_valid,
        torch.sqrt(torch.abs(sum_f)) / n_valid.clamp(min=1),
        torch.full_like(sum_f, 1e5),
    )
    return GHResult(f=f, nabla=nabla, hessian=hessian, num_valid=n_valid)


def reduce_gh(b: torch.Tensor, A: torch.Tensor, valid: torch.Tensor, min_valid: int = 100,
              weights: Optional[torch.Tensor] = None) -> GHResult:
    """Normal-equation reduction over the valid pixels v: H = Σ AAᵀ,
    ∇ = Σ bA. With per-pixel `weights` ω (the weighted ICP tracker) the
    JAX package's sums, quirks included: H = Σ (vωA)(vωA)ᵀ (ω² on H),
    ∇ = Σ (vb)(vωA) (ω once), Σ(vωb)² for f, and N = Σ v unweighted."""
    v = valid.to(b.dtype).reshape(-1)
    w = v if weights is None else v * weights.reshape(-1)
    Af = A.reshape(-1, 6) * w[:, None]
    bf = b.reshape(-1) * w
    hessian = Af.T @ Af
    nabla = (bf if weights is None else b.reshape(-1) * v) @ Af
    return gh_from_sums(hessian, nabla, torch.sum(bf * bf), valid.sum(), min_valid)


def solve_delta(nabla: torch.Tensor, hessian: torch.Tensor, lam: torch.Tensor, mode: str) -> torch.Tensor:
    """Levenberg-damped Cholesky solve → step[6] (step[0:3] rotation,
    step[3:6] translation); a zero step when the system is not positive
    definite or the solution is not finite (reference: ComputeDelta)."""
    idx = {MODE_BOTH: slice(0, 6), MODE_ROTATION: slice(0, 3), MODE_TRANSLATION: slice(3, 6)}[mode]
    sub = hessian[idx, idx]
    g = nabla[idx]
    eye = torch.eye(sub.shape[0], dtype=sub.dtype, device=sub.device)
    x = solve_psd(sub * (1.0 + lam * eye), g)
    # the free half of a rotation- or translation-only step is zero (built
    # out of place, so that the step also runs under torch.vmap)
    if mode == MODE_ROTATION:
        return torch.cat([x, torch.zeros_like(x)])
    if mode == MODE_TRANSLATION:
        return torch.cat([torch.zeros_like(x), x])
    return x


def solve_psd(A: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x with A x = g by Cholesky, or zeros when A is not positive definite
    or x is not finite (the JAX package's `_solve_psd` guard), with no host
    sync; shared by the ICP and colour trackers."""
    L, info = torch.linalg.cholesky_ex(A)
    y = torch.linalg.solve_triangular(L, g[:, None], upper=False)
    x = torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]
    ok = (info == 0) & torch.isfinite(x).all()
    return torch.where(ok, x, torch.zeros_like(x))


def apply_delta(approx_inv_pose: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """Left-multiply the small-angle increment onto the camera→world pose
    (reference: ApplyDelta; Tinc rows [1, w2, −w1 | t0], [−w2, 1, w0 | t1],
    [w1, −w0, 1 | t2])."""
    w0, w1, w2, t0, t1, t2 = step.unbind(0)
    one = torch.ones_like(w0)
    zero = torch.zeros_like(w0)
    tinc = torch.stack(
        [
            torch.stack([one, w2, -w1, t0]),
            torch.stack([-w2, one, w0, t1]),
            torch.stack([w1, -w0, one, t2]),
            torch.stack([zero, zero, zero, one]),
        ]
    )
    return tinc @ approx_inv_pose


def has_converged(step: torch.Tensor, threshold: float) -> torch.Tensor:
    """|step|/6 < threshold (reference: HasConverged)."""
    return torch.sqrt(torch.sum(step * step)) / 6.0 < threshold
