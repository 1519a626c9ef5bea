"""K1: ICP residuals fused with the 6×6 normal-equation reduction.

Replaces the Pallas kernel infinitam_tpu/ops/pallas/icp_kernel.py
(`residuals_tiles`, whose 6×6 reduction ran outside the kernel). The CUDA
kernel (csrc/icp.cu) computes `ops/icp.py::compute_residuals` per view pixel,
reduces H = ΣAAᵀ, ∇ = ΣbA, Σb² and the valid count, and applies
`icp.gh_from_sums` in one launch: its last CTA sums the CTAs' partials in a
fixed order in double, so a run is reproducible. Its plain twin is
`compute_residuals` + `reduce_gh`. With a per-pixel weight map (the weighted
ICP tracker) the same call launches the kernel's weighted variant, counted
apart as "icp_weighted", and its twin is `reduce_gh(weights=)`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from infinitam_tpu_torch.ops import icp
from infinitam_tpu_torch.ops.kernels import build

THREADS = 256  # threads per CTA (csrc/icp.cu ICP_THREADS)
CTAS_PER_SM = 2  # the grid's cap: a few hundred partials for the last CTA to sum
N_SUMS = 29  # 21 upper-triangle H terms, 6 ∇ terms, Σb², count
N_OUT = 44  # H [6×6] row-major, ∇ [6], f, N (int32 bits)


def icp_gh_plain(depth, view_proj, points_map, normals_map, scene_proj, approx_inv_pose, scene_pose,
                 dist_thresh: float, min_valid: int, weights=None) -> icp.GHResult:
    """The plain version: per-pixel residuals, then the masked (and, with
    `weights` [h, w], weighted) reduction."""
    b, A, valid, _p = icp.compute_residuals(
        depth, view_proj, points_map, normals_map, scene_proj, approx_inv_pose, scene_pose, dist_thresh
    )
    return icp.reduce_gh(b, A, valid, min_valid, weights=weights)


def gh_from_buffer(out: torch.Tensor) -> icp.GHResult:
    """The GHResult the kernel writes into `out` [44]: views, no copies."""
    return icp.GHResult(f=out[42], nabla=out[36:42], hessian=out[:36].view(6, 6),
                        num_valid=out[43:].view(torch.int32)[0])


@functools.cache
def _counter(index: int, stream: int) -> torch.Tensor:
    """The ticket counter for the kernel's last-CTA sum, one per device and
    stream: launches on one stream run one after another, so no two share a
    counter. Zeroed once here, and every launch leaves it at 0. torch hands
    out streams from a fixed pool per device, so the cache stays small."""
    return torch.zeros((1,), dtype=torch.int32, device=torch.device("cuda", index))


@functools.cache
def _max_ctas(index: int) -> int:
    return CTAS_PER_SM * torch.cuda.get_device_properties(index).multi_processor_count


def icp_gh_cuda(depth, view_proj, points_map, normals_map, scene_proj, approx_inv_pose, scene_pose,
                dist_thresh: float, min_valid: int, weights=None) -> icp.GHResult:
    """Launch K1 (its weighted variant when `weights` is given): one kernel,
    and no other device op."""
    dev = depth.device
    h, w = depth.shape
    hs, ws = points_map.shape[:2]
    if points_map.shape != (hs, ws, 4) or normals_map.shape != (hs, ws, 4):
        raise ValueError("icp: maps must be [H, W, 4]")
    if view_proj.shape != (4,) or scene_proj.shape != (4,):
        raise ValueError("icp: intrinsics must be (fx, fy, cx, cy)")
    if approx_inv_pose.shape != (4, 4) or scene_pose.shape != (4, 4):
        raise ValueError("icp: poses must be [4, 4]")
    tensors = (depth, points_map, normals_map, view_proj, scene_proj, approx_inv_pose, scene_pose)
    if weights is not None:
        if weights.shape != (h, w):
            raise ValueError("icp: weights must be [H, W] like the depth")
        tensors += (weights,)
    for t in tensors:
        build.require_dtype("icp", t, torch.float32)
    build.require_cuda("icp", *tensors, device=dev)
    n_ctas = max(1, min((h * w + THREADS - 1) // THREADS, _max_ctas(dev.index)))
    partial = torch.empty((n_ctas, N_SUMS), dtype=torch.float32, device=dev)
    out = torch.empty((N_OUT,), dtype=torch.float32, device=dev)
    stream = build.stream_ptr()
    w_ptr = None if weights is None else weights.data_ptr()
    err = build.library().itpu_icp_gh(
        depth.data_ptr(), w_ptr, h, w, points_map.data_ptr(), normals_map.data_ptr(), hs, ws,
        view_proj.data_ptr(), scene_proj.data_ptr(), approx_inv_pose.data_ptr(), scene_pose.data_ptr(),
        ctypes.c_float(dist_thresh), int(min_valid), n_ctas, partial.data_ptr(), _counter(dev.index, stream).data_ptr(),
        out.data_ptr(), stream,
    )
    build.check("itpu_icp_gh", err)
    build.count_launch("icp" if weights is None else "icp_weighted")
    return gh_from_buffer(out)


def icp_gh(depth, view_proj, points_map, normals_map, scene_proj, approx_inv_pose, scene_pose,
           dist_thresh: float, min_valid: int, weights=None) -> icp.GHResult:
    """GHResult of one Gauss-Newton iteration, weighted per pixel when
    `weights` [h, w] is given: the plain version for CPU tensors, kernel K1
    for CUDA tensors."""
    fn = icp_gh_plain if depth.device.type == "cpu" else icp_gh_cuda
    return fn(depth, view_proj, points_map, normals_map, scene_proj, approx_inv_pose, scene_pose, dist_thresh,
              min_valid, weights=weights)
