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

The launch is the custom op `itpu::icp_gh`, which returns the 43-word
result buffer and the count. Under `torch.vmap` its vmap rule launches the
kernel once for all B lanes (grid (n_ctas, B), a ticket counter a lane;
every lane sums its partials in the same fixed order, so a lane's result
is bit-identical to a single-lane launch on its inputs); on the CPU it runs
the plain version lane by lane.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional, Tuple

import torch

from infinitam_tpu_torch.ops import icp
from infinitam_tpu_torch.ops.kernels import build

THREADS = 256  # threads per CTA (csrc/icp.cu ICP_THREADS)
CTAS_PER_SM = 2  # the grid's cap: a few hundred partials for the last CTA to sum
N_SUMS = 29  # 21 upper-triangle H terms, 6 ∇ terms, Σb², count
N_OUT = 43  # H [6×6] row-major, ∇ [6], f; the count N in an int32 word of its own


def icp_gh_plain(depth, view_proj, points_map, normals_map, scene_proj, approx_inv_pose, scene_pose,
                 dist_thresh: float, min_valid: int, weights=None) -> icp.GHResult:
    """The plain version: per-pixel residuals, then the masked (and, with
    `weights` [h, w], weighted) reduction."""
    b, A, valid, _p = icp.compute_residuals(
        depth, view_proj, points_map, normals_map, scene_proj, approx_inv_pose, scene_pose, dist_thresh
    )
    return icp.reduce_gh(b, A, valid, min_valid, weights=weights)


def gh_from_buffer(out: torch.Tensor, count: torch.Tensor) -> icp.GHResult:
    """The GHResult the kernel writes into `out` [43] and `count` (int32,
    0-dim): views, no copies."""
    return icp.GHResult(f=out[42], nabla=out[36:42], hessian=out[:36].view(6, 6), num_valid=count)


def buffer_from_gh(gh: icp.GHResult):
    """(out [43], count) of a GHResult, the layout the kernel writes."""
    return torch.cat([gh.hessian.reshape(36), gh.nabla, gh.f.reshape(1)]), gh.num_valid.to(torch.int32)


@functools.cache
def _counter(index: int, stream: int, n_lanes: int) -> torch.Tensor:
    """The ticket counters for the kernel's last-CTA sum, one a lane, per
    device, stream and lane count: launches on one stream run one after
    another, so no two share a counter. Zeroed once here, and every launch
    leaves them at 0. torch hands out streams from a fixed pool per device,
    so the cache stays small."""
    return torch.zeros((n_lanes,), dtype=torch.int32, device=torch.device("cuda", index))


# K1's ticket counters inside a graph's warm-up and capture ((device, lanes) →
# counter), set by graph_counters; None outside them
_graph_counters: Optional[dict] = None


@contextlib.contextmanager
def graph_counters(counters: dict):
    """Inside the block K1 takes its ticket counters from `counters`, a
    captured graph's own (engine/captured.py), made in the graph's warm-up:
    a counter made during capture would be a node of the graph, and an
    eager launch on the capture stream would share the stream's counter
    with the replays."""
    global _graph_counters
    prev, _graph_counters = _graph_counters, counters
    try:
        yield
    finally:
        _graph_counters = prev


def _ticket_counter(index: int, stream: int, n_lanes: int) -> torch.Tensor:
    if _graph_counters is None:
        return _counter(index, stream, n_lanes)
    c = _graph_counters.get((index, n_lanes))
    if c is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("icp: a graph's ticket counters are made in its warm-up, not during capture")
        c = _graph_counters[(index, n_lanes)] = torch.zeros((n_lanes,), dtype=torch.int32,
                                                            device=torch.device("cuda", index))
    return c


@functools.cache
def _max_ctas(index: int) -> int:
    return CTAS_PER_SM * torch.cuda.get_device_properties(index).multi_processor_count


def _launch(n_lanes: int, depth, view_proj, points_map, normals_map, scene_proj, approx_inv_pose, scene_pose,
            weights, dist_thresh: float, min_valid: int):
    """One launch of K1 (its weighted variant when `weights` holds a map)
    for `n_lanes` lanes, each tensor argument a build.LaneArg. Returns the
    lanes' buffers [B, 43] and counts [B]."""
    d0 = depth.lane(0)
    dev = d0.device
    h, w = d0.shape
    pm, nm = points_map.lane(0), normals_map.lane(0)
    hs, ws = pm.shape[:2]
    if pm.shape != (hs, ws, 4) or nm.shape != (hs, ws, 4):
        raise ValueError("icp: maps must be [H, W, 4]")
    if view_proj.lane(0).shape != (4,) or scene_proj.lane(0).shape != (4,):
        raise ValueError("icp: intrinsics must be (fx, fy, cx, cy)")
    if approx_inv_pose.lane(0).shape != (4, 4) or scene_pose.lane(0).shape != (4, 4):
        raise ValueError("icp: poses must be [4, 4]")
    args = [depth, weights, points_map, normals_map, view_proj, scene_proj, approx_inv_pose, scene_pose]
    tensors = [a.lane(0) for a in args if a.t is not None]
    if weights.t is not None and weights.lane(0).shape != (h, w):
        raise ValueError("icp: weights must be [H, W] like the depth")
    for t in tensors:
        build.require_dtype("icp", t, torch.float32)
    build.require_cuda("icp", *tensors, device=dev)
    n_ctas = max(1, min((h * w + THREADS - 1) // THREADS, _max_ctas(dev.index)))
    partial = torch.empty((n_lanes, n_ctas, N_SUMS), dtype=torch.float32, device=dev)
    out = torch.empty((n_lanes, N_OUT), dtype=torch.float32, device=dev)
    count = torch.empty((n_lanes,), dtype=torch.int32, device=dev)
    stream = build.stream_ptr()
    err = build.library().itpu_icp_gh(
        depth.ptr(), weights.ptr(), h, w, points_map.ptr(), normals_map.ptr(), hs, ws,
        view_proj.ptr(), scene_proj.ptr(), approx_inv_pose.ptr(), scene_pose.ptr(),
        ctypes.c_float(dist_thresh), int(min_valid), n_ctas, partial.data_ptr(),
        _ticket_counter(dev.index, stream, n_lanes).data_ptr(), out.data_ptr(), count.data_ptr(), n_lanes,
        build.lane_strides(args), stream,
    )
    build.check("itpu_icp_gh", err)
    build.count_launch("icp" if weights.t is None else "icp_weighted")
    return out, count


def icp_gh_cuda(depth, view_proj, points_map, normals_map, scene_proj, approx_inv_pose, scene_pose,
                dist_thresh: float, min_valid: int, weights=None) -> icp.GHResult:
    """Launch K1 for one lane (its weighted variant when `weights` is
    given): one kernel, and no other device op."""
    out, count = _launch(1, *build.single(depth, view_proj, points_map, normals_map, scene_proj, approx_inv_pose,
                                          scene_pose, weights), dist_thresh, min_valid)
    return gh_from_buffer(out[0], count[0])


@torch.library.custom_op("itpu::icp_gh", mutates_args=())
def icp_gh_op(depth: torch.Tensor, view_proj: torch.Tensor, points_map: torch.Tensor, normals_map: torch.Tensor,
              scene_proj: torch.Tensor, approx_inv_pose: torch.Tensor, scene_pose: torch.Tensor,
              weights: Optional[torch.Tensor], dist_thresh: float,
              min_valid: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One lane's 43-word GH buffer and its count: the plain version for CPU
    tensors, K1 for CUDA tensors."""
    args = (depth, view_proj, points_map, normals_map, scene_proj, approx_inv_pose, scene_pose)
    if depth.device.type == "cpu":
        return buffer_from_gh(icp_gh_plain(*args, dist_thresh, min_valid, weights=weights))
    out, count = _launch(1, *build.single(*args, weights), dist_thresh, min_valid)
    return out.reshape(N_OUT), count.reshape(())


@icp_gh_op.register_vmap
def _icp_gh_vmap(info, in_dims, depth, view_proj, points_map, normals_map, scene_proj, approx_inv_pose, scene_pose,
                 weights, dist_thresh, min_valid):
    """B lanes: one K1 launch on the card; the plain version lane by lane on
    the CPU. An argument with no batch dim is shared (stride 0)."""
    lanes, _backs = build.vmap_lanes(
        in_dims[:8], (depth, view_proj, points_map, normals_map, scene_proj, approx_inv_pose, scene_pose, weights))
    B = info.batch_size
    if depth.device.type == "cpu":
        outs = [icp_gh_op(*(a.lane(b) for a in lanes), dist_thresh, min_valid) for b in range(B)]
        return (torch.stack([o for o, _n in outs]), torch.stack([n for _o, n in outs])), (0, 0)
    return _launch(B, *lanes, dist_thresh, min_valid), (0, 0)


def icp_gh(depth, view_proj, points_map, normals_map, scene_proj, approx_inv_pose, scene_pose,
           dist_thresh: float, min_valid: int, weights=None) -> icp.GHResult:
    """GHResult of one Gauss-Newton iteration, weighted per pixel when
    `weights` [h, w] is given: the plain version for CPU tensors, kernel K1
    for CUDA tensors (through `itpu::icp_gh`, so that `torch.vmap` batches
    it into one launch)."""
    return gh_from_buffer(*icp_gh_op(depth, view_proj, points_map, normals_map, scene_proj, approx_inv_pose,
                                     scene_pose, weights, float(dist_thresh), int(min_valid)))
