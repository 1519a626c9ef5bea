"""Spatial-hash primitives for the voxel-block-hash world model.

Counterpart of infinitam_tpu/ops/hashing.py (reference:
DeviceAgnostic/ITMRepresentationAccess.h:8-20 hashIndex / pointToVoxelBlockPos,
and the allocation ray march of ITMSceneReconstructionEngine.h:141-241).

Also home of the two scatter forms the port uses in place of JAX's
`.at[idx].set(v, mode="drop")` and `jnp.nonzero(size=K)`: `scatter_drop`
and `compact_by_mask`. Neither reads a value back to the host, so both keep
the frame loop free of device→host syncs, and both write out of place, so
they also run under `torch.vmap` with a batched index into a buffer that
has no batch dim.
"""

from __future__ import annotations

from typing import Tuple

import torch

# reference hash constants (ITMRepresentationAccess.h:9)
_P1 = 73856093
_P2 = 19349669
_P3 = 83492791
_U32 = 0xFFFFFFFF


def scatter_drop(target: torch.Tensor, idx: torch.Tensor, values, reduce: str | None = None):
    """`target.at[idx].set(values, mode="drop")` along dim 0: indices outside
    [0, len) are dropped. Returns a new tensor; `target` is unchanged.

    Dropped writes land in a sink row appended for the call and sliced off,
    so the index tensor never has to be filtered (a boolean filter would sync
    with the host). Duplicate in-range indices keep one unspecified writer,
    as in JAX (on the card it varies from run to run), so a caller whose
    duplicates carry different values elects a winner first: `reduce` =
    "amin" / "amax" gives `.at[].min/.max`."""
    n = target.shape[0]
    ok = (idx >= 0) & (idx < n)
    ext = torch.cat([target, target[:1]])
    safe = torch.where(ok, idx, n).long()
    if not torch.is_tensor(values):
        values = torch.full(safe.shape + target.shape[1:], values, dtype=target.dtype, device=target.device)
    values = values.to(target.dtype).expand(safe.shape + target.shape[1:])
    if reduce is None:
        ext = ext.index_put((safe,), values)
    else:
        ext = ext.scatter_reduce(0, safe, values, reduce=reduce, include_self=True)
    return ext[:n]


def hash_index(block_pos: torch.Tensor, mask: int) -> torch.Tensor:
    """((73856093·x) ^ (19349669·y) ^ (83492791·z)) & mask in uint32
    arithmetic, done in int64 and masked to 32 bits. [..., 3] int → [...] int32."""
    p = block_pos.to(torch.int64) & _U32
    h = ((p[..., 0] * _P1) & _U32) ^ ((p[..., 1] * _P2) & _U32) ^ ((p[..., 2] * _P3) & _U32)
    return (h & mask).to(torch.int32)


def compact_by_mask(
    mask: torch.Tensor,  # [N] bool
    values: torch.Tensor,  # [N]
    size: int,
    fill,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stream compaction: the first `size` True positions' values, in order,
    padded with `fill` — the static-capacity cumsum + scatter of
    `jnp.nonzero(size=·)`. Returns ([size] values, total True count as an
    int32 tensor; the count may exceed `size`, the overflow is dropped)."""
    pos = torch.cumsum(mask.to(torch.int32), 0) - 1
    out = torch.full((size + 1,), fill, dtype=values.dtype, device=values.device)
    out = out.index_put((torch.where(mask & (pos < size), pos, size).long(),), values)
    return out[:size], mask.sum(dtype=torch.int32)


def point_to_block(point: torch.Tensor, block_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global voxel coords → (block coords, linear in-block index), floor
    division toward −∞ (reference pointToVoxelBlockPos). point: [..., 3] int32."""
    block = torch.div(point, block_size, rounding_mode="floor")
    local = point - block * block_size
    linear = local[..., 0] + local[..., 1] * block_size + local[..., 2] * (block_size * block_size)
    return block, linear


def blocks_on_ray_segment_planes(
    depth: torch.Tensor,  # [H, W] metric depth, −1 invalid
    proj: torch.Tensor,  # (fx, fy, cx, cy)
    inv_M: torch.Tensor,  # [4,4] camera→world
    mu: float,
    voxel_size: float,
    block_size: int,
    max_steps: int,
    view_frustum_min: float,
    view_frustum_max: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Candidate blocks touched by each pixel's ±mu ray-band segment, by an
    exact 3-D DDA with a static step count, as component planes.

    Returns (bx, by, bz, valid), each [max_steps, H·W] (int32 / bool)."""
    H, W = depth.shape
    N = H * W
    dev = depth.device
    fx, fy, cx, cy = proj[0], proj[1], proj[2], proj[3]
    one_over_block = 1.0 / (voxel_size * block_size)

    d2 = depth.reshape(-1)
    valid_px = (d2 > 0.0) & (d2 - mu >= view_frustum_min) & (d2 + mu <= view_frustum_max)
    d = torch.where(valid_px, d2, torch.ones_like(d2))

    xs = torch.arange(W, dtype=torch.float32, device=dev).repeat(H)
    ys = torch.arange(H, dtype=torch.float32, device=dev).repeat_interleave(W)
    pcx = (xs - cx) / fx * d
    pcy = (ys - cy) / fy * d
    pcz = d
    norm = torch.sqrt(pcx * pcx + pcy * pcy + pcz * pcz)
    sca_s = 1.0 - mu / norm
    sca_e = 1.0 + mu / norm

    R = inv_M[:3, :3]
    t = inv_M[:3, 3]

    def to_blocks(sca):
        px, py, pz = pcx * sca, pcy * sca, pcz * sca
        return tuple(
            (R[i, 0] * px + R[i, 1] * py + R[i, 2] * pz + t[i]) * one_over_block for i in range(3)
        )

    bs = to_blocks(sca_s)
    be = to_blocks(sca_e)
    seg = [e - s for e, s in zip(be, bs)]
    flat = [s.abs() < 1e-9 for s in seg]
    safe = [torch.where(f, torch.full_like(s, 1e-9), s) for f, s in zip(flat, seg)]
    sgn = [torch.sign(s).to(torch.int32) for s in seg]
    up = [(s > 0).to(torch.int32) for s in seg]

    blk = [torch.floor(b).to(torch.int32) for b in bs]
    tpar = torch.zeros((N,), dtype=torch.float32, device=dev)
    two = torch.full_like(tpar, 2.0)
    out_x, out_y, out_z, out_v = [], [], [], []
    for _ in range(max_steps):
        out_x.append(blk[0])
        out_y.append(blk[1])
        out_z.append(blk[2])
        out_v.append(valid_px & (tpar <= 1.0))
        ta = []
        for a in range(3):
            t_a = ((blk[a] + up[a]).to(torch.float32) - bs[a]) / safe[a]
            t_a = torch.where(flat[a], two, t_a)
            ta.append(torch.where(t_a <= tpar + 1e-7, two, t_a))
        t_next = torch.minimum(torch.minimum(ta[0], ta[1]), ta[2])
        blk = [blk[a] + torch.where(ta[a] <= t_next + 1e-9, sgn[a], 0) for a in range(3)]
        tpar = t_next
    return torch.stack(out_x), torch.stack(out_y), torch.stack(out_z), torch.stack(out_v)


def blocks_on_ray_segment(
    depth: torch.Tensor,  # [H, W] metric depth, −1 invalid
    proj: torch.Tensor,  # (fx, fy, cx, cy)
    inv_M: torch.Tensor,  # [4,4] camera→world
    mu: float,
    voxel_size: float,
    block_size: int,
    max_steps: int,
    view_frustum_min: float,
    view_frustum_max: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate block coords touched by each pixel's ±mu ray-band segment
    (reference buildHashAllocAndVisibleTypePP: the camera-frame surface
    point offset by ±mu along the ray, both ends in block units), by the
    exact 3-D DDA of blocks_on_ray_segment_planes over a static step count.
    The [..., 3] layout of the legacy allocator (hash_pipeline
    _allocate_scene_from_depth_legacy).

    Returns (blocks [H, W, max_steps, 3] int32, valid [H, W, max_steps] bool)."""
    H, W = depth.shape
    dev = depth.device
    fx, fy, cx, cy = proj[0], proj[1], proj[2], proj[3]
    one_over_block = 1.0 / (voxel_size * block_size)

    # reference gate: skip if d−mu < frustum_min or d+mu > frustum_max
    valid_px = (depth > 0.0) & (depth - mu >= view_frustum_min) & (depth + mu <= view_frustum_max)
    d = torch.where(valid_px, depth, torch.ones_like(depth))

    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    dir_cam = torch.stack([(xs - cx) / fx, (ys - cy) / fy, torch.ones_like(d)], dim=-1)
    pt_cam = dir_cam * d[..., None]
    norm = torch.linalg.vector_norm(pt_cam, dim=-1)

    def to_blocks(pc):
        pw = torch.einsum("ij,hwj->hwi", inv_M[:3, :3], pc) + inv_M[:3, 3]
        return pw * one_over_block

    bs = to_blocks(pt_cam * (1.0 - mu / norm)[..., None])
    be = to_blocks(pt_cam * (1.0 + mu / norm)[..., None])
    seg = be - bs
    flat = seg.abs() < 1e-9
    safe_seg = torch.where(flat, torch.full_like(seg, 1e-9), seg)
    sgn = torch.sign(seg).to(torch.int32)
    up = (seg > 0).to(torch.int32)
    two = torch.full_like(seg, 2.0)

    blk = torch.floor(bs).to(torch.int32)  # [H, W, 3]
    t = torch.zeros_like(d)
    blocks_list, valid_list = [], []
    for _ in range(max_steps):
        blocks_list.append(blk)
        valid_list.append(valid_px & (t <= 1.0))
        # param t of the next boundary crossing per axis
        t_axis = ((blk + up).to(torch.float32) - bs) / safe_seg
        t_axis = torch.where(flat, two, t_axis)
        t_axis = torch.where(t_axis <= t[..., None] + 1e-7, two, t_axis)  # crossed already
        t_next = t_axis.amin(dim=-1)
        blk = blk + torch.where(t_axis <= t_next[..., None] + 1e-9, sgn, 0)
        t = t_next
    return torch.stack(blocks_list, dim=2), torch.stack(valid_list, dim=2)
