"""Voxel-block-hash world model: hash table + voxel block array as tensors.

Counterpart of infinitam_tpu/engine/hash_volume.py (reference:
ITMVoxelBlockHash.h:22, ITMLocalVBA.h:19, and the allocation protocol of
ITMSceneReconstructionEngine_CUDA.cu:350-495). Field names, shapes, dtypes and
packing match the JAX package exactly, so `convert.py` moves state between
the two field by field.

entry_ptr semantics (reference ITMHashEntry.ptr): ≥0 → block index in the
voxel block array (VBA); −1 → allocated but swapped out; ≤−2 → empty entry.

Functions return new state tensors like their JAX counterparts, with one
exception: `vox` (and `vox_rgb` with colour) is updated in place by the
integrate step (ops/kernels/integrate.py), as the Pallas kernel aliases it,
and by the swap merge and eviction (engine/swapping.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from infinitam_tpu_torch.config import VoxelBlockHashParams
from infinitam_tpu_torch.ops.hashing import compact_by_mask, hash_index, point_to_block, scatter_drop

FREE_PTR = -2  # empty hash entry
SWAPPED_PTR = -1  # allocated, streamed out to the host tier

# packed voxel lane: sdf int16 << 16 | w uint8 << 8 (reference ITMVoxel_s_rgb
# stores sdf as a short scaled by 32767 and w as a uchar)
SDF_SCALE = 32767.0
VOX_INIT = 32767 << 16  # empty space: sdf = 1.0, w = 0

# visible_type codes (reference ITMRenderState_VH); the [E] plane is kept
# only when swapping, whose eviction reads VT_NOT_VISIBLE
VT_NOT_VISIBLE = 0
VT_VISIBLE = 1
VT_VISIBLE_SWAPPED = 2  # visible, its block streamed out to the host store
VT_VISIBLE_PREVIOUS = 3  # visible last frame and still in view

# static bound on hash-chain walks (the default table's load factor is ~6%)
MAX_PROBE = 4


def sdf_to_q(f: torch.Tensor) -> torch.Tensor:
    """float sdf in [-1, 1] → int16-valued int32, rounded half to even."""
    return torch.round(torch.clamp(f, -1.0, 1.0) * SDF_SCALE).to(torch.int32)


def sdf_from_q(q: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * (1.0 / SDF_SCALE)


def clr_to_q(c: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.clamp(c, 0.0, 1.0) * 255.0).to(torch.int32)


def clr_from_q(q: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * (1.0 / 255.0)


def pack_vox(sdf_q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(sdf int16, w uint8) → packed int32 lane."""
    return ((sdf_q.to(torch.int32) & 0xFFFF) << 16) | ((w.to(torch.int32) & 0xFF) << 8)


def vox_sdf_q(vox: torch.Tensor) -> torch.Tensor:
    return vox >> 16


def vox_sdf(vox: torch.Tensor) -> torch.Tensor:
    return sdf_from_q(vox >> 16)


def vox_w(vox: torch.Tensor) -> torch.Tensor:
    return (vox >> 8) & 0xFF


def pack_rgb(clr_q: torch.Tensor, wc: torch.Tensor) -> torch.Tensor:
    c = clr_q.to(torch.int32) & 0xFF
    return (c[..., 0] << 24) | (c[..., 1] << 16) | (c[..., 2] << 8) | (wc.to(torch.int32) & 0xFF)


def rgb_clr_q(vox_rgb: torch.Tensor) -> torch.Tensor:
    return torch.stack([(vox_rgb >> 24) & 0xFF, (vox_rgb >> 16) & 0xFF, (vox_rgb >> 8) & 0xFF], dim=-1)


def rgb_wc(vox_rgb: torch.Tensor) -> torch.Tensor:
    return vox_rgb & 0xFF


class HashVolume(NamedTuple):
    entry_pos: torch.Tensor  # [E, 3] int32 block coords
    entry_ptr: torch.Tensor  # [E] int32 (see semantics above)
    entry_offset: torch.Tensor  # [E] int32: 0 = chain end, k>0 → excess idx k−1
    vox: torch.Tensor  # [B, S³] int32 packed sdf<<16|w<<8 (lin idx x+y·S+z·S²)
    alloc_list: torch.Tensor  # [B] int32 free block stack
    last_free_block: torch.Tensor  # int32 index of the stack top
    excess_list: torch.Tensor  # [X] int32 free excess-entry stack
    last_free_excess: torch.Tensor  # int32
    # [B, S³] int32 packed r<<24 | g<<16 | b<<8 | wc, or None without colour
    vox_rgb: Optional[torch.Tensor] = None
    # dense cell→entry grid over the working window, [G³] int32 packed
    # (entry_idx << 1) | swapped, −1 = no entry (see build_entry_grid)
    entry_grid: Optional[torch.Tensor] = None
    # dense cell→VBA-row grid, [G³] int32, −1 = not resident
    block_grid: Optional[torch.Tensor] = None


class RenderStateVH(NamedTuple):
    """Visible-entry bookkeeping (reference ITMRenderState_VH). `visible_ids`
    is canonical; `cell_claim`/`entry_epoch`/`epoch` drive the compact
    allocator (see hash_pipeline.allocate_scene_from_depth)."""

    visible_type: torch.Tensor  # [E] int32 (VT_* codes; maintained only when swapping)
    visible_ids: torch.Tensor  # [V] int32, −1 padding
    n_visible: torch.Tensor  # int32
    cell_claim: Optional[torch.Tensor] = None  # [G³] int32 winning candidate row per cell
    entry_epoch: Optional[torch.Tensor] = None  # [E] int32 frame tag (out-of-grid dedupe)
    epoch: Optional[torch.Tensor] = None  # int32 current frame tag


def sentinel_row(params: VoxelBlockHashParams) -> int:
    """VBA row reserved as never allocated (the free stack tops out at B−2)."""
    return params.n_blocks - 1


def create_hash(params: VoxelBlockHashParams, with_color: bool = False, grid_params=None,
                device: torch.device | str = "cuda") -> HashVolume:
    """Allocate + reset (reference ResetScene: free lists full, entries empty,
    sdf = 1, w = 0; colour 0 with weight 0 when `with_color`). `grid_params`
    enables the entry/block grid caches."""
    E, B, X, S3 = params.n_entries, params.n_blocks, params.n_excess, params.block_volume
    i32 = dict(dtype=torch.int32, device=device)
    eg = bg = None
    if grid_params is not None:
        gx, gy, gz = grid_params.dims
        eg = torch.full((gx * gy * gz,), -1, **i32)
        bg = torch.full((gx * gy * gz,), -1, **i32)
    return HashVolume(
        entry_pos=torch.zeros((E, 3), **i32),
        entry_ptr=torch.full((E,), FREE_PTR, **i32),
        entry_offset=torch.zeros((E,), **i32),
        vox=torch.full((B, S3), VOX_INIT, **i32),
        alloc_list=torch.arange(B, **i32),
        last_free_block=torch.full((), B - 2, **i32),
        excess_list=torch.arange(X, **i32),
        last_free_excess=torch.full((), X - 1, **i32),
        vox_rgb=torch.zeros((B, S3), **i32) if with_color else None,
        entry_grid=eg,
        block_grid=bg,
    )


def create_render_state(params: VoxelBlockHashParams, grid_params=None, device: torch.device | str = "cuda") -> RenderStateVH:
    i32 = dict(dtype=torch.int32, device=device)
    ce = ee = ep = None
    if grid_params is not None:
        gx, gy, gz = grid_params.dims
        ce = torch.zeros((gx * gy * gz,), **i32)
        ee = torch.zeros((params.n_entries,), **i32)
        ep = torch.zeros((), **i32)
    return RenderStateVH(
        visible_type=torch.zeros((params.n_entries,), **i32),
        visible_ids=torch.full((params.max_visible_blocks,), -1, **i32),
        n_visible=torch.zeros((), **i32),
        cell_claim=ce,
        entry_epoch=ee,
        epoch=ep,
    )


def grid_cell(block_pos: torch.Tensor, grid_params) -> Tuple[torch.Tensor, torch.Tensor]:
    """(flat cell index, in-bounds mask) of block coords in the working grid."""
    gx, gy, gz = grid_params.dims
    ox, oy, oz = grid_params.origin
    g0 = block_pos[..., 0] - ox
    g1 = block_pos[..., 1] - oy
    g2 = block_pos[..., 2] - oz
    inb = (g0 >= 0) & (g0 < gx) & (g1 >= 0) & (g1 < gy) & (g2 >= 0) & (g2 < gz)
    return (g0 * gy + g1) * gz + g2, inb


class ProbeResult(NamedTuple):
    found: torch.Tensor  # bool: matching entry with ptr ≥ min_ptr
    entry_idx: torch.Tensor  # int32 entry index when found
    entry_ptr: torch.Tensor  # ptr at the found entry (FREE_PTR when not found)
    tail_idx: torch.Tensor  # last entry index visited in the chain
    ordered_empty: torch.Tensor  # bool: the ordered bucket itself is empty


def pack_entries(vol: HashVolume) -> torch.Tensor:
    """[E, 5] int32 (pos.xyz, ptr, offset): one row gather per chain link in
    `probe` instead of three table gathers."""
    return torch.cat([vol.entry_pos, vol.entry_ptr[:, None], vol.entry_offset[:, None]], dim=1)


def probe(vol: HashVolume, block_pos: torch.Tensor, params: VoxelBlockHashParams, include_swapped: bool = True,
          packed: Optional[torch.Tensor] = None) -> ProbeResult:
    """Vectorized hash-chain walk, unrolled to MAX_PROBE links (reference
    findVoxel hash overload, ITMRepresentationAccess.h:22-54). `packed`
    (pack_entries(vol), reused across calls) reads the tables by rows."""
    min_ptr = SWAPPED_PTR if include_swapped else 0
    idx0 = hash_index(block_pos, params.hash_mask)
    cur = idx0
    found = torch.zeros(block_pos.shape[:-1], dtype=torch.bool, device=block_pos.device)
    found_idx = idx0
    found_ptr = torch.full(block_pos.shape[:-1], FREE_PTR, dtype=torch.int32, device=block_pos.device)
    tail = idx0
    ordered_empty = None
    for k in range(MAX_PROBE):
        c = cur.long()
        if packed is None:
            pos, ptr, off = vol.entry_pos[c], vol.entry_ptr[c], vol.entry_offset[c]
        else:
            row = packed[c]
            pos, ptr, off = row[..., :3], row[..., 3], row[..., 4]
        if k == 0:
            ordered_empty = ptr < SWAPPED_PTR
        match = (pos == block_pos).all(dim=-1) & (ptr >= min_ptr) & ~found
        found_idx = torch.where(match, cur, found_idx)
        found_ptr = torch.where(match, ptr, found_ptr)
        found = found | match
        has_next = (off >= 1) & ~found
        nxt = params.n_buckets + off - 1
        tail = torch.where(has_next, nxt, tail)
        cur = torch.where(has_next, nxt, cur)
    return ProbeResult(found=found, entry_idx=found_idx, entry_ptr=found_ptr, tail_idx=tail, ordered_empty=ordered_empty)


def build_entry_grid(vol: HashVolume, grid_params) -> torch.Tensor:
    """Dense cell→entry grid [G³] int32, packed (entry_idx << 1) | swapped,
    −1 where no allocated entry (swapped-out entries included)."""
    gx, gy, gz = grid_params.dims
    cell, inb = grid_cell(vol.entry_pos, grid_params)
    inb = inb & (vol.entry_ptr >= SWAPPED_PTR)
    E = vol.entry_ptr.shape[0]
    code = (torch.arange(E, dtype=torch.int32, device=cell.device) << 1) | (vol.entry_ptr == SWAPPED_PTR).to(torch.int32)
    grid = torch.full((gx * gy * gz,), -1, dtype=torch.int32, device=cell.device)
    return scatter_drop(grid, torch.where(inb, cell, gx * gy * gz), code)


def build_block_grid(vol: HashVolume, grid_params) -> torch.Tensor:
    """Dense cell→VBA-row grid [Gx, Gy, Gz] int32, −1 = unallocated."""
    gx, gy, gz = grid_params.dims
    cell, inb = grid_cell(vol.entry_pos, grid_params)
    inb = inb & (vol.entry_ptr >= 0)
    grid = torch.full((gx * gy * gz,), -1, dtype=torch.int32, device=cell.device)
    return scatter_drop(grid, torch.where(inb, cell, gx * gy * gz), vol.entry_ptr).reshape(gx, gy, gz)


def refresh_caches(vol: HashVolume, grid_params) -> HashVolume:
    """`entry_grid` and `block_grid` rebuilt from the hash (a snapshot that
    lacks them; the test oracle of their per-frame upkeep)."""
    return vol._replace(entry_grid=build_entry_grid(vol, grid_params),
                        block_grid=build_block_grid(vol, grid_params).reshape(-1))


def get_block_grid(vol: HashVolume, grid_params) -> torch.Tensor:
    """[Gx, Gy, Gz] cell→VBA-row grid: the maintained cache when present,
    else a rebuild."""
    if vol.block_grid is not None:
        return vol.block_grid.reshape(grid_params.dims)
    return build_block_grid(vol, grid_params)


def insert_blocks(
    vol: HashVolume,
    visible_type: torch.Tensor,  # [E] int32
    new_blocks: torch.Tensor,  # [N, 3] int32 block coords
    valid: torch.Tensor,  # [N] bool
    params: VoxelBlockHashParams,
    grid_params=None,
) -> Tuple[HashVolume, torch.Tensor, torch.Tensor]:
    """Candidate-space hash insertion: probe → one winner per contended
    bucket/chain tail (duplicate-index scatter, unspecified winner; losers
    retry) → free-list pops → entry writes (reference
    allocateVoxelBlocksList_device). Returns (vol, visible_type, widx) with
    widx[N] the entry each candidate was written to, or E."""
    E = params.n_entries
    N = new_blocks.shape[0]
    dev = new_blocks.device
    pr = probe(vol, new_blocks, params, include_swapped=True)
    need = valid & ~pr.found
    a_type = torch.where(pr.ordered_empty, 1, 2)
    tidx = torch.where(need, pr.tail_idx, E)

    iota = torch.arange(N, dtype=torch.int32, device=dev)
    claim = scatter_drop(torch.full((E + 1,), -1, dtype=torch.int32, device=dev), tidx, iota)
    win = need & (claim[tidx.clamp(0, E).long()] == iota)

    # rank only candidates that take a resource, so the stack pointers stay
    # consistent when a free list runs dry
    needs_excess = win & (a_type == 2)
    excess_rank = torch.cumsum(needs_excess.to(torch.int32), 0) - 1
    exl_list_idx = vol.last_free_excess - excess_rank
    has_excess = needs_excess & (exl_list_idx >= 0)
    take = win & ((a_type == 1) | has_excess)
    block_rank = torch.cumsum(take.to(torch.int32), 0) - 1
    blk_list_idx = vol.last_free_block - block_rank
    has_block = take & (blk_list_idx >= 0)

    new_block = vol.alloc_list[blk_list_idx.clamp(0, vol.alloc_list.shape[0] - 1).long()]
    excess_slot = vol.excess_list[exl_list_idx.clamp(0, vol.excess_list.shape[0] - 1).long()]

    do1 = has_block & (a_type == 1)
    do2 = has_block & (a_type == 2)
    child = params.n_buckets + excess_slot
    widx = torch.where(do1, tidx, torch.where(do2, child, E)).to(torch.int32)

    entry_pos = scatter_drop(vol.entry_pos, widx, new_blocks)
    entry_ptr = scatter_drop(vol.entry_ptr, widx, new_block)
    entry_offset = scatter_drop(vol.entry_offset, widx, 0)
    entry_offset = scatter_drop(entry_offset, torch.where(do2, tidx, E), excess_slot + 1)
    visible_type = scatter_drop(visible_type, widx, VT_VISIBLE)

    n_blocks_taken = (do1 | do2).sum(dtype=torch.int32)
    n_excess_taken = do2.sum(dtype=torch.int32)
    new_vol = vol._replace(
        entry_pos=entry_pos,
        entry_ptr=entry_ptr,
        entry_offset=entry_offset,
        last_free_block=vol.last_free_block - n_blocks_taken,
        last_free_excess=vol.last_free_excess - n_excess_taken,
    )
    if grid_params is not None and vol.entry_grid is not None:
        cell, inb = grid_cell(new_blocks, grid_params)
        G3 = vol.entry_grid.shape[0]
        cidx = torch.where((do1 | do2) & inb, cell, G3)
        new_vol = new_vol._replace(
            entry_grid=scatter_drop(vol.entry_grid, cidx, widx << 1),
            block_grid=scatter_drop(vol.block_grid, cidx, new_block),
        )
    return new_vol, visible_type, widx


def _grid_voxels(grid: torch.Tensor, grid_params, params: VoxelBlockHashParams):
    """`(int voxel pts [..., 3]) -> (flat voxel index, found)` through the
    dense block grid: one grid tap; a point outside the grid or in an
    unallocated block is not found (its index points at row 0)."""
    S = params.block_size
    gx, gy, gz = grid_params.dims
    ox, oy, oz = grid_params.origin
    flat_grid = grid.reshape(-1)

    def lookup(pts_int: torch.Tensor):
        block, linear = point_to_block(pts_int, S)
        g0, g1, g2 = block[..., 0] - ox, block[..., 1] - oy, block[..., 2] - oz
        inb = (g0 >= 0) & (g0 < gx) & (g1 >= 0) & (g1 < gy) & (g2 >= 0) & (g2 < gz)
        cell = (g0.clamp(0, gx - 1) * gy + g1.clamp(0, gy - 1)) * gz + g2.clamp(0, gz - 1)
        ptr = flat_grid[cell.long()]
        found = inb & (ptr >= 0)
        return torch.where(found, ptr, 0).long() * params.block_volume + linear.long(), found

    return lookup


def _hash_voxels(vol: HashVolume, params: VoxelBlockHashParams):
    """`(int voxel pts [..., 3]) -> (flat voxel index, found)` through the
    hash table (swapped-out blocks are not found)."""

    def lookup(pts_int: torch.Tensor):
        block, linear = point_to_block(pts_int, params.block_size)
        pr = probe(vol, block, params, include_swapped=False)
        return torch.where(pr.found, pr.entry_ptr, 0).long() * params.block_volume + linear.long(), pr.found

    return lookup


def _sdf_reader(vol: HashVolume, lookup):
    flat_vox = vol.vox.reshape(-1)

    def read(pts_int: torch.Tensor):
        idx, found = lookup(pts_int)
        sdf = vox_sdf(flat_vox[idx])
        return torch.where(found, sdf, torch.ones_like(sdf)), found

    return read


def make_grid_reader(vol: HashVolume, grid: torch.Tensor, grid_params, params: VoxelBlockHashParams):
    """`(int voxel pts [..., 3]) -> (sdf, found)` through the dense block
    grid: one grid tap + one voxel tap; empty space reads sdf = 1."""
    return _sdf_reader(vol, _grid_voxels(grid, grid_params, params))


def make_hash_reader(vol: HashVolume, params: VoxelBlockHashParams):
    """`(int voxel pts [..., 3]) -> (sdf, found)` through the hash table
    (reference readVoxel, hash overload): it finds every resident block,
    those allocated outside the block grid's window too; empty space reads
    sdf = 1."""
    return _sdf_reader(vol, _hash_voxels(vol, params))


def _weight_reader(vol: HashVolume, lookup):
    def read(pts_int: torch.Tensor):
        idx, found = lookup(pts_int)
        w = vox_w(vol.vox.reshape(-1)[idx]).to(torch.float32)
        return torch.where(found, w, torch.zeros_like(w)), found

    return read


def make_hash_weight_reader(vol: HashVolume, params: VoxelBlockHashParams):
    """`(int voxel pts [..., 3]) -> (w_depth, found)`: fusion weights through
    the hash table, for the weight display (reference WeightToUchar4);
    unallocated voxels read 0."""
    return _weight_reader(vol, _hash_voxels(vol, params))


def make_grid_weight_reader(vol: HashVolume, grid: torch.Tensor, grid_params, params: VoxelBlockHashParams):
    """make_hash_weight_reader through the dense block grid."""
    return _weight_reader(vol, _grid_voxels(grid, grid_params, params))


def make_hash_color_reader(vol: HashVolume, params: VoxelBlockHashParams):
    """`(int voxel pts [..., 3]) -> colour [..., 3]` in 0..1 through the hash
    table; unallocated voxels (or a volume without colour) read 0."""
    lookup = _hash_voxels(vol, params)

    def read(pts_int: torch.Tensor):
        if vol.vox_rgb is None:
            return torch.zeros(pts_int.shape[:-1] + (3,), dtype=torch.float32, device=pts_int.device)
        idx, found = lookup(pts_int)
        c = clr_from_q(rgb_clr_q(vol.vox_rgb.reshape(-1)[idx]))
        return torch.where(found[..., None], c, torch.zeros_like(c))

    return read


def check_block_visibility_planes(
    bx_i: torch.Tensor,  # [...] int32 block coords, component planes
    by_i: torch.Tensor,
    bz_i: torch.Tensor,
    M_d: torch.Tensor,
    proj: torch.Tensor,
    img_size: Tuple[int, int],
    voxel_size: float,
    block_size: int,
    enlarged: bool = False,
) -> torch.Tensor:
    """Project the 8 block corners; visible if any lands in the image
    (reference checkBlockVisibility; `enlarged` pads by 1/8 image)."""
    H, W = img_size
    fx, fy, cx, cy = proj[0], proj[1], proj[2], proj[3]
    factor = block_size * voxel_size
    bx = bx_i.to(torch.float32) * factor
    by = by_i.to(torch.float32) * factor
    bz = bz_i.to(torch.float32) * factor
    R = M_d[:3, :3]
    t = M_d[:3, 3]
    p0 = [R[i, 0] * bx + R[i, 1] * by + R[i, 2] * bz + t[i] for i in range(3)]
    if enlarged:
        x_lo, x_hi, y_lo, y_hi = -W / 8.0, W + W / 8.0, -H / 8.0, H + H / 8.0
    else:
        x_lo, x_hi, y_lo, y_hi = 0.0, float(W), 0.0, float(H)
    vis = torch.zeros(bx.shape, dtype=torch.bool, device=bx.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                # corner offset R·(dx, dy, dz)·factor, as the JAX package's R @ c
                co = [R[i, 0] * (dx * factor) + R[i, 1] * (dy * factor) + R[i, 2] * (dz * factor) for i in range(3)]
                z = p0[2] + co[2]
                ok = z >= 1e-10
                zs = torch.where(ok, z, torch.ones_like(z))
                u = fx * (p0[0] + co[0]) / zs + cx
                v = fy * (p0[1] + co[1]) / zs + cy
                vis = vis | (ok & (u >= x_lo) & (u < x_hi) & (v >= y_lo) & (v < y_hi))
    return vis


def check_block_visibility(block_pos, M_d, proj, img_size, voxel_size, block_size, enlarged=False):
    """check_block_visibility_planes on [..., 3] block coords."""
    return check_block_visibility_planes(
        block_pos[..., 0], block_pos[..., 1], block_pos[..., 2],
        M_d, proj, img_size, voxel_size, block_size, enlarged,
    )


class AllocationPlan(NamedTuple):
    alloc_type: torch.Tensor  # [E] int32: 0 none, 1 ordered, 2 excess
    block_coords: torch.Tensor  # [E, 3] int32 requested block pos
    visible_type: torch.Tensor  # [E] int32 updated visibility marks
    cand_need: torch.Tensor  # [N] bool: candidate not found (allocation wanted)


def plan_allocations(
    vol: HashVolume,
    visible_type: torch.Tensor,  # [E] int32 (entries from last frame pre-set to 3)
    cand_blocks: torch.Tensor,  # [N, 3] int32 candidate block coords
    cand_valid: torch.Tensor,  # [N] bool
    params: VoxelBlockHashParams,
    packed: Optional[torch.Tensor] = None,
) -> AllocationPlan:
    """Mark entries to allocate and the visibility of touched entries
    (reference buildHashAllocAndVisibleTypePP, its scatter phase). A
    contended bucket keeps ONE winner per frame (duplicate-index scatter,
    unspecified winner, as the reference's last-writer-wins race); losers
    retry on a later frame."""
    E = params.n_entries
    pr = probe(vol, cand_blocks, params, include_swapped=True, packed=packed)
    # visibility marks for found entries: 2 if swapped out, 1 otherwise
    vis_val = torch.where(pr.entry_ptr == SWAPPED_PTR, VT_VISIBLE_SWAPPED, VT_VISIBLE)
    hit = cand_valid & pr.found
    visible_type = scatter_drop(visible_type, torch.where(hit, pr.entry_idx, E), torch.where(hit, vis_val, 0))
    need = cand_valid & ~pr.found
    a_type = torch.where(pr.ordered_empty, 1, 2)
    tidx = torch.where(need, pr.tail_idx, E)
    zeros = torch.zeros_like(vol.entry_ptr)
    alloc_type = scatter_drop(zeros, tidx, torch.where(need, a_type, 0))
    block_coords = scatter_drop(torch.zeros_like(vol.entry_pos), tidx, cand_blocks)
    # new ordered entries are visible at once (reference: the planning sets
    # entriesVisibleType[hashIdx] = 1 for !isExcess)
    visible_type = scatter_drop(visible_type, torch.where(need & (a_type == 1), pr.tail_idx, E), VT_VISIBLE)
    return AllocationPlan(alloc_type=alloc_type, block_coords=block_coords, visible_type=visible_type,
                          cand_need=need)


def execute_allocations(vol: HashVolume, plan: AllocationPlan,
                        params: VoxelBlockHashParams) -> Tuple[HashVolume, torch.Tensor]:
    """Pop the free lists and write the planned entries (reference
    allocateVoxelBlocksList_device). Returns (vol, visible_type): excess
    children become visible here."""
    E = params.n_entries
    visible_type = plan.visible_type
    needs_block = plan.alloc_type > 0
    needs_excess = plan.alloc_type == 2
    block_rank = torch.cumsum(needs_block.to(torch.int32), 0) - 1
    excess_rank = torch.cumsum(needs_excess.to(torch.int32), 0) - 1
    blk_list_idx = vol.last_free_block - block_rank
    exl_list_idx = vol.last_free_excess - excess_rank
    has_block = needs_block & (blk_list_idx >= 0)
    has_excess = needs_excess & (exl_list_idx >= 0)
    new_block = vol.alloc_list[blk_list_idx.clamp(0, vol.alloc_list.shape[0] - 1).long()]
    excess_slot = vol.excess_list[exl_list_idx.clamp(0, vol.excess_list.shape[0] - 1).long()]
    iota = torch.arange(E, dtype=torch.int32, device=vol.entry_ptr.device)

    # type 1: the ordered bucket itself
    do1 = (plan.alloc_type == 1) & has_block
    idx1 = torch.where(do1, iota, E)
    entry_pos = scatter_drop(vol.entry_pos, idx1, plan.block_coords)
    entry_ptr = scatter_drop(vol.entry_ptr, idx1, new_block)
    entry_offset = scatter_drop(vol.entry_offset, idx1, 0)
    # type 2: an excess child, linked from its parent
    do2 = (plan.alloc_type == 2) & has_block & has_excess
    cidx = torch.where(do2, params.n_buckets + excess_slot, E)
    entry_pos = scatter_drop(entry_pos, cidx, plan.block_coords)
    entry_ptr = scatter_drop(entry_ptr, cidx, new_block)
    entry_offset = scatter_drop(entry_offset, cidx, 0)
    entry_offset = scatter_drop(entry_offset, torch.where(do2, iota, E), excess_slot + 1)
    visible_type = scatter_drop(visible_type, cidx, VT_VISIBLE)

    new_vol = vol._replace(
        entry_pos=entry_pos,
        entry_ptr=entry_ptr,
        entry_offset=entry_offset,
        last_free_block=vol.last_free_block - (do1 | do2).sum(dtype=torch.int32),
        last_free_excess=vol.last_free_excess - do2.sum(dtype=torch.int32),
    )
    return new_vol, visible_type


def build_visible_list(
    vol: HashVolume,
    visible_type: torch.Tensor,
    M_d: torch.Tensor,
    proj: torch.Tensor,
    img_size: Tuple[int, int],
    voxel_size: float,
    params: VoxelBlockHashParams,
    use_enlarged: bool = False,
    prev_ids: Optional[torch.Tensor] = None,
) -> RenderStateVH:
    """Re-check the carried-over entries and compact the visible list
    (reference buildVisibleList_device: type-3 entries get a projection
    re-check, then a prefix-sum compaction). With `prev_ids` (last frame's
    compact list) the re-check runs over those ≤ V rows only: type-3 entries
    are exactly last frame's visibles. The legacy allocator's list; the
    state it returns has no claim or epoch planes."""
    E = params.n_entries
    if prev_ids is not None:
        pid_c = prev_ids.clamp(0, E - 1).long()
        is_prev = (prev_ids >= 0) & (visible_type[pid_c] == VT_VISIBLE_PREVIOUS)
        vis = check_block_visibility(vol.entry_pos[pid_c], M_d, proj, img_size, voxel_size, params.block_size,
                                     enlarged=use_enlarged)
        visible_type = scatter_drop(visible_type, torch.where(is_prev & ~vis, pid_c, E), VT_NOT_VISIBLE)
    else:
        vis = check_block_visibility(vol.entry_pos, M_d, proj, img_size, voxel_size, params.block_size,
                                     enlarged=use_enlarged)
        visible_type = torch.where((visible_type == VT_VISIBLE_PREVIOUS) & ~vis, VT_NOT_VISIBLE, visible_type)
    ids, n = compact_by_mask(visible_type > 0, torch.arange(E, dtype=torch.int32, device=visible_type.device),
                             params.max_visible_blocks, fill=-1)
    return RenderStateVH(visible_type=visible_type, visible_ids=ids, n_visible=n)


def set_previous_visible(render_state: RenderStateVH) -> torch.Tensor:
    """Start of a frame: last frame's visible entries demoted to type 3
    (reference setToType3), the rest of the [E] plane cleared."""
    ids = render_state.visible_ids
    E = render_state.visible_type.shape[0]
    return scatter_drop(torch.zeros_like(render_state.visible_type), torch.where(ids >= 0, ids, E),
                        VT_VISIBLE_PREVIOUS)
