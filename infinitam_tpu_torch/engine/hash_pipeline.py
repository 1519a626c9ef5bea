"""End-to-end per-frame pipeline on the voxel-block-hash volume.

Counterpart of infinitam_tpu/engine/hash_pipeline.py for the depth-ICP,
weighted-ICP, colour, Ren and external trackers, with or without colour
fusion, the approximate raycast and swapping (reference
ITMMainEngine::ProcessFrame → ITMDenseMapper::ProcessFrame →
ITMTrackingController::Prepare). Per frame: track (ICP and weighted ICP:
kernel K1; Ren: K1 at the coarse levels, then the SDF LM against the
volume; colour: photometric LM; external: the given pose) → divergence
gate → allocate → integrate (kernel K2, with its colour half when
`use_color`) → expected-depth ranges → raycast (kernel K3; in the RGB frame
for the colour tracker; with the approximate raycast, its result is kept
only on the frames that need a full refresh) → the next frame's tracking
maps → diagnostics. With swapping, `step_frame_swap` also merges an earlier
frame's needed blocks before tracking, reallocates and marks the visible
swapped-out entries after allocating, and builds the needed list and evicts
a window of invisible blocks before the raycast (engine/swapping.py). With
`use_block_grid=False` the raycast (kernel K3h) and the Ren tracker read the
volume through the hash table instead of the block grid; with
`raycast_coarse_factor` c > 1 a coarse raycast at 1/c resolution first
tightens the per-pixel ranges.

Every step is a fixed sequence of tensor ops and kernel launches that reads
nothing back to the host, so frames queue on the card without a sync, and
on the card each step runs as one captured CUDA graph (engine/captured.py). Where
the JAX package skips a branch with `lax.cond` (allocation inserts,
out-of-grid probes, the large-block widening, the approximate raycast's
refresh), the branch runs unconditionally here: with nothing to do it
writes nothing, or its result is not selected, so the result is the same
and no host-side decision is needed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from infinitam_tpu_torch.config import Settings, SwappingMode, TrackerType
from infinitam_tpu_torch.engine import captured
from infinitam_tpu_torch.engine import hash_volume as hv
from infinitam_tpu_torch.engine import spans
from infinitam_tpu_torch.engine import swapping
from infinitam_tpu_torch.engine.hash_volume import HashVolume, RenderStateVH
from infinitam_tpu_torch.engine.tracking_state import TrackingState, create_tracking_state
from infinitam_tpu_torch.engine.trackers import (
    TrackResult,
    track_color,
    track_depth,
    track_external,
    track_far_from_point_cloud,
    track_ren,
)
from infinitam_tpu_torch.engine.view_builder import View
from infinitam_tpu_torch.ops import hashing
from infinitam_tpu_torch.ops import raycast as rc
from infinitam_tpu_torch.ops.hashing import compact_by_mask, scatter_drop
from infinitam_tpu_torch.ops.kernels import integrate as integrate_kernel
from infinitam_tpu_torch.ops.kernels import raycast as raycast_kernel
from infinitam_tpu_torch.ops.voxel_access import read_color_interpolated
from infinitam_tpu_torch.utils import se3

# cap on the ±mu band DDA steps (band_steps derives the exact count)
MAX_BAND_STEPS = 6
# static capacity for out-of-working-grid allocation candidates per frame
OOG_CAP = 2048
# bbox raster tile cap (subsampled cells) in expected_depth_ranges
MINMAX_MAX_T = 8
MINMAX_SMALL_T = 4


def band_steps(settings: Settings) -> int:
    """Static DDA step count for the ±mu allocation band."""
    edge = settings.hashing.block_size * settings.scene.voxel_size
    ratio = 2.0 * settings.scene.mu / edge
    return min(MAX_BAND_STEPS, 1 + 3 * max(1, math.ceil(ratio - 1e-6)))


def novel_cap(settings: Settings) -> int:
    """Capacity of the compacted novel-candidate stage of the allocator."""
    return max(2 * settings.hashing.max_visible_blocks, 4096)


def oog_cap(settings: Settings) -> int:
    """Capacity of a frame's out-of-grid candidates: OOG_CAP, or with
    swapping on the novel stage's (novel_cap). A swapping map grows past
    the block grid by design (the eviction frees pool blocks, not grid
    cells), and a camera that pans across a wall past the grid's edge
    sends several times OOG_CAP band candidates a frame there at 5 mm.
    The JAX package keeps OOG_CAP in both modes: the path without swapping
    stays held to it entry for entry past the cap
    (tests/test_torch_alloc.py), and the swap path differs from it only
    past the cap."""
    if settings.swapping_mode.value == SwappingMode.ENABLED.value:
        return max(OOG_CAP, novel_cap(settings))
    return OOG_CAP


class FrameDiagnostics(NamedTuple):
    f: torch.Tensor
    num_valid: torch.Tensor
    n_visible: torch.Tensor
    n_free_blocks: torch.Tensor
    # silent-cap counters, all 0 on a healthy scene:
    n_alloc_overflow: torch.Tensor  # new blocks deferred (alloc / novel / out-of-grid caps)
    n_render_overflow: torch.Tensor  # visible blocks beyond max_render_blocks
    n_pool_overflow: torch.Tensor  # raycast blocks dropped; no pool in the CUDA raycast: 0
    n_too_big_blocks: torch.Tensor  # blocks meeting the image whose bbox exceeded the range raster tile
    n_window_clipped: torch.Tensor  # integrate window clipping; K2 has no window: 0
    # port-only diagnostic, not a cap: the wanted blocks that no insert
    # round placed this frame (lost their bucket's election in every round,
    # or found no free block or excess slot); retried next frame
    n_alloc_unplaced: torch.Tensor


# the swap step's own counters, after the hash frame's: blocks evicted and
# needed-list entries listed this frame, and what the frame's quanta left
# (swapping.eviction_backlog over all E after the eviction,
# swapping.list_backlog after the list); the hash step computes none of them
SWAP_COUNTERS = ("n_swap_evicted", "n_swap_listed", "n_evict_backlog", "n_list_backlog")
SwapDiagnostics = NamedTuple("SwapDiagnostics", [(k, torch.Tensor)
                                                 for k in FrameDiagnostics._fields + SWAP_COUNTERS])


def _pad_before(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift [.., Ph, Pw] by (dy, dx) ≥ 0 with −1 fill (jnp.pad + slice)."""
    Ph, Pw = x.shape[-2:]
    return F.pad(x[..., : Ph - dy, : Pw - dx], (dx, 0, dy, 0), value=-1)


def allocate_scene_from_depth(
    vol: HashVolume,
    render_state: RenderStateVH,
    depth: torch.Tensor,
    pose: torch.Tensor,
    proj: torch.Tensor,
    settings: Settings,
    only_update_visible: bool = False,
    enable: torch.Tensor | bool = True,
) -> Tuple[HashVolume, RenderStateVH, torch.Tensor]:
    """AllocateSceneFromDepth (reference _CUDA.cu:89-170), the JAX package's
    compact allocator: ±mu band DDA → neighbour dedupe → exact dedupe through
    the cell-claim plane → entry-grid taps (visible rows, allocation wants) →
    out-of-grid hash probes → last frame's visibles re-checked by projection
    → the new compact visible list. With swapping, the [E] visible_type
    plane is kept too (swapped-out entries coded VT_VISIBLE_SWAPPED) and the
    re-check pads the image by 1/8. `enable` (bool tensor) suppresses new
    allocations while visibility still refreshes.

    Returns (vol, render_state, n_alloc_overflow). Where several candidates
    claim one cell or one bucket, the highest candidate index wins: the
    writer the JAX package's sequential scatter keeps on the CPU, so the
    VBA rows equal the JAX package's there and are the same in every run on
    the card. A render state without its claim plane, or a volume without
    its entry grid, takes the legacy allocator instead, as in the JAX
    package."""
    return _allocate(vol, render_state, depth, pose, proj, settings, only_update_visible, enable)[:3]


def _allocate(vol, render_state, depth, pose, proj, settings, only_update_visible=False, enable=True):
    """allocate_scene_from_depth, and the wanted blocks that no insert
    round placed (FrameDiagnostics.n_alloc_unplaced): (vol, render_state,
    n_alloc_overflow, n_alloc_unplaced)."""
    if render_state.cell_claim is None or vol.entry_grid is None:
        return _allocate_scene_from_depth_legacy(vol, render_state, depth, pose, proj, settings,
                                                 only_update_visible=only_update_visible, enable=enable)
    hp = settings.hashing
    sp = settings.scene
    dev = depth.device
    img_size = tuple(depth.shape)
    E = hp.n_entries
    gp = settings.block_grid
    gx, gy, gz = gp.dims
    G3 = gx * gy * gz
    Vcap = hp.max_visible_blocks
    epoch = render_state.epoch + 1
    use_swapping = settings.swapping_mode.value == SwappingMode.ENABLED.value
    i32 = dict(dtype=torch.int32, device=dev)
    if not torch.is_tensor(enable):
        enable = torch.full((), bool(enable), device=dev)

    s = settings.alloc_subsample
    depth_a = depth[::s, ::s] if s > 1 else depth
    proj_a = proj / s if s > 1 else proj
    Ph, Pw = depth_a.shape
    nsteps = band_steps(settings)

    cbx, cby, cbz, cval = hashing.blocks_on_ray_segment_planes(
        depth_a, proj_a, se3.invert(pose), sp.mu, sp.voxel_size,
        hp.block_size, nsteps, sp.view_frustum_min, sp.view_frustum_max,
    )  # each [nsteps, Ph·Pw]
    cval = cval & enable

    ox, oy, oz = gp.origin
    gxc, gyc, gzc = cbx - ox, cby - oy, cbz - oz
    in_grid = (gxc >= 0) & (gxc < gx) & (gyc >= 0) & (gyc < gy) & (gzc >= 0) & (gzc < gz)
    cell = (gxc * gy + gyc) * gz + gzc

    # --- stage 2: neighbour dedupe + compact ------------------------------
    key = torch.where(cval & in_grid, cell, -1).reshape(nsteps, Ph, Pw)

    def matches_any(shifted):  # key vs every step of a neighbour pixel
        m = torch.zeros_like(key, dtype=torch.bool)
        for s2 in range(nsteps):
            nb = shifted[s2][None]
            m = m | ((key == nb) & (nb >= 0))
        return m

    dup_nb = matches_any(_pad_before(key, 0, 1)) | matches_any(_pad_before(key, 1, 0)) | matches_any(
        _pad_before(key, 1, 1)
    )
    novel_flat = ((key >= 0) & ~dup_nb).reshape(-1)
    C2 = novel_cap(settings)
    c2_cell, n_novel = compact_by_mask(novel_flat, torch.where(novel_flat, cell.reshape(-1), G3), C2, fill=G3)
    novel_overflow = (n_novel - C2).clamp(min=0)

    # --- stage 3: exact dedupe via the claim plane ------------------------
    iota2 = torch.arange(C2, **i32)
    # this frame's claims replace the old ones; of several on one cell the
    # highest row wins
    c2_at = torch.where(c2_cell < G3, c2_cell, G3)
    cell_claim = scatter_drop(scatter_drop(render_state.cell_claim, c2_at, -1), c2_at, iota2, reduce="amax")
    win = (c2_cell < G3) & (cell_claim[c2_cell.clamp(0, G3 - 1).long()] == iota2)
    kcell, n_k_total = compact_by_mask(win, c2_cell, Vcap, fill=G3)
    k_overflow = (n_k_total - Vcap).clamp(min=0)
    n_k = n_k_total.clamp(max=Vcap)
    kvalid = kcell < G3
    kcell_c = kcell.clamp(0, G3 - 1).long()

    # --- out-of-grid candidates: hash probes (unbounded world) -------------
    oog = (cval & ~in_grid).reshape(-1)
    n_oog = oog.sum(dtype=torch.int32)
    cb_flat = torch.stack([cbx.reshape(-1), cby.reshape(-1), cbz.reshape(-1)], dim=-1)
    ocap = oog_cap(settings)
    oidx, _ = compact_by_mask(oog, torch.arange(oog.shape[0], **i32), ocap, fill=-1)
    ovalid = oidx >= 0
    ocand = cb_flat[oidx.clamp(0, oog.shape[0] - 1).long()]
    opr = hv.probe(vol, ocand, hp, include_swapped=True)
    ofound = ovalid & opr.found
    oe = torch.where(ofound, opr.entry_idx, E)
    entry_epoch = scatter_drop(render_state.entry_epoch, oe, epoch)
    # sort-dedupe the found rows: many band candidates probe the same entry
    oe_s, order = torch.sort(oe, stable=True)
    first = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev), oe_s[1:] != oe_s[:-1]]) & (oe_s < E)
    oog_vis_idx = torch.where(first, oe_s, E).to(torch.int32)
    if use_swapping:
        ocode = torch.where(opr.entry_ptr == hv.SWAPPED_PTR, hv.VT_VISIBLE_SWAPPED, hv.VT_VISIBLE)
        oog_vis_code = torch.where(first, torch.where(ofound, ocode, 0)[order], 0)
    oog_new_idx = torch.full((ocap,), E, **i32)

    n_alloc_overflow = novel_overflow + k_overflow
    n_unplaced = torch.zeros((), **i32)
    if not only_update_visible:
        # allocation wants: winner cells with no entry yet
        packed0 = vol.entry_grid[kcell_c]
        want = kvalid & (packed0 < 0)
        n_want = want.sum(dtype=torch.int32)
        n_alloc_overflow = (
            n_alloc_overflow + (n_want - settings.max_alloc_blocks).clamp(min=0) + (n_oog - ocap).clamp(min=0)
        )
        dummy_vt = torch.zeros((1,), **i32)  # the codes are written below
        ncell, _ = compact_by_mask(want, kcell, settings.max_alloc_blocks, fill=G3)
        nv = ncell < G3
        ncell_c = ncell.clamp(0, G3 - 1)
        nblocks = torch.stack(
            [ncell_c // (gy * gz) + ox, (ncell_c // gz) % gy + oy, ncell_c % gz + oz], dim=-1
        ).to(torch.int32)
        # two rounds: same-bucket losers of round 1 insert in round 2
        # (already-inserted blocks re-probe as found and are no-ops)
        vol, _, w1 = hv.insert_blocks(vol, dummy_vt, nblocks, nv, hp, grid_params=gp)
        vol, _, w2 = hv.insert_blocks(vol, dummy_vt, nblocks, nv, hp, grid_params=gp)
        # out-of-grid candidates that probed as new
        vol, _, owidx = hv.insert_blocks(vol, dummy_vt, ocand, ovalid & ~ofound, hp, grid_params=gp)
        entry_epoch = scatter_drop(entry_epoch, owidx, epoch)
        oog_new_idx = torch.where(owidx < E, owidx, E)
        n_unplaced = _unplaced(torch.cat([nblocks, ocand]), torch.cat([nv, ovalid & ~ofound]),
                               torch.cat([(w1 < E) | (w2 < E), owidx < E]))

    # --- visible-list rows --------------------------------------------------
    # k-rows: winner cells that now have an entry, compact at offset 0
    packed = vol.entry_grid[kcell_c]
    k_live = kvalid & (packed >= 0)
    k_eidx = torch.where(k_live, packed >> 1, -1)
    n_k_eff = k_live.sum(dtype=torch.int32)

    # prev-rows: last frame's visibles re-checked by projection, deduped
    # against this frame's cells (claim plane) and out-of-grid rows (epochs)
    pid = render_state.visible_ids
    pidc = pid.clamp(0, E - 1)
    pvalid = pid >= 0
    ppos = vol.entry_pos[pidc.long()]
    ppx, ppy, ppz = ppos[:, 0], ppos[:, 1], ppos[:, 2]
    pvis = hv.check_block_visibility_planes(
        ppx, ppy, ppz, pose, proj, img_size, sp.voxel_size, hp.block_size, enlarged=use_swapping
    )
    pgx, pgy, pgz = ppx - ox, ppy - oy, ppz - oz
    pinb = (pgx >= 0) & (pgx < gx) & (pgy >= 0) & (pgy < gy) & (pgz >= 0) & (pgz < gz)
    pcell = (pgx * gy + pgy) * gz + pgz
    jclaim = cell_claim[pcell.clamp(0, G3 - 1).long()]
    dup_cell = pinb & (c2_cell[jclaim.clamp(0, C2 - 1).long()] == pcell) & (jclaim >= 0) & (jclaim < C2)
    dup = dup_cell | (entry_epoch[pidc.long()] == epoch)
    keep_prev = pvalid & pvis & ~dup

    # --- assembly: three offset scatters ----------------------------------
    ids = k_eidx.to(torch.int32)
    pdst = n_k + torch.cumsum(keep_prev.to(torch.int32), 0) - 1
    ids = scatter_drop(ids, torch.where(keep_prev & (pdst < Vcap), pdst, Vcap), pidc)
    n_prev = keep_prev.sum(dtype=torch.int32)
    om_f = oog_vis_idx < E
    om_n = oog_new_idx < E
    odst = n_k + n_prev + torch.cumsum(om_f.to(torch.int32), 0) - 1
    ids = scatter_drop(ids, torch.where(om_f & (odst < Vcap), odst, Vcap), oog_vis_idx)
    n_oog_f = om_f.sum(dtype=torch.int32)
    ondst = n_k + n_prev + n_oog_f + torch.cumsum(om_n.to(torch.int32), 0) - 1
    ids = scatter_drop(ids, torch.where(om_n & (ondst < Vcap), ondst, Vcap), oog_new_idx)
    n_oog_v = n_oog_f + om_n.sum(dtype=torch.int32)
    # true visible count, uncapped: _frame_diag compares it with the caps
    n_visible = n_k_eff + n_prev + n_oog_v

    # swapping evicts over the full [E] visible_type plane: clear last
    # frame's rows, then write this frame's codes, in the JAX package's
    # order (a later scatter wins an entry that two of them touch); without
    # swapping the plane is carried untouched
    vt = render_state.visible_type
    if use_swapping:
        k_code = torch.where((packed & 1) == 1, hv.VT_VISIBLE_SWAPPED, hv.VT_VISIBLE)
        vt = scatter_drop(vt, torch.where(pvalid, pidc, E), hv.VT_NOT_VISIBLE)
        vt = scatter_drop(vt, torch.where(k_live, k_eidx, E), k_code)
        vt = scatter_drop(vt, torch.where(keep_prev, pidc, E), hv.VT_VISIBLE_PREVIOUS)
        vt = scatter_drop(vt, torch.where(om_f, oog_vis_idx, E), oog_vis_code)
        vt = scatter_drop(vt, torch.where(om_n, oog_new_idx, E), hv.VT_VISIBLE)

    new_rs = RenderStateVH(
        visible_type=vt,
        visible_ids=ids,
        n_visible=n_visible,
        cell_claim=cell_claim,
        entry_epoch=entry_epoch,
        epoch=epoch,
    )
    return vol, new_rs, n_alloc_overflow, n_unplaced


def _unplaced(blocks, want, placed) -> torch.Tensor:
    """The distinct blocks among the `want`ed candidates [N, 3] of which no
    candidate was `placed` (written to an entry by an insert round), as an
    int32 count. A block may stand for several candidates (the out-of-grid
    ones are not deduplicated), and an insert places one of them, so the
    candidates are sorted by block, a block's placed ones first, and a
    block counts where its first is unplaced."""
    c = blocks.long() + (1 << 19)  # 20 bits an axis
    key = (c[:, 0] << 40) | (c[:, 1] << 20) | c[:, 2]
    k = torch.sort(torch.where(want, key * 2 + (~placed).long(), -1)).values
    prev = torch.cat([k.new_full((1,), -2), k[:-1]]) >> 1
    return ((k >= 0) & ((k >> 1) != prev) & ((k & 1) == 1)).sum(dtype=torch.int32)


def _allocate_scene_from_depth_legacy(
    vol: HashVolume,
    render_state: RenderStateVH,
    depth: torch.Tensor,
    pose: torch.Tensor,
    proj: torch.Tensor,
    settings: Settings,
    only_update_visible: bool = False,
    enable: torch.Tensor | bool = True,
) -> Tuple[HashVolume, RenderStateVH, torch.Tensor]:
    """The JAX package's oracle allocator over the full [E] visible-type
    plane (reference-shaped: setToType3 → plan → allocate →
    buildVisibleList), for a volume without its entry grid or a render state
    without its claim plane; also the oracle of the compact allocator. The
    ±mu band of every alloc_subsample-th pixel (MAX_BAND_STEPS DDA steps)
    taps the entry grid (rebuilt from the hash when the volume has none);
    in-grid cells without an entry are the wants, deduped through a [G³]
    plane, compacted and inserted in two rounds; out-of-grid candidates
    probe the hash and insert what they miss. The JAX package skips the
    probe and the inserts with `lax.cond` when there is nothing to do; here
    they always run, with nothing to write then. The new state has no claim
    or epoch planes."""
    hp = settings.hashing
    sp = settings.scene
    dev = depth.device
    img_size = tuple(depth.shape)
    E = hp.n_entries
    i32 = dict(dtype=torch.int32, device=dev)
    visible_type = hv.set_previous_visible(render_state)

    s = settings.alloc_subsample
    depth_a = depth[::s, ::s] if s > 1 else depth
    proj_a = proj / s if s > 1 else proj
    blocks, valid = hashing.blocks_on_ray_segment(depth_a, proj_a, se3.invert(pose), sp.mu, sp.voxel_size,
                                                  hp.block_size, MAX_BAND_STEPS, sp.view_frustum_min,
                                                  sp.view_frustum_max)
    cand = blocks.reshape(-1, 3)
    cand_valid = valid.reshape(-1) & enable

    gp = settings.block_grid
    gx, gy, gz = gp.dims
    ox, oy, oz = gp.origin
    G3 = gx * gy * gz
    g0, g1, g2 = cand[:, 0] - ox, cand[:, 1] - oy, cand[:, 2] - oz
    in_grid = (g0 >= 0) & (g0 < gx) & (g1 >= 0) & (g1 < gy) & (g2 >= 0) & (g2 < gz)
    cell = (g0 * gy + g1) * gz + g2
    entry_grid = vol.entry_grid if vol.entry_grid is not None else hv.build_entry_grid(vol, gp)
    code = entry_grid[cell.clamp(0, G3 - 1).long()]
    known = cand_valid & in_grid & (code >= 0)
    # visibility marks for known entries: 2 if swapped out, 1 otherwise
    vis_val = torch.where((code & 1) == 1, hv.VT_VISIBLE_SWAPPED, hv.VT_VISIBLE)
    visible_type = scatter_drop(visible_type, torch.where(known, code >> 1, E), torch.where(known, vis_val, 0))

    # out-of-grid candidates probe the hash (the grid is an accelerator,
    # the hash stays canonical)
    oog = cand_valid & ~in_grid
    n_oog = oog.sum(dtype=torch.int32)
    ocap = oog_cap(settings)
    oidx, _ = compact_by_mask(oog, torch.arange(oog.shape[0], **i32), ocap, fill=-1)
    ocand = cand[oidx.clamp(0, cand.shape[0] - 1).long()]
    ovalid = oidx >= 0
    opr = hv.probe(vol, ocand, hp, include_swapped=True)
    ofound = ovalid & opr.found
    ovis = torch.where(opr.entry_ptr == hv.SWAPPED_PTR, hv.VT_VISIBLE_SWAPPED, hv.VT_VISIBLE)
    visible_type = scatter_drop(visible_type, torch.where(ofound, opr.entry_idx, E), torch.where(ofound, ovis, 0))

    n_alloc_overflow = torch.zeros((), **i32)
    n_unplaced = torch.zeros((), **i32)
    if not only_update_visible:
        # new in-grid cells: deduped through a want plane, compacted, inserted
        want_at = torch.where(cand_valid & in_grid & (code < 0), cell, G3)
        want = scatter_drop(torch.zeros((G3 + 1,), dtype=torch.bool, device=dev), want_at, True)[:G3]
        n_want = want.sum(dtype=torch.int32)
        n_alloc_overflow = (n_want - settings.max_alloc_blocks).clamp(min=0) + (n_oog - ocap).clamp(min=0)
        ncell, _ = compact_by_mask(want, torch.arange(G3, **i32), settings.max_alloc_blocks, fill=-1)
        ncell_c = ncell.clamp(0, G3 - 1)
        nblocks = torch.stack([ncell_c // (gy * gz) + ox, (ncell_c // gz) % gy + oy, ncell_c % gz + oz],
                              dim=-1).to(torch.int32)
        # round 2 on the same set: same-bucket losers of round 1 insert now
        # (already-inserted blocks re-probe as found and are no-ops)
        vol, visible_type, w1 = hv.insert_blocks(vol, visible_type, nblocks, ncell >= 0, hp, grid_params=gp)
        vol, visible_type, w2 = hv.insert_blocks(vol, visible_type, nblocks, ncell >= 0, hp, grid_params=gp)
        vol, visible_type, ow = hv.insert_blocks(vol, visible_type, ocand, ovalid & ~opr.found, hp, grid_params=gp)
        n_unplaced = _unplaced(torch.cat([nblocks, ocand]), torch.cat([ncell >= 0, ovalid & ~opr.found]),
                               torch.cat([(w1 < E) | (w2 < E), ow < E]))

    use_swapping = settings.swapping_mode.value == SwappingMode.ENABLED.value
    new_rs = hv.build_visible_list(vol, visible_type, pose, proj, img_size, sp.voxel_size, hp,
                                   use_enlarged=use_swapping, prev_ids=render_state.visible_ids)
    return vol, new_rs, n_alloc_overflow, n_unplaced


def _visible_rows(vol: HashVolume, render_state: RenderStateVH, cap: int):
    """(ids, VBA rows with −1 for a skipped row, block coords, valid) of the
    first `cap` visible rows (0: all of them), looked up as K2 does."""
    ids = render_state.visible_ids
    ptrs, bpos = integrate_kernel.lookup_rows(ids, vol.entry_ptr, vol.entry_pos, cap)
    return ids[: ptrs.shape[0]], ptrs, bpos, ptrs >= 0


def integrate_into_scene(
    vol: HashVolume,
    render_state: RenderStateVH,
    view: View,
    pose: torch.Tensor,
    proj: torch.Tensor,
    settings: Settings,
    proj_rgb: torch.Tensor | None = None,
    rgb_to_depth: torch.Tensor | None = None,
    enable: torch.Tensor | bool = True,
) -> HashVolume:
    """IntegrateIntoScene over the visible blocks (kernel K2, in place in
    `vol.vox`, and in `vol.vox_rgb` when `use_color` and the view has RGB).
    The rgb camera sees the world through M_rgb = rgb_to_depth⁻¹ · pose
    (reference trafo_rgb_to_depth.calib_inv · M_d). The kernel reads the
    visible list and the hash entries itself; blocks beyond
    `max_fused_blocks` fuse on a later frame."""
    sp = settings.scene
    if not torch.is_tensor(enable):
        enable = torch.full((), bool(enable), device=vol.vox.device)
    rows = (render_state.visible_ids, vol.entry_ptr, vol.entry_pos)
    fuse = (sp.voxel_size, sp.mu, sp.max_w, sp.stop_integrating_at_max_w, settings.hashing.block_size,
            settings.max_fused_blocks)
    if settings.use_color and view.rgb is not None and vol.vox_rgb is not None:
        M_rgb = se3.invert(rgb_to_depth) @ pose if rgb_to_depth is not None else pose
        integrate_kernel.integrate_rgbd(
            vol.vox, vol.vox_rgb, *rows, view.depth.contiguous(), view.rgb.contiguous(), pose, proj,
            M_rgb.contiguous(), proj_rgb if proj_rgb is not None else proj, enable, *fuse,
        )
    else:
        integrate_kernel.integrate_depth(vol.vox, *rows, view.depth.contiguous(), pose, proj, enable, *fuse)
    return vol


def _project_block_corners(bpos: torch.Tensor, pose: torch.Tensor, proj: torch.Tensor, factor: float):
    """Project the 8 corners of each block → (U, V, Z) [V, 8]; corners behind
    the camera map to ∓1e9 (reference ProjectSingleBlock)."""
    fx, fy, cx, cy = proj[0], proj[1], proj[2], proj[3]
    us, vs, zs = [], [], []
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                pc = se3.apply_planes(
                    pose, (bpos[:, 0] + dx) * factor, (bpos[:, 1] + dy) * factor, (bpos[:, 2] + dz) * factor
                )
                z = pc[2]
                ok = z > 1e-6
                zsafe = torch.where(ok, z, torch.ones_like(z))
                far = torch.where(z <= 0, -1e9, 1e9)
                us.append(torch.where(ok, fx * pc[0] / zsafe + cx, far))
                vs.append(torch.where(ok, fy * pc[1] / zsafe + cy, far))
                zs.append(z)
    return torch.stack(us, -1), torch.stack(vs, -1), torch.stack(zs, -1)


def count_too_big_blocks(vol, render_state, pose, proj, settings: Settings,
                         img_size: Tuple[int, int]) -> torch.Tensor:
    """Visible blocks whose projected bbox reaches the MAX_T×MAX_T raster tile
    of expected_depth_ranges (their range widens to the frustum), among those
    whose bbox meets the image. A block wholly beside the image, which the
    swap path's visibility test (the image padded by 1/8) can keep, clips to
    the image's border in the raster and widens nothing; the JAX package
    counts it (ROADMAP Queue 3)."""
    H, W = img_size
    sub = settings.minmax_subsample
    _ids, _ptr, bpos, valid = _visible_rows(vol, render_state, settings.max_render_blocks)
    U, V, Z = _project_block_corners(
        bpos.to(torch.float32), pose, proj, settings.hashing.block_size * settings.scene.voxel_size
    )
    u_lo, u_hi, v_lo, v_hi = U.amin(-1), U.amax(-1), V.amin(-1), V.amax(-1)
    meets = (u_hi >= 0) & (u_lo < W) & (v_hi >= 0) & (v_lo < H)
    onscreen = (Z > 0).any(-1)
    big = ((u_hi - u_lo) / sub >= MINMAX_MAX_T) | ((v_hi - v_lo) / sub >= MINMAX_MAX_T)
    return (valid & onscreen & meets & big).sum(dtype=torch.int32)


def expected_depth_ranges(vol, render_state, pose, proj, img_size: Tuple[int, int], settings: Settings):
    """Per-pixel raycast range from the visible blocks' projections
    (reference CreateExpectedDepths: min/max z rasterised into a
    ×minmax_subsample grid, here scatter amin/amax). Returns (zmin, zmax)
    at full resolution and the count of blocks whose range fell back to the
    frustum."""
    sp = settings.scene
    H, W = img_size
    sub = settings.minmax_subsample
    Hs, Ws = (H + sub - 1) // sub, (W + sub - 1) // sub
    dev = pose.device
    ids, _ptr, bpos, valid = _visible_rows(vol, render_state, settings.max_render_blocks)
    nV = ids.shape[0]

    U, V, Z = _project_block_corners(
        bpos.to(torch.float32), pose, proj, settings.hashing.block_size * sp.voxel_size
    )
    behind = (Z <= 0).any(-1)
    u0 = torch.floor(U.amin(-1) / sub).to(torch.int32).clamp(0, Ws - 1)
    u1 = torch.ceil(U.amax(-1) / sub).to(torch.int32).clamp(0, Ws - 1)
    v0 = torch.floor(V.amin(-1) / sub).to(torch.int32).clamp(0, Hs - 1)
    v1 = torch.ceil(V.amax(-1) / sub).to(torch.int32).clamp(0, Hs - 1)
    zmin_b = torch.clamp(Z.amin(-1), min=sp.view_frustum_min)
    zmax_b = torch.clamp(Z.amax(-1), max=sp.view_frustum_max)
    fmin = torch.full_like(zmin_b, sp.view_frustum_min)
    fmax = torch.full_like(zmax_b, sp.view_frustum_max)
    zmin_b = torch.where(behind, fmin, zmin_b)
    zmax_b = torch.where(behind, fmax, zmax_b)

    # two-tier raster: most blocks fit SMALL_T cells per axis; the larger
    # ones are compacted into a MAX_T raster; beyond MAX_T the range widens
    MAX_T, SMALL_T = MINMAX_MAX_T, MINMAX_SMALL_T
    du_c, dv_c = u1 - u0, v1 - v0
    too_big = (du_c >= MAX_T) | (dv_c >= MAX_T)
    n_too_big = (valid & too_big).sum(dtype=torch.int32)
    is_large = valid & ~too_big & ((du_c >= SMALL_T) | (dv_c >= SMALL_T))
    is_small = valid & ~too_big & ~is_large
    zmin_b = torch.where(too_big, fmin, zmin_b)
    zmax_b = torch.where(too_big, fmax, zmax_b)

    zmin_img = torch.full((Hs * Ws,), sp.view_frustum_max, dtype=torch.float32, device=dev)
    zmax_img = torch.full((Hs * Ws,), sp.view_frustum_min, dtype=torch.float32, device=dev)

    def raster(z_lo, z_hi, u0t, v0t, u1t, v1t, ok, T, imgs):
        zmin_i, zmax_i = imgs
        d = torch.arange(T, device=dev)
        uu = u0t[:, None, None] + d[None, :, None]
        vv = v0t[:, None, None] + d[None, None, :]
        in_box = (uu <= u1t[:, None, None]) & (vv <= v1t[:, None, None]) & ok[:, None, None]
        flat = torch.where(in_box, vv * Ws + uu, Hs * Ws).reshape(-1)
        zl = z_lo[:, None, None].expand(in_box.shape).reshape(-1)
        zh = z_hi[:, None, None].expand(in_box.shape).reshape(-1)
        return scatter_drop(zmin_i, flat, zl, reduce="amin"), scatter_drop(zmax_i, flat, zh, reduce="amax")

    imgs = raster(
        zmin_b, zmax_b, u0, v0, torch.minimum(u1, u0 + SMALL_T - 1), torch.minimum(v1, v0 + SMALL_T - 1),
        is_small, SMALL_T, (zmin_img, zmax_img),
    )
    LARGE_CAP = max(nV // 8, 256)
    order = torch.arange(nV, dtype=torch.int32, device=dev)
    lidx, n_large = compact_by_mask(is_large, order, LARGE_CAP, fill=-1)
    lvalid = lidx >= 0
    lc = lidx.clamp(0, nV - 1).long()
    # large-tier compaction overflow falls back to the clipped small raster
    # and counts as too big (its range loosens)
    n_too_big = n_too_big + (n_large - LARGE_CAP).clamp(min=0)
    imgs = raster(
        zmin_b[lc], zmax_b[lc], u0[lc], v0[lc],
        torch.minimum(u1[lc], u0[lc] + MAX_T - 1), torch.minimum(v1[lc], v0[lc] + MAX_T - 1),
        lvalid, MAX_T, imgs,
    )
    # large blocks beyond the compaction cap widen their cells to the frustum
    # (nothing is written when none overflowed)
    all_large, _ = compact_by_mask(is_large, order, nV, fill=-1)
    ov = all_large[LARGE_CAP:]
    oc = ov.clamp(0, nV - 1).long()
    imgs = raster(
        fmin[oc], fmax[oc], u0[oc], v0[oc], torch.minimum(u1[oc], u0[oc] + MAX_T - 1),
        torch.minimum(v1[oc], v0[oc] + MAX_T - 1), ov >= 0, MAX_T, imgs,
    )
    zmin_img, zmax_img = imgs[0].reshape(Hs, Ws), imgs[1].reshape(Hs, Ws)
    # empty cells: collapse the march to a no-op
    empty = zmax_img < zmin_img
    zmin_img = torch.where(empty, sp.view_frustum_max, zmin_img)
    zmax_img = torch.where(empty, sp.view_frustum_max, zmax_img)

    if H % sub == 0 and W % sub == 0:
        def up(img):
            return img[:, None, :, None].expand(Hs, sub, Ws, sub).reshape(H, W)
        return up(zmin_img), up(zmax_img), n_too_big
    rows = (torch.arange(H, device=dev) // sub)[:, None]
    cols = (torch.arange(W, device=dev) // sub)[None, :]
    return zmin_img[rows, cols], zmax_img[rows, cols], n_too_big


def raycast_hash(vol, render_state, pose, proj, img_size: Tuple[int, int], settings: Settings,
                 enable: torch.Tensor | None = None) -> rc.RaycastResult:
    """Raycast of the volume from `pose` between the expected depth ranges
    (reference genericRaycast): kernel K3 through the block grid, or K3h
    through the hash table when `use_block_grid` is false. With
    `raycast_coarse_factor` c > 1, where c divides the image, a first launch
    at (H/c, W/c) with every intrinsic divided by c, over the min and max of
    the ranges in each c×c window, tightens the ranges of the full launch
    (ops/raycast.py refine_ranges_from_coarse, margin 2μ), as the JAX
    package's hierarchical raycast does. With `enable` (a device bool)
    false no ray is marched and the points are unspecified."""
    sp, hp = settings.scene, settings.hashing
    zmin, zmax, _ = expected_depth_ranges(vol, render_state, pose, proj, img_size, settings)
    inv_M = se3.invert(pose)
    if settings.use_block_grid:
        grid = hv.get_block_grid(vol, settings.block_grid)

        def march(proj_l, size, z0, z1):
            return raycast_kernel.raycast_grid(vol, grid, settings.block_grid, hp, inv_M, proj_l, size,
                                               1.0 / sp.voxel_size, sp.mu, z0, z1, enable=enable)
    else:
        def march(proj_l, size, z0, z1):
            return raycast_kernel.raycast_hash_probe(vol, hp, inv_M, proj_l, size, 1.0 / sp.voxel_size, sp.mu, z0,
                                                     z1, enable=enable)

    H, W = img_size
    c = settings.raycast_coarse_factor
    if c > 1 and H % c == 0 and W % c == 0:
        Hc, Wc = H // c, W // c
        zmin_c = zmin.reshape(Hc, c, Wc, c).amin(dim=(1, 3))
        zmax_c = zmax.reshape(Hc, c, Wc, c).amax(dim=(1, 3))
        res_c = march(proj / c, (Hc, Wc), zmin_c, zmax_c)
        zmin, zmax = rc.refine_ranges_from_coarse(res_c.points, pose, sp.voxel_size, img_size, c,
                                                  margin_m=2.0 * sp.mu, zmin0=zmin, zmax0=zmax)
    return march(proj, img_size, zmin, zmax)


def raycast_hash_diag(vol, render_state, pose, proj, img_size: Tuple[int, int],
                      settings: Settings) -> Tuple[rc.RaycastResult, torch.Tensor]:
    """raycast_hash and its dropped-page count: 0, as on the JAX package's
    XLA path, since the kernels have no page pool (the raster cap is counted
    by n_too_big_blocks)."""
    return (raycast_hash(vol, render_state, pose, proj, img_size, settings),
            torch.zeros((), dtype=torch.int32, device=pose.device))


def find_visible_blocks(vol: HashVolume, pose: torch.Tensor, proj: torch.Tensor, img_size: Tuple[int, int],
                        settings: Settings) -> RenderStateVH:
    """The visible-entry list for any camera (reference
    IITMVisualisationEngine::FindVisibleBlocks, the freeview render of
    ITMMainEngine::GetImage): the projection check over all E entries,
    compacted in entry order with no host sync. For rendering only: the
    state has no claim or epoch planes and must not be fed back into
    process_frame_hash."""
    hp = settings.hashing
    E = hp.n_entries
    vis = hv.check_block_visibility(vol.entry_pos, pose, proj, img_size, settings.scene.voxel_size, hp.block_size)
    mask = (vol.entry_ptr >= 0) & vis
    ids, n_visible = compact_by_mask(mask, torch.arange(E, dtype=torch.int32, device=pose.device),
                                     hp.max_visible_blocks, fill=-1)
    return RenderStateVH(visible_type=torch.zeros((E,), dtype=torch.int32, device=pose.device), visible_ids=ids,
                         n_visible=n_visible)


def prepare_tracking_maps(vol, render_state, pose, proj, img_size: Tuple[int, int], settings: Settings,
                          enable: torch.Tensor | None = None):
    """Raycast + ICP maps for the next frame's tracker (unspecified where
    `enable` is false, see raycast_hash). Returns (points_map, normals_map,
    n_pool_overflow); the CUDA raycast has no block pool, so the overflow is
    0 by construction."""
    res = raycast_hash(vol, render_state, pose, proj, img_size, settings, enable=enable)
    pm, nm = rc.make_icp_maps(res, settings.scene.voxel_size, se3.invert(pose))
    return pm, nm, torch.zeros((), dtype=torch.int32, device=pose.device)


def create_point_cloud(vol, render_state, pose, proj_rgb, depth_to_rgb, img_size: Tuple[int, int],
                       settings: Settings):
    """The colour tracker's point cloud, raycast in the RGB frame (reference
    ITMTrackingController::Prepare colour branch + CreatePointCloud):
    (locations, colours) as [H, W, 4] maps, metres and 0..1, w = 1 where
    the ray hit and −1 elsewhere."""
    res = raycast_hash(vol, render_state, depth_to_rgb @ pose, proj_rgb, img_size, settings)
    found = (res.points[..., 3] > 0)[..., None]
    w = torch.where(found, 1.0, -1.0)
    zero = torch.zeros_like(res.points[..., :3])
    locations = torch.cat([torch.where(found, res.points[..., :3] * settings.scene.voxel_size, zero), w], dim=-1)
    clr = read_color_interpolated(hv.make_hash_color_reader(vol, settings.hashing), res.points[..., :3])
    colours = torch.cat([torch.where(found, clr, zero), w], dim=-1)
    return locations, colours


def _rgb_extrinsics(rgb_to_depth, device):
    """(depth_to_rgb, rgb_to_depth), identity when no extrinsic is given."""
    if rgb_to_depth is None:
        eye = torch.eye(4, dtype=torch.float32, device=device)
        return eye, eye
    return se3.invert(rgb_to_depth), rgb_to_depth


def _track_fuse_impl(vol, render_state, state: TrackingState, view: View, proj, settings: Settings,
                     fusion_active: bool, proj_rgb=None, rgb_to_depth=None, external_pose=None, swap_states=None):
    """Track → divergence gate → allocate (with `swap_states`: then the
    visible swapped-out entries take blocks and the visible entries are
    marked for a swap-in check) → integrate. Returns (vol, render_state,
    swap_states, pose, tr, (n_alloc_overflow, n_alloc_unplaced))."""
    tt = settings.tracker_type.value
    if tt == TrackerType.EXTERNAL.value:
        tr = track_external(state.pose, external_pose if external_pose is not None else state.pose)
    elif tt == TrackerType.COLOR.value:
        d2r, r2d = _rgb_extrinsics(rgb_to_depth, proj.device)
        # the maps hold locations and colours (reference: same buffer pair)
        tr = track_color(
            state.pose, view.rgb, proj_rgb if proj_rgb is not None else proj, state.points_map,
            state.normals_map, d2r, r2d, settings.tracking, skip_points=settings.skip_points,
        )
    elif tt == TrackerType.REN.value:
        # composite ICP → Ren (reference ITMTrackerFactory MakeRenTracker):
        # ICP runs the coarse levels (noICPRunTillLevel = 1), then the SDF
        # tracker refines at the finest level against the volume itself
        tr_icp = track_depth(
            state.pose, view.depth, proj, state.points_map, state.normals_map, state.pose_point_cloud,
            dataclasses.replace(settings.tracking, no_icp_run_till_level=1),
        )
        if settings.use_block_grid:
            read = hv.make_grid_reader(vol, hv.get_block_grid(vol, settings.block_grid), settings.block_grid,
                                       settings.hashing)
        else:
            read = hv.make_hash_reader(vol, settings.hashing)
        tr = track_ren(tr_icp.pose, view.depth, proj, read, settings.scene.voxel_size, settings.tracking)
        # the result reports Ren's own energy and ICP's correspondence count;
        # the divergence gate below reads ICP's f, whose 1e5 sentinel it knows
        gate_f = tr_icp.f
        tr = tr._replace(num_valid=tr_icp.num_valid)
    else:
        # the weighted tracker takes the view's σ_z; without it (the view
        # was built without model_sensor_noise) it runs unweighted, as the
        # JAX package's does
        tr = track_depth(
            state.pose, view.depth, proj, state.points_map, state.normals_map, state.pose_point_cloud,
            settings.tracking, weights_map=view.depth_uncertainty if tt == TrackerType.WICP.value else None,
        )
    if tt != TrackerType.REN.value:
        gate_f = tr.f
    have_maps = state.age >= 0
    # divergence policy: a frame whose tracking energy spiked keeps the last
    # good pose and is not fused
    dvt = settings.tracking.divergence_f_threshold
    if dvt > 0:
        track_bad = (gate_f >= dvt) & have_maps
    else:
        track_bad = torch.zeros((), dtype=torch.bool, device=proj.device)
    pose = torch.where(have_maps & ~track_bad, tr.pose, state.pose)
    fuse_enable = ~track_bad
    spans.phase("track")

    vol, render_state, *n_alloc = _allocate(vol, render_state, view.depth, pose, proj, settings,
                                            only_update_visible=not fusion_active, enable=fuse_enable)
    if swap_states is not None:
        vol = swapping.reallocate_swapped_out(vol, render_state.visible_type, settings,
                                              visible_ids=render_state.visible_ids)
        swap_states = swapping.mark_visible_for_swap_compact(swap_states, render_state.visible_ids)
    spans.phase("alloc")
    if fusion_active:
        vol = integrate_into_scene(vol, render_state, view, pose, proj, settings, proj_rgb=proj_rgb,
                                   rgb_to_depth=rgb_to_depth, enable=fuse_enable)
    spans.phase("integrate")
    return vol, render_state, swap_states, pose, tr, tuple(n_alloc)


def _prepare_impl(vol, render_state, state: TrackingState, view: View, pose, tr: TrackResult, proj,
                  settings: Settings, proj_rgb=None, rgb_to_depth=None):
    """Raycast the next frame's tracking maps (reference
    ITMTrackingController::Prepare; for the colour tracker the point cloud
    in the RGB frame). With the approximate raycast the stale maps are kept
    and aged until the camera is far from them (reference
    TrackerFarFromPointCloud): the refresh test is a device bool, K3 runs
    on every frame but marches only when it is true, and the maps, their
    pose and age are chosen by torch.where, with no host read."""
    img_size = tuple(view.depth.shape)
    zero = torch.zeros((), dtype=torch.int32, device=pose.device)
    pose_pc, age = pose, zero
    if settings.tracker_type.value == TrackerType.COLOR.value:
        d2r, _r2d = _rgb_extrinsics(rgb_to_depth, proj.device)
        points_map, normals_map = create_point_cloud(
            vol, render_state, pose, proj_rgb if proj_rgb is not None else proj, d2r, img_size, settings
        )
        n_pool = zero
    elif settings.use_approximate_raycast:
        full = (state.age < 0) | track_far_from_point_cloud(pose, state.pose_point_cloud, state.age)
        pm, nm, n_pool = prepare_tracking_maps(vol, render_state, pose, proj, img_size, settings, enable=full)
        points_map = torch.where(full, pm, state.points_map)
        normals_map = torch.where(full, nm, state.normals_map)
        pose_pc = torch.where(full, pose, state.pose_point_cloud)
        age = torch.where(full, zero, state.age + 1)
    else:
        points_map, normals_map, n_pool = prepare_tracking_maps(vol, render_state, pose, proj, img_size, settings)
    return TrackingState(
        pose=pose,
        points_map=points_map,
        normals_map=normals_map,
        pose_point_cloud=pose_pc,
        age=age,
        f=tr.f,
        num_valid=tr.num_valid,
    ), n_pool


def _frame_diag(vol, render_state, pose, proj, tr: TrackResult, settings: Settings, n_alloc,
                n_pool_overflow, img_size: Tuple[int, int]) -> FrameDiagnostics:
    n_alloc_overflow, n_alloc_unplaced = n_alloc
    zero = torch.zeros((), dtype=torch.int32, device=pose.device)
    n_vis = render_state.n_visible
    n_render = (n_vis - settings.max_render_blocks).clamp(min=0) if settings.max_render_blocks else zero
    return FrameDiagnostics(
        f=tr.f,
        num_valid=tr.num_valid,
        n_visible=n_vis,
        n_free_blocks=vol.last_free_block + 1,
        n_alloc_overflow=n_alloc_overflow.to(torch.int32),
        n_render_overflow=n_render.to(torch.int32),
        n_pool_overflow=n_pool_overflow,
        n_too_big_blocks=count_too_big_blocks(vol, render_state, pose, proj, settings, img_size),
        # K2 fuses every voxel of a block with no image window, so nothing
        # clips: 0 by construction
        n_window_clipped=zero,
        n_alloc_unplaced=n_alloc_unplaced,
    )


def _frame_hash(vol, render_state, state, view, proj, settings, fusion_active=True, proj_rgb=None,
                rgb_to_depth=None, external_pose=None):
    """process_frame_hash's step, functional: new state tensors (but
    `vol.vox`, updated in place)."""
    vol, render_state, _sw, pose, tr, n_alloc = _track_fuse_impl(
        vol, render_state, state, view, proj, settings, fusion_active, proj_rgb, rgb_to_depth, external_pose,
    )
    new_state, n_pool = _prepare_impl(vol, render_state, state, view, pose, tr, proj, settings, proj_rgb,
                                      rgb_to_depth)
    spans.phase("raycast")
    diag = _frame_diag(vol, render_state, pose, proj, tr, settings, n_alloc, n_pool,
                       tuple(view.depth.shape))
    return vol, render_state, new_state, diag


def _captured_frame(vol, render_state, state, view, proj, settings, fusion_active, proj_rgb, rgb_to_depth,
                    external_pose):
    """One frame through captured.run (one graph a key): (vol, render_state,
    state) written in place, and the packed (pose, diag)."""

    def body(st, frame):
        view, external_pose, proj, proj_rgb, rgb_to_depth = frame
        vol, rs, s, diag = _frame_hash(*st, view, proj, settings, fusion_active, proj_rgb, rgb_to_depth,
                                       external_pose)
        return (vol, rs, s), (s.pose, diag)

    return captured.run("hash", (settings, fusion_active), body, (vol, render_state, state),
                        (view, external_pose, proj, proj_rgb, rgb_to_depth))


def process_frame_hash(
    vol: HashVolume,
    render_state: RenderStateVH,
    state: TrackingState,
    view: View,
    proj: torch.Tensor,
    settings: Settings,
    fusion_active: bool = True,
    proj_rgb: torch.Tensor | None = None,
    rgb_to_depth: torch.Tensor | None = None,
    external_pose: torch.Tensor | None = None,
    capture: bool = True,
) -> Tuple[HashVolume, RenderStateVH, TrackingState, FrameDiagnostics]:
    """One frame on the hash volume: track → allocate + fuse → raycast.
    With colour (`use_color` or the colour tracker) the view carries RGB,
    `proj_rgb` holds the rgb intrinsics (default: `proj`) and `rgb_to_depth`
    the extrinsic (default: identity). The external tracker takes
    `external_pose` [4, 4] world→camera (default: the last pose).

    With `capture` (the default) the frame runs as one replay of a CUDA
    graph on the card (engine/captured.py; eagerly on the CPU) and the
    state comes back as the caller's own tensors, written in place: keep a
    copy of what must outlive the next frame. The diagnostics are copies.
    With capture=False the step runs op by op and every state tensor but
    `vol.vox` (and `vol.vox_rgb`), which is updated in place, is new.

    With spans on (engine/spans.py), a mark as each phase has been issued:
    "track", "alloc", "integrate", "raycast"; captured or not."""
    if not capture:
        return _frame_hash(vol, render_state, state, view, proj, settings, fusion_active, proj_rgb, rgb_to_depth,
                           external_pose)
    (vol, render_state, state), out = _captured_frame(vol, render_state, state, view, proj, settings,
                                                      fusion_active, proj_rgb, rgb_to_depth, external_pose)
    _pose, diag = out.read()
    return vol, render_state, state, diag


def step_track_fuse_swap(vol, render_state, state: TrackingState, swap_states, view: View, proj,
                         settings: Settings, fusion_active: bool = True, proj_rgb=None, rgb_to_depth=None,
                         external_pose=None):
    """The device half-frame before a synchronous swap exchange: the same
    tracker, divergence gate and fusion as process_frame_hash, with the
    swap-protocol hooks (reference ITMDenseMapper.cpp:51-65). Returns (vol,
    render_state, swap_states, pose, tr, diag)."""
    vol, render_state, swap_states, pose, tr, n_alloc = _track_fuse_impl(
        vol, render_state, state, view, proj, settings, fusion_active, proj_rgb, rgb_to_depth, external_pose,
        swap_states=swap_states,
    )
    zero = torch.zeros((), dtype=torch.int32, device=proj.device)
    diag = _frame_diag(vol, render_state, pose, proj, tr, settings, n_alloc, zero,
                       tuple(view.depth.shape))
    return vol, render_state, swap_states, pose, tr, diag


def step_frame_swap(vol, render_state, state: TrackingState, swap_states, view: View, proj, settings: Settings,
                    fusion_active: bool = True, proj_rgb=None, rgb_to_depth=None, external_pose=None,
                    merge_flips: torch.Tensor | None = None, merge_slab: torch.Tensor | None = None,
                    capture: bool = True):
    """One swap-mode frame, all of it on the device with no host read: the
    resolution of an earlier frame's needed list (`merge_flips`, that list's
    meta [Q+1]: its entries go to state 2; `merge_slab`: the blocks of it
    that have stored data, merged) → track → allocate → integrate (as
    process_frame_hash) → this frame's needed list over the visible list →
    the eviction of one rotating window → raycast. SwapExchange runs the
    host halves around it.

    `capture` as in process_frame_hash: one graph for each combination of
    the merge inputs given and each row count of `merge_slab` (a multiple
    of 64 up to the exchange quantum: at most 6), as jit compiles one
    program for each; the outputs are copies. The spans' marks as in
    process_frame_hash, with "swap" after the list and the eviction.
    Returns (vol, render_state, tracking state, swap_states, diag (a
    SwapDiagnostics: the hash frame's fields, then SWAP_COUNTERS),
    in_meta [Q+1] (needed ids, count), (ev_meta [Qe+1] (evicted ids, count),
    ev_sdf, ev_w, ev_clr, ev_wc))."""
    if not capture:
        return _frame_swap(vol, render_state, state, swap_states, view, proj, settings, fusion_active, proj_rgb,
                           rgb_to_depth, external_pose, merge_flips, merge_slab)

    def body(st, frame):
        view, external_pose, merge_flips, merge_slab, proj, proj_rgb, rgb_to_depth = frame
        vol, rs, s, sw, diag, in_meta, ev = _frame_swap(*st, view, proj, settings, fusion_active, proj_rgb,
                                                        rgb_to_depth, external_pose, merge_flips, merge_slab)
        return (vol, rs, s, sw), (diag, in_meta, ev)

    (vol, render_state, state, swap_states), out = captured.run(
        "swap", (settings, fusion_active), body, (vol, render_state, state, swap_states),
        (view, external_pose, merge_flips, merge_slab, proj, proj_rgb, rgb_to_depth))
    diag, in_meta, ev = out.read()
    return vol, render_state, state, swap_states, diag, in_meta, ev


def _frame_swap(vol, render_state, state, swap_states, view, proj, settings, fusion_active=True, proj_rgb=None,
                rgb_to_depth=None, external_pose=None, merge_flips=None, merge_slab=None):
    """step_frame_swap's step, functional."""
    E = settings.hashing.n_entries
    if merge_flips is not None:
        # listed entries without stored data go straight to state 2 (the
        # flips are an earlier frame's in_meta; its count row is dropped)
        flips = merge_flips[:-1]
        swap_states = scatter_drop(swap_states, torch.where(flips >= 0, flips, E), 2)
    if merge_slab is not None:
        vol, swap_states = swapping.merge_data_slab(vol, swap_states, merge_slab, settings,
                                                    with_color=settings.use_color and vol.vox_rgb is not None)
    vol, render_state, swap_states, pose, tr, n_alloc = _track_fuse_impl(
        vol, render_state, state, view, proj, settings, fusion_active, proj_rgb, rgb_to_depth, external_pose,
        swap_states=swap_states,
    )
    in_ids, in_n, swap_states = swapping.build_swap_in_list_visible(
        swap_states, render_state.visible_ids, swapping.exchange_quantum(settings))
    vol, swap_states, ev_ids, ev_sdf, ev_w, ev_clr, ev_wc, ev_n = swapping.evict_blocks_window(
        vol, swap_states, render_state.visible_type, settings, swapping.evict_quantum(settings),
        render_state.epoch)
    swap_counts = (ev_n, in_n, swapping.eviction_backlog(vol, swap_states, render_state.visible_type),
                   swapping.list_backlog(swap_states, render_state.visible_ids))
    spans.phase("swap")
    new_state, n_pool = _prepare_impl(vol, render_state, state, view, pose, tr, proj, settings, proj_rgb,
                                      rgb_to_depth)
    spans.phase("raycast")

    diag = SwapDiagnostics(*_frame_diag(vol, render_state, pose, proj, tr, settings, n_alloc, n_pool,
                                        tuple(view.depth.shape)), *swap_counts)
    in_meta = torch.cat([in_ids, in_n[None]])
    ev_meta = torch.cat([ev_ids, ev_n[None]])
    return vol, render_state, new_state, swap_states, diag, in_meta, (ev_meta, ev_sdf, ev_w, ev_clr, ev_wc)


def step_prepare(vol, render_state, state: TrackingState, view: View, pose, tr: TrackResult, proj,
                 settings: Settings, proj_rgb=None, rgb_to_depth=None):
    """The device half-frame after a synchronous swap exchange (the raycast
    prepare). Returns (tracking state, n_pool_overflow)."""
    return _prepare_impl(vol, render_state, state, view, pose, tr, proj, settings, proj_rgb, rgb_to_depth)


def process_sequence_hash(vol, render_state, state, depths: torch.Tensor, proj, settings: Settings,
                          fusion_active: bool = True, rgbs: torch.Tensor | None = None,
                          proj_rgb: torch.Tensor | None = None, rgb_to_depth: torch.Tensor | None = None,
                          capture: bool = True):
    """Replay N depth frames [N, H, W] (with `rgbs` [N, H, W, 3] float 0..1
    for the colour path) with a frame loop that never syncs with the host:
    on the card one frame graph (process_frame_hash's) replayed N times, each
    frame's depth (and rgb) copied into its static input before the replay
    and its pose and diagnostics into [N] buffers after it (capture=False:
    the frames op by op). Returns (vol, render_state, state, poses [N,4,4],
    diags with [N]-stacked fields)."""
    if not capture:
        poses, diags = [], []
        for i, depth in enumerate(depths):
            vol, render_state, state, diag = _frame_hash(
                vol, render_state, state, View(depth=depth, rgb=None if rgbs is None else rgbs[i]), proj, settings,
                fusion_active=fusion_active, proj_rgb=proj_rgb, rgb_to_depth=rgb_to_depth,
            )
            poses.append(state.pose)
            diags.append(diag)
        stacked = FrameDiagnostics(*(torch.stack(list(field)) for field in zip(*diags)))
        return vol, render_state, state, torch.stack(poses), stacked
    rows = None
    for i, depth in enumerate(depths):
        (vol, render_state, state), out = _captured_frame(
            vol, render_state, state, View(depth=depth, rgb=None if rgbs is None else rgbs[i]), proj, settings,
            fusion_active, proj_rgb, rgb_to_depth, None)
        if rows is None:
            rows = torch.empty((len(depths), out.buf.numel()), dtype=torch.uint8, device=out.buf.device)
        rows[i].copy_(out.buf)
    poses, diags = out.read(rows)
    return vol, render_state, state, poses, diags


def create_engine_state(settings: Settings, img_size: Tuple[int, int], device: torch.device | str = "cuda"):
    """(HashVolume, RenderStateVH, TrackingState) for a fresh map on `device`:
    the card unless the caller passes device="cpu" (no fallback: without a
    card the default raises)."""
    vol = hv.create_hash(settings.hashing, with_color=settings.use_color, grid_params=settings.block_grid,
                         device=device)
    rs = hv.create_render_state(settings.hashing, grid_params=settings.block_grid, device=device)
    return vol, rs, create_tracking_state(img_size, device=device)
