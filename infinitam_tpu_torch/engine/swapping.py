"""Host↔device voxel-block streaming (swapping): scenes larger than the
card's memory.

Counterpart of infinitam_tpu/engine/swapping.py (reference
ITMLib/Objects/ITMGlobalCache.h:18-129 and ITMSwappingEngine_CUDA.cu:42-296):

  swap-in : state 1 entries → compact needed list (≤ quantum) → host gather
            → upload → weighted-average merge into the VBA → state 2
  swap-out: state 2 ∧ resident ∧ not visible → copy the block out and clear
            it → back on the free stack (ptr → −1) → download → host scatter
            → state 0

The device steps are tensor ops with static sizes that read nothing back to
the host. Like the integrate kernel, the merge and the eviction update
`vol.vox` (and `vol.vox_rgb`) in place; every other state tensor is new. A
masked row of those writes goes to the never-allocated sentinel row with the
sentinel's own words, so no index is filtered on the host. The host store is
numpy in the JAX package's `.npz` keys, so a store written by either package
loads in the other. `SwapExchange` moves a frame's slabs through pinned host
buffers and reads them two frames later, so the frame never waits on the
card.

swap_states codes (reference ITMHashSwapState): 0 = newest data on the host
or nowhere, 1 = on the host, to be combined with the device, 2 = device
newest, 3 = listed for a merge that has not landed yet (SWAP_IN_FLIGHT).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from infinitam_tpu_torch.config import Settings
from infinitam_tpu_torch.engine import hash_volume as hv
from infinitam_tpu_torch.engine import spans
from infinitam_tpu_torch.engine.hash_volume import HashVolume, RenderStateVH
from infinitam_tpu_torch.ops.hashing import compact_by_mask, scatter_drop

# an entry on a needed list whose host gather has not landed: not listed
# again and not evicted until its merge resolves it to 2 (see SwapExchange)
SWAP_IN_FLIGHT = 3


@dataclasses.dataclass
class GlobalCache:
    """Host store of every addressable block, indexed by hash entry
    (reference ITMGlobalCache, which keeps whole voxels: the colour planes
    too when the voxels have them)."""

    stored_sdf: np.ndarray  # [E, S³] int16 (×32767, as in the VBA)
    stored_w: np.ndarray  # [E, S³] uint8
    has_stored: np.ndarray  # [E] bool
    stored_clr: Optional[np.ndarray] = None  # [E, S³, 3] uint8 (use_color)
    stored_wc: Optional[np.ndarray] = None  # [E, S³] uint8

    @classmethod
    def create(cls, settings: Settings) -> "GlobalCache":
        E = settings.hashing.n_entries
        S3 = settings.hashing.block_volume
        return cls(
            stored_sdf=np.full((E, S3), 32767, dtype=np.int16),
            stored_w=np.zeros((E, S3), dtype=np.uint8),
            has_stored=np.zeros((E,), dtype=bool),
            stored_clr=np.zeros((E, S3, 3), dtype=np.uint8) if settings.use_color else None,
            stored_wc=np.zeros((E, S3), dtype=np.uint8) if settings.use_color else None,
        )

    def save(self, path: str) -> None:
        """reference ITMGlobalCache::SaveToFile."""
        extra = {} if self.stored_clr is None else {"clr": self.stored_clr, "wc": self.stored_wc}
        np.savez_compressed(path, sdf=self.stored_sdf, w=self.stored_w, has=self.has_stored, **extra)

    def reset(self) -> None:
        """An empty store, in place: only the flags are cleared, since the
        planes are read only where a flag is set (a new store allocates and
        fills 1.81 GB at the default table)."""
        self.has_stored[:] = False

    @classmethod
    def load(cls, path: str) -> "GlobalCache":
        z = np.load(path)
        return cls(stored_sdf=z["sdf"], stored_w=z["w"], has_stored=z["has"],
                   stored_clr=z["clr"] if "clr" in z else None, stored_wc=z["wc"] if "wc" in z else None)


def create_swap_states(settings: Settings, device: torch.device | str = "cuda") -> torch.Tensor:
    """[E] int32 swap states, all 0, on `device` (the card unless the caller
    passes "cpu")."""
    return torch.zeros((settings.hashing.n_entries,), dtype=torch.int32, device=device)


def _entry_ids(swap_states: torch.Tensor) -> torch.Tensor:
    return torch.arange(swap_states.shape[0], dtype=torch.int32, device=swap_states.device)


def _mark_in_flight(swap_states: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    E = swap_states.shape[0]
    return scatter_drop(swap_states, torch.where(ids >= 0, ids, E), SWAP_IN_FLIGHT)


def build_swap_in_list(swap_states: torch.Tensor, cap: int):
    """reference buildListToSwapIn_device: the state-1 entries, compacted in
    entry order, at most `cap`. Returns ([cap] ids, −1 padded; count)."""
    ids, n = compact_by_mask(swap_states == 1, _entry_ids(swap_states), cap, fill=-1)
    return ids, n.clamp(max=cap)


def build_swap_in_list_mark(swap_states: torch.Tensor, cap: int):
    """build_swap_in_list, with the listed entries set in flight, so that a
    list built before this one's merge lands cannot list them again (a
    second listing would combine the stored content twice)."""
    ids, n = build_swap_in_list(swap_states, cap)
    return ids, n, _mark_in_flight(swap_states, ids)


def build_swap_in_list_visible(swap_states: torch.Tensor, visible_ids: torch.Tensor, cap: int):
    """The needed list over the compact visible list instead of all E
    entries: state-1 entries are marked from visibility, so the list holds
    each freshly marked one; one that leaves the view unlisted is listed
    when next visible. Listed entries go in flight."""
    E = swap_states.shape[0]
    idc = visible_ids.clamp(0, E - 1)
    need = (visible_ids >= 0) & (swap_states[idc.long()] == 1)
    ids, n = compact_by_mask(need, idc, cap, fill=-1)
    return ids, n.clamp(max=cap), _mark_in_flight(swap_states, ids)


def mark_visible_for_swap(swap_states: torch.Tensor, visible_type: torch.Tensor) -> torch.Tensor:
    """reference buildVisibleList_device: a visible entry that is not device
    newest needs a swap-in check (state → 1); entries in flight keep their
    state (marking them would combine their stored content twice)."""
    return torch.where((visible_type > 0) & (swap_states != 2) & (swap_states != SWAP_IN_FLIGHT), 1, swap_states)


def mark_visible_for_swap_compact(swap_states: torch.Tensor, visible_ids: torch.Tensor) -> torch.Tensor:
    """mark_visible_for_swap over the compact visible list, which holds
    exactly the entries with visible_type > 0: ≤ V rows instead of [E]."""
    E = swap_states.shape[0]
    idc = visible_ids.clamp(0, E - 1)
    st = swap_states[idc.long()]
    new_st = torch.where((st != 2) & (st != SWAP_IN_FLIGHT), 1, st)
    return scatter_drop(swap_states, torch.where(visible_ids >= 0, idc, E), new_st)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·b + c rounded once to float32, as the JAX package's CPU build fuses
    the merge's `wₛ·fₛ + w_d·f_d` (the first product into the add); the exact
    product and the sum run in float64."""
    return (a.double() * b.double() + c.double()).float()


def _merge_core(vol: HashVolume, swap_states, needed_ids, src_sdf, src_w, valid, settings: Settings,
                src_clr_q=None, src_wc=None) -> Tuple[HashVolume, torch.Tensor]:
    """Fold host data (`src_sdf` float, `src_w` int32, [cap, S³]; colour as
    0..255 [cap, S³, 3] and int32) into the resident blocks of `needed_ids`,
    in place; every listed entry goes to state 2."""
    E = settings.hashing.n_entries
    max_w = settings.scene.max_w
    ids_c = needed_ids.clamp(0, E - 1).long()
    ptr = vol.entry_ptr[ids_c]
    valid = valid & (needed_ids >= 0) & (ptr >= 0)
    rows = torch.where(valid, ptr, hv.sentinel_row(settings.hashing)).long()
    keep = ~valid[:, None]

    dst_vox = vol.vox[rows]
    dst_sdf, dst_w = hv.vox_sdf(dst_vox), hv.vox_w(dst_vox)
    # combineVoxelDepthInformation: where the host weight is 0 the device
    # voxel stays; else the float32 weighted mean, the weight capped at max_w
    merged_w_raw = dst_w + src_w
    merged_sdf = _fma(src_w, src_sdf, dst_w * dst_sdf) / merged_w_raw.clamp(min=1)
    use = (src_w > 0) & valid[:, None]
    out_sdf = torch.where(use, merged_sdf, dst_sdf)
    out_w = torch.where(use, merged_w_raw.clamp(max=max_w), dst_w)
    vol.vox[rows] = torch.where(keep, dst_vox, hv.pack_vox(hv.sdf_to_q(out_sdf), out_w))
    if vol.vox_rgb is not None and src_clr_q is not None:
        # combineVoxelColorInformation: the same running average on (clr,
        # w_color); wᶜ·(q/255) is formed as q·(wᶜ/255), as the JAX package's
        # CPU build reassociates it
        dst_rgb = vol.vox_rgb[rows]
        dst_q, dst_wc = hv.rgb_clr_q(dst_rgb), hv.rgb_wc(dst_rgb)
        src_wc = src_wc.to(torch.int32)
        merged_wc_raw = dst_wc + src_wc
        w_src, w_dst = hv.clr_from_q(src_wc)[..., None], hv.clr_from_q(dst_wc)[..., None]
        merged_clr = _fma(src_clr_q, w_src, dst_q.to(torch.float32) * w_dst) / merged_wc_raw.clamp(min=1)[..., None]
        use_c = (src_wc > 0) & valid[:, None]
        out_clr = torch.where(use_c[..., None], merged_clr, hv.clr_from_q(dst_q))
        out_wc = torch.where(use_c, merged_wc_raw.clamp(max=max_w), dst_wc)
        vol.vox_rgb[rows] = torch.where(keep, dst_rgb, hv.pack_rgb(hv.clr_to_q(out_clr), out_wc))
    swap_states = scatter_drop(swap_states, torch.where(needed_ids >= 0, ids_c, E), 2)
    return vol, swap_states


def merge_swapped_in(vol: HashVolume, swap_states, needed_ids, buf_sdf, buf_w, has_data, settings: Settings,
                     buf_clr=None, buf_wc=None) -> Tuple[HashVolume, torch.Tensor]:
    """reference integrateOldIntoActiveData_device + combineVoxel*Information
    (DeviceAgnostic/ITMSwappingEngine.h:7-63): fold the host-gathered blocks
    (`buf_sdf` int16, `buf_w` uint8 [cap, S³], `has_data` [cap] bool; colour
    uint8 [cap, S³, 3] and [cap, S³]) into the live ones; every needed entry
    goes to state 2, with stored data or without, as in the reference."""
    src_clr_q = src_wc = None
    if vol.vox_rgb is not None and buf_clr is not None:
        src_clr_q, src_wc = buf_clr.to(torch.int32), buf_wc.to(torch.int32)
    return _merge_core(vol, swap_states, needed_ids, hv.sdf_from_q(buf_sdf), buf_w.to(torch.int32), has_data,
                       settings, src_clr_q=src_clr_q, src_wc=src_wc)


def merge_data_slab(vol: HashVolume, swap_states, slab: torch.Tensor, settings: Settings,
                    with_color: bool = False) -> Tuple[HashVolume, torch.Tensor]:
    """The exchange's one-operand merge: `slab` [D(+D)+1, S³] int32 holds D
    packed voxel rows (then D packed colour rows with colour) of the needed
    blocks that have stored data, and in its last row their entry ids
    (SwapExchange._pack_data_slab)."""
    D = (slab.shape[0] - 1) // (2 if with_color else 1)
    ids, packed = slab[-1, :D], slab[:D]
    src_clr_q = src_wc = None
    if with_color and vol.vox_rgb is not None:
        prgb = slab[D:2 * D]
        src_clr_q, src_wc = hv.rgb_clr_q(prgb), hv.rgb_wc(prgb)
    return _merge_core(vol, swap_states, ids, hv.sdf_from_q(hv.vox_sdf_q(packed)), hv.vox_w(packed),
                       torch.ones(ids.shape, dtype=torch.bool, device=slab.device), settings,
                       src_clr_q=src_clr_q, src_wc=src_wc)


def evict_blocks(vol: HashVolume, swap_states, visible_type, settings: Settings, cap: int | None = None):
    """reference buildListToSwapOut + moveActiveDataToTransferBuffer +
    cleanMemory over all E entries: the first `cap` (default
    n_transfer_blocks) entries with state 2, a block and visible_type 0 are
    copied out and cleared, their blocks go back on the free stack, ptr → −1,
    state → 0. Entries beyond the cap stay and go on a later call.

    Returns (vol, swap_states, evicted ids [cap], sdf int16 [cap, S³], w
    uint8, clr uint8 [cap, S³, 3] or None, wc uint8 or None, count)."""
    cap = settings.hashing.n_transfer_blocks if cap is None else cap
    mask = (swap_states == 2) & (vol.entry_ptr >= 0) & (visible_type == hv.VT_NOT_VISIBLE)
    ids, n = compact_by_mask(mask, _entry_ids(swap_states), cap, fill=-1)
    return _evict_rows(vol, swap_states, ids, n.clamp(max=cap), settings)


def evict_blocks_window(vol: HashVolume, swap_states, visible_type, settings: Settings, cap: int, window_idx,
                        n_windows: int = 16):
    """evict_blocks over one rotating window of ⌈E / n_windows⌉ entries, the
    (window_idx mod n_windows)-th: a block is evicted within n_windows frames
    of leaving the view (the reference scans every entry every frame).
    `window_idx` may be a device tensor: the window is gathered at
    arange(W) + offset, with no read to the host. The offset is clamped to
    E − W, so the last window ends at E when n_windows does not divide E
    (the JAX package clamps its slice but not its ids there: ROADMAP
    Queue 3)."""
    E = settings.hashing.n_entries
    W = -(-E // n_windows)
    dev = swap_states.device
    if not torch.is_tensor(window_idx):
        window_idx = torch.tensor(window_idx, dtype=torch.int32, device=dev)
    off = ((window_idx.to(torch.int64) % n_windows) * W).clamp(max=E - W)
    local = torch.arange(W, dtype=torch.int64, device=dev) + off
    mask = (swap_states[local] == 2) & (vol.entry_ptr[local] >= 0) & (visible_type[local] == hv.VT_NOT_VISIBLE)
    ids, n = compact_by_mask(mask, local.to(torch.int32), cap, fill=-1)
    return _evict_rows(vol, swap_states, ids, n.clamp(max=cap), settings)


def _evict_rows(vol: HashVolume, swap_states, ids, n, settings: Settings):
    hp = settings.hashing
    E = hp.n_entries
    sent = hv.sentinel_row(hp)
    valid = ids >= 0
    ids_c = ids.clamp(0, E - 1).long()
    ptr_c = torch.where(valid, vol.entry_ptr[ids_c], 0)
    rows = torch.where(valid, ptr_c, sent).long()
    keep = ~valid[:, None]

    # read the blocks before they are cleared; the host store keeps the
    # reference's voxel planes (int16 sdf, uint8 w)
    buf_vox = vol.vox[ptr_c.long()]
    buf_sdf = hv.vox_sdf_q(buf_vox).to(torch.int16)
    buf_w = hv.vox_w(buf_vox).to(torch.uint8)
    # cleared as the reference's TVoxel(): sdf 1, w 0, colour 0, w_color 0
    vol.vox[rows] = torch.where(keep, vol.vox[sent], hv.VOX_INIT)
    buf_clr = buf_wc = None
    if vol.vox_rgb is not None:
        buf_rgb = vol.vox_rgb[ptr_c.long()]
        buf_clr = hv.rgb_clr_q(buf_rgb).to(torch.uint8)
        buf_wc = hv.rgb_wc(buf_rgb).to(torch.uint8)
        vol.vox_rgb[rows] = torch.where(keep, vol.vox_rgb[sent], 0)

    # the blocks go back on the free stack, above its top, in list order
    stack_idx = vol.last_free_block + torch.cumsum(valid.to(torch.int32), 0)
    ok = valid & (stack_idx < hp.n_blocks)
    alloc_list = scatter_drop(vol.alloc_list, torch.where(ok, stack_idx, hp.n_blocks), ptr_c)
    eidx = torch.where(valid, ids_c, E)
    new_vol = vol._replace(
        alloc_list=alloc_list,
        last_free_block=vol.last_free_block + ok.sum(dtype=torch.int32),
        entry_ptr=scatter_drop(vol.entry_ptr, eidx, hv.SWAPPED_PTR),
    )
    swap_states = scatter_drop(swap_states, eidx, 0)
    if vol.entry_grid is not None:
        cell, inb = hv.grid_cell(vol.entry_pos[ids_c], settings.block_grid)
        cidx = torch.where(valid & inb, cell, vol.entry_grid.shape[0])
        new_vol = new_vol._replace(entry_grid=scatter_drop(vol.entry_grid, cidx, (ids_c << 1) | 1),
                                   block_grid=scatter_drop(vol.block_grid, cidx, -1))
    return new_vol, swap_states, ids, buf_sdf, buf_w, buf_clr, buf_wc, n


def swap_in_gather(cache: GlobalCache, ids_np: np.ndarray, with_color: bool):
    """Host half of IntegrateGlobalIntoLocal: the needed blocks from the
    host store (numpy only). Returns (sdf, w, has, clr, wc) host arrays; w
    and wc are 0 on rows without stored data."""
    sel = np.clip(ids_np, 0, cache.stored_sdf.shape[0] - 1)
    has = cache.has_stored[sel] & (ids_np >= 0)
    buf_sdf = cache.stored_sdf[sel]
    buf_w = np.where(has[:, None], cache.stored_w[sel], 0)
    buf_clr = buf_wc = None
    if with_color and cache.stored_clr is not None:
        buf_clr = cache.stored_clr[sel]
        buf_wc = np.where(has[:, None], cache.stored_wc[sel], 0)
    return buf_sdf, buf_w, has, buf_clr, buf_wc


def swap_in(vol: HashVolume, swap_states, cache: GlobalCache, settings: Settings) -> Tuple[HashVolume, torch.Tensor]:
    """IntegrateGlobalIntoLocal, synchronously: needed list → host gather →
    merge. It reads the list's count to the host; the frame path uses
    SwapExchange instead."""
    ids, n = build_swap_in_list(swap_states, settings.hashing.n_transfer_blocks)
    if int(n) == 0:
        return vol, swap_states
    dev = swap_states.device
    buf_sdf, buf_w, has, buf_clr, buf_wc = swap_in_gather(cache, ids.cpu().numpy(), vol.vox_rgb is not None)

    def up(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return merge_swapped_in(vol, swap_states, ids, up(buf_sdf), up(buf_w), up(has), settings,
                            buf_clr=up(buf_clr), buf_wc=up(buf_wc))


def swap_out_device(vol: HashVolume, swap_states, render_state: RenderStateVH, settings: Settings):
    """Device half of SaveToGlobalMemory (a full-scan evict_blocks). Returns
    (vol, swap_states, host_job): host_job(cache) reads the evicted blocks
    back and scatters them into the store."""
    vol, swap_states, ids, buf_sdf, buf_w, buf_clr, buf_wc, n = evict_blocks(
        vol, swap_states, render_state.visible_type, settings)

    def host_job(cache: GlobalCache) -> None:
        n_ = int(n)
        if n_ == 0:
            return
        ids_np = ids[:n_].cpu().numpy()
        cache.stored_sdf[ids_np] = buf_sdf[:n_].cpu().numpy()
        cache.stored_w[ids_np] = buf_w[:n_].cpu().numpy()
        if buf_clr is not None and cache.stored_clr is not None:
            cache.stored_clr[ids_np] = buf_clr[:n_].cpu().numpy()
            cache.stored_wc[ids_np] = buf_wc[:n_].cpu().numpy()
        cache.has_stored[ids_np] = True

    return vol, swap_states, host_job


def swap_out(vol: HashVolume, swap_states, render_state: RenderStateVH, cache: GlobalCache,
             settings: Settings) -> Tuple[HashVolume, torch.Tensor]:
    """SaveToGlobalMemory, synchronously: evict the invisible device-newest
    blocks (at most n_transfer_blocks) to the host store."""
    vol, swap_states, host_job = swap_out_device(vol, swap_states, render_state, settings)
    host_job(cache)
    return vol, swap_states


def reallocate_swapped_out(vol: HashVolume, visible_type, settings: Settings,
                           visible_ids: Optional[torch.Tensor] = None) -> HashVolume:
    """reference reAllocateSwappedOutVoxelBlocks_device: visible entries with
    ptr −1 take a block from the top of the free stack, in entry order (in
    list order with `visible_ids`, the compact visible list, which holds
    every entry with visible_type > 0: ≤ V rows instead of E)."""
    hp = settings.hashing
    E = hp.n_entries
    if visible_ids is not None:
        ids_c = visible_ids.clamp(0, E - 1)
        icl = ids_c.long()
        need = (visible_ids >= 0) & (visible_type[icl] > 0) & (vol.entry_ptr[icl] == hv.SWAPPED_PTR)
    else:
        ids_c = torch.arange(E, dtype=torch.int32, device=visible_type.device)
        need = (visible_type > 0) & (vol.entry_ptr == hv.SWAPPED_PTR)
    list_idx = vol.last_free_block - (torch.cumsum(need.to(torch.int32), 0) - 1)
    ok = need & (list_idx >= 0)
    new_block = vol.alloc_list[list_idx.clamp(0, hp.n_blocks - 1).long()]
    idx = torch.where(ok, ids_c, E)
    out = vol._replace(entry_ptr=scatter_drop(vol.entry_ptr, idx, new_block),
                       last_free_block=vol.last_free_block - ok.sum(dtype=torch.int32))
    if vol.entry_grid is not None:
        idc = idx.clamp(0, E - 1)
        cell, inb = hv.grid_cell(vol.entry_pos[idc.long()], settings.block_grid)
        cidx = torch.where(ok & inb, cell, vol.entry_grid.shape[0])
        out = out._replace(entry_grid=scatter_drop(vol.entry_grid, cidx, idc << 1),
                           block_grid=scatter_drop(vol.block_grid, cidx, new_block))
    return out


def exchange_quantum(settings: Settings) -> int:
    """Needed-list entries a frame (the reference's transfer buffer bounds
    its exchange the same way, ITMGlobalCache.h:18-40); the rest list on
    later frames."""
    return min(256, settings.hashing.n_transfer_blocks)


def evict_quantum(settings: Settings) -> int:
    """Blocks evicted a frame at most: the eviction slabs are the bulk of
    the frame's device→host traffic (96 KB at 64 blocks); entries beyond
    stay in state 2 and go on later frames."""
    return min(64, settings.hashing.n_transfer_blocks)


def eviction_backlog(vol: HashVolume, swap_states: torch.Tensor, visible_type: torch.Tensor) -> torch.Tensor:
    """The entries an eviction may take and none has: resident, device
    newest (state 2) and not visible, over all E (int32, on the device)."""
    return ((swap_states == 2) & (vol.entry_ptr >= 0)
            & (visible_type == hv.VT_NOT_VISIBLE)).sum(dtype=torch.int32)


def list_backlog(swap_states: torch.Tensor, visible_ids: torch.Tensor) -> torch.Tensor:
    """The visible entries still waiting for a needed list (state 1): after
    a frame's list, those past its quantum (int32, on the device)."""
    E = swap_states.shape[0]
    st = swap_states[visible_ids.clamp(0, E - 1).long()]
    return ((visible_ids >= 0) & (st == 1)).sum(dtype=torch.int32)


def end_session(exchange: "SwapExchange", vol: HashVolume, swap_states: torch.Tensor, render_state: RenderStateVH,
                cache: GlobalCache, settings: Settings):
    """The end of a session (MainEngine.flush_swap: checkpoint save,
    shutdown): the exchange drained (SwapExchange.flush), then one full-scan
    eviction (the frame scans a rotating window) of at most
    n_transfer_blocks. It reads back to the host. Returns (vol,
    swap_states)."""
    vol, swap_states = exchange.flush(vol, swap_states, cache)
    return swap_out(vol, swap_states, render_state, cache, settings)


class SwapExchange:
    """The pipelined host↔device swap exchange of the JAX package (a frame's
    needed list and evicted blocks are read by the host PIPE_DEPTH frames
    later; reference ITMSwappingEngine_CUDA.cu:42-296 exchanges within the
    frame):

    - step_frame_swap resolves an earlier needed list (state flips and a
      data-slab merge), fuses, builds this frame's needed list and evicts a
      window; its outputs are a needed-list meta [Q+1] (ids, count) and an
      eviction pack (meta [Qe+1], sdf, w, clr, wc).
    - after_frame starts their copies to the host and completes the host
      halves of the frame PIPE_DEPTH back: the eviction scatter into the
      store, then the needed list's gather, packed into the slab that the
      next frame merges. A needed block's stored content merges two frames
      after listing (listed entries stay in flight meanwhile); evictions
      reach the store two frames after the scan.

    On the card the copies run on a side stream into pinned buffers, a ring
    of PIPE_DEPTH + 1 slots, after an event on the frame's stream; the host
    reads a slot only after waiting on its copy event, two frames on, and
    keeps the device tensors until then (so their memory is not handed out
    again). A data slab goes up from a pinned ring too, rewritten only after
    its upload's event. `n_waits` counts the events that had not completed
    when the host needed them; `frame_counts` holds what the last
    after_frame did (the host halves of the frame PIPE_DEPTH back: blocks
    evicted into the store, needed-list entries resolved, of them merged
    with stored data; and the waits of the call). With spans on
    (engine/spans.py), the host spans `swap_wait` (the wait for a landing),
    `swap_scatter` (the store's scatter), `swap_gather` (the gather and the
    slab's packing) and `swap_upload`. `reset()` empties it for a fresh map
    and keeps the pinned rings. On the CPU (device="cpu") the copies are
    plain and the protocol the same."""

    _DQ = 64  # data-slab row quantum
    PIPE_DEPTH = 2  # frames a copy waits before the host reads it

    def __init__(self, settings: Settings, with_color: bool, device: torch.device | str = "cuda"):
        self.settings = settings
        self.with_color = with_color
        self.device = torch.device(device)
        self._q = []  # (in_meta on the device, eviction pack, landing), oldest first
        self._merge_flips = None  # in_meta [Q+1] of a landed list, for the next dispatch
        self._merge_slab = None  # data slab for the next dispatch
        # what the host halves have done (read from landed copies only)
        self.n_listed = 0  # needed-list entries resolved
        self.n_merged = 0  # of them, with stored data merged
        self.n_evicted = 0  # blocks scattered into the store
        self.n_waits = 0  # events not complete when the host needed them
        self.frame_counts = dict.fromkeys(("evicted", "listed", "merged", "waits"), 0)
        self._slot = self._up_slot = 0
        if self.device.type != "cuda":
            return
        hp = settings.hashing
        q, qe, s3 = exchange_quantum(settings), evict_quantum(settings), hp.block_volume
        shapes = [((q + 1,), torch.int32), ((qe + 1,), torch.int32), ((qe, s3), torch.int16),
                  ((qe, s3), torch.uint8)]
        if with_color:
            shapes += [((qe, s3, 3), torch.uint8), ((qe, s3), torch.uint8)]
        slots = self.PIPE_DEPTH + 1
        self._stream = torch.cuda.Stream(self.device)
        self._down = [[torch.empty(s, dtype=d, pin_memory=True) for s, d in shapes] for _ in range(slots)]
        self._up = [torch.empty(((2 * q if with_color else q) + 1, s3), dtype=torch.int32, pin_memory=True)
                    for _ in range(slots)]
        self._up_done = [None] * slots

    def reset(self) -> None:
        """The exchange of a fresh map, in place: the copies in flight are
        waited for and dropped, the counts zeroed; the pinned rings stay."""
        if self.device.type == "cuda":
            for _meta, _pack, (_host, event) in self._q:
                event.synchronize()
            for event in self._up_done:
                if event is not None:
                    event.synchronize()
            self._up_done = [None] * len(self._up_done)
        self._q = []
        self._merge_flips = self._merge_slab = None
        self.n_listed = self.n_merged = self.n_evicted = self.n_waits = 0
        self.frame_counts = dict.fromkeys(self.frame_counts, 0)
        self._slot = self._up_slot = 0

    def merge_args(self):
        """(merge_flips, merge_slab) for this frame's step_frame_swap (None
        where nothing is pending)."""
        return self._merge_flips, self._merge_slab

    def _wait(self, event) -> None:
        if event is not None and not event.query():
            self.n_waits += 1
            event.synchronize()

    def _download(self, tensors):
        """Start the copies of a frame's outputs to the host. Returns the
        landing: (host arrays, in the order given, None kept; the event
        after the copies, None on the CPU)."""
        if self.device.type != "cuda":
            return [None if t is None else t.numpy() for t in tensors], None
        slot = self._slot
        self._slot = (slot + 1) % len(self._down)
        ready = torch.cuda.Event()
        ready.record()
        bufs = iter(self._down[slot])
        out = []
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(ready)
            for t in tensors:
                if t is None:
                    out.append(None)
                    continue
                buf = next(bufs)
                buf.copy_(t, non_blocking=True)
                out.append(buf.numpy())
            done = torch.cuda.Event()
            done.record(self._stream)
        return out, done

    def _upload(self, slab: np.ndarray) -> torch.Tensor:
        """A packed data slab on the device (from a pinned ring on the card)."""
        if self.device.type != "cuda":
            return torch.from_numpy(slab)
        slot = self._up_slot
        self._up_slot = (slot + 1) % len(self._up)
        self._wait(self._up_done[slot])
        buf = self._up[slot][: slab.shape[0]]
        buf.numpy()[:] = slab
        dev = torch.empty(slab.shape, dtype=torch.int32, device=self.device)
        dev.copy_(buf, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        self._up_done[slot] = done
        return dev

    def after_frame(self, in_meta: torch.Tensor, out_pack, cache: GlobalCache) -> None:
        """Called once the frame's device work is issued: start the copies of
        its needed-list meta and eviction pack, then complete the host halves
        of the frame PIPE_DEPTH back, whose copies have landed: its evicted
        blocks into the store, then its needed blocks gathered for the next
        frame's merge."""
        landing = self._download((in_meta, *out_pack))
        self._q.append((in_meta, out_pack, landing))
        self._merge_flips = self._merge_slab = None
        waits0 = self.n_waits
        self.frame_counts = dict.fromkeys(self.frame_counts, 0)
        if len(self._q) <= self.PIPE_DEPTH:
            return
        meta_dev, _pack, (host, event) = self._q.pop(0)
        t = spans.start()
        self._wait(event)
        spans.host("swap_wait", t)
        in_meta_h, ev_meta, sdf, w, clr, wc = host
        n_ev = int(ev_meta[-1])
        if n_ev > 0:
            t = spans.start()
            ids_np = ev_meta[:n_ev]
            cache.stored_sdf[ids_np] = sdf[:n_ev]
            cache.stored_w[ids_np] = w[:n_ev]
            if clr is not None and cache.stored_clr is not None:
                cache.stored_clr[ids_np] = clr[:n_ev]
                cache.stored_wc[ids_np] = wc[:n_ev]
            cache.has_stored[ids_np] = True
            self.n_evicted += n_ev
            spans.host("swap_scatter", t)
        n_in = int(in_meta_h[-1])
        d_eff = 0
        if n_in > 0:
            ids_np = in_meta_h[:-1]
            # the flips are the meta's own device tensor: nothing goes up
            self._merge_flips = meta_dev
            t = spans.start()
            bs, bw, has, bc, bwc = swap_in_gather(cache, ids_np, self.with_color)
            d_eff = int(has.sum())
            self.n_listed += n_in
            slab = self._pack_data_slab(ids_np, bs, bw, has, bc, bwc, d_eff) if d_eff > 0 else None
            spans.host("swap_gather", t)
            if slab is not None:
                t = spans.start()
                self._merge_slab = self._upload(slab)
                spans.host("swap_upload", t)
                self.n_merged += d_eff
        self.frame_counts = {"evicted": n_ev, "listed": n_in, "merged": d_eff, "waits": self.n_waits - waits0}

    def _pack_data_slab(self, ids_np, bs, bw, has, bc, bwc, d_eff) -> np.ndarray:
        """The has-data rows as a [D(+D)+1, S³] int32 slab, D = d_eff rounded
        up to _DQ: packed voxels (sdf << 16 | w << 8), no-op rows
        0x7FFF0000 (sdf +1, w 0) after them, then the packed colour rows,
        and the entry ids (−1 padded) in the last row."""
        s3 = self.settings.hashing.block_volume
        D = min(bs.shape[0], -(-d_eff // self._DQ) * self._DQ)
        sel = np.nonzero(has)[0][:D]
        slab = np.zeros(((2 * D if self.with_color else D) + 1, s3), dtype=np.int32)
        k = len(sel)
        slab[:k] = ((bs[sel].astype(np.int32) & 0xFFFF) << 16) | ((bw[sel].astype(np.int32) & 0xFF) << 8)
        slab[k:D] = 0x7FFF0000
        if self.with_color and bc is not None:
            c = bc[sel].astype(np.int32)
            slab[D:D + k] = (c[..., 0] << 24) | (c[..., 1] << 16) | (c[..., 2] << 8) | bwc[sel].astype(np.int32)
        slab[-1, :k] = ids_np[sel]
        slab[-1, k:] = -1
        return slab

    def flush(self, vol: HashVolume, swap_states: torch.Tensor, cache: GlobalCache):
        """Drain every stage (checkpoint save, shutdown): apply the pending
        merges and push empty frames through until each queued frame's host
        half has run. Returns (vol, swap_states)."""
        E = swap_states.shape[0]
        dev = swap_states.device
        q, qe, s3 = exchange_quantum(self.settings), evict_quantum(self.settings), self.settings.hashing.block_volume

        def empty_meta(n):
            return torch.cat([torch.full((n,), -1, dtype=torch.int32, device=dev),
                              torch.zeros((1,), dtype=torch.int32, device=dev)])

        for _ in range(self.PIPE_DEPTH + 3):
            flips, slab = self.merge_args()
            if flips is not None:
                f = flips[:-1]
                swap_states = scatter_drop(swap_states, torch.where(f >= 0, f, E), 2)
            if slab is not None:
                vol, swap_states = merge_data_slab(vol, swap_states, slab, self.settings,
                                                   with_color=self.with_color and vol.vox_rgb is not None)
            # an empty frame, shaped as a real one (its count rows are 0)
            pack = (empty_meta(qe), torch.zeros((qe, s3), dtype=torch.int16, device=dev),
                    torch.zeros((qe, s3), dtype=torch.uint8, device=dev),
                    torch.zeros((qe, s3, 3), dtype=torch.uint8, device=dev) if self.with_color else None,
                    torch.zeros((qe, s3), dtype=torch.uint8, device=dev) if self.with_color else None)
            self.after_frame(empty_meta(q), pack, cache)
        self._q = []
        self._merge_flips = self._merge_slab = None
        return vol, swap_states
