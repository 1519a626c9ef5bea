"""The port's swap tier (infinitam_tpu_torch/engine/swapping.py) held to the
JAX package's, function by function, on the CPU.

Each test builds one random but consistent map from a numpy seed (resident,
swapped-out and free entries, some outside the block grid, random voxel and
colour words, a free stack, random swap states and visible-type codes, a
compact visible list with gaps), hands the same arrays to the JAX function
and to its port, and compares every output. Tolerance: none. The merges,
evictions, reallocations, list builds, markers and slab packing are integer
work or the same float32 ops in the same order, so the outputs must be equal
word for word. The merge is also held to the reference formula
(tests/test_swapping.py::test_combine_voxel_depth_golden), and a host store
written by either package must load in the other.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinitam_tpu import config as j_cfg
from infinitam_tpu.engine import hash_volume as j_hv
from infinitam_tpu.engine import swapping as j_sw
from infinitam_tpu_torch import config as t_cfg
from infinitam_tpu_torch import convert
from infinitam_tpu_torch.engine import hash_volume as t_hv
from infinitam_tpu_torch.engine import swapping as t_sw

# the tensors here are tiny: one intra-op thread per process keeps torch from
# contending for the cores with the other test workers (tier-1 runs under xdist)
torch.set_num_threads(1)

N_ALLOC, N_RESIDENT = 300, 240


def settings(cfg, n_excess=0x40, use_color=False):
    """E = 0x400 + n_excess entries (1088: 16 divides it; 1124: it does not),
    512 blocks, a 16³ block grid, transfer slabs of 64 blocks."""
    return cfg.Settings(
        scene=cfg.SceneParams(voxel_size=0.02, mu=0.08),
        hashing=cfg.VoxelBlockHashParams(n_buckets=0x400, n_excess=n_excess, n_blocks=0x200, n_transfer_blocks=0x40,
                                         max_visible_blocks=0x100),
        block_grid=cfg.BlockGridParams(dims=(16, 16, 16), origin=(-8, -8, 0)),
        swapping_mode=cfg.SwappingMode.ENABLED,
        use_color=use_color,
    )


def random_map(seed=0, n_excess=0x40, use_color=False):
    """(numpy HashVolume fields, swap_states, visible_type, visible_ids)."""
    S = settings(t_cfg, n_excess, use_color)
    hp = S.hashing
    E, B, S3 = hp.n_entries, hp.n_blocks, hp.block_volume
    rng = np.random.default_rng(seed)
    ent = rng.choice(E, N_ALLOC, replace=False)
    gx, gy, gz = S.block_grid.dims
    ox, oy, oz = S.block_grid.origin
    cells = rng.choice(gx * gy * gz, N_ALLOC, replace=False)
    pos = np.stack([cells // (gy * gz) + ox, (cells // gz) % gy + oy, cells % gz + oz], -1)
    pos[:12, 0] += 100  # outside the grid: reached through the hash only
    rows = rng.permutation(B - 1)  # the sentinel row B − 1 is never handed out
    n_free = B - 1 - N_RESIDENT
    d = dict(
        entry_pos=np.zeros((E, 3), np.int32),
        entry_ptr=np.full(E, t_hv.FREE_PTR, np.int32),
        entry_offset=np.zeros(E, np.int32),
        vox=np.full((B, S3), t_hv.VOX_INIT, np.int32),
        alloc_list=np.concatenate([rows[N_RESIDENT:], rows[:N_RESIDENT], [B - 1]]).astype(np.int32),
        last_free_block=np.int32(n_free - 1),
        excess_list=np.arange(hp.n_excess, dtype=np.int32),
        last_free_excess=np.int32(hp.n_excess - 1),
        vox_rgb=np.zeros((B, S3), np.int32) if use_color else None,
        entry_grid=None,
        block_grid=None,
    )
    d["entry_pos"][ent] = pos
    d["entry_ptr"][ent[:N_RESIDENT]] = rows[:N_RESIDENT]
    d["entry_ptr"][ent[N_RESIDENT:]] = t_hv.SWAPPED_PTR
    res = rows[:N_RESIDENT]
    sdf = rng.integers(-32767, 32768, (N_RESIDENT, S3))
    w = rng.integers(0, 101, (N_RESIDENT, S3)) * (rng.random((N_RESIDENT, S3)) < 0.8)
    d["vox"][res] = ((sdf & 0xFFFF) << 16) | (w << 8)
    if use_color:
        c = rng.integers(0, 256, (N_RESIDENT, S3, 4))
        d["vox_rgb"][res] = (c[..., 0] << 24) | (c[..., 1] << 16) | (c[..., 2] << 8) | c[..., 3]
    vol = t_hv.refresh_caches(convert.from_numpy(t_hv.HashVolume, d, device="cpu"), S.block_grid)
    d = convert.to_numpy(vol)
    swap_states = np.zeros(E, np.int32)
    swap_states[ent] = rng.choice(4, N_ALLOC, p=[0.2, 0.25, 0.45, 0.1])
    visible_type = np.zeros(E, np.int32)
    visible_type[ent] = rng.choice(4, N_ALLOC, p=[0.5, 0.25, 0.15, 0.1])
    vis = rng.permutation(np.nonzero(visible_type)[0])
    visible_ids = np.full(hp.max_visible_blocks, -1, np.int32)
    slots = np.sort(rng.choice(len(vis) + 20, len(vis), replace=False))  # −1 gaps between the rows
    visible_ids[slots] = vis
    return d, swap_states, visible_type, visible_ids


def j_vol(d):
    return j_hv.HashVolume(**{k: None if v is None else jnp.asarray(v) for k, v in d.items()})


def t_vol(d):
    return convert.from_numpy(t_hv.HashVolume, d, device="cpu")


def t_arr(a):
    return torch.from_numpy(np.array(a, copy=True))


def assert_same(j, t, what=""):
    """Equal word for word: a state NamedTuple, an array or None."""
    if hasattr(j, "_fields"):
        for k in j._fields:
            assert_same(getattr(j, k), getattr(t, k), f"{what}.{k}")
        return
    assert (j is None) == (t is None), what
    if j is not None:
        a, b = np.asarray(j), t.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f"{what}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}"
        np.testing.assert_array_equal(b, a, err_msg=what)


def test_refresh_caches_matches_jax():
    d, *_ = random_map()
    S = settings(j_cfg)
    j = j_hv.refresh_caches(j_vol(d), S.block_grid)
    t = t_hv.refresh_caches(t_vol(dict(d, entry_grid=None, block_grid=None)), S.block_grid)
    assert_same(j.entry_grid, t.entry_grid, "entry_grid")
    assert_same(j.block_grid, t.block_grid, "block_grid")


def test_swap_list_builders_and_markers_match_jax():
    d, ss, vt, vids = random_map(1)
    cap = 32
    j = j_sw.build_swap_in_list(jnp.asarray(ss), cap)
    t = t_sw.build_swap_in_list(t_arr(ss), cap)
    assert int(t[1]) == int(j[1]) == cap  # more state-1 entries than the cap
    assert_same(j[0], t[0], "build_swap_in_list")
    for jf, tf, args in ((j_sw.build_swap_in_list_mark, t_sw.build_swap_in_list_mark, ()),
                         (j_sw.build_swap_in_list_visible, t_sw.build_swap_in_list_visible, (vids,))):
        j = jf(jnp.asarray(ss), *map(jnp.asarray, args), cap)
        t = tf(t_arr(ss), *map(t_arr, args), cap)
        for k, (a, b) in enumerate(zip(j, t)):
            assert_same(a, b, f"{tf.__name__}[{k}]")
    assert_same(j_sw.mark_visible_for_swap(jnp.asarray(ss), jnp.asarray(vt)),
                t_sw.mark_visible_for_swap(t_arr(ss), t_arr(vt)), "mark_visible_for_swap")
    assert_same(j_sw.mark_visible_for_swap_compact(jnp.asarray(ss), jnp.asarray(vids)),
                t_sw.mark_visible_for_swap_compact(t_arr(ss), t_arr(vids)), "mark_visible_for_swap_compact")


def merge_inputs(seed, d, S, use_color):
    """Needed ids (resident, swapped-out and −1 rows) and host buffers with
    rows without data and voxels of weight 0."""
    rng = np.random.default_rng(seed)
    cap, S3 = S.hashing.n_transfer_blocks, S.hashing.block_volume
    alloc = np.nonzero(d["entry_ptr"] >= -1)[0]
    ids = np.full(cap, -1, np.int32)
    ids[: cap - 8] = rng.choice(alloc, cap - 8, replace=False)
    buf = dict(buf_sdf=rng.integers(-32767, 32768, (cap, S3)).astype(np.int16),
               buf_w=(rng.integers(0, 120, (cap, S3)) * (rng.random((cap, S3)) < 0.7)).astype(np.uint8),
               has_data=rng.random(cap) < 0.75)
    if use_color:
        buf.update(buf_clr=rng.integers(0, 256, (cap, S3, 3)).astype(np.uint8),
                   buf_wc=rng.integers(0, 120, (cap, S3)).astype(np.uint8))
    return ids, buf


@pytest.mark.parametrize("use_color", [False, True], ids=["depth", "colour"])
def test_merge_swapped_in_matches_jax(use_color):
    d, ss, _vt, _v = random_map(2, use_color=use_color)
    S = settings(j_cfg, use_color=use_color)
    ids, buf = merge_inputs(3, d, S, use_color)
    j_v, j_ss = j_sw.merge_swapped_in(j_vol(d), jnp.asarray(ss), jnp.asarray(ids), settings=S,
                                      **{k: jnp.asarray(v) for k, v in buf.items()})
    t_v, t_ss = t_sw.merge_swapped_in(t_vol(d), t_arr(ss), t_arr(ids), settings=S,
                                      **{k: t_arr(v) for k, v in buf.items()})
    assert_same(j_v, t_v, "vol")
    assert_same(j_ss, t_ss, "swap_states")
    assert (t_v.vox.numpy() != d["vox"]).sum() > 10000  # the merge changed voxels
    # the never-allocated sentinel row kept its words
    np.testing.assert_array_equal(t_v.vox.numpy()[-1], d["vox"][-1])


def pack_slab(exchange, ids, buf, cache_like):
    """_pack_data_slab of `exchange` (either package's) on buffers gathered
    as swap_in_gather gathers them."""
    has = buf["has_data"] & (ids >= 0)
    bw = np.where(has[:, None], buf["buf_w"], 0)
    bwc = np.where(has[:, None], buf["buf_wc"], 0) if "buf_wc" in buf else None
    return exchange._pack_data_slab(ids, buf["buf_sdf"], bw, has, buf.get("buf_clr"), bwc, int(has.sum()))


@pytest.mark.parametrize("use_color", [False, True], ids=["depth", "colour"])
def test_pack_data_slab_and_merge_data_slab_match_jax(use_color):
    d, ss, _vt, _v = random_map(4, use_color=use_color)
    Sj, St = settings(j_cfg, use_color=use_color), settings(t_cfg, use_color=use_color)
    ids, buf = merge_inputs(5, d, Sj, use_color)
    slab_j = np.asarray(pack_slab(j_sw.SwapExchange(Sj, use_color), ids, buf, None))
    slab_t = pack_slab(t_sw.SwapExchange(St, use_color, device="cpu"), ids, buf, None)
    assert slab_t.dtype == slab_j.dtype == np.int32
    np.testing.assert_array_equal(slab_t, slab_j)
    assert slab_t.shape[0] == (2 if use_color else 1) * 64 + 1  # D: the has-data count rounded up to 64
    j_v, j_ss = j_sw.merge_data_slab(j_vol(d), jnp.asarray(ss), jnp.asarray(slab_j), Sj, with_color=use_color)
    t_v, t_ss = t_sw.merge_data_slab(t_vol(d), t_arr(ss), torch.from_numpy(slab_t), Sj, with_color=use_color)
    assert_same(j_v, t_v, "vol")
    assert_same(j_ss, t_ss, "swap_states")


def test_merge_matches_the_reference_formula():
    """tests/test_swapping.py::test_combine_voxel_depth_golden on the port:
    combineVoxelDepthInformation — host weight 0 keeps the device voxel,
    else newF = (oldW·oldF + newW·newF) / (oldW + newW), the weight capped."""
    S = settings(t_cfg)
    hp = S.hashing
    S3, max_w = hp.block_volume, S.scene.max_w
    vol = t_hv.create_hash(hp, device="cpu")
    cand = torch.tensor([[4, 5, 6]], dtype=torch.int32)
    vol, _vt, widx = t_hv.insert_blocks(vol, torch.zeros(hp.n_entries, dtype=torch.int32), cand,
                                        torch.ones(1, dtype=torch.bool), hp)
    entry, blk = int(widx[0]), int(vol.entry_ptr[int(widx[0])])
    rng = np.random.RandomState(0)
    dst_sdf = np.round(rng.uniform(-1, 1, S3).astype(np.float32) * 32767) / 32767
    dst_w = rng.randint(0, 90, S3).astype(np.int32)
    src_sdf = np.round(rng.uniform(-1, 1, S3).astype(np.float32) * 32767) / 32767
    src_w = rng.randint(0, 90, S3).astype(np.int32)
    src_w[:37] = 0  # host voxels without data leave the device voxel
    vol.vox[blk] = t_hv.pack_vox(t_hv.sdf_to_q(torch.from_numpy(dst_sdf.astype(np.float32))),
                                 torch.from_numpy(dst_w))
    cap = hp.n_transfer_blocks
    ids = torch.full((cap,), -1, dtype=torch.int32)
    ids[0] = entry
    buf_sdf = torch.full((cap, S3), 32767, dtype=torch.int16)
    buf_sdf[0] = t_hv.sdf_to_q(torch.from_numpy(src_sdf.astype(np.float32))).to(torch.int16)
    buf_w = torch.zeros((cap, S3), dtype=torch.uint8)
    buf_w[0] = torch.from_numpy(src_w.astype(np.uint8))
    has = torch.zeros(cap, dtype=torch.bool)
    has[0] = True
    vol, ss = t_sw.merge_swapped_in(vol, t_sw.create_swap_states(S, device="cpu"), ids, buf_sdf, buf_w, has, S)
    want_sdf, want_w = dst_sdf.copy(), dst_w.copy()
    for i in range(S3):
        old_w, new_w = int(src_w[i]), int(dst_w[i])
        if old_w:
            want_sdf[i] = (old_w * src_sdf[i] + new_w * dst_sdf[i]) / (old_w + new_w)
            want_w[i] = min(old_w + new_w, max_w)
    np.testing.assert_allclose(t_hv.vox_sdf(vol.vox[blk]).numpy(), want_sdf, atol=1e-4)
    np.testing.assert_array_equal(t_hv.vox_w(vol.vox[blk]).numpy(), want_w)
    assert int(ss[entry]) == 2


def compare_evictions(j_out, t_out):
    names = ("vol", "swap_states", "ids", "buf_sdf", "buf_w", "buf_clr", "buf_wc", "n")
    for name, a, b in zip(names, j_out, t_out):
        assert_same(a, b, name)


@pytest.mark.parametrize("cap", [None, 16], ids=["transfer_cap", "cap_16"])
@pytest.mark.parametrize("use_color", [False, True], ids=["depth", "colour"])
def test_evict_blocks_matches_jax(use_color, cap):
    d, ss, vt, _v = random_map(6, use_color=use_color)
    S = settings(j_cfg, use_color=use_color)
    j = j_sw.evict_blocks(j_vol(d), jnp.asarray(ss), jnp.asarray(vt), S, cap=cap)
    t = t_sw.evict_blocks(t_vol(d), t_arr(ss), t_arr(vt), S, cap=cap)
    compare_evictions(j, t)
    n = int(t[-1])
    assert n == min(int(((ss == 2) & (d["entry_ptr"] >= 0) & (vt == 0)).sum()), cap or 64) > 0
    # cleared blocks, back on the free stack; the sentinel row untouched
    rows = d["entry_ptr"][t[2][:n].numpy()]
    assert (t[0].vox.numpy()[rows] == t_hv.VOX_INIT).all()
    np.testing.assert_array_equal(t[0].vox.numpy()[-1], d["vox"][-1])
    assert int(t[0].last_free_block) == int(d["last_free_block"]) + n


@pytest.mark.parametrize("window", [0, 7, 15])
def test_evict_blocks_window_matches_jax(window):
    """Windows of a table whose E (1088) 16 divides."""
    d, ss, vt, _v = random_map(7)
    S = settings(j_cfg)
    j = j_sw.evict_blocks_window(j_vol(d), jnp.asarray(ss), jnp.asarray(vt), S, 8, jnp.int32(window + 16))
    t = t_sw.evict_blocks_window(t_vol(d), t_arr(ss), t_arr(vt), S, 8, torch.tensor(window + 16, dtype=torch.int32))
    compare_evictions(j, t)
    W = S.hashing.n_entries // 16
    ids = t[2].numpy()[: int(t[-1])]
    assert len(ids) > 0 and ((ids >= window * W) & (ids < (window + 1) * W)).all()


@pytest.mark.parametrize("window", [7, 15])
def test_evict_blocks_window_where_16_does_not_divide_e(window):
    """E = 1124, windows of 71 entries: window 7 equals the JAX package's;
    window 15 would start at 1065 and end past E, so the port clamps it to
    [1053, 1124) (the JAX package clamps its slice there, but not its ids:
    ROADMAP Queue 3), and it must evict exactly the first `cap` evictable
    entries of that range."""
    d, ss, vt, _v = random_map(8, n_excess=100)
    S = settings(j_cfg, n_excess=100)
    E, cap = S.hashing.n_entries, 64
    assert E == 1124
    t = t_sw.evict_blocks_window(t_vol(d), t_arr(ss), t_arr(vt), S, cap, window)
    if window == 7:
        compare_evictions(j_sw.evict_blocks_window(j_vol(d), jnp.asarray(ss), jnp.asarray(vt), S, cap,
                                                   jnp.int32(window)), t)
        return
    lo = E - 71
    idx = np.arange(lo, E)
    want = idx[(ss[idx] == 2) & (d["entry_ptr"][idx] >= 0) & (vt[idx] == 0)][:cap]
    n = int(t[-1])
    assert n == len(want) > 0
    np.testing.assert_array_equal(t[2].numpy()[:n], want)
    assert (t[2].numpy()[n:] == -1).all()
    np.testing.assert_array_equal(t[0].entry_ptr.numpy()[want], -1)


@pytest.mark.parametrize("form", ["compact", "full"])
def test_reallocate_swapped_out_matches_jax(form):
    d, _ss, vt, vids = random_map(9)
    S = settings(j_cfg)
    kw_j = dict(visible_ids=jnp.asarray(vids)) if form == "compact" else {}
    kw_t = dict(visible_ids=t_arr(vids)) if form == "compact" else {}
    j = j_sw.reallocate_swapped_out(j_vol(d), jnp.asarray(vt), S, **kw_j)
    t = t_sw.reallocate_swapped_out(t_vol(d), t_arr(vt), S, **kw_t)
    assert_same(j, t, "vol")
    taken = int(d["last_free_block"]) - int(t.last_free_block)
    assert taken == int(((vt > 0) & (d["entry_ptr"] == -1)).sum()) > 0


@pytest.mark.parametrize("use_color", [False, True], ids=["depth", "colour"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_global_cache_loads_in_the_other_package(tmp_path, writer, use_color):
    rng = np.random.default_rng(10)
    S = settings(t_cfg, use_color=use_color)
    src_cls, dst_cls = (t_sw.GlobalCache, j_sw.GlobalCache) if writer == "port" else (j_sw.GlobalCache,
                                                                                      t_sw.GlobalCache)
    cache = src_cls.create(S)
    cache.stored_sdf[:100] = rng.integers(-32767, 32768, cache.stored_sdf[:100].shape)
    cache.stored_w[:100] = rng.integers(0, 256, cache.stored_w[:100].shape)
    cache.has_stored[:100] = True
    if use_color:
        cache.stored_clr[:100] = rng.integers(0, 256, cache.stored_clr[:100].shape)
        cache.stored_wc[:100] = 7
    path = str(tmp_path / "cache.npz")
    cache.save(path)
    back = dst_cls.load(path)
    for f in dataclasses.fields(t_sw.GlobalCache):
        a, b = getattr(cache, f.name), getattr(back, f.name)
        assert (a is None) == (b is None) == (f.name in ("stored_clr", "stored_wc") and not use_color)
        if a is not None:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    # and it converts field for field into the port's class
    conv = convert.from_numpy(t_sw.GlobalCache, convert.to_numpy(back))
    np.testing.assert_array_equal(conv.stored_sdf, cache.stored_sdf)


def test_evict_and_reload_roundtrip_through_the_host_store():
    """tests/test_swapping.py::test_evict_and_reload_roundtrip on the port,
    with colour: an invisible block goes to the host store and comes back
    through reallocation, the marker and the synchronous swap_in."""
    S = settings(t_cfg, use_color=True)
    hp = S.hashing
    E = hp.n_entries
    vol = t_hv.create_hash(hp, with_color=True, grid_params=S.block_grid, device="cpu")
    cache = t_sw.GlobalCache.create(S)
    cand = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    vol, _vt, widx = t_hv.insert_blocks(vol, torch.zeros(E, dtype=torch.int32), cand, torch.ones(1, dtype=torch.bool),
                                        hp, grid_params=S.block_grid)
    entry = int(widx[0])
    blk = int(vol.entry_ptr[entry])
    vol.vox[blk] = t_hv.pack_vox(t_hv.sdf_to_q(torch.tensor(-0.25)), torch.tensor(7))
    vol.vox_rgb[blk] = t_hv.pack_rgb(t_hv.clr_to_q(torch.tensor([0.25, 0.5, 0.75])), torch.tensor(5))
    ss = torch.zeros(E, dtype=torch.int32)
    ss[entry] = 2
    free = int(vol.last_free_block)
    rs = t_hv.create_render_state(hp, device="cpu")  # nothing visible
    vol, ss = t_sw.swap_out(vol, ss, rs, cache, S)
    assert int(vol.entry_ptr[entry]) == -1 and int(ss[entry]) == 0 and int(vol.last_free_block) == free + 1
    assert cache.has_stored[entry] and (cache.stored_w[entry] == 7).all() and (cache.stored_wc[entry] == 5).all()
    np.testing.assert_allclose(cache.stored_sdf[entry] / 32767.0, -0.25, atol=1e-4)
    assert (vol.vox[blk] == t_hv.VOX_INIT).all() and (vol.vox_rgb[blk] == 0).all()
    cell, _inb = t_hv.grid_cell(cand[0], S.block_grid)
    assert int(vol.entry_grid[int(cell)]) == (entry << 1) | 1 and int(vol.block_grid[int(cell)]) == -1
    vt = torch.zeros(E, dtype=torch.int32)
    vt[entry] = t_hv.VT_VISIBLE_SWAPPED
    vol = t_sw.reallocate_swapped_out(vol, vt, S)
    new_blk = int(vol.entry_ptr[entry])
    assert new_blk >= 0 and int(vol.block_grid[int(cell)]) == new_blk
    ss = t_sw.mark_visible_for_swap(ss, vt)
    assert int(ss[entry]) == 1
    vol, ss = t_sw.swap_in(vol, ss, cache, S)
    assert int(ss[entry]) == 2
    np.testing.assert_allclose(t_hv.vox_sdf(vol.vox[new_blk]).numpy(), -0.25, atol=1e-4)
    assert (t_hv.vox_w(vol.vox[new_blk]) == 7).all() and (t_hv.rgb_wc(vol.vox_rgb[new_blk]) == 5).all()
