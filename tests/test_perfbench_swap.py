"""The benchmark's swap cell on the CPU (perfbench/kinds/hash_swap.py,
perfbench/reference_swap.py) and the swap tier's counters, spans and
in-place reset (infinitam_tpu_torch/engine/swapping.py).

One module-scoped pass of the cell cut to 60×80 on a small table
(perfbench/tests/tiny_swap.py: the camera pans 4° a frame to ±24° and
holds 16 frames at each end, as long as the rotating eviction window takes
to see every entry, then rests): blocks leave the view, go to the host
store and come back merged.

1. The pass against the plain reference on the same seeded frames: each
   frame's pose from the program's previous one, the drained map, the last
   raycast, no block lost, nothing left after the drain.
2. Each frame's four swap counters against a count by hand from the state
   before and after the frame.
3. A second pass from the in-place reset gives the same outputs, and the
   host store's planes are the same arrays.
4. The plain reference imports no module of JAX, the JAX package or the
   port.
5. A pass whose merges of stored data are dropped, whose host store
   forgets what it is given, or whose eviction frees the entry it evicts,
   comes out not correct: on the drained map, and on the blocks lost.
6. Passes under other swap schedules (the quanta, the eviction windows and
   the lag halved, or doubled) come out correct: the judged map does not
   hang on the schedule past the limits.
7. The readers of the swap phase and of the pinned copies; the store's and
   the exchange's resets; MainEngine's reset keeps its store; the swap
   path's out-of-grid capacity (hash_pipeline.oog_cap).
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

from infinitam_tpu_torch.calib import default_calib
from infinitam_tpu_torch.config import BlockGridParams, SwappingMode, TrackingParams, tiny_test_settings
from infinitam_tpu_torch.engine import hash_pipeline as hp
from infinitam_tpu_torch.engine import hash_volume as hv
from infinitam_tpu_torch.engine import swapping as sw
from infinitam_tpu_torch.engine.main_engine import MainEngine
from infinitam_tpu_torch.ops.hashing import scatter_drop
from perfbench import compare, registry
from perfbench.tests import tiny_swap
from perfbench.trace import DeviceTrace

torch.set_num_threads(1)

SEED = 2**31 + 5
IMG = tiny_swap.IMG
TRAFFIC = tiny_swap.traffic()
# the pose gap at 2 cm voxels and 60×80, where one frame's ICP amplifies a
# small difference of the maps (the hash kind on the same frames reads as
# high); the other numbers are held to the configuration's limits
POSE_GAP_MM = 2.0


def hand_counts(before, after) -> list:
    """A frame's swap counters from its state before and after: entries
    evicted (resident → swapped out), entries listed (→ in flight), then
    the resident, device-newest, invisible entries and the visible ones
    still in state 1."""
    vol0, _rs0, _st0, states0 = before
    vol, rs, _st, states = after
    ptr0, ptr = vol0.entry_ptr.numpy(), vol.entry_ptr.numpy()
    s0, s = states0.numpy(), states.numpy()
    vt, vis = rs.visible_type.numpy(), rs.visible_ids.numpy()
    vis = vis[vis >= 0]
    return [int(((ptr0 >= 0) & (ptr == hv.SWAPPED_PTR)).sum()), int(((s == sw.SWAP_IN_FLIGHT) & (s0 != s)).sum()),
            int(((s == 2) & (ptr >= 0) & (vt == hv.VT_NOT_VISIBLE)).sum()), int((s[vis] == 1).sum())]


def one_pass(system, inputs, by_hand=None):
    """A pass as System.run_pass runs it, frame by frame; with `by_hand`, a
    list, each frame's hand counts appended. Returns its record."""
    rec = system.new_record(TRAFFIC["frames"])
    if by_hand is None:
        system.run_pass(inputs, rec)
        return rec
    real = system.frame

    def frame(depths, i, record=None):
        before = [x.clone() if torch.is_tensor(x) else x._replace(**{k: v.clone() for k, v in x._asdict().items()
                                                                      if torch.is_tensor(v)})
                  for x in system.state]
        issue = real(depths, i, record)
        by_hand.append(hand_counts(before, system.state))
        return issue

    system.frame = frame
    try:
        system.run_pass(inputs, rec)
    finally:
        del system.frame
    return rec


def judged(kind, cfg, gt, inputs, system, rec):
    outputs = system.outputs()
    nums, _failed = kind.judge(cfg, inputs, gt, rec["poses"][None].numpy(), outputs,
                               rec["counters"][None].numpy(), IMG, TRAFFIC["intrinsics"], torch.device("cpu"))
    return nums, outputs


@pytest.fixture(scope="module")
def swap_pass():
    cfg = tiny_swap.config()
    kind = registry.kind("hash_swap")
    gt, inputs = kind.frames(TRAFFIC, SEED, torch.device("cpu"))
    system = kind.System(cfg, TRAFFIC, "cpu")
    by_hand = []
    rec = one_pass(system, inputs, by_hand)
    nums, outputs = judged(kind, cfg, gt, inputs, system, rec)
    return dict(cfg=cfg, kind=kind, gt=gt, inputs=inputs, system=system, rec=rec, by_hand=by_hand, nums=nums,
                outputs=outputs, counts=dict(system.passes[-1]))


def test_the_pass_matches_the_plain_reference(swap_pass):
    nums, cfg = swap_pass["nums"], swap_pass["cfg"]
    limits = compare.limits_of(cfg)
    assert nums["pose_gap_mm"] <= POSE_GAP_MM, nums
    for k in ("voxel_mismatch", "map_mismatch", "cap_counters", "swap_lost_blocks", "swap_backlog_drained"):
        assert nums[k] <= limits[k], (k, nums)
    assert nums["swap_lost_blocks"] == 0 and nums["swap_backlog_drained"] == 0
    # the sweep moves blocks both ways: evicted into the store, merged back
    counts = swap_pass["counts"]
    assert counts["evicted"] > 100 and counts["merged"] > 100, counts


def test_the_map_holds_stored_blocks(swap_pass):
    """The drained map holds blocks that only the store has (the ones out
    of view at the end) and they carry fused voxels."""
    system = swap_pass["system"]
    vol = system.state[0]
    stored = (vol.entry_ptr == hv.SWAPPED_PTR).numpy() & system.cache.has_stored
    assert stored.sum() > 0
    keys, _q, w = swap_pass["outputs"][0][0]
    assert keys.numel() == int((vol.entry_ptr >= 0).sum()) + int(stored.sum())
    assert bool(torch.all(keys[1:] > keys[:-1])) and int((w > 0).sum()) > 0


@pytest.mark.parametrize("col,name", list(enumerate(hp.SWAP_COUNTERS)))
def test_each_swap_counter_matches_a_hand_count(swap_pass, col, name):
    kind = swap_pass["kind"]
    got = swap_pass["rec"]["counters"][:, 0, len(kind.COUNTERS) - len(hp.SWAP_COUNTERS) + col].tolist()
    want = [row[col] for row in swap_pass["by_hand"]]
    assert got == want, name
    assert max(want) > 0, name


def test_the_exchange_counts_each_frame(swap_pass):
    """frame_counts summed over the pass are the pass's totals, and the
    evicted blocks that landed are those the step evicted two frames back."""
    counts, rec = swap_pass["counts"], swap_pass["rec"]
    col = swap_pass["kind"].COUNTERS.index("n_swap_evicted")
    per_frame = rec["counters"][:, 0, col].tolist()
    lag = sw.SwapExchange.PIPE_DEPTH
    assert counts["evicted"] == sum(per_frame[:-lag])
    assert counts["waits"] == 0


def test_a_second_pass_from_the_reset_is_the_same(swap_pass):
    system, inputs = swap_pass["system"], swap_pass["inputs"]
    planes = [system.cache.stored_sdf, system.cache.stored_w, system.cache.has_stored]
    ptrs = [a.ctypes.data for a in planes]
    exchange = system.exchange
    rec = one_pass(system, inputs)
    assert torch.equal(rec["poses"], swap_pass["rec"]["poses"])
    assert torch.equal(rec["counters"], swap_pass["rec"]["counters"])
    out = system.outputs()
    (k0, q0, w0), (p0, n0), d0 = swap_pass["outputs"][0]
    (k1, q1, w1), (p1, n1), d1 = out[0]
    assert all(torch.equal(a, b) for a, b in ((k0, k1), (q0, q1), (w0, w1), (p0, p1), (n0, n1)))
    assert d0["backlog"] == d1["backlog"]
    assert [a.ctypes.data for a in (system.cache.stored_sdf, system.cache.stored_w, system.cache.has_stored)] == ptrs
    assert system.exchange is exchange and system.passes[-1] == swap_pass["counts"]


def test_the_plain_reference_imports_no_program():
    code = ("import sys, perfbench.reference_swap\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'infinitam_tpu', "
            "'infinitam_tpu_torch'}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_a_dropped_merge_is_not_correct(swap_pass, monkeypatch):
    """The exchange's data slabs never reach the step: the listed entries
    resolve, the stored content is never merged back."""
    kind, cfg, system = swap_pass["kind"], swap_pass["cfg"], swap_pass["system"]
    real = system.exchange.merge_args
    monkeypatch.setattr(system.exchange, "merge_args", lambda: (real()[0], None))
    rec = one_pass(system, swap_pass["inputs"])
    nums, _out = judged(kind, cfg, swap_pass["gt"], swap_pass["inputs"], system, rec)
    limits = compare.limits_of(cfg)
    assert nums["voxel_mismatch"] > limits["voxel_mismatch"], nums
    assert not compare.verdict(nums, limits)
    assert swap_pass["nums"]["voxel_mismatch"] <= limits["voxel_mismatch"]


def test_a_dropped_store_loses_blocks(swap_pass, monkeypatch):
    """The host store forgets the blocks the exchange scatters into it: the
    blocks still out of view at the end are neither resident nor stored."""
    kind, cfg, system = swap_pass["kind"], swap_pass["cfg"], swap_pass["system"]
    real = system.exchange.after_frame

    def forgetful(in_meta, out_pack, cache):
        had = cache.has_stored.copy()
        real(in_meta, out_pack, cache)
        cache.has_stored[:] = had

    monkeypatch.setattr(system.exchange, "after_frame", forgetful)
    rec = one_pass(system, swap_pass["inputs"])
    nums, _out = judged(kind, cfg, swap_pass["gt"], swap_pass["inputs"], system, rec)
    limit = compare.limits_of(cfg)["swap_lost_blocks"]
    assert nums["swap_lost_blocks"] > limit >= swap_pass["nums"]["swap_lost_blocks"], nums
    assert not compare.verdict(nums, compare.limits_of(cfg))


def test_an_eviction_that_frees_its_entry_is_not_correct(swap_pass, monkeypatch):
    """Each frame's eviction frees the hash entries it evicts (FREE_PTR in
    place of SWAPPED_PTR): the table forgets the blocks it sent to the
    store, and the drained map lacks those still out of view."""
    kind, cfg, system = swap_pass["kind"], swap_pass["cfg"], swap_pass["system"]
    real = sw.evict_blocks_window

    def freeing(*args, **kw):
        vol, states, ids, *rest = real(*args, **kw)
        freed = scatter_drop(vol.entry_ptr, torch.where(ids >= 0, ids, vol.entry_ptr.shape[0]), hv.FREE_PTR)
        return (vol._replace(entry_ptr=freed), states, ids, *rest)

    monkeypatch.setattr(sw, "evict_blocks_window", freeing)
    rec = one_pass(system, swap_pass["inputs"])
    nums, _out = judged(kind, cfg, swap_pass["gt"], swap_pass["inputs"], system, rec)
    limit = compare.limits_of(cfg)["swap_lost_blocks"]
    assert nums["swap_lost_blocks"] > limit >= swap_pass["nums"]["swap_lost_blocks"], nums
    assert not compare.verdict(nums, compare.limits_of(cfg))


SCHEDULES = {"halved": dict(evict=32, exchange=128, windows=8, lag=1),
             "doubled": dict(evict=128, exchange=512, windows=32, lag=3)}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_another_swap_schedule_is_correct(swap_pass, monkeypatch, name):
    """The schedule's quanta (64 evictions, 256 listed a frame), the
    rotating window's 16 parts and the two-frame lag halved or doubled:
    the pass comes out correct against the same reference, with blocks
    evicted and merged back."""
    kind, cfg, system = swap_pass["kind"], swap_pass["cfg"], swap_pass["system"]
    sch = SCHEDULES[name]
    real = sw.evict_blocks_window
    monkeypatch.setattr(sw, "evict_quantum", lambda settings: sch["evict"])
    monkeypatch.setattr(sw, "exchange_quantum", lambda settings: sch["exchange"])
    monkeypatch.setattr(sw, "evict_blocks_window",
                        lambda *a, **kw: real(*a, **dict(kw, n_windows=sch["windows"])))
    monkeypatch.setattr(system.exchange, "PIPE_DEPTH", sch["lag"])
    rec = one_pass(system, swap_pass["inputs"])
    nums, _out = judged(kind, cfg, swap_pass["gt"], swap_pass["inputs"], system, rec)
    limits = compare.limits_of(cfg)
    assert compare.verdict(nums, limits) and nums["pose_gap_mm"] <= POSE_GAP_MM, nums
    assert nums["swap_backlog_drained"] == 0, nums
    counts = system.passes[-1]
    assert counts["evicted"] > 100 and counts["merged"] > 100, counts


def test_the_swap_phase_reader():
    read = registry.reader("swap_ms")
    ctx = type("Ctx", (), {})()
    assert read(ctx) is None
    ctx.spans = {"dropped": 0, "phases_ms": {"track": 3.9, "swap": 0.25}}
    assert read(ctx) == 0.25
    ctx.spans = {"dropped": 0, "phases_ms": {"track": 3.9}}
    assert read(ctx) is None
    ctx.spans = {"dropped": 2, "phases_ms": {"swap": 0.25}}
    assert read(ctx) is None


def test_the_pinned_copy_reader():
    read = registry.reader("swap_copy_ms.swap")
    ops = [("Memcpy DtoH (Device -> Pinned)", 0.0, 3.0), ("Memcpy HtoD (Pinned -> Device)", 5.0, 7.0),
           ("Memcpy DtoD (Device -> Device)", 20.0, 50.0), ("itpu_icp_kernel", 80.0, 9.0)]
    ctx = type("Ctx", (), {"trace": DeviceTrace(ops), "traced_steps": 2})()
    assert read(ctx) == pytest.approx((3.0 + 7.0) * 1e-3 / 2)
    ctx.trace = DeviceTrace(ops[2:])
    assert read(ctx) is None
    ctx.trace = None
    assert read(ctx) is None


def small_swap_settings():
    return tiny_test_settings().replace(tracking=TrackingParams(n_levels=3, min_valid_points=50),
                                        swapping_mode=SwappingMode.ENABLED)


def test_the_store_resets_its_flags_only():
    cache = sw.GlobalCache.create(small_swap_settings())
    cache.stored_sdf[3] = 7
    cache.stored_w[3] = 9
    cache.has_stored[[3, 5]] = True
    sdf = cache.stored_sdf
    cache.reset()
    assert not cache.has_stored.any() and cache.stored_sdf is sdf and int(cache.stored_sdf[3, 0]) == 7
    got = sw.swap_in_gather(cache, np.array([3, 5, -1]), False)
    assert not got[2].any() and not got[1].any()  # no weight comes from an unflagged row


def test_the_exchange_resets_in_place():
    s = small_swap_settings()
    ex = sw.SwapExchange(s, False, device="cpu")
    cache = sw.GlobalCache.create(s)
    E, q, qe, s3 = s.hashing.n_entries, sw.exchange_quantum(s), sw.evict_quantum(s), s.hashing.block_volume
    meta = torch.cat([torch.tensor([4], dtype=torch.int32), torch.full((q - 1,), -1, dtype=torch.int32),
                      torch.tensor([1], dtype=torch.int32)])
    ev = torch.cat([torch.tensor([6], dtype=torch.int32), torch.full((qe - 1,), -1, dtype=torch.int32),
                    torch.tensor([1], dtype=torch.int32)])
    pack = (ev, torch.zeros((qe, s3), dtype=torch.int16), torch.full((qe, s3), 3, dtype=torch.uint8), None, None)
    for _ in range(sw.SwapExchange.PIPE_DEPTH + 1):
        ex.after_frame(meta, pack, cache)
    assert ex.frame_counts == {"evicted": 1, "listed": 1, "merged": 0, "waits": 0} and ex.n_evicted == 1
    assert bool(cache.has_stored[6]) and ex.merge_args()[0] is not None
    ex.reset()
    assert ex._q == [] and ex.merge_args() == (None, None) and ex.n_evicted == ex.n_listed == 0
    assert ex.frame_counts == dict.fromkeys(ex.frame_counts, 0) and E > 6


@pytest.mark.parametrize("mode", [SwappingMode.DISABLED, SwappingMode.ENABLED])
def test_the_swap_path_takes_candidates_past_the_grid(mode):
    """A wall 1.5 m away seen through a block grid of 2³ blocks: nearly every
    band candidate lies outside the grid, more than OOG_CAP of them. Without
    swapping the excess is deferred and counted; with swapping the
    out-of-grid path takes the novel stage's capacity and defers none."""
    s = small_swap_settings()
    s = s.replace(hashing=dataclasses.replace(s.hashing, max_visible_blocks=0x1000),
                  block_grid=BlockGridParams(dims=(2, 2, 2), origin=(-1, -1, 0)), swapping_mode=mode)
    vol, rs, _st = hp.create_engine_state(s, IMG, device="cpu")
    proj = torch.tensor(TRAFFIC["intrinsics"])
    vol, rs, overflow = hp.allocate_scene_from_depth(vol, rs, torch.full(IMG, 1.5), torch.eye(4), proj, s)
    n_blocks = int((vol.entry_ptr >= 0).sum())
    if mode is SwappingMode.DISABLED:
        assert hp.oog_cap(s) == hp.OOG_CAP and int(overflow) > 0
    else:
        assert hp.oog_cap(s) == hp.novel_cap(s) == 0x2000 and int(overflow) == 0
    assert n_blocks > 0


def test_the_engine_reset_keeps_its_store():
    s = small_swap_settings()
    eng = MainEngine(s, default_calib(IMG[1], IMG[0]), IMG, device="cpu")
    cache, exchange = eng.global_cache, eng.swap_exchange
    cache.has_stored[2] = True
    eng.reset_scene()
    assert eng.global_cache is cache and eng.swap_exchange is exchange and not cache.has_stored.any()
    assert int(eng.swap_states.abs().sum()) == 0
