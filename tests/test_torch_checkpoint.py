"""The port's checkpoint/resume (infinitam_tpu_torch/utils/checkpoint.py)
on the CPU, alone and against the JAX package's.

- A resumed engine continues exactly as the engine that was saved, with
  swapping and without (tests/test_native_and_checkpoint.py's resume test
  on the port): poses equal, VBAs equal word for word.
- A snapshot whose hash points at the sentinel row raises; a snapshot
  without the block-grid caches and epoch planes loads, its caches rebuilt
  equal to refresh_caches; format v1 (positional leaves) loads while its
  leaf count matches.
- Across packages, with swapping: a JAX snapshot loads into the port and a
  port snapshot into the JAX package; each continues to the poses of the
  engine that wrote it, within 1e-4 m and 0.01° a frame (the bar of
  tests/test_torch_slice.py: ICP sums in another float32 order), and the
  two packages name their leaves alike.
"""

import json
import os

import numpy as np
import pytest
import torch

from infinitam_tpu.calib import default_calib
from infinitam_tpu.config import SceneParams, Settings, SwappingMode, TrackingParams, VoxelBlockHashParams
from infinitam_tpu.engine.main_engine import MainEngine as JEngine
from infinitam_tpu.io import synth as j_synth
from infinitam_tpu.utils import checkpoint as j_ckpt
from infinitam_tpu_torch import convert
from infinitam_tpu_torch.engine import hash_volume as hv
from infinitam_tpu_torch.engine.main_engine import MainEngine
from infinitam_tpu_torch.utils import checkpoint as ckpt

IMG = (60, 80)
N_FRAMES, N_SAVED = 6, 3

# the tensors here are tiny: one intra-op thread per process keeps torch from
# contending for the cores with the other test workers (tier-1 runs under xdist)
torch.set_num_threads(1)


def make_settings(swapping: bool) -> Settings:
    """tests/test_native_and_checkpoint.py's SETTINGS (with swapping: the
    transfer size of tests/test_swapping.py::swap_settings)."""
    return Settings(
        scene=SceneParams(voxel_size=0.025, mu=0.1, view_frustum_min=0.3, view_frustum_max=3.0),
        hashing=VoxelBlockHashParams(n_buckets=0x4000, n_excess=0x400, n_blocks=0x1800, n_transfer_blocks=0x200,
                                     max_visible_blocks=0x1000),
        tracking=TrackingParams(n_levels=3, min_valid_points=50),
        swapping_mode=SwappingMode.ENABLED if swapping else SwappingMode.DISABLED,
    )


@pytest.fixture(scope="module")
def depths():
    calib = default_calib(IMG[1], IMG[0])
    src = j_synth.SyntheticSource(calib, n_frames=N_FRAMES, img_size=IMG)
    return calib, [np.asarray(src.get_images()[0]) for _ in range(N_FRAMES)]


def pose_error(P, G):
    """(camera-centre distance in metres, rotation angle in degrees)."""
    P, G = np.asarray(P, np.float64), np.asarray(G, np.float64)
    t = np.linalg.norm(np.linalg.inv(P)[:3, 3] - np.linalg.inv(G)[:3, 3])
    dR = P[:3, :3] @ G[:3, :3].T
    v = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]])
    return t, np.degrees(np.arctan2(0.5 * np.linalg.norm(v), 0.5 * (np.trace(dR) - 1.0)))


def run(engine, frames) -> list:
    poses = []
    for d in frames:
        engine.process_frame(metric_depth=d)
        poses.append(engine.get_pose())
    return poses


@pytest.mark.parametrize("swapping", [False, True], ids=["plain", "swapping"])
def test_resume_continues_identically(tmp_path, depths, swapping):
    calib, frames = depths
    settings = make_settings(swapping)
    eng = MainEngine(settings, calib, IMG, device="cpu")
    run(eng, frames[:N_SAVED])
    path = str(tmp_path / "snap.npz")
    ckpt.save_engine(path, eng)
    assert os.path.exists(path + ".cache.npz") == swapping
    want = run(eng, frames[N_SAVED:])
    eng2 = MainEngine(settings, calib, IMG, device="cpu")
    ckpt.load_engine(path, eng2)
    assert eng2.frame_no == N_SAVED
    got = run(eng2, frames[N_SAVED:])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(eng.vol.vox, eng2.vol.vox) and torch.equal(eng.vol.entry_ptr, eng2.vol.entry_ptr)
    if swapping:
        assert torch.equal(eng.swap_states, eng2.swap_states)
        eng.flush_swap()
        eng2.flush_swap()
        np.testing.assert_array_equal(eng.global_cache.has_stored, eng2.global_cache.has_stored)
        np.testing.assert_array_equal(eng.global_cache.stored_sdf, eng2.global_cache.stored_sdf)


def test_sentinel_violation_raises(tmp_path, depths):
    calib, frames = depths
    settings = make_settings(False)
    eng = MainEngine(settings, calib, IMG, device="cpu")
    run(eng, frames[:2])
    ptr = eng.vol.entry_ptr.clone()
    ptr[torch.nonzero(ptr >= 0)[0, 0]] = hv.sentinel_row(settings.hashing)
    eng.vol = eng.vol._replace(entry_ptr=ptr)
    path = str(tmp_path / "bad.npz")
    ckpt.save_engine(path, eng)
    with pytest.raises(ValueError, match="sentinel"):
        ckpt.load_engine(path, MainEngine(settings, calib, IMG, device="cpu"))


def rewrite(path, keep_leaf, names=True):
    """Rewrite a snapshot keeping the leaves `keep_leaf(name)` accepts; with
    names=False as format v1 (positional, no names)."""
    z = dict(np.load(path))
    meta = json.loads(bytes(z["__meta__"]).decode())
    keep = [(i, n) for i, n in enumerate(meta["__names__"]) if keep_leaf(n)]
    arrays = {f"leaf_{j}": z[f"leaf_{i}"] for j, (i, _n) in enumerate(keep)}
    meta["__names__"] = [n for _i, n in keep]
    if not names:
        del meta["__names__"], meta["__format__"]
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def test_missing_cache_leaves_are_rebuilt(tmp_path, depths):
    """A snapshot without the block-grid caches, the claim plane and the
    epochs (an older format) loads: the caches rebuilt from the hash equal
    refresh_caches', the epochs start again at 0, and the engine tracks on."""
    calib, frames = depths
    settings = make_settings(False)
    eng = MainEngine(settings, calib, IMG, device="cpu")
    run(eng, frames[:2])
    path = str(tmp_path / "old.npz")
    ckpt.save_engine(path, eng)
    dropped = ("entry_grid", "block_grid", "cell_claim", "entry_epoch", "epoch")
    rewrite(path, lambda n: not any(t in n for t in dropped))
    eng2 = MainEngine(settings, calib, IMG, device="cpu")
    ckpt.load_engine(path, eng2)
    ref = hv.refresh_caches(eng.vol, settings.block_grid)
    assert torch.equal(eng2.vol.entry_grid, ref.entry_grid) and torch.equal(eng2.vol.block_grid, ref.block_grid)
    assert torch.equal(eng2.vol.entry_grid, eng.vol.entry_grid)  # the per-frame upkeep agrees with the rebuild
    assert int(eng2.render_state.epoch) == 0 and int(eng2.render_state.cell_claim.abs().sum()) == 0
    for d in frames[2:4]:
        diag = eng2.process_frame(metric_depth=d)
    assert diag["num_valid"] > 500


def test_format_v1_loads_while_its_leaf_count_matches(tmp_path, depths):
    calib, frames = depths
    settings = make_settings(False)
    eng = MainEngine(settings, calib, IMG, device="cpu")
    run(eng, frames[:2])
    path = str(tmp_path / "v1.npz")
    ckpt.save_engine(path, eng)
    rewrite(path, lambda n: True, names=False)
    eng2 = MainEngine(settings, calib, IMG, device="cpu")
    ckpt.load_engine(path, eng2)
    assert torch.equal(eng2.vol.vox, eng.vol.vox) and torch.equal(eng2.tracking_state.pose, eng.tracking_state.pose)
    ckpt.save_engine(path, eng)
    rewrite(path, lambda n: "vox" not in n, names=False)
    with pytest.raises(ValueError, match="format v1"):
        ckpt.load_engine(path, MainEngine(settings, calib, IMG, device="cpu"))


def test_both_packages_name_the_leaves_alike(tmp_path, depths):
    calib, frames = depths
    names = {}
    for swapping in (False, True):
        settings = make_settings(swapping)
        for tag, eng, save in (("jax", JEngine(settings, calib, IMG), j_ckpt.save_engine),
                               ("port", MainEngine(settings, calib, IMG, device="cpu"), ckpt.save_engine)):
            eng.process_frame(metric_depth=frames[0])
            path = str(tmp_path / f"{tag}_{swapping}.npz")
            save(path, eng)
            z = np.load(path)
            meta = json.loads(bytes(z["__meta__"]).decode())
            names[tag, swapping] = meta["__names__"]
            # same shapes and dtypes leaf for leaf
            names[tag, swapping, "arrays"] = [(z[f"leaf_{i}"].shape, z[f"leaf_{i}"].dtype)
                                              for i in range(len(meta["__names__"]))]
        assert names["port", swapping] == names["jax", swapping]
        assert names["port", swapping, "arrays"] == names["jax", swapping, "arrays"]
    assert "['vol'].entry_pos" in names["port", False]
    assert "['swap_states']" in names["port", True] and "['swap_states']" not in names["port", False]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshot_of_a_swapping_engine_continues_in_the_other_package(tmp_path, depths, writer):
    """The writer runs N_SAVED frames, saves (draining its exchange) and
    continues; the other package loads the snapshot, host store included,
    and continues on the same frames to the writer's poses."""
    calib, frames = depths
    settings = make_settings(True)
    engines = {"jax": lambda: JEngine(settings, calib, IMG), "port": lambda: MainEngine(settings, calib, IMG,
                                                                                        device="cpu")}
    io = {"jax": (j_ckpt.save_engine, j_ckpt.load_engine), "port": (ckpt.save_engine, ckpt.load_engine)}
    reader = "port" if writer == "jax" else "jax"
    eng = engines[writer]()
    run(eng, frames[:N_SAVED])
    path = str(tmp_path / "snap.npz")
    io[writer][0](path, eng)
    stored = int(np.asarray(eng.global_cache.has_stored).sum())
    states = convert.to_numpy(eng.swap_states)
    want = run(eng, frames[N_SAVED:])
    eng2 = engines[reader]()
    io[reader][1](path, eng2)
    assert eng2.frame_no == N_SAVED and int(np.asarray(eng2.global_cache.has_stored).sum()) == stored
    np.testing.assert_array_equal(convert.to_numpy(eng2.swap_states), states)
    got = run(eng2, frames[N_SAVED:])
    for i, (a, b) in enumerate(zip(got, want)):
        t_err, r_err = pose_error(a, b)
        assert t_err <= 1e-4 and r_err <= 0.01, f"frame {N_SAVED + i}: {t_err:.2e} m, {r_err:.2e} deg"
