"""The commit rule of kernels K3h's and K3d's lookahead march
(csrc/raycast.cu itpu_raycast_pixel), rehearsed on the CPU by a small
torch model of it, held to the port's lock-step march
(ops/raycast.py::raycast_rays, the plain twin of K3, K3h and K3d) ray for
ray at 60×80.

The model marches every ray in batches of LA samples, as the kernel does.
A batch's first sample is the march's next position; the next LA − 1
positions are guessed on the assumption that each sample reads what the
last committed sample read (a truncated voxel, found and 1.0, before the
first), with raycast_rays' own float32 ops. All LA samples are read, then
committed in order: sample j + 1 commits at its guessed position only
where sample j read the assumption bit for bit, so the batch ends at the
first sample that did not (its read becomes the next assumption), at a hit,
or where the ray's length passes its end. Positions, hits and march steps
must equal raycast_rays' exactly, for LA 2, 4 and 8, over:

- the dense reader (volume.make_dense_reader) of a 128³ array of 2 cm after
  3 fused frames, whose rays also leave the array;
- the hash reader (hash_volume.make_hash_reader) of a map after 3 fused
  frames;
- the hash reader of tests/test_torch_kernels_cuda.py's `far_blocks`
  volume: blocks outside the grid's window, one behind an excess link, one
  swapped out (it reads as empty);

each over the frustum's whole range and over ranges 4-12 voxels long, which
end inside a batch. This checks the rule, not the kernel: nothing here runs
csrc/raycast.cu, so a change to the kernel's march that departs from the
rule shows only on the card, where the kernel is held to the plain march
(tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from infinitam_tpu_torch.calib import default_calib
from infinitam_tpu_torch.config import PlainVoxelArrayParams, TrackingParams, tiny_test_settings
from infinitam_tpu_torch.engine import dense_pipeline as dp
from infinitam_tpu_torch.engine import hash_pipeline as hp
from infinitam_tpu_torch.engine import hash_volume as hv
from infinitam_tpu_torch.engine import volume as vol_mod
from infinitam_tpu_torch.engine.view_builder import View
from infinitam_tpu_torch.io import synth
from infinitam_tpu_torch.ops import raycast as rc
from infinitam_tpu_torch.ops.voxel_access import read_sdf_interpolated, read_sdf_uninterpolated
from infinitam_tpu_torch.utils import se3

torch.set_num_threads(1)

IMG = (60, 80)
SETTINGS = tiny_test_settings().replace(tracking=TrackingParams(n_levels=3, min_valid_points=50))
CALIB = default_calib(IMG[1], IMG[0])
PROJ = torch.as_tensor(CALIB.intrinsics_d.vector)


def lookahead_march(read, pt_start, ray_dir, len_start, len_end, step_scale: float, block_size: int, LA: int):
    """The kernel's lookahead march over `read`, ray by ray, then
    raycast_rays' refinement: ([..., 4] points with w = the hit flag, [...]
    march steps, [...] batches). The steps use raycast_rays' ops; a guessed
    position is committed only under the commit rule, never recomputed."""
    shape = len_start.shape
    tiny = ray_dir.abs() < 1e-9
    safe_dir = torch.where(tiny, torch.full_like(ray_dir, 1e-9), ray_dir)
    up = (ray_dir > 0).to(torch.float32)

    def step_of(found, s, p):
        nxt_bound = (torch.floor(p / block_size) + up) * block_size
        t_exit = torch.where(tiny, torch.full_like(p, 1e9), (nxt_bound - p) / safe_dir).amin(dim=-1)
        empty_step = torch.clamp(t_exit + 0.01, 0.5, float(block_size))
        return torch.where(found, torch.clamp(s * step_scale, min=1.0), empty_step)

    pt, total = pt_start.clone(), len_start.clone()
    sdf = torch.ones(shape)
    active = torch.ones(shape, dtype=torch.bool)
    steps = torch.zeros(shape, dtype=torch.int32)
    batches = torch.zeros(shape, dtype=torch.int32)
    af, as_ = torch.ones(shape, dtype=torch.bool), torch.ones(shape)  # the assumption: a truncated voxel
    while bool(active.any()):
        batches += active
        guess, guess_total = [pt], [total]
        for _j in range(1, LA):
            st = step_of(af, as_, guess[-1])
            guess.append(guess[-1] + st[..., None] * ray_dir)
            guess_total.append(guess_total[-1] + st)
        reads = [read_sdf_uninterpolated(read, g) for g in guess]
        live = active.clone()  # the rays whose sample j commits
        for j in range(LA):
            s, f = reads[j]
            steps += live
            sdf = torch.where(live, s, sdf)
            hit = live & f & (s <= 0.0)
            as_assumed = (f == af) & (s.view(torch.int32) == as_.view(torch.int32))
            take_guess = as_assumed & (j + 1 < LA)
            st = step_of(f, s, guess[j])
            nxt = torch.where(take_guess[..., None], guess[min(j + 1, LA - 1)], guess[j] + st[..., None] * ray_dir)
            nxt_total = torch.where(take_guess, guess_total[min(j + 1, LA - 1)], guess_total[j] + st)
            advance = live & ~hit
            pt = torch.where(advance[..., None], nxt, pt)
            total = torch.where(advance, nxt_total, total)
            ended = hit | (advance & ~(nxt_total < len_end))
            active = active & ~(live & ended)
            new_assumption = live & ~ended & ~as_assumed
            af = torch.where(new_assumption, f, af)
            as_ = torch.where(new_assumption, s, as_)
            live = live & ~ended & as_assumed
    # raycast_rays' secant step and two trilinear refinements
    found_surface = sdf <= 0.0
    p = pt + (sdf * step_scale)[..., None] * ray_dir
    r1, _ = read_sdf_interpolated(read, p)
    p = p + (r1 * step_scale)[..., None] * ray_dir
    r2, _ = read_sdf_interpolated(read, p)
    p = p + (r2 * step_scale)[..., None] * ray_dir
    points = torch.cat([torch.where(found_surface[..., None], p, pt), found_surface.to(torch.float32)[..., None]],
                       dim=-1)
    return points, steps, batches


def fused_hash():
    src = synth.SyntheticSource(CALIB, n_frames=3, img_size=IMG, device="cpu")
    vol, rs, st = hp.create_engine_state(SETTINGS, IMG, device="cpu")
    for _ in range(3):
        vol, rs, st, _d = hp.process_frame_hash(vol, rs, st, View(depth=src.get_images()[0]), PROJ, SETTINGS)
    return hv.make_hash_reader(vol, SETTINGS.hashing), st.pose, SETTINGS.hashing.block_size


def fused_dense():
    settings = SETTINGS.replace(plain=PlainVoxelArrayParams(size=(128, 128, 128), offset=(-64, -64, 0)))
    src = synth.SyntheticSource(CALIB, n_frames=3, img_size=IMG, device="cpu")
    vol, st = dp.create_engine_state(settings, IMG, device="cpu")
    for _ in range(3):
        vol, st, _d = dp.process_frame_dense(vol, st, View(depth=src.get_images()[0]), PROJ, settings)
    return vol_mod.make_dense_reader(vol, settings.plain), st.pose, vol_mod.VIRTUAL_BLOCK


def far_blocks():
    """tests/test_torch_kernels_cuda.py far_blocks(swapped=True) on the CPU:
    three solid blocks outside the grid's window in front of a camera at x =
    6.56 m, (41, 0, 4) behind an excess link of (−4055, 0, 4), (40, 1, 4)
    swapped out."""
    h, gp = SETTINGS.hashing, SETTINGS.block_grid
    vol = hv.create_hash(h, grid_params=gp, device="cpu")
    vt = torch.zeros(h.n_entries, dtype=torch.int32)
    A, B, C, D = (40, 0, 4), (41, 0, 4), (-4055, 0, 4), (40, 1, 4)
    for group in ([C], [A, B, D]):
        vol, vt, _w = hv.insert_blocks(vol, vt, torch.tensor(group, dtype=torch.int32),
                                       torch.ones(len(group), dtype=torch.bool), h, gp)
    pr = hv.probe(vol, torch.tensor([A, B, D], dtype=torch.int32), h)
    assert bool(pr.found.all()) and int(pr.entry_idx[1]) >= h.n_buckets
    vol.vox[pr.entry_ptr.long()] = hv.pack_vox(hv.sdf_to_q(torch.full((h.block_volume,), -0.5)),
                                               torch.ones(h.block_volume, dtype=torch.int32))
    ptr = vol.entry_ptr.clone()
    ptr[pr.entry_idx[2].long()] = hv.SWAPPED_PTR
    pose = torch.eye(4)
    pose[:3, 3] = torch.tensor([-6.56, -0.16, 0.0])
    return hv.make_hash_reader(vol._replace(entry_ptr=ptr), h), pose, h.block_size


VOLUMES = {"dense": fused_dense, "hash": fused_hash, "hash_far_blocks": far_blocks}


@pytest.fixture(scope="module")
def volumes():
    return {name: make() for name, make in VOLUMES.items()}


@pytest.mark.parametrize("ranges", ["frustum", "end_mid_batch"])
@pytest.mark.parametrize("volume", list(VOLUMES))
@pytest.mark.parametrize("LA", [2, 4, 8])
def test_lookahead_commits_the_lockstep_march(volumes, volume, ranges, LA):
    read, pose, block_size = volumes[volume]
    sp = SETTINGS.scene
    zmin = torch.full(IMG, sp.view_frustum_min)
    zmax = torch.full(IMG, sp.view_frustum_max)
    if ranges == "end_mid_batch":
        rng = np.random.default_rng(LA)
        zmin = zmin + torch.from_numpy(rng.random(IMG, dtype=np.float32)) * 1.5
        zmax = zmin + sp.voxel_size * (4.0 + 8.0 * torch.from_numpy(rng.random(IMG, dtype=np.float32)))
    pt, ray_dir, l0, l1 = rc.pixel_rays(se3.invert(pose), PROJ, IMG, 1.0 / sp.voxel_size, zmin, zmax)
    step_scale = sp.mu / sp.voxel_size
    ref, ref_steps = rc.raycast_rays(read, pt, ray_dir, l0, l1, step_scale, block_size)
    got, steps, batches = lookahead_march(read, pt, ray_dir, l0, l1, step_scale, block_size, LA)
    assert torch.equal(got, ref)
    assert torch.equal(steps, ref_steps)
    n_hits = int((ref[..., 3] > 0).sum())
    if volume == "hash_far_blocks":
        assert 0 < n_hits < IMG[0] * IMG[1] // 2  # the swapped-out block reads as empty
    elif ranges == "frustum":
        assert n_hits > 1000
    if ranges == "frustum" and volume != "hash":
        # the batches stand for several steps: the guesses held
        assert int(batches.sum()) < 0.8 * int(steps.sum())
