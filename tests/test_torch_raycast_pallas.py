"""The port's plain K3 raycast vs the JAX package's Pallas raycast kernel in
interpret mode, at the bars tests/test_pallas_raycast.py holds that kernel to
against the XLA oracle: hit/miss agreement > 0.93, and on pixels both hit a
median offset < 0.5 voxel and a 95th percentile < 2 voxels.

The Pallas kernel derives exact per-ray ranges from its page lists while
the plain K3 (like the XLA oracle it reproduces) marches the ×8-subsampled
range raster, so the two legitimately differ at silhouettes; its stored sdf
keeps only the top byte, hence the sub-voxel offsets.
"""

import jax.numpy as jnp
import numpy as np
import torch

from infinitam_tpu.calib import default_calib
from infinitam_tpu.config import BlockGridParams, SceneParams, Settings, TrackingParams, VoxelBlockHashParams
from infinitam_tpu.engine import hash_pipeline as j_hp
from infinitam_tpu.engine.view_builder import View as JView
from infinitam_tpu.io import synth as j_synth
from infinitam_tpu_torch import convert
from infinitam_tpu_torch.engine import hash_pipeline as t_hp
from infinitam_tpu_torch.engine import hash_volume as t_hv

IMG = (64, 64)  # a multiple of the Pallas kernel's 16-px tile

# the tensors here are tiny: one intra-op thread per process keeps torch from
# contending for the cores with the other test workers (tier-1 runs under xdist)
torch.set_num_threads(1)


def test_plain_k3_within_pallas_kernel_bars():
    settings = Settings(  # tests/test_pallas_raycast.py's settings
        scene=SceneParams(voxel_size=0.025, mu=0.1, view_frustum_min=0.3, view_frustum_max=3.0),
        hashing=VoxelBlockHashParams(n_buckets=0x4000, n_excess=0x400, n_blocks=0x1800, max_visible_blocks=0x1000),
        block_grid=BlockGridParams(dims=(32, 32, 32), origin=(-16, -16, 0)),
        tracking=TrackingParams(n_levels=3, min_valid_points=50),
        max_render_blocks=512,
        raycast_t_march=48,
        raycast_pages_per_tile=48,
    )
    calib = default_calib(IMG[1], IMG[0])
    proj = jnp.asarray(calib.intrinsics_d.vector)
    depth, _rgb, _gt = j_synth.SyntheticSource(calib, n_frames=2, img_size=IMG).get_images()
    vol, rs, st = j_hp.create_engine_state(settings, IMG)
    for _ in range(2):
        vol, rs, st, _d = j_hp.process_frame_hash(vol, rs, st, JView(depth=depth), proj, settings)

    kern, _ovf = j_hp.raycast_hash_pallas(vol, rs, jnp.eye(4), proj, IMG, settings, interpret=True)
    vt = convert.from_numpy(t_hv.HashVolume, convert.to_numpy(vol), device="cpu")
    rt = convert.from_numpy(t_hv.RenderStateVH, convert.to_numpy(rs), device="cpu")
    ours = t_hp.raycast_hash(vt, rt, torch.eye(4), torch.from_numpy(np.asarray(proj)), IMG, settings).points.numpy()

    f_k = np.asarray(kern.points[..., 3]) > 0
    f_t = ours[..., 3] > 0
    agree = (f_k == f_t).mean()
    assert agree > 0.93, f"hit/miss agreement {agree:.3f}"
    both = f_k & f_t
    assert both.sum() > 100
    d = np.linalg.norm(np.asarray(kern.points[..., :3])[both] - ours[..., :3][both], axis=-1)
    assert np.median(d) < 0.5, f"median hit offset {np.median(d):.3f} voxels"
    assert np.percentile(d, 95) < 2.0, f"p95 hit offset {np.percentile(d, 95):.3f}"
    # and the hits reproduce the fused synthetic depth
    z = ours[..., 2] * settings.scene.voxel_size
    sel = f_t & (np.asarray(depth) > 0)
    assert np.median(np.abs(z[sel] - np.asarray(depth)[sel])) < settings.scene.voxel_size
