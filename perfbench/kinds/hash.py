"""The voxel-block hash (ITMVoxelBlockHash): a configuration of kind `hash`.

One lane steps through hash_pipeline.process_frame_hash, B lanes through
parallel/batch.py make_batched_step; each frame records the five
silent-cap counters. The map as the comparison reads it: the resident
blocks' sorted keys, int16 sdf values and weights. Judged by
perfbench/compare.py against perfbench/reference.py's hash volume.
"""

from __future__ import annotations

import torch

from infinitam_tpu_torch.engine import hash_pipeline as hp
from infinitam_tpu_torch.parallel import batch
from perfbench import compare, scene, system
from perfbench.reference import pack_keys

KERNELS = {"icp": "itpu_icp_kernel", "integrate": "itpu_integrate_kernel", "raycast": "itpu_raycast_kernel"}
COUNTERS = ("n_alloc_overflow", "n_render_overflow", "n_pool_overflow", "n_too_big_blocks", "n_window_clipped")
frames = scene.frames


class System(system.System):
    COUNTERS = COUNTERS

    def fresh_state(self):
        if self.lanes > 1:
            return batch.batched_state_hash(self.settings, self.img, self.lanes, device=self.dev)
        return hp.create_engine_state(self.settings, self.img, device=self.dev)

    def frame_step(self, state, view):
        vol, rs, st, diag = hp.process_frame_hash(*state, view, self.proj, self.settings)
        return (vol, rs, st), diag

    def batched_step(self):
        return batch.make_batched_step(self.settings)

    def lane_map(self, lane):
        """(sorted block keys, sdf int16 values, weights) of the resident
        blocks."""
        vol = lane[0]
        live = vol.entry_ptr >= 0
        pos = vol.entry_pos[live].long()
        rows = vol.entry_ptr[live].long()
        keys = pack_keys(pos[:, 0], pos[:, 1], pos[:, 2])
        order = torch.argsort(keys)
        vox = vol.vox[rows[order]]
        return keys[order], (vox >> 16).to(torch.int32), ((vox >> 8) & 0xFF).to(torch.int32)


def judge(cfg, inputs, gt, pass_poses, outputs, counters, img, proj, dev, counts=None):
    """compare.judge against the reference's hash volume, also for a
    configuration of a kind that drives this kind's step."""
    return compare.judge(dict(cfg, kind="hash"), "hash", inputs, gt, pass_poses, outputs, counters, img, proj, dev,
                         counts=counts)
