"""The dense voxel array (ITMPlainVoxelArray): a configuration of kind
`dense`.

One lane steps through dense_pipeline.process_frame_dense, B lanes through
parallel/batch.py make_batched_step_dense; the fusion is K2d
(`itpu_integrate_dense_kernel`), the raycast K3d. No per-frame counters.
The map as the comparison reads it: the array's sdf and weights. Judged
by perfbench/compare.py against perfbench/reference.py's dense array.
"""

from __future__ import annotations

from infinitam_tpu_torch.engine import dense_pipeline as dp
from infinitam_tpu_torch.parallel import batch
from perfbench import compare, scene, system

KERNELS = {"icp": "itpu_icp_kernel", "integrate": "itpu_integrate_dense_kernel", "raycast": "itpu_raycast_kernel"}
COUNTERS = ()
frames = scene.frames


class System(system.System):
    COUNTERS = COUNTERS

    def fresh_state(self):
        if self.lanes > 1:
            return batch.batched_state_dense(self.settings, self.img, self.lanes, device=self.dev)
        return dp.create_engine_state(self.settings, self.img, device=self.dev)

    def frame_step(self, state, view):
        vol, st, diag = dp.process_frame_dense(*state, view, self.proj, self.settings)
        return (vol, st), diag

    def batched_step(self):
        return batch.make_batched_step_dense(self.settings)

    def lane_map(self, lane):
        """(sdf, w) of the array."""
        vol = lane[0]
        return vol.sdf.clone(), vol.w_depth.clone()


def judge(cfg, inputs, gt, pass_poses, outputs, counters, img, proj, dev, counts=None):
    """compare.judge against the reference's dense array, also for a
    configuration of a kind that drives this kind's step."""
    return compare.judge(dict(cfg, kind="dense"), "dense", inputs, gt, pass_poses, outputs, counters, img, proj, dev,
                         counts=counts)
