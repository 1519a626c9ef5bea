"""The plain reference against the port on a few tiny frames on the CPU,
and the control: the reference itself in bfloat16 in the program's place,
which the comparison has to reject."""

from __future__ import annotations

import pytest
import torch

from conftest import tiny_config, tiny_traffic
from perfbench import compare, registry, scene


def frames(traffic, seed):
    gt, depths = scene.frames(traffic, seed, "cpu")
    return gt, depths, tuple(traffic["image"]), traffic["intrinsics"]


@pytest.mark.parametrize("kind", ["hash", "dense"])
def test_port_agrees_with_the_reference(kind):
    cfg, traffic = tiny_config(kind), tiny_traffic(frames=5)
    gt, depths, img, proj = frames(traffic, 2**40 + 17)
    system = registry.kind(kind).System(cfg, traffic, "cpu")
    rec = system.new_record(traffic["frames"])
    system.run_pass(depths, rec)
    nums, failed = compare.judge(cfg, kind, depths, gt, rec["poses"][None].numpy(), system.outputs(),
                                 rec["counters"][None].numpy() if kind == "hash" else None, img, proj, "cpu")
    assert failed == 0
    assert nums["pose_gap_mm"] < 0.1 and nums["pose_gap_deg"] < 0.01
    assert nums["voxel_mismatch"] < 1e-3 and nums["map_mismatch"] < 1e-2
    assert nums["ate_mm"] < 10.0
    assert compare.verdict(nums, compare.limits_of(cfg))


@pytest.mark.parametrize("kind", ["hash", "dense"])
def test_the_control_in_bfloat16_is_rejected(kind):
    cfg, traffic = tiny_config(kind), tiny_traffic(frames=5)
    gt, depths, img, proj = frames(traffic, 12345)
    poses, vmap, maps = compare.free_run(cfg, depths[0], img, proj, "cpu", torch.bfloat16)
    nums, _failed = compare.judge(cfg, kind, depths, gt, poses[None, :, None], [(vmap, maps)], None, img, proj, "cpu")
    limits = compare.limits_of(cfg)
    assert not compare.verdict(nums, limits)
    assert nums["pose_gap_mm"] > 3 * limits["pose_gap_mm"]
    assert nums["map_mismatch"] > 3 * limits["map_mismatch"]
