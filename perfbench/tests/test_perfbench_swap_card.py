"""On the card: the swap cell's kind at a small size. A pass against the
plain reference (perfbench/reference_swap.py) comes out correct with blocks
evicted and merged back; the first pass captures every graph the step needs
(one for each set of merge inputs and slab rows: at most six) and a second
pass captures none and gives the same poses and map. Skips without a card."""

from __future__ import annotations

import pytest
import torch

import tiny_swap
from perfbench import compare, registry


@pytest.mark.cuda
def test_swap_pass_on_the_card(card):
    cfg, traffic = tiny_swap.config(), tiny_swap.traffic()
    kind = registry.kind("hash_swap")
    gt, inputs = kind.frames(traffic, 2**31 + 5, card)
    system = kind.System(cfg, traffic, card)
    recs = []
    for _ in range(2):
        rec = system.new_record(traffic["frames"])
        system.run_pass(inputs, rec)
        recs.append(rec)
        if len(recs) == 1:
            graphs = system.graphs()
    assert 1 <= len(graphs) <= 6 and system.graphs() == graphs
    assert torch.equal(recs[0]["poses"], recs[1]["poses"])
    counts = system.passes[-1]
    assert counts["evicted"] > 100 and counts["merged"] > 100, counts
    outputs = system.outputs()
    nums, _failed = kind.judge(cfg, inputs, gt, recs[-1]["poses"][None].cpu().numpy(), outputs,
                               recs[-1]["counters"][None].cpu().numpy(), tuple(traffic["image"]),
                               traffic["intrinsics"], card)
    system.close()
    limits = compare.limits_of(cfg)
    for k in ("voxel_mismatch", "map_mismatch", "cap_counters", "swap_lost_blocks", "swap_backlog_drained"):
        assert nums[k] <= limits[k], (k, nums)
