"""The swap cell cut to a test's size, shared by its CPU tests
(tests/test_perfbench_swap.py) and its card test
(test_perfbench_swap_card.py): 60×80 frames, 2 cm voxels, a small table,
and a pan of 4° a frame to ±24° that holds 16 frames at each end (as long
as the rotating eviction window takes to see every entry), then rests."""

from __future__ import annotations

import copy
import json

from perfbench import registry

KNOTS = [[0, 0.0], [6, 24.0], [22, 24.0], [34, -24.0], [50, -24.0], [56, 0.0], [60, 0.0]]
IMG = (60, 80)


def traffic() -> dict:
    return {"lanes": 1, "frames": KNOTS[-1][0], "image": list(IMG), "intrinsics": [65.625, 65.625, 39.5, 29.5],
            "yaw_knots_deg": KNOTS}


def config() -> dict:
    """hash_5mm_swap.json cut as the benchmark's CPU tests cut the hash
    configuration: 2 cm voxels, a small table."""
    with open(registry.BENCH_DIR / "configs" / "hash_5mm_swap.json") as f:
        cfg = copy.deepcopy(json.load(f))
    s = cfg["settings"]
    s["scene"].update(voxel_size=0.02, mu=0.08)
    s["hashing"].update(n_buckets=0x4000, n_excess=0x200, n_blocks=0x800, n_transfer_blocks=0x100,
                        n_global_blocks=0x1000, max_visible_blocks=0x800)
    s["block_grid"].update(dims=[24, 24, 24], origin=[-12, -12, 0])
    s["alloc_subsample"] = 2
    s["tracking"].update(n_levels=3, n_rotation_only_levels=2, min_valid_points=50)
    s["max_fused_blocks"] = s["max_render_blocks"] = s["max_alloc_blocks"] = 0x800
    return cfg
