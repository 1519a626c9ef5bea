"""Shared pieces of the benchmark's CPU tests: tiny configurations of the
two volume kinds and a tiny traffic mix (60×80 frames), and the `cuda`
marker for the tests that need the card."""

from __future__ import annotations

import copy
import json

import pytest
import torch

from perfbench import registry


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips where torch.cuda.is_available() is false")


@pytest.fixture
def card():
    """The card's device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def tiny_config(kind: str) -> dict:
    """The 5 mm configuration of `kind` cut to a CPU test's size: 2 cm
    voxels, small hash capacities and grids, a 3-level ICP pyramid."""
    with open(registry.BENCH_DIR / "configs" / f"{kind}_5mm.json") as f:
        cfg = copy.deepcopy(json.load(f))
    s = cfg["settings"]
    s["scene"].update(voxel_size=0.02, mu=0.08)
    s["hashing"].update(n_buckets=0x10000, n_excess=0x200, n_blocks=0x800, n_transfer_blocks=0x100,
                        n_global_blocks=0x1000, max_visible_blocks=0x800)
    s["plain"].update(size=[128, 128, 128], offset=[-64, -64, 0])
    s["block_grid"].update(dims=[24, 24, 24], origin=[-12, -12, 0])
    s["alloc_subsample"] = 2
    s["tracking"].update(n_levels=3, n_rotation_only_levels=2, min_valid_points=50)
    s["max_fused_blocks"] = s["max_render_blocks"] = s["max_alloc_blocks"] = 0x800
    return cfg


def tiny_traffic(lanes: int = 1, frames: int = 6) -> dict:
    return {"lanes": lanes, "frames": frames, "image": [60, 80],
            "intrinsics": [65.625, 65.625, 39.5, 29.5], "lane_scale_step": 0.15}
