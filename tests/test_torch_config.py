"""The port's own configuration and calibration objects held equal to the
JAX package's (infinitam_tpu_torch/config.py and calib.py are copies, so
that the port runs without the JAX package): the same classes, fields,
defaults and enum values, the same test settings and default calibration,
and a frame loop that accepts a Settings from either package.
"""

import dataclasses
import enum

import numpy as np
import pytest
import torch

from infinitam_tpu import calib as j_calib
from infinitam_tpu import config as j_cfg
from infinitam_tpu_torch import calib as t_calib
from infinitam_tpu_torch import config as t_cfg
from infinitam_tpu_torch.engine import hash_pipeline as t_hp
from infinitam_tpu_torch.engine.view_builder import View
from infinitam_tpu_torch.io import synth as t_synth

# the tensors here are tiny: one intra-op thread per process keeps torch from
# contending for the cores with the other test workers (tier-1 runs under xdist)
torch.set_num_threads(1)

PARAM_CLASSES = ("SceneParams", "VoxelBlockHashParams", "PlainVoxelArrayParams", "BlockGridParams",
                 "TrackingParams", "Settings")


def plain(obj):
    """A dataclass as nested dicts, enums by value (comparable across packages)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    return obj


@pytest.mark.parametrize("name", PARAM_CLASSES)
def test_config_classes_match_jax(name):
    t, j = getattr(t_cfg, name), getattr(j_cfg, name)
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    assert plain(t()) == plain(j())


@pytest.mark.parametrize("name", ["TrackerType", "SwappingMode"])
def test_enums_match_jax(name):
    assert [(m.name, m.value) for m in getattr(t_cfg, name)] == [(m.name, m.value) for m in getattr(j_cfg, name)]


def test_test_settings_and_properties_match_jax():
    t, j = t_cfg.tiny_test_settings(), j_cfg.tiny_test_settings()
    assert plain(t) == plain(j)
    for prop in ("block_volume", "n_entries", "hash_mask"):
        assert getattr(t.hashing, prop) == getattr(j.hashing, prop)
    assert plain(t.replace(alloc_subsample=3)) == plain(j.replace(alloc_subsample=3))


@pytest.mark.parametrize("size", [(640, 480), (80, 60)])
def test_default_calib_matches_jax(size):
    t, j = t_calib.default_calib(*size), j_calib.default_calib(*size)
    assert plain(t) == plain(j)
    np.testing.assert_array_equal(t.intrinsics_d.vector, j.intrinsics_d.vector)
    assert (t_calib.DISPARITY_KINECT, t_calib.DISPARITY_AFFINE) == (j_calib.DISPARITY_KINECT, j_calib.DISPARITY_AFFINE)


@pytest.mark.parametrize("cfg", [t_cfg, j_cfg], ids=["port", "jax"])
def test_supported_settings_gate_reads_either_package(cfg):
    """The port reads a Settings of either package by field and its enums by
    value, and refuses none of them: every tracker, colour, the approximate
    raycast and swapping set up an engine state, and the coarse raycast pass
    and the hash-probe raycast run a frame."""
    s = cfg.tiny_test_settings().replace(tracking=cfg.TrackingParams(n_levels=3, min_valid_points=50))
    for good in (dict(use_color=True), dict(use_color=True, tracker_type=cfg.TrackerType.COLOR),
                 dict(tracker_type=cfg.TrackerType.WICP, model_sensor_noise=True, use_bilateral_filter=True),
                 dict(tracker_type=cfg.TrackerType.EXTERNAL), dict(tracker_type=cfg.TrackerType.REN),
                 dict(use_approximate_raycast=True), dict(swapping_mode=cfg.SwappingMode.ENABLED)):
        t_hp.create_engine_state(s.replace(**good), (6, 8), device="cpu")
    img = (60, 80)
    calib = t_calib.default_calib(img[1], img[0])
    proj = torch.as_tensor(calib.intrinsics_d.vector)
    depth = t_synth.render_depth(torch.eye(4), proj, img)
    for ported in (dict(raycast_coarse_factor=2), dict(use_block_grid=False)):
        settings = s.replace(**ported)
        vol, rs, st = t_hp.create_engine_state(settings, img, device="cpu")
        vol, rs, st, diag = t_hp.process_frame_hash(vol, rs, st, View(depth=depth), proj, settings)
        assert int(diag.n_visible) > 100 and float(st.points_map[..., 3].max()) == 1.0


def test_rgb_to_depth_matches_jax():
    """The extrinsic as a float32 [4, 4] array, for the default and for a
    calibration with a baseline and a rotation."""
    c, s = np.cos(0.02), np.sin(0.02)
    trafo = ((c, 0.0, s, 0.025), (0.0, 1.0, 0.0, 0.0), (-s, 0.0, c, 0.001), (0.0, 0.0, 0.0, 1.0))
    for size in ((640, 480), (80, 60)):
        t, j = t_calib.default_calib(*size), j_calib.default_calib(*size)
        for tc, jc in ((t, j), (dataclasses.replace(t, trafo_rgb_to_depth=trafo),
                                dataclasses.replace(j, trafo_rgb_to_depth=trafo))):
            a, b = tc.rgb_to_depth, jc.rgb_to_depth
            assert a.dtype == b.dtype == np.float32 and a.shape == (4, 4)
            np.testing.assert_array_equal(a, b)


# the configurations bench.py checks (its 5 mm and 1 cm settings at 640×480,
# f = 525 px), the tiny test settings, a stride past the limit and a coarse
# voxel that allows a wide one
STRIDE_CASES = [
    dict(),
    dict(alloc_subsample=4),
    dict(alloc_subsample=8),
    dict(scene=j_cfg.SceneParams(voxel_size=0.01, mu=0.04)),
    dict(scene=j_cfg.SceneParams(voxel_size=0.005, mu=0.02), alloc_subsample=3),
    dict(scene=j_cfg.SceneParams(voxel_size=0.05, mu=0.2, view_frustum_max=2.0), alloc_subsample=20),
]


@pytest.mark.parametrize("case", range(len(STRIDE_CASES)))
@pytest.mark.parametrize("focal_px", [525.0, 70.0])
def test_alloc_stride_helpers_match_jax(case, focal_px):
    """safe_alloc_stride returns the JAX value, and assert_alloc_stride_safe
    raises (ValueError, the same message) exactly where the JAX one does,
    for settings of either package."""
    j_set = j_cfg.Settings().replace(**STRIDE_CASES[case])
    t_set = t_cfg.Settings().replace(**{k: (t_cfg.SceneParams(**dataclasses.asdict(v)) if k == "scene" else v)
                                        for k, v in STRIDE_CASES[case].items()})
    want = j_cfg.safe_alloc_stride(j_set, focal_px)
    assert t_cfg.safe_alloc_stride(t_set, focal_px) == t_cfg.safe_alloc_stride(j_set, focal_px) == want >= 1
    try:
        j_cfg.assert_alloc_stride_safe(j_set, focal_px)
        j_err = None
    except ValueError as e:
        j_err = str(e)
    for s in (t_set, j_set):
        if j_err is None:
            t_cfg.assert_alloc_stride_safe(s, focal_px)
        else:
            with pytest.raises(ValueError) as e:
                t_cfg.assert_alloc_stride_safe(s, focal_px)
            assert str(e.value) == j_err
