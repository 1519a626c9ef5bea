"""The port's copies of the JAX package's framework-free I/O modules held to
the originals: the calibration reader and writer, image file I/O, the frame
sources (record / replay, the fallback chain, the IMU rotations) and the
IMU calibrator, plus the port's own DeviceFrameFeed on the CPU. The copies
run the same numpy code, so every comparison is exact.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from infinitam_tpu import calib as j_calib
from infinitam_tpu.engine import imu as j_imu
from infinitam_tpu.io import sources as j_src
from infinitam_tpu.utils import image_io as j_iio
from infinitam_tpu_torch import calib as t_calib
from infinitam_tpu_torch.engine import imu as t_imu
from infinitam_tpu_torch.io import sources as t_src
from infinitam_tpu_torch.io import synth as t_synth
from infinitam_tpu_torch.utils import image_io as t_iio

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "replay")
# tests/test_ops_basic.py::test_calib_parser_teddy_format's text
TEDDY = """640 480
504.261 503.905
352.457 272.202

640 480
573.71 574.394
346.471 249.031

0.999749 0.00518867 0.0217975 0.0243073
-0.0051649 0.999986 -0.0011465 -0.000166518
-0.0218031 0.00103363 0.999762 0.0151706

1135.09 0.0819141
"""

# the tensors here are tiny: one intra-op thread per process keeps torch from
# contending for the cores with the other test workers (tier-1 runs under xdist)
torch.set_num_threads(1)


@pytest.mark.parametrize("which", ["fixture", "teddy"])
def test_calib_reader_and_writer_match_jax(which):
    arg = os.path.join(FIX, "calib.txt") if which == "fixture" else TEDDY
    t, j = t_calib.read_rgbd_calib(arg), j_calib.read_rgbd_calib(arg)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    text = t_calib.write_rgbd_calib(t)
    assert text == j_calib.write_rgbd_calib(j)
    # the written text (the extrinsic as float32) reads back alike in both
    assert dataclasses.asdict(t_calib.read_rgbd_calib(text)) == dataclasses.asdict(j_calib.read_rgbd_calib(text))


def images():
    rng = np.random.default_rng(0)
    return {
        "grey8.pgm": rng.integers(0, 256, (7, 9), dtype=np.uint8),
        "depth16.pgm": rng.integers(0, 65536, (7, 9), dtype=np.uint16),
        "rgb.ppm": rng.integers(0, 256, (7, 9, 3), dtype=np.uint8),
        "rgba.png": rng.integers(0, 256, (7, 9, 4), dtype=np.uint8),
        "depth16.png": rng.integers(0, 65536, (7, 9), dtype=np.uint16),
    }


@pytest.mark.parametrize("name", sorted(images()))
def test_image_io_round_trips_byte_equal_to_jax(tmp_path, name):
    img = images()[name]
    t_path, j_path = str(tmp_path / f"t_{name}"), str(tmp_path / f"j_{name}")
    t_iio.write_image(t_path, img)
    j_iio.write_image(j_path, img)
    with open(t_path, "rb") as ft, open(j_path, "rb") as fj:
        assert ft.read() == fj.read()
    back = t_iio.read_image(t_path)
    np.testing.assert_array_equal(back, j_iio.read_image(j_path))
    np.testing.assert_array_equal(back, img)


def test_printf_masks_match_jax():
    for mask, i in (("Frames/%04i.ppm", 7), ("img_%i.pgm", 12), ("d_%d_%03i.pgm", 5), ("plain.pgm", 3)):
        assert t_iio.expand_printf_mask(mask, i) == j_iio.expand_printf_mask(mask, i)


def test_image_file_reader_matches_jax():
    mask = os.path.join(FIX, "depth_%04i.pgm")
    t = t_src.ImageFileReader(os.path.join(FIX, "calib.txt"), "", mask)
    j = j_src.ImageFileReader(os.path.join(FIX, "calib.txt"), "", mask)
    assert dataclasses.asdict(t.calib) == dataclasses.asdict(j.calib)
    n = 0
    while j.has_more_images():
        assert t.has_more_images()
        (dt, rt), (dj, rj) = t.get_images(), j.get_images()
        assert dt.dtype == dj.dtype == np.uint16 and rt is None and rj is None
        np.testing.assert_array_equal(dt, dj)
        n += 1
    assert n == 10 and not t.has_more_images()


def test_record_and_replay_match_jax(tmp_path):
    """Record the fixture (raw mm) and three synthetic CPU frames (metric
    depth as tensors, recorded as mm), then replay each directory through
    both packages' ReplaySource."""
    calib = t_calib.read_rgbd_calib(os.path.join(FIX, "calib.txt"))
    rec = t_src.RecordingSource(t_src.ImageFileReader(os.path.join(FIX, "calib.txt"), "",
                                                      os.path.join(FIX, "depth_%04i.pgm")), str(tmp_path / "a"))
    raw = [rec.get_images()[0] for _ in range(3)]
    synth = t_synth.SyntheticSource(t_calib.default_calib(80, 60), n_frames=3, img_size=(60, 80), with_rgb=True,
                                    device="cpu")
    rec2 = t_src.RecordingSource(synth, str(tmp_path / "b"))
    metric = [rec2.get_images() for _ in range(3)]
    for d, frames in (("a", raw), ("b", metric)):
        t = t_src.ReplaySource(str(tmp_path / d), calib)
        j = j_src.ReplaySource(str(tmp_path / d), calib)
        for i in range(3):
            (dt, rt), (dj, rj) = t.get_images(), j.get_images()
            np.testing.assert_array_equal(dt, dj)
            if d == "a":
                np.testing.assert_array_equal(dt, frames[i].astype(np.float32) / 1000.0)
                assert rt is None and rj is None
            else:
                # metres → whole millimetres, truncated
                np.testing.assert_allclose(dt, frames[i][0].numpy().clip(min=0), atol=1e-3)
                np.testing.assert_array_equal(rt, rj)
        assert not t.has_more_images() and not j.has_more_images()


def test_make_source_fallback_matches_jax(tmp_path, capsys):
    calib_path = os.path.join(FIX, "calib.txt")
    files, syn = t_src.make_source(calib_path=calib_path, depth_mask=os.path.join(FIX, "depth_%04i.pgm"),
                                   device="cpu")
    assert isinstance(files, t_src.ImageFileReader) and not syn
    # no frames at the mask: the message, then the synthetic source
    src, syn = t_src.make_source(calib_path=calib_path, depth_mask=str(tmp_path / "none_%04i.pgm"), n_frames=2,
                                 img_size=(60, 80), device="cpu")
    _j, j_syn = j_src.make_source(calib_path=calib_path, depth_mask=str(tmp_path / "none_%04i.pgm"), n_frames=2,
                                  img_size=(60, 80))
    out = capsys.readouterr().out
    assert syn and j_syn and out.count("[sources] no frames at") == 2
    assert "live camera sources are unavailable" in out
    assert dataclasses.asdict(src.calib) == dataclasses.asdict(_j.calib)
    depth, _rgb, _gt = src.get_images()
    assert depth.shape == (60, 80) and depth.device.type == "cpu"
    # a TUM directory with an associations file
    (tmp_path / "tum").mkdir()
    (tmp_path / "tum" / "associations.txt").write_text("# t rgb t depth\n0.1 rgb/0.png 0.1 depth/0.png\n")
    tum, syn = t_src.make_source(tum_root=str(tmp_path / "tum"), device="cpu")
    j_tum, _s = j_src.make_source(tum_root=str(tmp_path / "tum"))
    assert isinstance(tum, t_src.TUMSource) and not syn and tum.pairs == j_tum.pairs
    assert dataclasses.asdict(tum.calib) == dataclasses.asdict(j_tum.calib)
    with pytest.raises(RuntimeError):
        t_src.LiveSourceStub()


def test_imu_source_and_calibrator_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    for i in range(4):
        R = t_imu._rot_exp(rng.normal(0, 0.1, 3))
        np.savetxt(tmp_path / f"imu_{i:04d}.txt", R)
    mask = str(tmp_path / "imu_%04i.txt")
    t, j = t_src.IMUSource(mask), j_src.IMUSource(mask)
    cal_t, cal_j = t_imu.IMUCalibratoriPad(), j_imu.IMUCalibratoriPad()
    pose = np.eye(4)
    while j.has_more_measurements():
        assert t.has_more_measurements()
        mt, mj = t.get_measurement(), j.get_measurement()
        assert mt.dtype == mj.dtype == np.float32
        np.testing.assert_array_equal(mt, mj)
        cal_t.register_measurement(mt)
        cal_j.register_measurement(mj)
        dt, dj = cal_t.differential_rotation(), cal_j.differential_rotation()
        np.testing.assert_array_equal(dt, dj)
        np.testing.assert_array_equal(t_imu.apply_imu_prior(pose, dt), j_imu.apply_imu_prior(pose, dj))
    assert not t.has_more_measurements()
    assert not np.allclose(dt, np.eye(3))


def test_pose_source_matches_jax():
    t, j = t_src.PoseSource(), j_src.PoseSource()
    assert t.latest() is None and j.latest() is None
    pose = np.arange(16, dtype=np.float64).reshape(4, 4)
    t.push(pose)
    j.push(pose)
    assert t.latest().dtype == j.latest().dtype == np.float32
    np.testing.assert_array_equal(t.latest(), j.latest())


def test_device_frame_feed_passes_frames_through_on_cpu():
    """On device="cpu" the feed hands on the inner source's frames as they
    are (no copy, no pinned buffer), in order, with their extra fields."""
    synth = t_synth.SyntheticSource(t_calib.default_calib(16, 12), n_frames=5, img_size=(12, 16), device="cpu")
    frames = [synth.get_images() for _ in range(5)]

    class Replay:
        calib = synth.calib

        def __init__(self):
            self.i = 0

        def has_more_images(self):
            return self.i < len(frames)

        def get_images(self):
            self.i += 1
            return frames[self.i - 1]

    feed = t_src.DeviceFrameFeed(Replay(), device="cpu")
    assert feed.calib is synth.calib
    got = []
    while feed.has_more_images():
        got.append(feed.get_images())
    assert len(got) == 5
    for g, f in zip(got, frames):
        assert all(a is b for a, b in zip(g, f))
    with pytest.raises(StopIteration):
        feed.get_images()
