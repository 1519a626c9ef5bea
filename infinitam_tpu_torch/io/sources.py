"""Frame sources: dataset readers with the reference's pull interface.

Counterpart of infinitam_tpu/io/sources.py (reference:
InfiniTAM/Engine/ImageSourceEngine.{h,cpp} — ImageSourceEngine (calib +
hasMoreImages/getImages), ImageFileReader (printf-mask ppm/pgm sequences with
a one-frame cache), RawFileReader, CalibSource; Engine/IMUSourceEngine.cpp
(per-frame 3×3 rotation text files)), plus a TUM-RGBD association-file
reader. The readers return numpy arrays, as the JAX package's do;
`DeviceFrameFeed` moves them to the card through a ring of pinned host
buffers.

Live camera sources (OpenNI/UVC/RealSense/Kinect2, reference
Engine/OpenNIEngine.cpp etc.) are represented by the `LiveSourceStub` gate.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from infinitam_tpu_torch.calib import DisparityCalib, Intrinsics, RGBDCalib, default_calib, read_rgbd_calib
from infinitam_tpu_torch.utils.image_io import expand_printf_mask, read_image, write_image


class ImageSourceEngine:
    """Abstract pull-style source (reference: ImageSourceEngine.h:9-21)."""

    calib: RGBDCalib

    def has_more_images(self) -> bool:
        raise NotImplementedError

    def get_images(self) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        """Returns (raw_depth uint16 [H,W], rgb uint8 [H,W,3] or None)."""
        raise NotImplementedError


class CalibSource(ImageSourceEngine):
    """Calibration only, no frames (reference: CalibSource — used when a live
    source provides images but calib comes from file)."""

    def __init__(self, calib_path: str):
        self.calib = read_rgbd_calib(calib_path)

    def has_more_images(self) -> bool:
        return False

    def get_images(self):
        raise RuntimeError("CalibSource provides no images")


class ImageFileReader(ImageSourceEngine):
    """printf-mask sequence reader (reference: ImageFileReader — masks like
    `Frames/%04i.ppm` / `%04i.pgm`, caching one frame ahead)."""

    def __init__(self, calib_path: str, rgb_mask: str, depth_mask: str, start_index: int = 0):
        self.calib = read_rgbd_calib(calib_path)
        self.rgb_mask = rgb_mask
        self.depth_mask = depth_mask
        self.index = start_index
        self._cached: Optional[Tuple[np.ndarray, Optional[np.ndarray]]] = None
        self._cache_index = -1

    def _paths(self, i: int):
        return (
            expand_printf_mask(self.rgb_mask, i) if self.rgb_mask else None,
            expand_printf_mask(self.depth_mask, i),
        )

    def _load(self, i: int):
        rgb_path, depth_path = self._paths(i)
        if not os.path.exists(depth_path):
            return None
        depth = read_image(depth_path)
        rgb = None
        if rgb_path and os.path.exists(rgb_path):
            rgb = read_image(rgb_path)
        return depth, rgb

    def has_more_images(self) -> bool:
        if self._cache_index != self.index:
            self._cached = self._load(self.index)
            self._cache_index = self.index
        return self._cached is not None

    def get_images(self):
        if not self.has_more_images():
            raise StopIteration
        depth, rgb = self._cached
        self.index += 1
        return depth, rgb


class RawFileReader(ImageSourceEngine):
    """Raw binary frame reader (reference: RawFileReader — fixed-size
    uint16 depth + rgb frames appended per index)."""

    def __init__(self, calib_path: str, rgb_mask: str, depth_mask: str, image_size: Tuple[int, int]):
        self.calib = read_rgbd_calib(calib_path)
        self.rgb_mask = rgb_mask
        self.depth_mask = depth_mask
        self.image_size = image_size  # (H, W)
        self.index = 0

    def has_more_images(self) -> bool:
        return os.path.exists(expand_printf_mask(self.depth_mask, self.index))

    def get_images(self):
        H, W = self.image_size
        dpath = expand_printf_mask(self.depth_mask, self.index)
        depth = np.fromfile(dpath, dtype=np.uint16, count=H * W).reshape(H, W)
        rgb = None
        if self.rgb_mask:
            rpath = expand_printf_mask(self.rgb_mask, self.index)
            if os.path.exists(rpath):
                rgb = np.fromfile(rpath, dtype=np.uint8, count=H * W * 3).reshape(H, W, 3)
        self.index += 1
        return depth, rgb


class TUMSource(ImageSourceEngine):
    """TUM-RGBD sequence via an associations file (`timestamp rgb_path
    timestamp depth_path` per line). Depth PNGs are 16-bit with 1/5000 m
    scale; calib defaults to the TUM fr intrinsics unless given."""

    TUM_DEPTH_SCALE = 1.0 / 5000.0

    def __init__(self, root: str, associations: str = "associations.txt", calib: Optional[RGBDCalib] = None):
        self.root = root
        self.pairs = []
        with open(os.path.join(root, associations)) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                if len(parts) >= 4:
                    self.pairs.append((parts[1], parts[3]))
        if calib is None:
            intr = Intrinsics(fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480)
            calib = default_calib(640, 480)
            calib = RGBDCalib(
                intrinsics_rgb=intr,
                intrinsics_d=intr,
                trafo_rgb_to_depth=calib.trafo_rgb_to_depth,
                disparity=DisparityCalib(a=self.TUM_DEPTH_SCALE, b=0.0, type="affine"),
            )
        self.calib = calib
        self.index = 0

    def has_more_images(self) -> bool:
        return self.index < len(self.pairs)

    def get_images(self):
        rgb_rel, depth_rel = self.pairs[self.index]
        self.index += 1
        depth = read_image(os.path.join(self.root, depth_rel))
        rgb = read_image(os.path.join(self.root, rgb_rel))
        return depth, rgb


class IMUSource:
    """Per-frame 3×3 rotation matrices from text files (reference:
    IMUSourceEngine.cpp:11-69 — nine floats per file, printf mask)."""

    def __init__(self, mask: str):
        self.mask = mask
        self.index = 0

    def has_more_measurements(self) -> bool:
        return os.path.exists(expand_printf_mask(self.mask, self.index))

    def get_measurement(self) -> np.ndarray:
        path = expand_printf_mask(self.mask, self.index)
        self.index += 1
        vals = np.loadtxt(path).reshape(3, 3).astype(np.float32)
        return vals


class PoseSource:
    """External pose feed (reference: PoseSourceEngine / RosPoseSourceEngine
    without ROS — poses pushed by the caller, pulled per frame)."""

    def __init__(self):
        self._pose: Optional[np.ndarray] = None

    def push(self, pose_4x4: np.ndarray) -> None:
        self._pose = np.asarray(pose_4x4, dtype=np.float32)

    def latest(self) -> Optional[np.ndarray]:
        return self._pose


class RecordingSource(ImageSourceEngine):
    """Wrap any source and record its raw stream to disk for deterministic
    replay (reference: UIEngine 's' key writes the input depth/rgb images to
    Files/Out with printf masks, UIEngine.cpp:498-508). Replay the directory
    later with `ReplaySource(dir, calib)` / `--replay`."""

    DEPTH_MASK = "depth_%04i.pgm"
    RGB_MASK = "rgb_%04i.ppm"

    def __init__(self, inner: ImageSourceEngine, out_dir: str):
        self.inner = inner
        self.calib = inner.calib
        self.out_dir = out_dir
        self.index = 0
        os.makedirs(out_dir, exist_ok=True)

    def has_more_images(self) -> bool:
        return self.inner.has_more_images()

    def get_images(self):
        out = self.inner.get_images()
        depth, rgb = (a.cpu().numpy() if torch.is_tensor(a) else a for a in out[:2])
        if depth is not None:
            d = np.asarray(depth)
            if d.dtype != np.uint16:
                # metric float depth records as millimetres (TUM-style raw)
                d = np.clip(np.asarray(d, np.float64) * 1000.0, 0, 65535).astype(np.uint16)
            write_image(os.path.join(self.out_dir, expand_printf_mask(self.DEPTH_MASK, self.index)), d)
        if rgb is not None:
            r = np.asarray(rgb)
            if r.dtype != np.uint8:
                r = np.clip(np.asarray(r, np.float64) * 255.0, 0, 255).astype(np.uint8)
            write_image(os.path.join(self.out_dir, expand_printf_mask(self.RGB_MASK, self.index)), r)
        self.index += 1
        return out


class ReplaySource(ImageSourceEngine):
    """Replay a RecordingSource directory (metric depth reconstructed from
    the recorded millimetre uint16)."""

    def __init__(self, rec_dir: str, calib: RGBDCalib):
        self.root = rec_dir
        self.calib = calib
        self.index = 0

    def _dpath(self, i: int) -> str:
        return os.path.join(self.root, expand_printf_mask(RecordingSource.DEPTH_MASK, i))

    def has_more_images(self) -> bool:
        return os.path.exists(self._dpath(self.index))

    def get_images(self):
        depth_mm = read_image(self._dpath(self.index))
        rpath = os.path.join(
            self.root, expand_printf_mask(RecordingSource.RGB_MASK, self.index)
        )
        rgb = read_image(rpath) if os.path.exists(rpath) else None
        self.index += 1
        return depth_mm.astype(np.float32) / 1000.0, rgb


def make_source(
    calib_path: Optional[str] = None,
    rgb_mask: Optional[str] = None,
    depth_mask: Optional[str] = None,
    tum_root: Optional[str] = None,
    allow_synthetic: bool = True,
    img_size: Tuple[int, int] = (480, 640),
    n_frames: int = 50,
    with_rgb: bool = False,
    device: torch.device | str = "cuda",
):
    """Source fallback chain (reference: InfiniTAM.cpp:21-87 tries
    files → OpenNI → UVC → RealSense → Kinect2): here
    file masks → TUM directory → live cameras (absent in this build) →
    synthetic replay, rendered on `device`. Returns (source, is_synthetic)."""
    if depth_mask and calib_path:
        first = expand_printf_mask(depth_mask, 0)
        if os.path.exists(first):
            return ImageFileReader(calib_path, rgb_mask or "", depth_mask), False
        print(f"[sources] no frames at {first}; trying next source")
    if tum_root and os.path.exists(os.path.join(tum_root, "associations.txt")):
        return TUMSource(tum_root), False
    try:
        return LiveSourceStub(), False
    except RuntimeError as e:
        print(f"[sources] {e}")
    if not allow_synthetic:
        raise RuntimeError("no usable image source")
    from infinitam_tpu_torch.io import synth

    calib = (
        read_rgbd_calib(calib_path) if calib_path
        else default_calib(img_size[1], img_size[0])
    )
    return (
        synth.SyntheticSource(calib, n_frames=n_frames, img_size=img_size, with_rgb=with_rgb, device=device),
        True,
    )


class LiveSourceStub(ImageSourceEngine):
    """Placeholder for live camera backends (OpenNI2 / libuvc / RealSense /
    Kinect2 — reference Engine/{OpenNIEngine,LibUVCEngine,RealSenseEngine,
    Kinect2Engine}.cpp). No camera hardware exists in this deployment; the
    class preserves the fallback-chain API of InfiniTAM.cpp:21-87."""

    def __init__(self, *_a, **_k):
        raise RuntimeError(
            "live camera sources are unavailable in this build; use "
            "ImageFileReader/TUMSource/SyntheticSource"
        )


def frame_tensor(a, device: torch.device | str) -> Optional[torch.Tensor]:
    """A frame (numpy array or tensor) as a tensor on `device`; uint16 raw
    depth widens to int32 (the view builder's conversions read any integer
    type)."""
    if a is None:
        return None
    if not torch.is_tensor(a):
        a = np.asarray(a)
        a = torch.from_numpy(a.astype(np.int32) if a.dtype == np.uint16 else np.array(a))  # a writable copy
    return a.to(device)


class DeviceFrameFeed(ImageSourceEngine):
    """Keeps the next `depth_frames` frames of any source uploaded to the
    card ahead of the consumer (the JAX package's DeviceFrameFeed, a
    device-side frame ring). Each frame's depth and rgb are copied into
    pinned host buffers that a ring of `depth_frames` slots reuses, then to
    the card with `non_blocking=True` on the feed's own stream, so the copy
    runs beside the frame steps (captured graph replays) before it; an
    event recorded after a slot's copies says when its buffers may be
    written again (checked with `query`, waited on only while the copy is
    still running). `get_images` hands a frame out after making the
    caller's stream wait for its copies on the device, never on the host,
    so the step that copies it into its graph's static input runs after
    them. Frames already on the card pass through; on device="cpu" every
    frame passes through unchanged."""

    def __init__(self, inner: ImageSourceEngine, device: torch.device | str = "cuda", depth_frames: int = 3):
        self.inner = inner
        self.calib = inner.calib
        self.device = torch.device(device)
        self.depth_frames = depth_frames
        self._q: list = []  # (frame, the event after its copies or None)
        self._pinned: list = [{} for _ in range(depth_frames)]  # slot → {field: pinned buffer}
        self._copied: list = [None] * depth_frames  # slot → event after its copies
        self._slot = 0
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def _upload(self, out):
        if self.device.type != "cuda":
            return out, None
        slot = self._slot
        self._slot = (slot + 1) % self.depth_frames
        done = self._copied[slot]
        if done is not None and not done.query():
            done.synchronize()
        frame = []
        with torch.cuda.stream(self._stream):
            for field, a in enumerate(out[:2]):
                if a is None or (torch.is_tensor(a) and a.device.type == "cuda"):
                    frame.append(a if a is None else a.to(self.device))
                    continue
                host = frame_tensor(a, "cpu")
                buf = self._pinned[slot].get(field)
                if buf is None or buf.shape != host.shape or buf.dtype != host.dtype:
                    buf = self._pinned[slot][field] = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
                buf.copy_(host)
                frame.append(buf.to(self.device, non_blocking=True))
            done = torch.cuda.Event()
            done.record(self._stream)
        self._copied[slot] = done
        return tuple(frame) + tuple(out[2:]), done

    def _fill(self) -> None:
        while len(self._q) < self.depth_frames and self.inner.has_more_images():
            self._q.append(self._upload(self.inner.get_images()))

    def has_more_images(self) -> bool:
        self._fill()
        return len(self._q) > 0

    def get_images(self):
        self._fill()
        if not self._q:
            raise StopIteration
        frame, done = self._q.pop(0)
        if done is not None:
            # the caller's stream waits for the copies on the device; the
            # tensors, made on the feed's stream, are not reused before the
            # caller's work on them has run
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for t in frame[:2]:
                if t is not None:
                    t.record_stream(stream)
        return frame
