"""RGB-D calibration objects (reference: ITMLib/Objects/ITMIntrinsics.h:17,
ITMExtrinsics.h:17, ITMDisparityCalib.h:18).

The port's own copy of the objects of infinitam_tpu/calib.py, with the same
fields and the same `default_calib`, so that the port runs with no part of
the JAX package present. tests/test_torch_config.py fails on any drift
between the two copies: a field changed in one file is changed in the other
in the same commit.
The port reads a calibration by field, so one of the JAX package's, as its
file reader returns it, works as well. `read_rgbd_calib` and
`write_rgbd_calib` are copies of the JAX package's (reference
ITMLib/Utils/ITMCalibIO.cpp readRGBDCalib), held equal to them by
tests/test_torch_io.py.

The calib file format (e.g. reference Files/Teddy/calib.txt):
    rgb:   W H / fx fy / cx cy
    depth: W H / fx fy / cx cy
    extrinsics rgb→depth: 3 rows of 4 (row-major of the column-major ref matrix)
    disparity: ["kinect"|"affine"] a b
"""

from __future__ import annotations

import dataclasses
import io
import os
from typing import Tuple

import numpy as np

DISPARITY_KINECT = "kinect"
DISPARITY_AFFINE = "affine"


@dataclasses.dataclass(frozen=True)
class Intrinsics:
    """Pinhole intrinsics (fx, fy, cx, cy) + image size."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    @property
    def vector(self) -> np.ndarray:
        return np.array([self.fx, self.fy, self.cx, self.cy], dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class DisparityCalib:
    """Disparity→depth transform.

    kinect: depth = 8·b·fx_depth / (a − disparity)
    affine: depth = a·raw + b
    """

    a: float = 1.0 / 1000.0
    b: float = 0.0
    type: str = DISPARITY_AFFINE


@dataclasses.dataclass(frozen=True)
class RGBDCalib:
    intrinsics_rgb: Intrinsics
    intrinsics_d: Intrinsics
    # 4×4 row-major, RGB camera frame → depth camera frame
    trafo_rgb_to_depth: Tuple[Tuple[float, ...], ...]
    disparity: DisparityCalib

    @property
    def rgb_to_depth(self) -> np.ndarray:
        return np.array(self.trafo_rgb_to_depth, dtype=np.float32)


def default_calib(width: int = 640, height: int = 480) -> RGBDCalib:
    """A pinhole calibration with a Kinect-like field of view (~62°) at any
    resolution, for synthetic sources and tests."""
    f = 525.0 * width / 640.0
    intr = Intrinsics(fx=f, fy=f, cx=width / 2 - 0.5, cy=height / 2 - 0.5, width=width, height=height)
    return RGBDCalib(
        intrinsics_rgb=intr,
        intrinsics_d=intr,
        trafo_rgb_to_depth=tuple(tuple(float(x) for x in row) for row in np.eye(4)),
        disparity=DisparityCalib(),
    )


def _read_intrinsics(tokens) -> Intrinsics:
    w, h = float(next(tokens)), float(next(tokens))
    fx, fy = float(next(tokens)), float(next(tokens))
    cx, cy = float(next(tokens)), float(next(tokens))
    return Intrinsics(fx=fx, fy=fy, cx=cx, cy=cy, width=int(w), height=int(h))


def read_rgbd_calib(path_or_text: str) -> RGBDCalib:
    """Parse the reference calib text format from a path or literal text."""
    if "\n" in path_or_text or " " in path_or_text.strip().split("\n")[0] and not os.path.exists(path_or_text):
        text = path_or_text
    else:
        with open(path_or_text, "r") as f:
            text = f.read()
    tokens = iter(text.split())

    intr_rgb = _read_intrinsics(tokens)
    intr_d = _read_intrinsics(tokens)

    # Extrinsics: the reference reads 3 text rows into columns m{0..3}{row}
    # of a column-major matrix, so each text row IS a row of the matrix.
    M = np.eye(4, dtype=np.float64)
    for r in range(3):
        for c in range(4):
            M[r, c] = float(next(tokens))

    word = next(tokens)
    dtype_ = DISPARITY_KINECT
    if word == "kinect":
        a = float(next(tokens))
    elif word == "affine":
        dtype_ = DISPARITY_AFFINE
        a = float(next(tokens))
    else:
        a = float(word)
    b = float(next(tokens))
    if a == 0.0 and b == 0.0:
        dtype_, a, b = DISPARITY_AFFINE, 1.0 / 1000.0, 0.0

    return RGBDCalib(
        intrinsics_rgb=intr_rgb,
        intrinsics_d=intr_d,
        trafo_rgb_to_depth=tuple(tuple(float(x) for x in row) for row in M),
        disparity=DisparityCalib(a=a, b=b, type=dtype_),
    )


def write_rgbd_calib(calib: RGBDCalib) -> str:
    """Serialize back to the reference text format."""
    out = io.StringIO()
    for intr in (calib.intrinsics_rgb, calib.intrinsics_d):
        out.write(f"{intr.width} {intr.height}\n")
        out.write(f"{intr.fx} {intr.fy}\n")
        out.write(f"{intr.cx} {intr.cy}\n\n")
    M = calib.rgb_to_depth
    for r in range(3):
        out.write(" ".join(str(float(x)) for x in M[r]) + "\n")
    out.write("\n")
    d = calib.disparity
    out.write(f"{d.type} {d.a} {d.b}\n")
    return out.getvalue()
