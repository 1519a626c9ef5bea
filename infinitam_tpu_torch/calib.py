"""RGB-D calibration objects (reference: ITMLib/Objects/ITMIntrinsics.h:17,
ITMExtrinsics.h:17, ITMDisparityCalib.h:18).

The port's own copy of the objects of infinitam_tpu/calib.py, with the same
fields and the same `default_calib`, so that the port runs with no part of
the JAX package present. tests/test_torch_config.py fails on any drift
between the two copies: a field changed in one file is changed in the other
in the same commit.
The port reads a calibration by field, so one of the JAX package's, as its
file reader returns it, works as well. The calib-file reader and writer come
with the port of the apps.
"""

from __future__ import annotations

import dataclasses
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
