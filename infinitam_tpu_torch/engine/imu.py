"""IMU-assisted tracking: calibrator + rotation predictor + composite order.

Reference parity: ITMLib/Objects/ITMIMUCalibrator.h:27-82 (iPad-convention
calibrator — negated rotation parameters on registration, differential
rotation new·old⁻¹ with swapped/negated axes), ITMLib/Engine/ITMIMUTracker.cpp:17-22
(applies the differential rotation to the pose before ICP) and
ITMLib/Engine/ITMCompositeTracker.h:42-45 (trackers run in sequence).

The port's own copy of infinitam_tpu/engine/imu.py. The calibrator is tiny
per-frame host-side math (3×3), so it runs in numpy; the rotation prior goes
to MainEngine.process_frame(imu_rotation=).
"""

from __future__ import annotations

import numpy as np


def _rot_log(R: np.ndarray) -> np.ndarray:
    """SO(3) log → axis-angle vector (host-side; tiny)."""
    cos = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    theta = np.arccos(cos)
    if theta < 1e-8:
        return np.zeros(3, dtype=np.float64)
    w = (
        np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        * 0.5
        / np.sin(theta)
    )
    return w * theta


def _rot_exp(w: np.ndarray) -> np.ndarray:
    theta = float(np.linalg.norm(w))
    if theta < 1e-8:
        return np.eye(3)
    k = w / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)


class IMUCalibrator:
    """Base calibrator interface (reference: ITMIMUCalibrator.h:12-25)."""

    def register_measurement(self, R: np.ndarray) -> None:
        raise NotImplementedError

    def differential_rotation(self) -> np.ndarray:
        raise NotImplementedError


class IMUCalibratoriPad(IMUCalibrator):
    """iPad-convention calibrator (reference: ITMIMUCalibrator_iPad,
    ITMIMUCalibrator.h:27-82): each raw measurement's rotation parameters are
    negated (device→camera handedness flip); the differential rotation
    R_new·R_old⁻¹ is re-expressed with its x/y rotation parameters swapped
    and negated before being applied to the camera pose."""

    def __init__(self) -> None:
        self._R_imu = np.eye(3)
        self._diff = np.eye(3)
        self._has_two = False

    def register_measurement(self, R: np.ndarray) -> None:
        old_R = self._R_imu
        # negate rotation params (reference :40-46)
        self._R_imu = _rot_exp(-_rot_log(np.asarray(R, dtype=np.float64)))
        self._old_R = old_R

    def differential_rotation(self) -> np.ndarray:
        if self._has_two:
            d = self._R_imu @ np.linalg.inv(self._old_R)
            r = _rot_log(d)
            # swap rx<->ry, negate all (reference :57)
            self._diff = _rot_exp(np.array([-r[1], -r[0], -r[2]]))
        self._has_two = True
        return self._diff


def apply_imu_prior(pose: np.ndarray, diff_rotation: np.ndarray) -> np.ndarray:
    """IMU tracker step (reference: ITMIMUTracker.cpp:20-21):
    pose.R ← diff_rotation · pose.R, translation unchanged. The ICP tracker
    then refines from this prior (composite order per ITMTrackerFactory's
    TRACKER_IMU maker)."""
    out = np.array(pose, dtype=np.float64, copy=True)
    out[:3, :3] = np.asarray(diff_rotation) @ out[:3, :3]
    return out
