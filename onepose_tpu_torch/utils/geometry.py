"""Host-side (numpy) geometry for the port: rotations, projection and the
pose-error metrics of the cmd1/3/5 protocol.

The port's own copy of the functions of ``onepose_tpu/utils/geometry.py``
that it calls.
"""
from __future__ import annotations

import numpy as np


def rodrigues(rvec) -> np.ndarray:
    """Axis-angle vector → 3x3 rotation matrix."""
    rvec = np.asarray(rvec, dtype=np.float64).reshape(3)
    theta = np.linalg.norm(rvec)
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    K = np.array([
        [0, -k[2], k[1]],
        [k[2], 0, -k[0]],
        [-k[1], k[0], 0],
    ])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def query_pose_error(pose_pred: np.ndarray, pose_gt: np.ndarray):
    """Return (angular error deg, translation error cm) between two object
    poses (3x4 or 4x4). Translation in centimetres = ||dt|| * 100."""
    if pose_pred.shape[0] == 4:
        pose_pred = pose_pred[:3]
    if pose_gt.shape[0] == 4:
        pose_gt = pose_gt[:3]

    t_err_cm = np.linalg.norm(pose_pred[:, 3] - pose_gt[:, 3]) * 100.0
    rot_diff = pose_pred[:, :3] @ pose_gt[:, :3].T
    trace = min(np.trace(rot_diff), 3.0)
    trace = max(trace, -1.0)
    r_err_deg = np.rad2deg(np.arccos((trace - 1.0) / 2.0))
    return r_err_deg, t_err_cm


def aggregate_metrics(metrics: dict, thres=(1, 3, 5)) -> dict:
    """Recall at joint (cm, deg) thresholds over accumulated error lists."""
    R_errs = np.asarray(metrics["R_errs"], dtype=np.float64)
    t_errs = np.asarray(metrics["t_errs"], dtype=np.float64)
    return {
        f"{t}cm@{t}degree": float(np.mean((R_errs < t) & (t_errs < t)))
        for t in thres
    }


def project_points(pts3d: np.ndarray, K: np.ndarray, pose: np.ndarray):
    """Project Nx3 object-frame points with 3x4/4x4 pose and 3x3 K → Nx2."""
    pose = np.asarray(pose, dtype=np.float64)
    R, t = pose[:3, :3], pose[:3, 3]
    cam = pts3d @ R.T + t
    uv = cam @ K.T
    return uv[:, :2] / uv[:, 2:3]
