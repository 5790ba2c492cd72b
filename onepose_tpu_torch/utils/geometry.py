"""Host-side (numpy) geometry for the port: intrinsics-consistent crop and
resize, intrinsics file IO, rotations and quaternions, projection and
the pose-error
metrics of the cmd1/3/5 protocol.

The port's own copy of the functions of ``onepose_tpu/utils/geometry.py``
that it calls.
"""
from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# Similarity (center/scale/rot) crop transform
# ---------------------------------------------------------------------------

def get_affine_transform(
    center: np.ndarray,
    scale,
    rot: float,
    output_size,
    shift=(0.0, 0.0),
    inv: bool = False,
) -> np.ndarray:
    """2x3 similarity transform mapping a (center, scale, rot) source box onto
    an ``output_size`` = (w, h) target rectangle.

    Uniform scale = out_w / box_w; ``scale[1]`` only affects the shift
    term, so intrinsics updated with this transform stay consistent with
    the warped image.
    """
    center = np.asarray(center, dtype=np.float64)
    scale = np.asarray(
        scale if np.ndim(scale) else [scale, scale], dtype=np.float64
    )
    shift = np.asarray(shift, dtype=np.float64)
    out_w, out_h = float(output_size[0]), float(output_size[1])

    src_w = scale[0]
    theta = np.pi * rot / 180.0
    c, s = np.cos(theta), np.sin(theta)

    # Uniform similarity: x' = k * R(-theta) @ (x - src_center) + dst_center.
    # The source triangle is built by rotating the output frame by +theta, so
    # the forward map applies the inverse rotation.
    k = out_w / src_w
    R = np.array([[c, s], [-s, c]], dtype=np.float64)
    src_center = center + scale * shift
    dst_center = np.array([out_w * 0.5, out_h * 0.5], dtype=np.float64)

    A = k * R
    t = dst_center - A @ src_center
    trans = np.concatenate([A, t[:, None]], axis=1)

    if inv:
        A_inv = np.linalg.inv(A)
        t_inv = -A_inv @ t
        trans = np.concatenate([A_inv, t_inv[:, None]], axis=1)
    return trans.astype(np.float64)


def get_image_crop_resize(image: np.ndarray, box, resize_shape):
    """Crop ``image`` to ``box`` = [x0, y0, x1, y1] and resize to
    ``resize_shape`` = (h, w). Returns (crop, 3x3 homogeneous transform)."""
    import cv2

    center = np.array([(box[0] + box[2]) / 2.0, (box[1] + box[3]) / 2.0])
    scale = np.array([box[2] - box[0], box[3] - box[1]])
    resize_h, resize_w = resize_shape
    trans = get_affine_transform(center, scale, 0, [resize_w, resize_h])
    crop = cv2.warpAffine(
        image, trans.astype(np.float32), (int(resize_w), int(resize_h)),
        flags=cv2.INTER_LINEAR,
    )
    trans_homo = np.concatenate([trans, np.array([[0.0, 0.0, 1.0]])], axis=0)
    return crop, trans_homo


def get_K_crop_resize(box, K_orig: np.ndarray, resize_shape):
    """Update a 3x3 (or 3x4) intrinsics matrix for the crop+resize defined by
    ``box`` → ``resize_shape``. Returns (K_crop 3x3, K_crop_homo 3x4)."""
    center = np.array([(box[0] + box[2]) / 2.0, (box[1] + box[3]) / 2.0])
    scale = np.array([box[2] - box[0], box[3] - box[1]])
    resize_h, resize_w = resize_shape
    trans = get_affine_transform(center, scale, 0, [resize_w, resize_h])
    trans_homo = np.concatenate([trans, np.array([[0.0, 0.0, 1.0]])], axis=0)

    K = np.asarray(K_orig, dtype=np.float64)
    if K.shape == (3, 3):
        K_homo = np.concatenate([K, np.zeros((3, 1))], axis=-1)
    else:
        K_homo = K.copy()
    if K_homo.shape != (3, 4):
        raise ValueError(f"K must be 3x3 or 3x4, got {K.shape}")
    K_crop_homo = trans_homo @ K_homo
    return K_crop_homo[:3, :3], K_crop_homo


# ---------------------------------------------------------------------------
# Intrinsics file IO
# ---------------------------------------------------------------------------

def get_K(intrin_file: str):
    """Parse an ``intrinsics.txt`` with lines 'fx: ...', 'fy: ...', 'cx: ...',
    'cy: ...'. Returns (K 3x3, K_homo 3x4)."""
    with open(intrin_file, "r") as f:
        lines = f.readlines()
    vals = [float(line.rstrip("\n").split(":")[1]) for line in lines]
    fx, fy, cx, cy = vals
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float64)
    K_homo = np.array(
        [[fx, 0, cx, 0], [0, fy, cy, 0], [0, 0, 1, 0]], dtype=np.float64
    )
    return K, K_homo


# ---------------------------------------------------------------------------
# Rotations, pose errors, projection
# ---------------------------------------------------------------------------

def qvec2rotmat(qvec) -> np.ndarray:
    """Quaternion (w, x, y, z) → 3x3 rotation matrix."""
    w, x, y, z = np.asarray(qvec, dtype=np.float64)
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
    ])


def rotmat2qvec(R) -> np.ndarray:
    """3x3 rotation matrix → quaternion (w, x, y, z), w >= 0."""
    R = np.asarray(R, dtype=np.float64)
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
    ]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


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
