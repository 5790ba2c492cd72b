"""Synthetic scenes with known poses, for running and checking the port
without a dataset: a textured plane filmed by a moving camera, in numpy
and torch only (no cv2), in the role of
``scripts/bench_tracker.py::make_sequence``, and the planting of an
object DB's points on that plane.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from onepose_tpu_torch.utils import geometry as geo


def plane_sequence(rng, n_frames, hw=512, focal=460.0, n_points=400,
                   slots=1024, desc_dim=256, rot0=0.25,
                   rot_step=(0.02, 0.03, 0.01),
                   trans_step=(0.004, -0.002)):
    """A textured plane (z = 0 in the object frame, 0.4 m square) under a
    moving camera 0.5 m away, with known poses: a 80x80 random texture
    upsampled bicubically to 640x640, each frame the exact homography warp
    of it (``grid_sample``, bilinear, black outside).
    Keypoints are ``n_points`` projected plane points (0.3 px noise) with
    stable descriptors (noise 0.02), padded with masked slots to
    ``slots``. → (K [3, 3], pts3d [n_points, 3], frames: dicts of image
    [hw, hw] float32 in [0, 1], pose [3, 4], keypoints [slots, 2],
    descriptors [slots, desc_dim], mask [slots])."""
    K = np.array([[focal, 0, hw / 2], [0, focal, hw / 2], [0, 0, 1]])
    tex_res = 640
    cells = torch.from_numpy(rng.uniform(0, 1, (1, 1, 80, 80)))
    tex = F.interpolate(cells, size=(tex_res, tex_res), mode="bicubic",
                        align_corners=False).clamp(0, 1)
    scale = tex_res / 0.4                       # texture px a metre
    T_plane = np.array([[scale, 0, 0.2 * scale], [0, scale, 0.2 * scale],
                        [0, 0, 1]])
    pts3d = np.concatenate([rng.uniform(-0.15, 0.15, (n_points, 2)),
                            np.zeros((n_points, 1))], axis=1)
    descs = rng.normal(size=(n_points, desc_dim)).astype(np.float32)
    ys, xs = np.mgrid[0:hw, 0:hw].astype(np.float64)
    pix = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3)

    frames = []
    for i in range(n_frames):
        R = geo.rodrigues([rot0 + rot_step[0] * i, rot_step[1] * i,
                           rot_step[2] * i])
        t = np.array([trans_step[0] * i, trans_step[1] * i, 0.5])
        pose = np.concatenate([R, t[:, None]], axis=1)
        H = K @ np.stack([R[:, 0], R[:, 1], t], axis=1) @ np.linalg.inv(
            T_plane)                            # texture px → image px
        src = pix @ np.linalg.inv(H).T
        src = src[:, :2] / src[:, 2:3]
        grid = torch.from_numpy((2 * src + 1) / tex_res - 1).reshape(
            1, hw, hw, 2)
        img = F.grid_sample(tex, grid, mode="bilinear", padding_mode="zeros",
                            align_corners=False)[0, 0]
        uv = geo.project_points(pts3d, K, pose)
        kp = np.zeros((slots, 2), np.float32)
        ds = np.zeros((slots, desc_dim), np.float32)
        mask = np.zeros(slots, bool)
        kp[:n_points] = uv + rng.normal(size=uv.shape) * 0.3
        ds[:n_points] = descs + 0.02 * rng.normal(size=descs.shape)
        mask[:n_points] = True
        frames.append({"image": img.numpy().astype(np.float32),
                       "pose": pose, "keypoints": kp, "descriptors": ds,
                       "mask": mask})
    return K, pts3d, frames


def plant_on_plane(db, matches0, keypoints2d, kmat, pose):
    """A copy of ``db`` whose 3D points matched by one frame's keypoints
    are those keypoints' rays intersected with the plane z = 0 under the
    frame's pose (``plane_sequence``'s object). Matching reads descriptors
    only, so the frame's matches stay and are now consistent with the
    pose, and LK flow from the frame is consistent with them later."""
    kpts3d = db.keypoints3d.copy()
    R, t = pose[:, :3], pose[:, 3]
    center = -R.T @ t
    m0 = np.asarray(matches0)
    rays = np.concatenate([np.asarray(keypoints2d, np.float64),
                           np.ones((len(m0), 1))], 1) @ np.linalg.inv(kmat).T
    dirs = rays @ R                                   # R^T ray, row-wise
    for k in np.flatnonzero(m0 >= 0):
        kpts3d[m0[k]] = center - center[2] / dirs[k, 2] * dirs[k]
    return dataclasses.replace(db, keypoints3d=kpts3d.astype(np.float32))
