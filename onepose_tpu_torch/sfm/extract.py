"""SuperPoint extraction settings and image loading for the port: the
port's own copy of ``CONFS`` and ``load_gray`` from
``onepose_tpu/sfm/extract.py``. (Writing features to HDF5 belongs to the
SfM slice, which is not ported yet.)

The conf's ``keypoint_threshold`` is 0.005, the value the reference's
extraction effectively runs with: its conf spells the key
``keypoints_threshold``, which the model never reads.
"""
from __future__ import annotations

import numpy as np

CONFS = {
    "superpoint": {
        "output": "feats-superpoint",
        "preprocessing": {"grayscale": True, "resize_h": 512,
                          "resize_w": 512},
        "conf": {
            "descriptor_dim": 256,
            "nms_radius": 3,
            "max_keypoints": 4096,
            "keypoint_threshold": 0.005,
        },
    }
}


def load_gray(img_path: str, resize_hw=None) -> np.ndarray:
    """Grayscale image as float32 in [0, 1], resized to ``resize_hw``
    (h, w) when given."""
    import cv2

    img = cv2.imread(img_path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(img_path)
    if resize_hw is not None and tuple(img.shape[:2]) != tuple(resize_hw):
        img = cv2.resize(img, (resize_hw[1], resize_hw[0]),
                         interpolation=cv2.INTER_LINEAR)
    return img.astype(np.float32) / 255.0
