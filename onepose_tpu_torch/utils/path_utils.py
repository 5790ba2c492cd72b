"""Dataset directory layout, the parts the port's inference reads (its own
copy of those functions of ``onepose_tpu/utils/path_utils.py``).

data_root/<seq>/
    color/          crops for GT_box mode
    color_det/      detector crops
    poses_ba/       GT object poses (txt, 4x4)
    intrin_ba/      per-frame crop intrinsics (txt, 3x3)
    intrin_det/     detector-crop intrinsics

sfm_model_dir/outputs_<detection>_<matching>/anno/
    anno_3d_average.npz  anno_3d_collect.npz  idxs.npy
"""
from __future__ import annotations

import os.path as osp


def get_gt_pose_path_by_color(color_path: str, det_type: str = "GT_box") -> str:
    src = {"GT_box": "/color/", "feature_matching": "/color_det/"}[det_type]
    return color_path.replace(src, "/poses_ba/").replace(".png", ".txt")


def get_intrin_path_by_color(color_path: str,
                             det_type: str = "GT_box") -> str:
    if det_type == "GT_box":
        return color_path.replace("/color/", "/intrin_ba/").replace(
            ".png", ".txt")
    if det_type == "feature_matching":
        return color_path.replace("/color_det/", "/intrin_det/").replace(
            ".png", ".txt")
    raise NotImplementedError(det_type)


def get_anno_dir(sfm_model_dir: str, detection: str = "superpoint",
                 matching: str = "superglue") -> str:
    return osp.join(
        sfm_model_dir, f"outputs_{detection}_{matching}", "anno")
