"""Dataset directory layout (the port's own copy of
``onepose_tpu/utils/path_utils.py``).

data_root/
    box3d_corners.txt
    <seq>/
        intrinsics.txt  full-frame intrinsics
        color_full/     full frames
        color/          crops for GT_box mode
        color_det/      detector crops
        poses_ba/       GT object poses (txt, 4x4)
        intrin_ba/      per-frame crop intrinsics (txt, 3x3)
        intrin_det/     detector-crop intrinsics

sfm_model_dir/outputs_<detection>_<matching>/anno/
    anno_3d_average.npz  anno_3d_collect.npz  idxs.npy  anno_2d.json
"""
from __future__ import annotations

import os.path as osp


def get_gt_pose_path_by_color(color_path: str, det_type: str = "GT_box") -> str:
    src = {"GT_box": "/color/", "feature_matching": "/color_det/"}[det_type]
    return color_path.replace(src, "/poses_ba/").replace(".png", ".txt")


def get_img_full_path_by_color(color_path: str,
                               det_type: str = "GT_box") -> str:
    src = {"GT_box": "/color/", "feature_matching": "/color_det/"}[det_type]
    return color_path.replace(src, "/color_full/")


def get_intrin_path_by_color(color_path: str,
                             det_type: str = "GT_box") -> str:
    if det_type == "GT_box":
        return color_path.replace("/color/", "/intrin_ba/").replace(
            ".png", ".txt")
    if det_type == "feature_matching":
        return color_path.replace("/color_det/", "/intrin_det/").replace(
            ".png", ".txt")
    raise NotImplementedError(det_type)


def get_intrin_dir(seq_root: str) -> str:
    return osp.join(seq_root, "intrin_ba")


def get_gt_pose_dir(seq_root: str) -> str:
    return osp.join(seq_root, "poses_ba")


def get_intrin_full_path(seq_root: str) -> str:
    return osp.join(seq_root, "intrinsics.txt")


def get_3d_box_path(data_root: str) -> str:
    return osp.join(data_root, "box3d_corners.txt")


def get_anno_dir(sfm_model_dir: str, detection: str = "superpoint",
                 matching: str = "superglue") -> str:
    return osp.join(
        sfm_model_dir, f"outputs_{detection}_{matching}", "anno")
