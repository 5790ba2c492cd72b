"""Feature-matching 2D object detection over full frames with the PyTorch
port.

Counterpart of the repository's ``feature_matching_object_detector.py``:
for each test sequence, detect the object in every ``color_full`` frame by
SuperGlue-matching it against reference views sampled from the SfM model,
and write 512x512 crops to ``color_det/`` and cropped intrinsics to
``intrin_det/``, which inference reads with
``object_detect_mode=feature_matching``.

    python -m onepose_tpu_torch.feature_matching_object_detector \\
        +experiment=object_detector

The config key ``device`` names the torch device (default ``cuda``; there
is no quiet CPU fallback).
"""
from __future__ import annotations

import glob
import os
import os.path as osp
import sys

import numpy as np


def _read_list(path):
    with open(path, "r") as f:
        return [line.strip() for line in f if line.strip()]


def sample_ref_views(sfm_model_dir, detection, matching, n_ref_view):
    """Every (n_images // n_ref_view)-th database image path of the SfM
    model, in image-id order."""
    from onepose_tpu_torch.utils import colmap_io

    model_dir = osp.join(
        sfm_model_dir, f"outputs_{detection}_{matching}", "sfm_ws", "model")
    _, images, _ = colmap_io.read_model(model_dir)
    ids = sorted(images.keys())
    gap = max(len(ids) // n_ref_view, 1)
    return [images[ids[i]].name for i in range(0, len(ids), gap)]


def detect_sequence(cfg, seq_dir, sfm_model_dir, sp_model, sg_model):
    import cv2
    import torch

    from onepose_tpu_torch.detector import LocalFeatureObjectDetector
    from onepose_tpu_torch.sfm.extract import load_gray
    from onepose_tpu_torch.utils import geometry as geo

    db_paths = sample_ref_views(
        sfm_model_dir, cfg.network.detection, cfg.network.matching,
        cfg.n_ref_view)
    db_images = [load_gray(p) for p in db_paths]
    detector = LocalFeatureObjectDetector(
        sp_model, sg_model, db_images, max_keypoints=cfg.max_keypoints,
        device=torch.device(cfg.get("device", "cuda")))

    K, _ = geo.get_K(osp.join(seq_dir, "intrinsics.txt"))
    out_color = osp.join(seq_dir, "color_det")
    out_intrin = osp.join(seq_dir, "intrin_det")
    os.makedirs(out_color, exist_ok=True)
    os.makedirs(out_intrin, exist_ok=True)

    frames = sorted(
        glob.glob(osp.join(seq_dir, "color_full", "*.png")),
        key=lambda p: int(osp.splitext(osp.basename(p))[0]))
    for p in frames:
        # every frame's RANSAC draws from a generator seeded 0
        res = detector.detect(load_gray(p), K)
        name = osp.basename(p)
        cv2.imwrite(osp.join(out_color, name),
                    (res.crop * 255).astype(np.uint8))
        np.savetxt(osp.join(out_intrin, name.replace(".png", ".txt")),
                   res.K_crop)
    print(f"[detector] {seq_dir}: {len(frames)} frames → {out_color}")


def detection(cfg):
    from onepose_tpu_torch.utils import model_io

    sp_model = model_io.load_superpoint(cfg.model.extractor_model_path)
    sg_model = model_io.load_superglue(cfg.model.matching_model_path)
    for entry, sfm_name in zip(_read_list(cfg.input.data_list),
                               _read_list(cfg.input.sfm_list)):
        obj_dir, *seqs = entry.split(" ")
        for seq in seqs:
            detect_sequence(cfg, osp.join(cfg.scan_data_dir, obj_dir, seq),
                            osp.join(cfg.sfm_model_dir, sfm_name),
                            sp_model, sg_model)


def main():
    from onepose_tpu_torch.config import load_config

    cfg = load_config(sys.argv[1:])
    {"detection": detection}[cfg.type](cfg)


if __name__ == "__main__":
    main()
