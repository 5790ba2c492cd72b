"""Merge per-object annotation files into one training index: the port's
own copy of ``onepose_tpu/datasets/merge.py`` (the reference's ``run.py
merge_anno``, the same JSON schema)."""
from __future__ import annotations

import json
import os
import os.path as osp
from typing import Sequence


def merge_anno(data_dir: str, names: Sequence[str], out_path: str,
               detection: str = "superpoint",
               matching: str = "superglue") -> int:
    """Collect each object's anno_2d.json into one {'images', 'annotations'}
    index. Returns the number of images merged."""
    images, annotations = [], []
    img_id = ann_id = 0
    for name in names:
        anno_dir = osp.join(
            data_dir, name, f"outputs_{detection}_{matching}", "anno")
        anno_2d_file = osp.join(anno_dir, "anno_2d.json")
        avg_file = osp.join(anno_dir, "anno_3d_average.npz")
        clt_file = osp.join(anno_dir, "anno_3d_collect.npz")
        idxs_file = osp.join(anno_dir, "idxs.npy")
        if not (osp.isfile(anno_2d_file) and osp.isfile(avg_file)
                and osp.isfile(clt_file)):
            print(f"[merge_anno] no annotation in {anno_dir}")
            continue
        with open(anno_2d_file, "r") as f:
            annos_2d = json.load(f)
        for anno_2d in annos_2d:
            img_id += 1
            images.append({"id": img_id, "img_file": anno_2d["img_file"]})
            ann_id += 1
            annotations.append({
                "image_id": img_id,
                "id": ann_id,
                "pose_file": anno_2d["pose_file"],
                "anno2d_file": anno_2d["anno_file"],
                "avg_anno3d_file": avg_file,
                "collect_anno3d_file": clt_file,
                "idxs_file": idxs_file,
            })
    os.makedirs(osp.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)
    print(f"[merge_anno] total num: {len(images)}")
    return len(images)
