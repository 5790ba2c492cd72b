"""SfM postprocess for the port: track-length filtering, 3D-box filtering,
point merging, and 3D-descriptor aggregation into the annotation files
that ``datasets/anno.py::load_object_db`` (inference) and training read.

The port's own copy of ``onepose_tpu/sfm/postprocess.py``: numpy and the
port's HDF5 reader (``utils/hdf5.py``) on the host. The files are the
reference's (``anno_3d_average.npz``,
``anno_3d_collect.npz``, ``idxs.npy``, ``anno_2d.json`` and a json per
image); the reference's per-point gather loops are sorted segment
operations here.
"""
from __future__ import annotations

import json
import os
import os.path as osp
from typing import Dict, List, Optional, Sequence

import numpy as np

from onepose_tpu_torch.utils import colmap_io, path_utils


# ---------------------------------------------------------------------------
# Track-length threshold selection (filter_tkl.get_tkl)
# ---------------------------------------------------------------------------

def select_track_length(points3D: Dict[int, colmap_io.Point3D],
                        max_num_points: int) -> int:
    """Smallest track-length threshold keeping <= max_num_points points."""
    lengths = np.array([len(p.point2D_idxs) for p in points3D.values()])
    if len(lengths) == 0:
        return 2
    if len(lengths) <= max_num_points:
        return int(lengths.min())
    counts = np.bincount(lengths)
    remaining = len(lengths)
    for tl in range(len(counts)):
        remaining -= counts[tl]
        if remaining <= max_num_points:
            return tl + 1
    return int(lengths.max())


def write_tkl_ply(points3D: Dict[int, colmap_io.Point3D],
                  track_length: int, output_dir: str) -> str:
    """Dump the track-length-filtered cloud as PLY for visual inspection
    (filter_tkl.vis_tkl_filtered_pcds role, filter_tkl.py:55-81)."""
    kept = {pid: p for pid, p in points3D.items()
            if len(p.point2D_idxs) >= track_length}
    out_dir = osp.join(output_dir, "tkl_model")
    os.makedirs(out_dir, exist_ok=True)
    out_path = osp.join(out_dir, f"tl-{track_length}.ply")
    colmap_io.write_points_ply(kept, out_path)
    return out_path


# ---------------------------------------------------------------------------
# Filters (filter_points.py)
# ---------------------------------------------------------------------------

def filter_by_track_length(points3D: Dict[int, colmap_io.Point3D],
                           track_length: int):
    ids = sorted(points3D.keys())
    keep = [i for i in ids
            if len(points3D[i].point2D_idxs) >= track_length]
    xyzs = np.array([points3D[i].xyz for i in keep]).reshape(-1, 3)
    return xyzs, np.asarray(keep, np.int64)


def filter_by_3d_box(xyzs: np.ndarray, point_ids: np.ndarray,
                     corners: np.ndarray):
    """Keep points inside the oriented 3D box given by its 8 corners
    (projection onto the three edge vectors from corner 4; reference
    filter_points.py:38-61)."""
    corners = np.asarray(corners, np.float64)
    v45 = corners[5] - corners[4]
    v40 = corners[0] - corners[4]
    v47 = corners[7] - corners[4]
    rel = xyzs - corners[4]
    keep = np.ones(len(xyzs), bool)
    for v in (v45, v40, v47):
        m = rel @ v
        keep &= (m > 0) & (m < v @ v)
    return xyzs[keep], point_ids[keep]


def merge_points(xyzs: np.ndarray, point_ids: np.ndarray,
                 dist_threshold: float = 1e-3):
    """Greedy merge of points closer than ``dist_threshold``; each new point
    is the mean of its cluster. Returns (new_xyzs [P,3],
    {new_idx: old_point_id_array}). Same greedy-scan semantics as the
    reference (filter_points.py:86-117), vectorized distance matrix."""
    if len(xyzs) == 0:
        return np.zeros((0, 3)), {}
    diff = xyzs[:, None, :] - xyzs[None, :, :]
    close = np.linalg.norm(diff, axis=-1) < dist_threshold

    merged = np.zeros(len(xyzs), bool)
    ret_points = []
    ret_idxs: Dict[int, np.ndarray] = {}
    count = 0
    for j in range(len(xyzs)):
        members = close[j]
        if (merged & members).any():
            continue
        ret_points.append(xyzs[members].mean(axis=0))
        ret_idxs[count] = point_ids[members]
        count += 1
        merged |= members
    return np.stack(ret_points), ret_idxs


# ---------------------------------------------------------------------------
# Feature aggregation (feature_process.py) — vectorized
# ---------------------------------------------------------------------------

def aggregate_features(img_lists: Sequence[str],
                       features: Dict[str, dict],
                       images: Dict[int, colmap_io.Image],
                       merged_xyzs: np.ndarray,
                       points_idxs: Dict[int, np.ndarray]):
    """Gather every observing 2D keypoint's (position, descriptor, score)
    for each merged 3D point.

    features: per-image dict with 'keypoints' [N,2], 'descriptors' [D,N],
    'scores' [N]. Returns dict with collect/average arrays plus per-image
    2D-3D correspondences for assign matrices.
    """
    old_to_new: Dict[int, int] = {}
    for new_id, old_ids in points_idxs.items():
        for old in old_ids:
            old_to_new[int(old)] = new_id
    n_new = len(points_idxs)

    name_to_image = {im.name: im for im in images.values()}

    # Flatten all valid observations across images (image order preserved —
    # reference gather order is img_lists-major).
    obs_new_id: List[int] = []
    obs_img_order: List[int] = []
    obs_old_id: List[int] = []
    obs_uv: List[np.ndarray] = []
    obs_desc: List[np.ndarray] = []
    obs_score: List[np.ndarray] = []
    per_image_corr: Dict[str, List] = {}

    for img_i, name in enumerate(img_lists):
        im = name_to_image[name]
        feat = features[name]
        p3d = im.point3D_ids
        valid_idx = np.where(p3d != -1)[0]
        corr = []
        for ki in valid_idx:
            old = int(p3d[ki])
            if old not in old_to_new:
                continue
            new_id = old_to_new[old]
            obs_new_id.append(new_id)
            obs_img_order.append(img_i)
            obs_old_id.append(old)
            obs_uv.append(feat["keypoints"][ki])
            obs_desc.append(feat["descriptors"][:, ki])
            obs_score.append(np.atleast_1d(feat["scores"][ki]))
            corr.append((old, int(ki)))
        per_image_corr[name] = corr

    if not obs_new_id:
        dim = next(iter(features.values()))["descriptors"].shape[0]
        return {
            "xyzs": np.zeros((0, 3)),
            "collect_descriptors": np.zeros((0, dim)),
            "collect_scores": np.zeros((0, 1)),
            "avg_descriptors": np.zeros((0, dim)),
            "avg_scores": np.zeros((0, 1)),
            "idxs": np.zeros(0, np.int64),
            "per_image_corr": per_image_corr,
        }

    obs_new_id = np.asarray(obs_new_id)
    obs_img_order = np.asarray(obs_img_order)
    # Within a new point, the reference orders observations old-point-major
    # (gather_3d_ann concatenates per old id), each old point's obs in image
    # order. Reproduce with a stable lexsort.
    old_rank = {}  # (new_id, old_id) -> rank within the new point's list
    for new_id, old_ids in points_idxs.items():
        for r, old in enumerate(old_ids):
            old_rank[(new_id, int(old))] = r
    obs_old_rank = np.asarray(
        [old_rank[(int(n), int(o))]
         for n, o in zip(obs_new_id, obs_old_id)])
    order = np.lexsort((obs_img_order, obs_old_rank, obs_new_id))

    descs = np.stack(obs_desc)[order]          # [O, D]
    scores = np.stack(obs_score)[order].reshape(-1, 1)
    new_ids_sorted = obs_new_id[order]

    idxs = np.bincount(new_ids_sorted, minlength=n_new).astype(np.int64)
    # segment means
    sums_d = np.zeros((n_new, descs.shape[1]))
    np.add.at(sums_d, new_ids_sorted, descs)
    sums_s = np.zeros((n_new, 1))
    np.add.at(sums_s, new_ids_sorted, scores)
    denom = np.maximum(idxs, 1)[:, None]
    avg_descriptors = sums_d / denom
    avg_scores = sums_s / denom

    return {
        "xyzs": merged_xyzs,
        "collect_descriptors": descs,
        "collect_scores": scores,
        "avg_descriptors": avg_descriptors,
        "avg_scores": avg_scores,
        "idxs": idxs,
        "per_image_corr": per_image_corr,
    }


def build_assign_matrix(corr: List, old_to_new: Dict[int, int],
                        n_points: int):
    """Per-image GT assign matrix [2, k] of (kp2d_idx, new_kp3d_idx), each
    2D and 3D index used at most once (reference get_assign_matrix
    semantics, feature_process.py:197-230)."""
    used2d, used3d = set(), set()
    pairs = []
    for old, ki in corr:
        new_id = old_to_new.get(old)
        if new_id is None or new_id >= n_points:
            continue
        if ki in used2d or new_id in used3d:
            used2d.add(ki)
            continue
        used2d.add(ki)
        used3d.add(new_id)
        pairs.append([ki, new_id])
    if not pairs:
        return 0, np.zeros((2, 0), np.int64)
    return len(pairs), np.asarray(pairs, np.int64).T


# ---------------------------------------------------------------------------
# Artifact writers
# ---------------------------------------------------------------------------

def save_anno(out_dir: str, result: dict, img_lists: Sequence[str],
              features: Dict[str, dict], points_idxs: Dict[int, np.ndarray],
              detection: str = "superpoint"):
    """Write anno_3d_average.npz, anno_3d_collect.npz, idxs.npy,
    per-image anno jsons, and the per-object anno_2d.json index."""
    os.makedirs(out_dir, exist_ok=True)
    xyzs = result["xyzs"]

    np.savez(
        osp.join(out_dir, "anno_3d_average.npz"),
        keypoints3d=xyzs,
        descriptors3d=result["avg_descriptors"].T,
        scores3d=result["avg_scores"])
    np.savez(
        osp.join(out_dir, "anno_3d_collect.npz"),
        keypoints3d=xyzs,
        descriptors3d=result["collect_descriptors"].T,
        scores3d=result["collect_scores"])
    np.save(osp.join(out_dir, "idxs.npy"), result["idxs"])

    old_to_new: Dict[int, int] = {}
    for new_id, old_ids in points_idxs.items():
        for old in old_ids:
            old_to_new[int(old)] = new_id

    annotations = []
    anno_id = 0
    for img_path in img_lists:
        corr = result["per_image_corr"].get(img_path, [])
        num_matches, assign = build_assign_matrix(
            corr, old_to_new, len(xyzs))
        if num_matches == 0:
            continue
        feat = features[img_path]
        data_dir = osp.dirname(osp.dirname(img_path))
        anno_dir = osp.join(data_dir, f"anno_{detection}")
        os.makedirs(anno_dir, exist_ok=True)
        img_name = osp.basename(img_path)
        anno_2d_path = osp.join(
            anno_dir, img_name.replace(".png", ".json"))
        # json.dumps takes the C encoder (json.dump encodes in Python):
        # the same text, several times faster at 4096 keypoints an image
        with open(anno_2d_path, "w") as f:
            f.write(json.dumps({
                "keypoints2d": np.asarray(
                    feat["keypoints"]).tolist(),
                "descriptors2d": np.asarray(
                    feat["descriptors"]).tolist(),
                "scores2d": np.asarray(
                    feat["scores"]).reshape(-1, 1).tolist(),
                "assign_matrix": assign.tolist(),
                "num_matches": num_matches,
            }))
        anno_id += 1
        annotations.append({
            "anno_id": anno_id,
            "anno_file": anno_2d_path,
            "img_file": img_path,
            "pose_file": path_utils.get_gt_pose_path_by_color(img_path),
        })
    with open(osp.join(out_dir, "anno_2d.json"), "w") as f:
        json.dump(annotations, f)
    return annotations


# ---------------------------------------------------------------------------
# Orchestration
# ---------------------------------------------------------------------------

def postprocess(model_dir: str, feature_path: str,
                img_lists: Sequence[str], anno_out_dir: str,
                box_path: Optional[str] = None,
                max_num_points: int = 2500,
                detection: str = "superpoint") -> dict:
    """Full postprocess: read the triangulated model, filter/merge points,
    aggregate descriptors, save annotation artifacts."""
    from onepose_tpu_torch.utils import hdf5

    cameras, images, points3D = colmap_io.read_model(model_dir)

    tkl = select_track_length(points3D, max_num_points)
    write_tkl_ply(points3D, tkl, osp.dirname(anno_out_dir) or ".")
    xyzs, point_ids = filter_by_track_length(points3D, tkl)
    if box_path is not None:
        corners = np.loadtxt(box_path)
        xyzs, point_ids = filter_by_3d_box(xyzs, point_ids, corners)
    merged_xyzs, points_idxs = merge_points(xyzs, point_ids)

    features: Dict[str, dict] = {}
    with hdf5.File(feature_path, "r") as ff:
        for name in img_lists:
            g = ff[name]
            features[name] = {
                "keypoints": g["keypoints"][()],
                "descriptors": g["descriptors"][()],
                "scores": g["scores"][()],
            }

    result = aggregate_features(
        img_lists, features, images, merged_xyzs, points_idxs)
    save_anno(anno_out_dir, result, img_lists, features, points_idxs,
              detection)
    return {
        "track_length": tkl,
        "num_points": len(merged_xyzs),
        "num_observations": int(result["idxs"].sum()),
    }
