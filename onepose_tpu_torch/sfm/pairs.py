"""Covisible pair selection from known camera poses, for the port's SfM.

The port's own copy of ``onepose_tpu/sfm/pairs.py`` (the reference's
``src/sfm/pairs_from_poses.py``): pairwise camera-centre distances and
relative rotation angles; per image and per sequence, the nearest
candidates among pairs with a relative rotation above 10 degrees, stride-2
subsampled. numpy on the host.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from onepose_tpu_torch.utils import path_utils


def pose_distances(Rs: np.ndarray, ts: np.ndarray):
    """Rs: [n,3,3] world→camera rotations; ts: [n,3] translations.
    Returns (center distances [n,n], relative rotation angles deg [n,n]).

    The arithmetic mirrors the reference bit-for-bit (scipy pdist on camera
    centers C = -R^T t, trace-based angles): the argpartition-based pair
    subsample is sensitive to last-ulp distance differences, and identical
    inputs are required for identical pair sets."""
    from scipy.spatial import distance as _distance

    Rs_t = Rs.transpose(0, 2, 1)                       # [n, 3, 3]
    centers = -(Rs_t @ ts[:, :, None])[:, :, 0]        # [n, 3]
    dist = _distance.squareform(_distance.pdist(centers))
    trace = np.einsum("nji,mji->mn", Rs_t, Rs_t, optimize=True)
    dR = np.clip((trace - 1.0) / 2.0, -1.0, 1.0)
    dR = np.rad2deg(np.abs(np.arccos(dR)))
    return dist, dR


def load_poses(pose_files: Sequence[str]):
    Rs, ts = [], []
    for pf in pose_files:
        pose = np.loadtxt(pf)
        Rs.append(pose[:3, :3])
        ts.append(pose[:3, 3])
    return np.stack(Rs), np.stack(ts)


def covis_pairs(img_lists: Sequence[str], num_matched: int = 10,
                min_rotation: float = 10.0,
                poses: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                seq_of: Optional[Sequence[str]] = None) -> List[Tuple[str, str]]:
    """Select covisible (query, reference) image pairs.

    poses: optional ([n,3,3], [n,3]) overriding file loading; seq_of:
    optional per-image sequence tags (defaults to the /<seq>/color/ path
    component, matching the reference's split on path segments).
    """
    if poses is None:
        pose_files = [path_utils.get_gt_pose_path_by_color(p)
                      for p in img_lists]
        Rs, ts = load_poses(pose_files)
    else:
        Rs, ts = poses
    if seq_of is None:
        seq_of = [p.split("/")[-3] for p in img_lists]

    seq_ids: Dict[str, List[int]] = {}
    for i, s in enumerate(seq_of):
        seq_ids.setdefault(s, []).append(i)

    dist, dR = pose_distances(Rs, ts)
    valid = dR > min_rotation
    np.fill_diagonal(valid, False)
    dist = np.where(valid, dist, np.inf)

    pairs: List[Tuple[str, str]] = []
    num_per_seq = max(num_matched // len(seq_ids), 1)
    n = len(img_lists)
    for i in range(n):
        dist_i = dist[i]
        for s, ids_list in seq_ids.items():
            ids = np.asarray(ids_list)
            if num_per_seq * 2 < len(ids):
                # nearest 2k candidates, stride-2 subsample of the
                # partitioned order (reference :56)
                part = np.argpartition(
                    dist_i[ids], num_per_seq * 2)[:num_per_seq:2]
            else:
                # reference fallback for short sequences (its argpartition
                # raises and the except branch keeps every candidate, :57-58)
                part = np.arange(len(ids))
            idx = ids[part]
            idx = idx[np.argsort(dist_i[idx])]
            idx = idx[valid[i][idx]]
            for j in idx:
                pairs.append((img_lists[i], img_lists[int(j)]))
    return pairs


def write_pairs(pairs: Sequence[Tuple[str, str]], out_path: str):
    with open(out_path, "w") as f:
        f.write("\n".join(" ".join(p) for p in pairs))


def read_pairs(path: str) -> List[Tuple[str, str]]:
    with open(path, "r") as f:
        return [tuple(line.split(" ")) for line in f.read().split("\n")
                if line]
