"""3D descriptor-database loading for the port: the
``anno_3d_average.npz`` / ``anno_3d_collect.npz`` / ``idxs.npy`` triple
that the SfM postprocess writes.

The port's own copy of ``onepose_tpu/datasets/anno.py`` (the parts the
pipeline and inference call), numpy only. Each 3D point gets exactly
``num_leaf`` of its observed 2D descriptors: sampled without replacement
when it has more, padded with the all-ones "dustbin" descriptor and a zero
score when it has fewer, from a seeded RNG, so both packages build the
same DB from the same files.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class ObjectDB:
    """Static-shape 3D descriptor database for one object.

    All arrays are padded to ``shape3d`` points; ``mask3d`` marks real ones.
    Descriptor layout is [N, D] (tokens first), matching the model contract.
    """

    keypoints3d: np.ndarray       # [shape3d, 3] float32
    descriptors3d: np.ndarray     # [shape3d, D] float32 (averaged)
    scores3d: np.ndarray          # [shape3d] float32
    descriptors2d_db: np.ndarray  # [shape3d * num_leaf, D] float32 (leaves)
    scores2d_db: np.ndarray       # [shape3d * num_leaf] float32
    mask3d: np.ndarray            # [shape3d] bool
    num_leaf: int
    num_points: int               # real (unpadded) point count


def sample_leaf_indices(idxs: np.ndarray, num_leaf: int,
                        rng: np.random.Generator) -> np.ndarray:
    """Per-point observation indices [num_points, num_leaf] into the
    stacked observation axis, with ``total`` (one past the end) as the
    dustbin sentinel for points with fewer than ``num_leaf`` observations.

    Sampling without replacement by segment-random ranking: every
    observation gets a random key and is ranked within its point's segment
    (a stable lexsort on (point, key) keeps segments contiguous); ranks
    below ``num_leaf`` are kept, then each point's slots are shuffled.
    """
    idxs = np.asarray(idxs, np.int64)
    num_points = idxs.shape[0]
    upper = np.cumsum(idxs)
    lower = upper - idxs
    total = int(upper[-1]) if num_points else 0

    point_id = np.repeat(np.arange(num_points), idxs)       # [total]
    order = np.lexsort((rng.random(total), point_id))       # [total]
    seg_rank = np.arange(total) - lower[point_id]           # [total]
    chosen = seg_rank < num_leaf
    pick = np.full((num_points, num_leaf), total, np.int64)
    pick[point_id[chosen], seg_rank[chosen]] = order[chosen]
    slot_perm = np.argsort(rng.random((num_points, num_leaf)), axis=1)
    return np.take_along_axis(pick, slot_perm, axis=1)


def build_leaves(descriptors: np.ndarray, scores: np.ndarray,
                 idxs: np.ndarray, num_leaf: int,
                 rng: Optional[np.random.Generator] = None):
    """Sample ``num_leaf`` observed 2D descriptors per 3D point.

    descriptors: [D, total_obs] stacked per-point observations (the collect
    layout); scores: [total_obs, 1]; idxs: [num_points] observation counts.
    Returns (leaf_desc [num_points*num_leaf, D], leaf_scores
    [num_points*num_leaf]).
    """
    if rng is None:
        rng = np.random.default_rng(12345)
    descriptors = np.asarray(descriptors, np.float32)
    scores = np.asarray(scores, np.float32).reshape(-1)
    dim = descriptors.shape[0]

    pick = sample_leaf_indices(idxs, num_leaf, rng)

    desc_aug = np.concatenate(
        [descriptors, np.ones((dim, 1), np.float32)], axis=1)
    score_aug = np.concatenate([scores, np.zeros(1, np.float32)])
    flat = pick.reshape(-1)
    return np.take(desc_aug, flat, axis=1).T, score_aug[flat]


def load_object_db(avg_path: str, collect_path: str, idxs_path: str,
                   num_leaf: int = 8, shape3d: Optional[int] = None,
                   seed: int = 12345) -> ObjectDB:
    """Load one object's annotation triple into a static-shape DB.

    shape3d=None keeps the natural point count, rounded up to a multiple
    of 8.
    """
    avg = np.load(avg_path)
    clt = np.load(collect_path)
    idxs = np.load(idxs_path)
    return build_object_db(
        avg_keypoints3d=clt["keypoints3d"],
        avg_descriptors3d=avg["descriptors3d"],
        avg_scores3d=avg["scores3d"],
        clt_descriptors=clt["descriptors3d"],
        clt_scores=clt["scores3d"],
        idxs=idxs, num_leaf=num_leaf, shape3d=shape3d, seed=seed,
    )


def build_object_db(avg_keypoints3d, avg_descriptors3d, avg_scores3d,
                    clt_descriptors, clt_scores, idxs, num_leaf: int = 8,
                    shape3d: Optional[int] = None,
                    seed: int = 12345) -> ObjectDB:
    """An :class:`ObjectDB` from in-memory arrays: points [P, 3],
    averaged descriptors [D, P] and scores [P, 1], the collected
    observations [D, total] and scores [total, 1], and the per-point
    observation counts ``idxs`` [P]. Padding rows are dustbins (all-ones
    descriptors, zero scores)."""
    kpts3d = np.asarray(avg_keypoints3d, np.float32)      # [P, 3]
    desc3d = np.asarray(avg_descriptors3d, np.float32)    # [D, P]
    scores3d = np.asarray(avg_scores3d, np.float32).reshape(-1)
    num_points = kpts3d.shape[0]
    dim = desc3d.shape[0]

    rng = np.random.default_rng(seed)
    leaf_desc, leaf_scores = build_leaves(
        clt_descriptors, clt_scores, idxs, num_leaf, rng)

    if shape3d is None:
        shape3d = ((num_points + 7) // 8) * 8
    if num_points > shape3d:
        raise ValueError(
            f"object has {num_points} points > shape3d={shape3d}")
    n_pad = shape3d - num_points

    kpts3d = np.concatenate(
        [kpts3d, np.zeros((n_pad, 3), np.float32)], axis=0)
    desc3d_t = np.concatenate(
        [desc3d.T, np.ones((n_pad, dim), np.float32)], axis=0)
    scores3d = np.concatenate([scores3d, np.zeros(n_pad, np.float32)])
    leaf_desc = np.concatenate(
        [leaf_desc, np.ones((n_pad * num_leaf, dim), np.float32)], axis=0)
    leaf_scores = np.concatenate(
        [leaf_scores, np.zeros(n_pad * num_leaf, np.float32)])
    mask = np.zeros(shape3d, bool)
    mask[:num_points] = True

    return ObjectDB(
        keypoints3d=kpts3d, descriptors3d=desc3d_t, scores3d=scores3d,
        descriptors2d_db=leaf_desc, scores2d_db=leaf_scores, mask3d=mask,
        num_leaf=num_leaf, num_points=num_points,
    )
