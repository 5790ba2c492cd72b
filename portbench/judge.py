"""The comparisons that decide ``correct``: what the timed path produced,
against the plain reference of ``portbench/reference/``.

Each stage is judged on the inputs the program itself gave it: extraction
on the frames, matching on the program's own keypoints and descriptors,
the pose or box fit on the program's own matches and the same injected
RANSAC noise. So a slot that rounding moves in one stage does not count
again in the next, and every number is the gap of one stage.

Every function returns plain floats, the largest over what it was given,
or a pooled share; :func:`merge` folds the readings of several batches.
"""
from __future__ import annotations

import torch

from portbench.reference import superpoint as ref_sp


def _codes(kpts: torch.Tensor, mask: torch.Tensor, width: int):
    """Integer pixel codes y·width + x of the valid keypoints, -1 else."""
    k = kpts.round().long()
    return torch.where(mask, k[..., 1] * width + k[..., 0], -1)


def features(prog, ref_scores, ref_desc, ref_feats, threshold) -> dict:
    """Extraction. ``prog`` has keypoints, scores, descriptors, mask of
    B frames; ``ref_scores`` [B, H, W] and ``ref_desc`` [B, Hc, Wc, D] are
    the reference's dense maps of the same frames, ``ref_feats`` its
    selection.

    - kpt_moved: valid program keypoints at a pixel the reference did not
      select, over the reference's valid keypoints (pooled);
    - score_err: largest |score − the reference's score at that pixel|
      over max(that score, the keypoint threshold);
    - desc_err: largest entry of |descriptor − the reference's descriptor
      sampled at that pixel|."""
    b, h, w = ref_scores.shape
    mask = prog.mask
    pc = _codes(prog.keypoints, mask, w)
    rc = _codes(ref_feats.keypoints, ref_feats.mask, w)
    moved = 0
    for i in range(b):
        got = pc[i][mask[i]]
        moved += int((~torch.isin(got, rc[i][ref_feats.mask[i]])).sum())
    xy = prog.keypoints.round().long()
    bi = torch.arange(b, device=xy.device)[:, None]
    s_ref = ref_scores[bi, xy[..., 1].clamp(0, h - 1), xy[..., 0].clamp(
        0, w - 1)]
    s_err = (prog.scores - s_ref).abs() / s_ref.clamp(min=threshold)
    d_ref = ref_sp.sample_descriptors(ref_desc, prog.keypoints.float())
    d_err = (prog.descriptors - d_ref).abs().amax(-1)
    zero = prog.scores.new_zeros(())
    return {"kpt_moved": (moved, int(ref_feats.mask.sum())),
            "score_err": float(torch.where(mask, s_err, zero).max()),
            "desc_err": float(torch.where(mask, d_err, zero).max())}


def gats_matches(prog_m0, prog_ms0, ref) -> dict:
    """GATsSPG matching. ``prog_m0`` / ``prog_ms0`` are the program's
    matches0 and matching_scores0, ``ref`` the reference's on the same
    descriptors.

    - match_moved: rows whose match differs, over rows matched on either
      side (pooled);
    - mscore_err: largest relative gap of the matching score over rows
      that both sides find mutual."""
    diff = int((prog_m0 != ref.matches0).sum())
    either = int(((prog_m0 >= 0) | (ref.matches0 >= 0)).sum())
    both = (prog_ms0 > 0) & (ref.matching_scores0 > 0)
    rel = (prog_ms0 - ref.matching_scores0).abs() / ref.matching_scores0.clamp(
        min=1e-30)
    return {"match_moved": (diff, either),
            "mscore_err": float(torch.where(both, rel, 0.0).max())}


def poses(prog_pose, prog_inliers, ref_pose, ref_inliers) -> dict:
    """PnP: the largest entry of |[R | t] − the reference's| (t in
    metres) and the largest difference of inlier counts."""
    return {"pose_err": float((prog_pose - ref_pose).abs().max()),
            "inlier_diff": float((prog_inliers.long()
                                  - ref_inliers.long()).abs().max())}


def log_assignment(prog_Z, ref_Z) -> dict:
    """SuperGlue: the largest |Z − Z_ref| over entries that no mask sends
    to -1e9, over the reference's largest such magnitude."""
    live = ref_Z.abs() < 1e6
    d = (prog_Z - ref_Z).abs()[live].max()
    return {"z_err": float(d / ref_Z.abs()[live].max())}


def boxes(prog_corners, prog_inliers, ref_corners, ref_inliers) -> dict:
    """The detector's box: the largest distance in pixels between the
    best view's warped corners on both sides, and the inlier counts'
    difference."""
    return {"box_err": float((prog_corners - ref_corners).abs().max()),
            "inlier_diff": float(abs(int(prog_inliers) - int(ref_inliers)))}


def merge(readings: list) -> dict:
    """Fold per-batch readings: (count, total) pairs are pooled into a
    share, names ending in ``_min`` keep their least, others their
    largest."""
    out = {}
    for r in readings:
        for k, v in r.items():
            if isinstance(v, tuple):
                a, b = out.get(k, (0, 0))
                out[k] = (a + v[0], b + v[1])
            elif k.endswith("_min"):
                out[k] = min(out.get(k, v), v)
            else:
                out[k] = max(out.get(k, 0.0), v)
    return {k: (v[0] / max(v[1], 1) if isinstance(v, tuple) else v)
            for k, v in out.items()}


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): correct when every number
    the limits name was read and lies at or under its limit."""
    table = {k: {"value": numbers.get(k), "limit": lim}
             for k, lim in limits.items()}
    ok = all(v["value"] is not None and v["value"] <= v["limit"]
             for v in table.values())
    return ok, table
