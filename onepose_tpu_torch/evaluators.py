"""Pose-metric evaluator for the port: 1/3/5 cm-degree recall, and the
per-sequence report, and the ADD / ADD-S metric. The port's own copy of
``onepose_tpu/evaluators.py``."""
from __future__ import annotations

import os

import numpy as np

from onepose_tpu_torch.utils.geometry import query_pose_error


class Evaluator:
    def __init__(self, thresholds=(1, 3, 5)):
        self.thresholds = thresholds
        self.reset()

    def reset(self):
        self.records = {t: [] for t in self.thresholds}
        self.R_errs = []
        self.t_errs = []

    def evaluate(self, pose_pred, pose_gt):
        """Add one frame; ``pose_pred`` None counts as a miss."""
        if pose_pred is None:
            for t in self.thresholds:
                self.records[t].append(False)
            self.R_errs.append(np.inf)
            self.t_errs.append(np.inf)
            return
        pose_pred = np.asarray(pose_pred)[:3, :4]
        pose_gt = np.asarray(pose_gt)[:3, :4]
        r_err, t_err = query_pose_error(pose_pred, pose_gt)
        self.R_errs.append(r_err)
        self.t_errs.append(t_err)
        for t in self.thresholds:
            self.records[t].append(bool(r_err < t and t_err < t))

    def summarize(self, verbose: bool = True) -> dict:
        """{"cmd1": recall, ...} over the frames so far; then reset."""
        out = {}
        for t in self.thresholds:
            val = float(np.mean(self.records[t])) if self.records[t] else 0.0
            out[f"cmd{t}"] = val
            if verbose:
                print(f"{t} cm {t} degree metric: {val}")
        self.reset()
        return out


def add_metric(pose_pred, pose_gt, model_points, symmetric: bool = False):
    """ADD / ADD-S: the mean distance between the model points moved by the
    predicted and by the GT pose. model_points [N, 3] in the object frame
    (the SfM cloud or the box corners); ``symmetric`` takes each predicted
    point's nearest GT point instead of its own (ADD-S)."""
    pose_pred = np.asarray(pose_pred)[:3, :4]
    pose_gt = np.asarray(pose_gt)[:3, :4]
    pts = np.asarray(model_points)
    p_pred = pts @ pose_pred[:3, :3].T + pose_pred[:3, 3]
    p_gt = pts @ pose_gt[:3, :3].T + pose_gt[:3, 3]
    if symmetric:
        d = np.linalg.norm(
            p_pred[:, None, :] - p_gt[None, :, :], axis=-1).min(axis=1)
    else:
        d = np.linalg.norm(p_pred - p_gt, axis=-1)
    return float(d.mean())


def record_eval_result(out_dir: str, obj_name: str, seq_name: str,
                       eval_result: dict):
    """Write the per-sequence eval report, one ``key: value`` line each."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, obj_name + seq_name + ".txt")
    with open(path, "w") as f:
        for k, v in eval_result.items():
            f.write(f"{k}: {v}\n")
