"""Training and validation callbacks: model watching, classification
heatmaps, and freezing part of the model for its first steps.

The port's copy of ``onepose_tpu/train/callbacks.py`` (the reference's
optional wandb callbacks, ``src/callbacks/wandb_callbacks.py``, and its
``UnfreezeModelCallback``). The model watch logs per-module parameter and
gradient norms; the heatmap callbacks accumulate (pred, target) labels
across validation batches and emit f1 / precision / recall and a
confusion matrix as logger scalars, a PNG heatmap, and a wandb HeatMap
when wandb is importable.
"""
from __future__ import annotations

import os
import os.path as osp
from typing import Callable, Collection, Dict, List, Mapping, Optional, \
    Sequence, Union

import numpy as np
import torch
from torch import nn


def _named(tree) -> Mapping[str, torch.Tensor]:
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    return tree


def param_norms(tree, prefix: str = "params") -> Dict[str, float]:
    """L2 norm of each top-level module's tensors: ``tree`` is a module, or
    a mapping of dotted names to tensors (gradients, say), grouped by the
    name's first part. The WatchModelWithWandb equivalent (wandb.watch logs
    histograms per module; norms are the scalar-logger analogue)."""
    sq: Dict[str, float] = {}
    for name, x in _named(tree).items():
        if x is None:
            continue
        top = name.split(".", 1)[0]
        sq[top] = sq.get(top, 0.0) + float(
            torch.sum(x.detach().float() ** 2))
    return {f"{prefix}_norm/{k}": float(np.sqrt(v)) for k, v in sq.items()}


class ModelWatcher:
    """Log per-module parameter (and optional gradient) norms every
    ``log_freq`` steps. Role of WatchModelWithWandb
    (wandb_callbacks.py:67-82)."""

    def __init__(self, logger, log_freq: int = 100):
        self.logger = logger
        self.log_freq = max(int(log_freq), 1)

    def step(self, step: int, params, grads=None):
        if step % self.log_freq != 0:
            return
        metrics = param_norms(params, "params")
        if grads is not None:
            metrics.update(param_norms(grads, "grads"))
        if self.logger is not None:
            self.logger.log(step, metrics)
        return metrics


class ClassificationHeatmaps:
    """Accumulate predicted/target class labels over validation batches,
    then emit f1 / precision / recall per class and the confusion matrix.

    Roles of LogF1PrecisionRecallHeatmapToWandb (wandb_callbacks.py:85-137)
    and LogConfusionMatrixToWandb (:140-186) in one accumulator (both
    reference callbacks gather the same (preds, targets) stream).
    """

    def __init__(self, class_names: Sequence[str]):
        self.class_names = list(class_names)
        self.preds: List[np.ndarray] = []
        self.targets: List[np.ndarray] = []

    def update(self, preds, targets):
        preds = np.asarray(preds).reshape(-1)
        targets = np.asarray(targets).reshape(-1)
        if preds.shape != targets.shape:
            raise ValueError(f"preds {preds.shape} != targets "
                             f"{targets.shape}")
        self.preds.append(preds.astype(np.int64))
        self.targets.append(targets.astype(np.int64))

    def confusion_matrix(self) -> np.ndarray:
        """[C, C] counts; rows = target class, cols = predicted class."""
        c = len(self.class_names)
        cm = np.zeros((c, c), np.int64)
        if self.preds:
            p = np.concatenate(self.preds)
            t = np.concatenate(self.targets)
            np.add.at(cm, (t, p), 1)
        return cm

    def scores(self) -> Dict[str, np.ndarray]:
        """Per-class f1/precision/recall from the confusion matrix
        (average=None semantics of the reference's sklearn calls)."""
        cm = self.confusion_matrix()
        tp = np.diag(cm).astype(np.float64)
        pred_tot = cm.sum(axis=0).astype(np.float64)
        targ_tot = cm.sum(axis=1).astype(np.float64)
        precision = np.divide(tp, pred_tot, out=np.zeros_like(tp),
                              where=pred_tot > 0)
        recall = np.divide(tp, targ_tot, out=np.zeros_like(tp),
                           where=targ_tot > 0)
        denom = precision + recall
        f1 = np.divide(2 * precision * recall, denom,
                       out=np.zeros_like(tp), where=denom > 0)
        return {"f1": f1, "precision": precision, "recall": recall,
                "confusion": cm}

    def emit(self, logger=None, step: int = 0, epoch: int = 0,
             plot_dir: Optional[str] = None) -> Dict[str, float]:
        """Compute, log scalars, save the heatmap PNG, mirror to wandb.
        Returns the flat scalar metrics. Resets the accumulators (the
        reference callbacks clear state at validation_epoch_end)."""
        s = self.scores()
        flat: Dict[str, float] = {}
        for metric in ("f1", "precision", "recall"):
            for ci, name in enumerate(self.class_names):
                flat[f"val_{metric}/{name}"] = float(s[metric][ci])
        if logger is not None:
            logger.log(step, flat)
            wandb_run = getattr(getattr(logger, "wandb", None), "run", None)
            if wandb_run is not None:
                import wandb

                wandb_run.log({
                    f"f1_p_r_heatmap/{epoch}": wandb.plots.HeatMap(
                        x_labels=self.class_names,
                        y_labels=["f1", "precision", "recall"],
                        matrix_values=[s["f1"].tolist(),
                                       s["precision"].tolist(),
                                       s["recall"].tolist()],
                        show_text=True),
                    f"confusion_matrix/{epoch}": wandb.plot.confusion_matrix(
                        preds=np.concatenate(self.preds).tolist(),
                        y_true=np.concatenate(self.targets).tolist(),
                        class_names=self.class_names),
                }, commit=False)
        if plot_dir is not None:
            self._save_png(s, epoch, plot_dir)
        self.preds, self.targets = [], []
        return flat

    def _save_png(self, s, epoch: int, plot_dir: str):
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        os.makedirs(plot_dir, exist_ok=True)
        fig, axes = plt.subplots(1, 2, figsize=(11, 4))
        m = np.stack([s["f1"], s["precision"], s["recall"]])
        im0 = axes[0].imshow(m, vmin=0, vmax=1, cmap="viridis")
        axes[0].set_yticks(range(3), ["f1", "precision", "recall"])
        axes[0].set_xticks(range(len(self.class_names)), self.class_names,
                           rotation=45, ha="right")
        for (i, j), v in np.ndenumerate(m):
            axes[0].text(j, i, f"{v:.2f}", ha="center", va="center",
                         color="w", fontsize=8)
        fig.colorbar(im0, ax=axes[0])
        axes[0].set_title("f1 / precision / recall")
        cm = s["confusion"]
        im1 = axes[1].imshow(cm, cmap="viridis")
        axes[1].set_xticks(range(len(self.class_names)), self.class_names,
                           rotation=45, ha="right")
        axes[1].set_yticks(range(len(self.class_names)), self.class_names)
        for (i, j), v in np.ndenumerate(cm):
            axes[1].text(j, i, str(v), ha="center", va="center",
                         color="w", fontsize=8)
        fig.colorbar(im1, ax=axes[1])
        axes[1].set_title("confusion (rows=target)")
        fig.tight_layout()
        fig.savefig(osp.join(plot_dir, f"heatmaps_epoch{epoch}.png"),
                    dpi=110)
        plt.close(fig)


def match_classification_labels(matches0, kpt_mask, kpts2d, gt_proj,
                                valid3d, thresh_px: float = 5.0):
    """Map the matcher's per-keypoint predictions to 3-class labels for the
    heatmap callbacks, using GT-pose reprojection as ground truth (live
    SuperPoint keypoints carry no index-level GT assignment):

    - pred:   0 = unmatched, 1 = matched and the matched 3D point
              reprojects within ``thresh_px`` of the keypoint, 2 = matched
              but reprojects farther (wrong match);
    - target: 1 if ANY valid 3D point reprojects within ``thresh_px``
              (the keypoint is matchable), else 0.

    matches0/kpt_mask: [K]; kpts2d: [K, 2]; gt_proj: [P, 2] DB points
    reprojected by the GT pose; valid3d: [P]. Returns (preds, targets)
    over valid keypoints only.
    """
    matches0 = np.asarray(matches0)
    kpt_mask = np.asarray(kpt_mask).astype(bool)
    kpts2d = np.asarray(kpts2d, np.float64)
    gt_proj = np.asarray(gt_proj, np.float64)
    valid3d = np.asarray(valid3d).astype(bool)

    d_all = np.linalg.norm(
        kpts2d[:, None, :] - gt_proj[None, :, :], axis=-1)  # [K, P]
    d_all[:, ~valid3d] = np.inf
    targ = (d_all.min(axis=1) < thresh_px).astype(np.int64)

    m_clip = np.clip(matches0, 0, len(gt_proj) - 1)
    d_match = np.linalg.norm(kpts2d - gt_proj[m_clip], axis=-1)
    pred = np.where(matches0 < 0, 0,
                    np.where(d_match < thresh_px, 1, 2)).astype(np.int64)
    return pred[kpt_mask], targ[kpt_mask]


MATCH_CLASS_NAMES = ("unmatched", "match_correct", "match_wrong")


class UnfreezeAfter:
    """Zero the gradients of the frozen parameters for the first
    ``wait_steps`` calls (see :func:`unfreeze_after`)."""

    def __init__(self, wait_steps: int,
                 frozen: Union[Callable[[str], bool], Collection[str]]):
        self.wait_steps = int(wait_steps)
        if callable(frozen):
            self.is_frozen = frozen
        else:
            prefixes = tuple(frozen)
            self.is_frozen = lambda name: any(
                name == p or name.startswith(p + ".") for p in prefixes)
        self.count = 0

    def __call__(self, names: Sequence[str],
                 grads: List[torch.Tensor]) -> List[torch.Tensor]:
        live = self.count >= self.wait_steps
        self.count += 1
        if live:
            return grads
        return [torch.zeros_like(g) if self.is_frozen(n) else g
                for n, g in zip(names, grads)]

    def state_dict(self) -> dict:
        return {"count": self.count}

    def load_state_dict(self, sd: dict) -> None:
        self.count = sd["count"]


def unfreeze_after(wait_steps: int,
                   frozen: Union[Callable[[str], bool], Collection[str]]
                   ) -> UnfreezeAfter:
    """Freeze part of the model for the first ``wait_steps`` micro-steps.

    Role of the reference's UnfreezeModelCallback
    (``src/callbacks/custom_callbacks.py:18-29``, which flips
    ``requires_grad`` after ``wait_epochs``). Pass it to the optimizer:

        tx = trainer.make_optimizer(..., grad_transforms=[
            callbacks.unfreeze_after(5 * steps_per_epoch, ["gnn"])])

    It zeroes the frozen parameters' gradients before the accumulation,
    clipping and Adam, so Adam's moments stay zero while they are frozen,
    as ``requires_grad=False`` leaves them. Its count advances on every
    micro-step, as the JAX package's ``unfreeze_after`` chained outside
    ``optax.MultiSteps`` does (callers convert epochs → micro-steps).

    ``frozen``: a predicate on parameter names, or the dotted name
    prefixes of the modules to freeze (``"gnn"``, ``"gnn.0"``,
    ``"final_proj.weight"``), the counterpart of the JAX package's
    pytree-prefix mask."""
    return UnfreezeAfter(wait_steps, frozen)
