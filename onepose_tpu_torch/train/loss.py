"""Focal loss on the dual-softmax confidence matrix.

Port of ``onepose_tpu/train/loss.py``: focal BCE with separate means over
the ground-truth matches and non-matches, by masked reductions, and a term
dropped when its set is empty. The means are split into sums and counts
(:func:`focal_sums`, :func:`focal_combine`) so that a data-parallel step
can divide by the counts of the whole batch.
"""
from __future__ import annotations

from typing import Optional

import torch


def focal_sums(conf_pred: torch.Tensor, conf_gt: torch.Tensor,
               alpha: float = 0.5, gamma: float = 2.0,
               valid_mask: Optional[torch.Tensor] = None,
               eps: float = 1e-12):
    """(sum of the positive terms, sum of the negative terms, number of
    GT matches, number of GT non-matches) of :func:`focal_loss`: what a
    data-parallel step reduces across ranks before it divides."""
    conf_pred = torch.clamp(conf_pred.float(), eps, 1.0 - eps)
    pos_mask = conf_gt == 1
    neg_mask = conf_gt == 0
    if valid_mask is not None:
        pos_mask = pos_mask & valid_mask
        neg_mask = neg_mask & valid_mask

    loss_pos = -alpha * (1.0 - conf_pred) ** gamma * torch.log(conf_pred)
    loss_neg = -(1.0 - alpha) * conf_pred ** gamma * torch.log1p(-conf_pred)
    return (torch.where(pos_mask, loss_pos, 0.0).sum(),
            torch.where(neg_mask, loss_neg, 0.0).sum(),
            pos_mask.sum(), neg_mask.sum())


def focal_combine(pos_sum: torch.Tensor, neg_sum: torch.Tensor,
                  n_pos: torch.Tensor, n_neg: torch.Tensor,
                  pos_weight: float = 0.5,
                  neg_weight: float = 0.5) -> torch.Tensor:
    """pos_weight * pos_sum / n_pos + neg_weight * neg_sum / n_neg, a term
    dropped when its count is 0. With one rank's sums and the whole
    batch's counts this is that rank's share of the batch's loss."""
    pos_mean = pos_sum / n_pos.clamp(min=1)
    neg_mean = neg_sum / n_neg.clamp(min=1)
    # a term whose set is empty is dropped rather than made NaN
    pos_term = torch.where(n_pos > 0, pos_weight * pos_mean, 0.0)
    neg_term = torch.where(n_neg > 0, neg_weight * neg_mean, 0.0)
    return pos_term + neg_term


def focal_loss(conf_pred: torch.Tensor, conf_gt: torch.Tensor,
               alpha: float = 0.5, gamma: float = 2.0,
               pos_weight: float = 0.5, neg_weight: float = 0.5,
               valid_mask: Optional[torch.Tensor] = None,
               eps: float = 1e-12) -> torch.Tensor:
    """conf_pred: [..., N1, N2] in (0, 1); conf_gt: same shape, {0, 1}.

    Positive term: -alpha * (1-p)^gamma * log(p) averaged over GT matches;
    negative term: -(1-alpha) * p^gamma * log(1-p) averaged over GT
    non-matches; total = pos_weight * pos_mean + neg_weight * neg_mean.
    The clip to [eps, 1 - eps] is in fp32, where 1 - 1e-12 is 1.0, as in
    the JAX package."""
    return focal_combine(*focal_sums(conf_pred, conf_gt, alpha, gamma,
                                     valid_mask, eps), pos_weight, neg_weight)
