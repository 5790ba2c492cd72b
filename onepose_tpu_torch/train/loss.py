"""Focal loss on the dual-softmax confidence matrix.

Port of ``onepose_tpu/train/loss.py``: focal BCE with separate means over
the ground-truth matches and non-matches, by masked reductions, and a term
dropped when its set is empty.
"""
from __future__ import annotations

from typing import Optional

import torch


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
    conf_pred = torch.clamp(conf_pred.float(), eps, 1.0 - eps)
    pos_mask = conf_gt == 1
    neg_mask = conf_gt == 0
    if valid_mask is not None:
        pos_mask = pos_mask & valid_mask
        neg_mask = neg_mask & valid_mask

    loss_pos = -alpha * (1.0 - conf_pred) ** gamma * torch.log(conf_pred)
    loss_neg = -(1.0 - alpha) * conf_pred ** gamma * torch.log1p(-conf_pred)

    n_pos = pos_mask.sum()
    n_neg = neg_mask.sum()
    pos_mean = torch.where(pos_mask, loss_pos, 0.0).sum() / n_pos.clamp(min=1)
    neg_mean = torch.where(neg_mask, loss_neg, 0.0).sum() / n_neg.clamp(min=1)
    # a term whose set is empty is dropped rather than made NaN
    pos_term = torch.where(n_pos > 0, pos_weight * pos_mean, 0.0)
    neg_term = torch.where(n_neg > 0, neg_weight * neg_mean, 0.0)
    return pos_term + neg_term
