"""Mutual nearest-neighbour descriptor matcher, on tensors.

Port of ``onepose_tpu/models/nn_matcher.py``: cosine-similarity mutual NN
with an optional Lowe ratio and an optional minimum similarity, used by the
BA tracker for keyframe↔query matching. ``torch.argmax`` returns the first
index of a tied maximum, as ``jnp.argmax`` does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class NNMatchResult(NamedTuple):
    matches0: torch.Tensor          # [N0] index into set 1, -1 invalid
    matching_scores0: torch.Tensor  # [N0] cosine similarity


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True),
                           min=1e-12)


def mutual_nearest_neighbour(desc0: torch.Tensor, desc1: torch.Tensor,
                             mask0: Optional[torch.Tensor] = None,
                             mask1: Optional[torch.Tensor] = None,
                             ratio_thresh: float = 0.0,
                             distance_thresh: float = 0.0) -> NNMatchResult:
    """desc0 [N0, D], desc1 [N1, D], normalized here. ratio_thresh: Lowe
    ratio on (1 - sim); distance_thresh: minimum cosine similarity. 0
    disables either test. Masked rows and columns take similarity -2."""
    sim = _unit_rows(desc0.float()) @ _unit_rows(desc1.float()).T
    if mask0 is not None:
        sim = torch.where(mask0[:, None], sim, -2.0)
    if mask1 is not None:
        sim = torch.where(mask1[None, :], sim, -2.0)

    best0 = sim.amax(dim=1)
    idx0 = sim.argmax(dim=1)
    idx1 = sim.argmax(dim=0)
    rows = torch.arange(sim.shape[0], device=sim.device)
    valid = rows == idx1[idx0]

    if ratio_thresh > 0:
        second = sim.scatter(1, idx0[:, None], -2.0).amax(dim=1)
        valid &= (1.0 - best0) < ratio_thresh * (1.0 - second)
    if distance_thresh > 0:
        valid &= best0 > distance_thresh

    return NNMatchResult(torch.where(valid, idx0, -1),
                         torch.where(valid, best0, 0.0))
