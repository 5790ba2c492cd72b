"""RANSAC estimation of 2D similarity transforms (uniform scale, rotation,
translation), batched over views, on tensors.

Port of ``onepose_tpu/ops/similarity.py::ransac_similarity``, which the
JAX detector ``vmap``s over its reference views; here the views are the
leading dimension V. Static shapes: correspondences come as fixed-size
arrays with a validity mask, hypotheses are 2-point minimal solves
evaluated all at once, and the winner is refit on its inliers by a
weighted closed-form (Umeyama) solve, four IRLS rounds with a guard
against an inlier set collapsing below two.

Parameterization: x' = A x + t with A = [[a, -b], [b, a]].

Hypothesis sampling is a top-2 over uniform noise [V, H, N] among valid
slots, ties to the lower index (as ``jax.lax.top_k``). The noise is
injectable so that tests can feed JAX's draws; otherwise it is drawn from
a ``torch.Generator``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class SimilarityResult(NamedTuple):
    A: torch.Tensor            # [V, 2, 2] rotation-scale
    t: torch.Tensor            # [V, 2]
    inliers: torch.Tensor      # [V, N] bool
    num_inliers: torch.Tensor  # [V] int32
    success: torch.Tensor      # [V] bool


def _similarity(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., 2, 2] matrices [[a, -b], [b, a]]."""
    return torch.stack([torch.stack([a, -b], -1), torch.stack([b, a], -1)],
                       -2)


def _solve_two_point(p: torch.Tensor, q: torch.Tensor):
    """Exact similarity from two correspondences p [..., 2, 2] → q."""
    dp = p[..., 1, :] - p[..., 0, :]
    dq = q[..., 1, :] - q[..., 0, :]
    denom = dp[..., 0] * dp[..., 0] + dp[..., 1] * dp[..., 1] + 1e-12
    # complex division (dq / dp) in real arithmetic
    a = (dq[..., 0] * dp[..., 0] + dq[..., 1] * dp[..., 1]) / denom
    b = (dq[..., 1] * dp[..., 0] - dq[..., 0] * dp[..., 1]) / denom
    A = _similarity(a, b)
    t = q[..., 0, :] - (A @ p[..., 0, :, None])[..., 0]
    return A, t


def _solve_weighted(p: torch.Tensor, q: torch.Tensor, w: torch.Tensor):
    """Weighted least-squares similarity p [V, N, 2] → q, weights [V, N]."""
    wsum = torch.sum(w, -1) + 1e-12
    pm = torch.sum(p * w[..., None], -2) / wsum[..., None]
    qm = torch.sum(q * w[..., None], -2) / wsum[..., None]
    pc = p - pm[..., None, :]
    qc = q - qm[..., None, :]
    denom = torch.sum(w * torch.sum(pc * pc, -1), -1) + 1e-12
    a = torch.sum(w * (qc[..., 0] * pc[..., 0] + qc[..., 1] * pc[..., 1]),
                  -1) / denom
    b = torch.sum(w * (qc[..., 1] * pc[..., 0] - qc[..., 0] * pc[..., 1]),
                  -1) / denom
    A = _similarity(a, b)
    t = qm - (A @ pm[..., None])[..., 0]
    return A, t


def _inliers(src, dst, mask, A, t, threshold):
    """||A src + t - dst|| < threshold among valid slots. src, dst
    [V, N, 2]; A [V, ..., 2, 2], t [V, ..., 2] → [V, ..., N]."""
    extra = A.dim() - 3
    s = src.reshape(src.shape[0], *([1] * extra), *src.shape[1:])
    d = dst.reshape(s.shape)
    resid = s @ A.transpose(-1, -2) + t[..., None, :] - d
    err = torch.sqrt(torch.sum(resid * resid, -1))
    return (err < threshold) & mask.reshape(s.shape[:-1])


def ransac_similarity(src: torch.Tensor, dst: torch.Tensor,
                      mask: torch.Tensor, threshold: float = 6.0,
                      num_hypotheses: int = 256,
                      noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> SimilarityResult:
    """src, dst [V, N, 2]; mask [V, N] bool. An inlier maps within
    ``threshold`` pixels (the reference uses 6). ``noise`` [V, H, N]
    uniform in [0, 1) replaces the draw from ``generator``."""
    src = src.to(torch.float32)
    dst = dst.to(torch.float32)
    v, n = mask.shape
    if noise is None:
        noise = torch.rand((v, num_hypotheses, n), generator=generator,
                           device=src.device)
    scored = torch.where(mask[:, None, :], noise, -1.0)
    # two distinct valid indices per hypothesis, ties to the lower index
    idx = torch.sort(scored, dim=-1, descending=True, stable=True)[1][..., :2]
    views = torch.arange(v, device=src.device)[:, None, None]
    A_h, t_h = _solve_two_point(src[views, idx], dst[views, idx])
    good = _inliers(src, dst, mask, A_h, t_h, threshold)        # [V, H, N]
    best = good.sum(-1).argmax(-1)                              # [V]
    pick = torch.arange(v, device=src.device)
    w = good[pick, best].to(torch.float32)
    # the carry starts from the winning hypothesis's own model, so the
    # guard below always falls back to a valid estimate
    A, t = A_h[pick, best], t_h[pick, best]

    # IRLS: refit on the inliers, re-select, repeat (cv2's post-RANSAC
    # refinement). If a round leaves fewer than 2 inliers, the next refit's
    # +1e-9 weights would fit all correspondences, outliers included, so
    # that view keeps its previous carry.
    for _ in range(4):
        A_new, t_new = _solve_weighted(src, dst, w + 1e-9)
        good = _inliers(src, dst, mask, A_new, t_new, threshold)
        ok = good.sum(-1) >= 2
        w = torch.where(ok[:, None], good.to(torch.float32), w)
        A = torch.where(ok[:, None, None], A_new, A)
        t = torch.where(ok[:, None], t_new, t)
    inliers = w > 0.5
    count = inliers.sum(-1)
    success = (mask.sum(-1) >= 2) & (count >= 2)
    return SimilarityResult(A, t, inliers & success[:, None],
                            torch.where(success, count, 0).to(torch.int32),
                            success)
