"""Pyramidal Lucas–Kanade sparse optical flow, on tensors.

Port of ``onepose_tpu/ops/lk_flow.py`` (the tracker's replacement for
``cv2.calcOpticalFlowPyrLK``: window 15, 3 levels, 10 iterations, eps
0.03). Each point crops one margin patch per pyramid level, and every LK
iteration samples its window by a sub-pixel shift inside that patch, so
the iterations never touch the full image. Per-level displacement is
bounded by the patch margin; a track that ends at the patch clamp is
failed, except where the patch edge is the image edge.

Every point at once: a patch is one gather from an index grid
[N, size, size], a window one integer gather plus a 4-tap blend. The JAX
version's early-exit ``while_loop`` is a fixed loop of ``iters`` masked
updates: a point's ``done`` only ever turns true, and a done point no
longer moves, so the result is the early exit's, with no host sync per
iteration.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class FlowResult(NamedTuple):
    points: torch.Tensor   # [N, 2] tracked positions in im1
    status: torch.Tensor   # [N] bool (trackable + stayed in bounds)
    error: torch.Tensor    # [N] mean abs residual of the final window


def _downsample(im: torch.Tensor) -> torch.Tensor:
    """2x blur + decimate (average pooling)."""
    h, w = im.shape
    im = im[: h - h % 2, : w - w % 2]
    return (im[0::2, 0::2] + im[1::2, 0::2] + im[0::2, 1::2]
            + im[1::2, 1::2]) * 0.25


def _crop_patches(im: torch.Tensor, centers: torch.Tensor, size: int):
    """[N] patches of [size, size] around ``centers`` (x, y), origins
    clamped to the image. Returns (patches [N, size, size], origin [N, 2]
    as (ox, oy) float)."""
    h, w = im.shape
    half = size // 2
    ox = torch.clamp(torch.floor(centers[:, 0]).long() - half,
                     0, max(w - size, 0))
    oy = torch.clamp(torch.floor(centers[:, 1]).long() - half,
                     0, max(h - size, 0))
    ar = torch.arange(size, device=im.device)
    rows = (oy[:, None] + ar)[:, :, None]
    cols = (ox[:, None] + ar)[:, None, :]
    patches = im[rows, cols]
    return patches, torch.stack([ox, oy], dim=1).float()


def _sample_window(patches: torch.Tensor, local_xy: torch.Tensor,
                   win: int) -> torch.Tensor:
    """[N, win, win] bilinear windows around ``local_xy`` [N, 2] (x, y in
    patch coordinates): the integer part by a gather, the fraction by a
    4-tap blend. The integer position is clipped to [r, P-r-2] (min of max,
    as ``jnp.clip``) and the slice start to [0, P-win-1] (as
    ``dynamic_slice``): the patch-border clamp."""
    r = win // 2
    P = patches.shape[-1]
    fl = torch.floor(local_xy)
    frac = local_xy - fl
    start = torch.clamp(torch.clamp(fl.long(), r, P - r - 2) - r,
                        0, P - win - 1)
    ar = torch.arange(win + 1, device=patches.device)
    n = torch.arange(patches.shape[0], device=patches.device)[:, None, None]
    sub = patches[n, (start[:, 1:2] + ar)[:, :, None],
                  (start[:, 0:1] + ar)[:, None, :]]
    fx = frac[:, 0, None, None]
    fy = frac[:, 1, None, None]
    w00 = (1 - fx) * (1 - fy)
    w01 = fx * (1 - fy)
    w10 = (1 - fx) * fy
    w11 = fx * fy
    return (sub[:, :win, :win] * w00 + sub[:, :win, 1:] * w01
            + sub[:, 1:, :win] * w10 + sub[:, 1:, 1:] * w11)


def _lk_level(im0, im1, pts0, guess, win: int, iters: int, eps: float,
              min_eig: float, margin: int):
    """One pyramid level of LK for all points. pts0: positions in im0;
    guess: current flow estimates (positions in im1)."""
    size = win + 3 + 2 * margin
    size = min(size, min(im0.shape))  # tiny images: shrink the patch
    # and the window with it, so that the (win+1)² slice fits the patch
    win = max(min(win, size - 1), 1)
    patches0, org0 = _crop_patches(im0, pts0, size)
    patches1, org1 = _crop_patches(im1, guess, size)

    dx, dy = 0.5 * torch.eye(2, device=pts0.device)   # no host copy
    c0 = pts0 - org0
    patch0 = _sample_window(patches0, c0, win)
    ix = (_sample_window(patches0, c0 + dx, win)
          - _sample_window(patches0, c0 - dx, win))
    iy = (_sample_window(patches0, c0 + dy, win)
          - _sample_window(patches0, c0 - dy, win))
    gxx = torch.sum(ix * ix, dim=(1, 2))
    gxy = torch.sum(ix * iy, dim=(1, 2))
    gyy = torch.sum(iy * iy, dim=(1, 2))
    det = gxx * gyy - gxy * gxy
    trace = gxx + gyy
    eig_min = 0.5 * (trace - torch.sqrt(
        torch.clamp(trace * trace - 4 * det, min=0.0)))
    ok = eig_min > min_eig * (win * win)
    det_s = torch.where(det.abs() < 1e-12, 1e-12, det)
    Ginv = torch.stack([torch.stack([gyy, -gxy], -1),
                        torch.stack([-gxy, gxx], -1)], -2) / det_s[:, None,
                                                                   None]

    pos = guess
    done = ~ok
    for _ in range(iters):
        di = patch0 - _sample_window(patches1, pos - org1, win)
        b = torch.stack([torch.sum(di * ix, dim=(1, 2)),
                         torch.sum(di * iy, dim=(1, 2))], -1)
        d = (Ginv @ b[:, :, None])[:, :, 0]
        pos = torch.where(done[:, None], pos, pos + d)
        done = done | (torch.linalg.vector_norm(d, dim=1) < eps)

    # A track that ends at the patch-sampling clamp was stopped short of
    # its true displacement: fail it, unless the patch edge is the image
    # edge there.
    r = win // 2
    h1, w1 = im1.shape
    loc = torch.floor(pos - org1)
    lo_m = (loc < r) & (org1 > 0)
    hi_m = (loc > size - r - 2) & torch.stack(
        [org1[:, 0] < max(w1 - size, 0), org1[:, 1] < max(h1 - size, 0)], 1)
    ok = ok & ~(lo_m | hi_m).any(dim=1)

    err = torch.mean(torch.abs(
        patch0 - _sample_window(patches1, pos - org1, win)), dim=(1, 2))
    return pos, ok, err


def pyramid_lk(im0: torch.Tensor, im1: torch.Tensor, pts: torch.Tensor,
               win: int = 15, levels: int = 3, iters: int = 10,
               eps: float = 0.03, min_eig: float = 1e-4,
               margin: int = 8) -> FlowResult:
    """Track [N, 2] (x, y) points from im0 to im1 ([H, W] grayscale,
    float in [0, 1])."""
    im0 = im0.float()
    im1 = im1.float()
    pts = pts.float()
    pyr0 = [im0]
    pyr1 = [im1]
    for _ in range(levels - 1):
        # a level smaller than the LK window can neither hold a sampling
        # patch nor pass the texture test: clamp the depth (as cv2 does)
        h, w = pyr0[-1].shape
        if min(h, w) // 2 < win + 3:
            break
        pyr0.append(_downsample(pyr0[-1]))
        pyr1.append(_downsample(pyr1[-1]))
    levels = len(pyr0)

    guess = pts / 2.0 ** (levels - 1)
    status = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    err = torch.zeros(pts.shape[0], device=pts.device)
    for lv in range(levels - 1, -1, -1):
        guess, ok, err = _lk_level(pyr0[lv], pyr1[lv], pts / 2.0 ** lv,
                                   guess, win, iters, eps, min_eig, margin)
        status = status & ok
        if lv > 0:
            guess = guess * 2.0

    h, w = im0.shape
    inb = ((guess[:, 0] >= 0) & (guess[:, 0] < w)
           & (guess[:, 1] >= 0) & (guess[:, 1] < h))
    return FlowResult(guess, status & inb, err)
