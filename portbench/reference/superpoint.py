"""Plain reference of SuperPoint as the port runs it, in fp32.

A frozen copy of the fp32 path of ``onepose_tpu_torch/models/superpoint.py``
with its stem as plain convolutions (the program runs a hand-written
kernel there): VGG encoder, 65-channel detector softmax with 8x
depth-to-space, two-round max-pool NMS, threshold and border masks, a
static top-K with the lower index winning ties, and bilinear descriptor
sampling with the reference coordinate map. It reads the weights from a
state dict in ``nn.Conv2d`` layout ([cout, cin, k, k]), the benchmark's
own, and imports nothing of the program.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

ENCODER = ["conv1a", "conv1b", "pool", "conv2a", "conv2b", "pool",
           "conv3a", "conv3b", "pool", "conv4a", "conv4b"]


class Features(NamedTuple):
    keypoints: torch.Tensor    # [B, K, 2] (x, y); image centre where ~mask
    scores: torch.Tensor       # [B, K]; 0 where ~mask
    descriptors: torch.Tensor  # [B, K, D] unit norm; all ones where ~mask
    mask: torch.Tensor         # [B, K] bool


def _conv(x, sd, name, padding=1):
    return F.conv2d(x, sd[f"{name}.weight"], sd[f"{name}.bias"],
                    padding=padding)


def dense_heads(sd: dict, images: torch.Tensor):
    """images [B, H, W, 1] in [0, 1] → (scores [B, H, W], coarse unit
    descriptors [B, H/8, W/8, D])."""
    x = images.permute(0, 3, 1, 2)
    for name in ENCODER:
        x = F.max_pool2d(x, 2) if name == "pool" else F.relu(_conv(x, sd,
                                                                   name))
    logits = _conv(F.relu(_conv(x, sd, "convPa")), sd, "convPb", 0)
    desc = _conv(F.relu(_conv(x, sd, "convDa")), sd, "convDb", 0)
    probs = torch.softmax(logits, dim=1)[:, :-1]
    scores = F.pixel_shuffle(probs, 8)[:, 0]
    desc = desc / torch.clamp(
        torch.linalg.vector_norm(desc, dim=1, keepdim=True), min=1e-12)
    return scores, desc.permute(0, 2, 3, 1)


def _maxpool_same(x, radius):
    return F.max_pool2d(x[:, None], 2 * radius + 1, stride=1,
                        padding=radius)[:, 0]


def simple_nms(scores: torch.Tensor, nms_radius: int) -> torch.Tensor:
    """Max-pool NMS with two suppression rounds, each re-admitting local
    maxima of the suppressed map."""
    zeros = torch.zeros_like(scores)
    max_mask = scores == _maxpool_same(scores, nms_radius)
    for _ in range(2):
        supp_mask = _maxpool_same(max_mask.float(), nms_radius) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == _maxpool_same(supp_scores, nms_radius)
        max_mask = max_mask | (new_max_mask & ~supp_mask)
    return torch.where(max_mask, scores, zeros)


def sample_descriptors(desc: torch.Tensor, kpts_xy: torch.Tensor,
                       s: int = 8) -> torch.Tensor:
    """Unit descriptors bilinearly sampled at keypoint pixels, with the
    map ((kpt - s/2 + 0.5) / (dim*s - s/2 - 0.5)) * 2 - 1 and
    align_corners=True, zero outside. desc [B, Hc, Wc, D]; kpts_xy
    [B, K, 2] → [B, K, D]."""
    b, hc, wc, _ = desc.shape
    g = torch.stack([(kpts_xy[..., 0] - s / 2.0 + 0.5)
                     / (wc * s - s / 2.0 - 0.5),
                     (kpts_xy[..., 1] - s / 2.0 + 0.5)
                     / (hc * s - s / 2.0 - 0.5)], -1) * 2.0 - 1.0
    out = F.grid_sample(desc.permute(0, 3, 1, 2), g[:, None], mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    out = out[:, :, 0].transpose(1, 2)
    return out / torch.clamp(
        torch.linalg.vector_norm(out, dim=-1, keepdim=True), min=1e-12)


def select_keypoints(nms_scores: torch.Tensor, desc: torch.Tensor,
                     config: dict) -> Features:
    """Static top-K over threshold- and border-masked NMS scores, ties to
    the lower index; invalid slots hold score 0, the image centre and an
    all-ones descriptor."""
    b, h, w = nms_scores.shape
    k, border = config["max_keypoints"], config["remove_borders"]
    dev = nms_scores.device
    row = torch.arange(h, device=dev)[:, None]
    col = torch.arange(w, device=dev)[None, :]
    inside = ((row >= border) & (row < h - border)
              & (col >= border) & (col < w - border))
    masked = torch.where(inside & (nms_scores > config["keypoint_threshold"]),
                         nms_scores, -1.0).reshape(b, h * w)
    top, idx = torch.sort(masked, dim=1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    kpts = torch.stack([(idx % w).float(), (idx // w).float()], -1)
    valid = top > 0.0
    descs = torch.where(valid[..., None], sample_descriptors(desc, kpts), 1.0)
    centre = torch.tensor([w / 2.0, h / 2.0], device=dev)
    return Features(torch.where(valid[..., None], kpts, centre),
                    torch.where(valid, top, 0.0), descs, valid)


def extract(sd: dict, images: torch.Tensor, config: dict) -> Features:
    scores, desc = dense_heads(sd, images)
    return select_keypoints(simple_nms(scores, config["nms_radius"]), desc,
                            config)
