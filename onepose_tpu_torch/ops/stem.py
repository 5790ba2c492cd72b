"""Fused SuperPoint stem: conv1a + ReLU + conv1b + ReLU + 2x2 max-pool.

Port of ``onepose_tpu/ops/pallas_stem.py::fused_stem_tiled`` (and of its
whole-width twin ``fused_stem``, which computes the same function). The
CUDA kernel is ``onepose_tpu_torch/csrc/stem.cu``; :func:`stem_reference`
is its plain PyTorch version.

Dispatch follows the tensor: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel, anything else raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from onepose_tpu_torch.ops import _kernels

C_STEM = 64


def stem_reference(images: torch.Tensor, w1a: torch.Tensor,
                   b1a: torch.Tensor, w1b: torch.Tensor,
                   b1b: torch.Tensor) -> torch.Tensor:
    """Plain version. images [B,H,W,1]; w1a [3,3,1,64], w1b [3,3,64,64]
    (HWIO); b1a, b1b [64] → [B,H/2,W/2,64]."""
    x = images.permute(0, 3, 1, 2)
    x = F.relu(F.conv2d(x, w1a.permute(3, 2, 0, 1), b1a, padding=1))
    x = F.relu(F.conv2d(x, w1b.permute(3, 2, 0, 1), b1b, padding=1))
    return F.max_pool2d(x, 2).permute(0, 2, 3, 1)


def fused_stem(images: torch.Tensor, w1a: torch.Tensor, b1a: torch.Tensor,
               w1b: torch.Tensor, b1b: torch.Tensor) -> torch.Tensor:
    """images [B,H,W,1] fp32, H and W even; HWIO weights as in
    :func:`stem_reference` → pooled activations [B,H/2,W/2,64] fp32."""
    if images.device.type == "cpu":
        return stem_reference(images, w1a, b1a, w1b, b1b)
    if images.device.type != "cuda":
        raise ValueError(f"fused_stem: no kernel for {images.device}")
    b, h, w, _ = images.shape
    if h % 2 or w % 2:
        raise ValueError(f"fused_stem: H and W must be even, got {h}x{w}")
    f32 = torch.float32
    _kernels.check_cuda("images", images, f32, (b, h, w, 1))
    _kernels.check_cuda("w1a", w1a, f32, (3, 3, 1, C_STEM))
    _kernels.check_cuda("b1a", b1a, f32, (C_STEM,))
    _kernels.check_cuda("w1b", w1b, f32, (3, 3, C_STEM, C_STEM))
    _kernels.check_cuda("b1b", b1b, f32, (C_STEM,))
    _kernels.check_aligned("w1b", w1b)
    out = torch.empty((b, h // 2, w // 2, C_STEM), dtype=f32,
                      device=images.device)
    _kernels.launch("stem_forward", images.data_ptr(), w1a.data_ptr(),
                    b1a.data_ptr(), w1b.data_ptr(), b1b.data_ptr(),
                    out.data_ptr(), b, h, w)
    fused_stem.launches += 1
    return out


fused_stem.launches = 0
