"""SuperPoint's encoder convolutions after the stem: 3x3 SAME convolutions,
each with its bias and ReLU, and a 2x2 max-pool after some, on NHWC fp32.

Replaces no Pallas kernel: the JAX package runs these convolutions as XLA
convolutions. The CUDA kernel is ``onepose_tpu_torch/csrc/encoder.cu``,
one launch a convolution; :func:`encoder_reference` is the plain PyTorch
version of the chain, ``F.conv2d`` as the port ran it before the kernel.

Dispatch follows the tensor: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel, anything else raises.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from onepose_tpu_torch.ops import _kernels

# input channels the kernel takes; output channels are multiples of 64
KERNEL_CIN = (64, 128)
COUT_TILE = 64


class Conv3x3(NamedTuple):
    weight: torch.Tensor   # [3, 3, Cin, Cout] HWIO
    bias: torch.Tensor     # [Cout]
    pool: bool             # a 2x2 max-pool after the ReLU


def encoder_reference(x: torch.Tensor, layers) -> torch.Tensor:
    """Plain version. x [B,H,W,Cin]; ``layers`` a sequence of
    :class:`Conv3x3` → [B,H',W',Cout] of the last (H' halved by each pool).
    Each convolution is ``F.conv2d`` on the NCHW view with the OIHW weights,
    so on the CPU the chain gives the bits of ``nn.Conv2d``'s."""
    x = x.permute(0, 3, 1, 2)
    for w, b, pool in layers:
        x = F.relu(F.conv2d(x, w.permute(3, 2, 0, 1).contiguous(), b,
                            padding=1))
        if pool:
            x = F.max_pool2d(x, 2)
    return x.permute(0, 2, 3, 1)


def _check_layer(i: int, x: torch.Tensor, layer: Conv3x3) -> None:
    b, h, w, cin = x.shape
    cout = layer.weight.shape[-1]
    if cin not in KERNEL_CIN or cout % COUT_TILE or cout == 0:
        raise ValueError(f"encoder_conv: layer {i} is {cin}->{cout}; the "
                         f"kernel takes Cin in {KERNEL_CIN} and Cout a "
                         f"multiple of {COUT_TILE}")
    if layer.pool and (h % 2 or w % 2):
        raise ValueError(f"encoder_conv: layer {i} pools, H and W must be "
                         f"even, got {h}x{w}")
    if b * (cout // COUT_TILE) > 65535:
        raise ValueError(f"encoder_conv: {b} images x {cout // COUT_TILE} "
                         "output tiles exceed the grid")
    f32 = torch.float32
    _kernels.check_cuda(f"layer {i} input", x, f32, (b, h, w, cin))
    _kernels.check_cuda(f"layer {i} weight", layer.weight, f32,
                        (3, 3, cin, cout))
    _kernels.check_cuda(f"layer {i} bias", layer.bias, f32, (cout,))
    _kernels.check_aligned(f"layer {i} input", x)


def encoder_conv(x: torch.Tensor, layers) -> torch.Tensor:
    """x [B,H,W,Cin] fp32; ``layers`` as in :func:`encoder_reference` →
    the last layer's activations, NHWC fp32. On a CUDA tensor every layer
    is one launch of the kernel (Cin 64 or 128, Cout a multiple of 64, H
    and W even before a pool)."""
    if x.device.type == "cpu":
        return encoder_reference(x, layers)
    if x.device.type != "cuda":
        raise ValueError(f"encoder_conv: no kernel for {x.device}")
    for i, layer in enumerate(layers):
        _check_layer(i, x, layer)
        b, h, w, _ = x.shape
        cout = layer.weight.shape[-1]
        if layer.pool:
            h, w = h // 2, w // 2
        out = torch.empty((b, h, w, cout), dtype=torch.float32,
                          device=x.device)
        _kernels.launch("encoder_conv_forward", x.data_ptr(),
                        layer.weight.data_ptr(), layer.bias.data_ptr(),
                        out.data_ptr(), *x.shape, cout, int(layer.pool))
        encoder_conv.launches += 1
        x = out
    return x


encoder_conv.launches = 0
