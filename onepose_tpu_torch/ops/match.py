"""Fused dual-softmax argmax for GATsSPG matching.

Port of ``onepose_tpu/ops/pallas_match.py::dual_softmax_argmax``. For
mdesc0 [B,N1,D] and mdesc1 [B,N2,D]:

    S = mdesc0 · mdesc1ᵀ / scale
    conf = softmax over N1 (S) ⊙ softmax over N2 (S)

and the result is the row argmax and max of conf ([B,N1]) and the column
argmax and max ([B,N2]), the first index winning ties. No mask is applied:
padded slots take part in the softmax statistics, and
``gats_spg._mutual_threshold`` applies the masks afterwards.

The CUDA kernel (``onepose_tpu_torch/csrc/match.cu``) never writes the
[B,N1,N2] conf matrix; :func:`match_reference` is its plain PyTorch
version. A CPU tensor takes the plain version, a CUDA tensor launches the
kernel, anything else raises.
"""
from __future__ import annotations

import torch

from onepose_tpu_torch.ops import _kernels


def match_reference(mdesc0: torch.Tensor, mdesc1: torch.Tensor,
                    scale: float):
    """Plain version: the whole conf matrix, then argmax and max."""
    s = torch.einsum("bnd,bmd->bnm", mdesc0, mdesc1) / scale
    conf = torch.softmax(s, dim=1) * torch.softmax(s, dim=2)
    # torch.argmax returns the first maximal index; Tensor.max does not
    # promise which one
    return (conf.argmax(dim=2).int(), conf.amax(dim=2),
            conf.argmax(dim=1).int(), conf.amax(dim=1))


def dual_softmax_argmax(mdesc0: torch.Tensor, mdesc1: torch.Tensor,
                        scale: float):
    """→ (idx0 [B,N1] int32, max0 [B,N1], idx1 [B,N2] int32, max1 [B,N2])."""
    if mdesc0.device.type == "cpu":
        return match_reference(mdesc0, mdesc1, scale)
    if mdesc0.device.type != "cuda":
        raise ValueError(f"dual_softmax_argmax: no kernel for {mdesc0.device}")
    b, n1, d = mdesc0.shape
    n2 = mdesc1.shape[1]
    f32 = torch.float32
    _kernels.check_cuda("mdesc0", mdesc0, f32, (b, n1, d))
    _kernels.check_cuda("mdesc1", mdesc1, f32, (b, n2, d))
    dev = mdesc0.device
    row_m = torch.empty((b, n1), dtype=f32, device=dev)
    row_l = torch.empty((b, n1), dtype=f32, device=dev)
    col_m = torch.empty((b, n2), dtype=f32, device=dev)
    col_l = torch.empty((b, n2), dtype=f32, device=dev)
    idx0 = torch.empty((b, n1), dtype=torch.int32, device=dev)
    max0 = torch.empty((b, n1), dtype=f32, device=dev)
    idx1 = torch.empty((b, n2), dtype=torch.int32, device=dev)
    max1 = torch.empty((b, n2), dtype=f32, device=dev)
    dims = (b, n1, n2, d, float(scale))
    stats = (row_m.data_ptr(), row_l.data_ptr(), col_m.data_ptr(),
             col_l.data_ptr())
    _kernels.launch("match_stats", mdesc0.data_ptr(), mdesc1.data_ptr(),
                    *dims, *stats)
    _kernels.launch("match_argmax", mdesc0.data_ptr(), mdesc1.data_ptr(),
                    *dims, *stats, idx0.data_ptr(), max0.data_ptr(),
                    idx1.data_ptr(), max1.data_ptr())
    dual_softmax_argmax.launches += 1
    return idx0, max0, idx1, max1


dual_softmax_argmax.launches = 0
