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
kernel, anything else raises. :func:`match_gate` is the one comparison
that holds a result to the plain version.
"""
from __future__ import annotations

import dataclasses

import torch

from onepose_tpu_torch.ops import _kernels

# Relative gate of match_gate. fp32-class products (cuBLAS fp32, or the
# kernel's 3xTF32) put the max conf of a row or column within 1.2e-5 of an
# fp64 product on random and peaked unit descriptors (H100); operands
# rounded to TF32 put it 1.6e-4 to 2e-3 away (tests/test_torch_match.py::
# test_gate_accepts_fp32_refuses_tf32).
GATE_REL = 3e-5


def match_reference(mdesc0: torch.Tensor, mdesc1: torch.Tensor,
                    scale: float):
    """Plain version: the whole conf matrix, then argmax and max."""
    conf = _conf(mdesc0, mdesc1, scale)
    # torch.argmax returns the first maximal index; Tensor.max does not
    # promise which one
    return (conf.argmax(dim=2).int(), conf.amax(dim=2),
            conf.argmax(dim=1).int(), conf.amax(dim=1))


def _conf(mdesc0, mdesc1, scale):
    s = torch.einsum("bnd,bmd->bnm", mdesc0, mdesc1) / scale
    return torch.softmax(s, dim=1) * torch.softmax(s, dim=2)


@dataclasses.dataclass
class GateResult:
    ok: bool
    max_rel_err: float   # max |max conf - plain| / plain, rows and columns
    max_abs_err: float
    idx_diff: int        # rows + columns whose index differs from plain
    near_ties: int       # rows + columns with top-2 gap < rel·top-1
    bad_idx: int         # index differences outside near-ties


def match_gate(got, mdesc0: torch.Tensor, mdesc1: torch.Tensor,
               scale: float) -> GateResult:
    """Hold ``got`` = (idx0, max0, idx1, max1) to the plain version on the
    same inputs, computed in the inputs' own dtype (fp32 under the current
    matmul precision, or float64).

    Each max must lie within GATE_REL × the plain max of its row or
    column. An index may differ from the plain argmax only where the plain
    conf's top-2 gap is below GATE_REL × its top-1 (a near-tie that
    rounding may flip), and only to an entry whose plain conf is that
    close to the top-1 too."""
    rel = GATE_REL
    conf = _conf(mdesc0, mdesc1, scale)
    rel_err = abs_err = 0.0
    idx_diff = near_ties = bad_idx = 0
    for idx, val, dim in ((got[0], got[1], 2), (got[2], got[3], 1)):
        top = conf.topk(min(2, conf.shape[dim]), dim=dim).values
        top1, top2 = top.select(dim, 0), top.select(dim, -1)
        err = (val.to(conf.dtype) - top1).abs()
        abs_err = max(abs_err, float(err.max()))
        rel_err = max(rel_err, float((err / top1.clamp_min(1e-38)).max()))
        near_ties += int(((top1 - top2) < rel * top1).sum())
        at = conf.gather(dim, idx.long().unsqueeze(dim)).squeeze(dim)
        diff = idx.long() != conf.argmax(dim)
        idx_diff += int(diff.sum())
        bad_idx += int((diff & ((top1 - at) >= rel * top1)).sum())
    return GateResult(rel_err <= rel and bad_idx == 0, rel_err, abs_err,
                      idx_diff, near_ties, bad_idx)


def dual_softmax_argmax(mdesc0: torch.Tensor, mdesc1: torch.Tensor,
                        scale: float):
    """→ (idx0 [B,N1] int32, max0 [B,N1], idx1 [B,N2] int32, max1 [B,N2]).

    On the card: contiguous fp32 inputs on the current device, each
    starting on a 16-byte boundary, any D."""
    if mdesc0.device.type == "cpu":
        return match_reference(mdesc0, mdesc1, scale)
    if mdesc0.device.type != "cuda":
        raise ValueError(f"dual_softmax_argmax: no kernel for {mdesc0.device}")
    b, n1, d = mdesc0.shape
    n2 = mdesc1.shape[1]
    f32 = torch.float32
    for name, t, n in (("mdesc0", mdesc0, n1), ("mdesc1", mdesc1, n2)):
        _kernels.check_cuda(name, t, f32, (b, n, d))
        _kernels.check_aligned(name, t)
    dev = mdesc0.device
    lib = _kernels.library()
    work = torch.empty(lib.match_workspace_bytes(b, n1, n2, d),
                       dtype=torch.uint8, device=dev)
    idx0 = torch.empty((b, n1), dtype=torch.int32, device=dev)
    max0 = torch.empty((b, n1), dtype=f32, device=dev)
    idx1 = torch.empty((b, n2), dtype=torch.int32, device=dev)
    max1 = torch.empty((b, n2), dtype=f32, device=dev)
    _kernels.launch("match_forward", mdesc0.data_ptr(), mdesc1.data_ptr(),
                    b, n1, n2, d, float(scale), work.data_ptr(),
                    idx0.data_ptr(), max0.data_ptr(), idx1.data_ptr(),
                    max1.data_ptr())
    dual_softmax_argmax.launches += 1
    return idx0, max0, idx1, max1


dual_softmax_argmax.launches = 0
