"""fp32 precision pin for the port.

Counterpart of ``onepose_tpu/ops/precision.py``. The geometric solvers
(RANSAC-PnP and everything it reaches) need true fp32: rounding their
matmul operands to bf16 halved PnP's success rate at 70% outliers
(docs/DESIGN.md §7b). On an NVIDIA card PyTorch runs fp32 matmuls in
full fp32 by default, but cuDNN convolutions run in TF32 (about three
decimal digits) unless told otherwise, which would also break the parity
of SuperPoint's keypoint selection with the fp32 reference.

``pin_fp32`` sets all three switches, and a fourth for bf16 products
(GATsSPG's bf16 mode): cuBLAS may otherwise reduce bf16 GEMMs' split-K
partial sums in bf16, where the JAX package accumulates in fp32.
``onepose_tpu_torch.pipeline`` calls it when it is imported and again
when a ``PosePipeline`` is built; ``fp32_pinned`` is what the tests
assert.
"""
from __future__ import annotations

import torch


def pin_fp32() -> None:
    """Turn TF32 off for cuDNN and cuBLAS and ask for full fp32 matmuls."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def fp32_pinned() -> bool:
    return (not torch.backends.cudnn.allow_tf32
            and not torch.backends.cuda.matmul.allow_tf32
            and torch.get_float32_matmul_precision() == "highest")
