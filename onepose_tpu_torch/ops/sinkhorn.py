"""SuperGlue's log-space Sinkhorn with a dustbin row and column.

Replaces no Pallas kernel: the JAX package leaves Sinkhorn
(``onepose_tpu/models/superglue.py::log_optimal_transport``) to XLA. For
scores [B,M,N] and the dustbin score alpha, the couplings are the scores
with a row and a column of alpha appended; ``iters`` alternating row and
column updates of the log-domain potentials u [B,M+1] and v [B,N+1]
follow, and the result is the log assignment
Z = couplings + u + v - norm [B,M+1,N+1], norm = -log(M+N).

The CUDA kernel (``onepose_tpu_torch/csrc/sinkhorn.cu``) reads the scores
once an iteration and never forms the couplings; :func:`sinkhorn_reference`
is its plain PyTorch version, the eager loop the port ran before the
kernel. A CPU tensor takes the plain version, a CUDA tensor launches the
kernel, anything else raises.
"""
from __future__ import annotations

import torch

from onepose_tpu_torch.ops import _kernels


def sinkhorn_reference(scores: torch.Tensor, alpha: torch.Tensor,
                       iters: int) -> torch.Tensor:
    """Plain version. scores [B, M, N] → log assignment [B, M+1, N+1] in
    the scores' dtype (fp32 on the main paths; float64 for a reference),
    in the JAX package's order of operations."""
    b, m, n = scores.shape
    dt = dict(dtype=scores.dtype, device=scores.device)
    ms, ns = torch.tensor(float(m), **dt), torch.tensor(float(n), **dt)
    alpha = alpha.to(scores.dtype)
    couplings = torch.cat(
        [torch.cat([scores, alpha.expand(b, m, 1)], dim=-1),
         torch.cat([alpha.expand(b, 1, n), alpha.expand(b, 1, 1)], dim=-1)],
        dim=1)

    norm = -torch.log(ms + ns)
    log_mu = torch.cat([norm.expand(m), (torch.log(ns) + norm)[None]])
    log_nu = torch.cat([norm.expand(n), (torch.log(ms) + norm)[None]])
    log_mu = log_mu.expand(b, m + 1)
    log_nu = log_nu.expand(b, n + 1)

    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(couplings + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(couplings + u[:, :, None], dim=1)
    return couplings + u[:, :, None] + v[:, None, :] - norm


def log_sinkhorn(scores: torch.Tensor, alpha: torch.Tensor,
                 iters: int) -> torch.Tensor:
    """scores [B, M, N] fp32, alpha a one-element tensor, iters ≥ 0 → log
    assignment [B, M+1, N+1] fp32.

    On the card: contiguous scores on the current device, alpha there too
    (read on the device: the call never waits for the card), rows whose
    slab fits a block's shared memory (N up to 5,282)."""
    if scores.device.type == "cpu":
        return sinkhorn_reference(scores, alpha, iters)
    if scores.device.type != "cuda":
        raise ValueError(f"log_sinkhorn: no kernel for {scores.device}")
    b, m, n = scores.shape
    f32 = torch.float32
    _kernels.check_cuda("scores", scores, f32, (b, m, n))
    alpha = alpha.to(f32).reshape(())
    _kernels.check_cuda("alpha", alpha, f32, ())
    if iters < 0:
        raise ValueError(f"log_sinkhorn: iters must be >= 0, got {iters}")
    if b * (m + 1) >= 2 ** 31 or b > 65535:
        raise ValueError(f"log_sinkhorn: {b} x {m + 1} rows exceed the grid")
    lib = _kernels.library()
    nbytes = lib.sinkhorn_workspace_bytes(b, m, n)
    if nbytes == 0:
        raise ValueError(f"log_sinkhorn: no kernel for scores {b}x{m}x{n} "
                         "(an empty dimension, or rows too long for a "
                         "shared-memory slab)")
    work = torch.empty(nbytes, dtype=torch.uint8, device=scores.device)
    Z = torch.empty((b, m + 1, n + 1), dtype=f32, device=scores.device)
    _kernels.launch("sinkhorn_forward", scores.data_ptr(), alpha.data_ptr(),
                    b, m, n, int(iters), Z.data_ptr(), work.data_ptr())
    log_sinkhorn.launches += 1
    return Z


log_sinkhorn.launches = 0
