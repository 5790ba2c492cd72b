"""Plain reference of SuperGlue as the port runs it, in fp32.

A frozen copy of ``onepose_tpu_torch/models/superglue.py``'s
``log_assignment`` and ``mutual_matches``: keypoint normalisation, the
keypoint MLP encoder (BatchNorm in eval mode), alternating self and cross
softmax attention (channel c in head c % num_heads), the final
projection, log-space Sinkhorn with a learned dustbin, and mutual-max
matching over a threshold. Weights come from a state dict in the port's
module layout, the benchmark's own.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5


class Matches(NamedTuple):
    matches0: torch.Tensor          # [B, N0] index into set 1, -1 none
    matching_scores0: torch.Tensor  # [B, N0]


def _mlp(sd, prefix, x, n_layers):
    for i in range(n_layers):
        x = F.linear(x, sd[f"{prefix}.lin.{i}.weight"],
                     sd[f"{prefix}.lin.{i}.bias"])
        if i < n_layers - 1:
            bn = f"{prefix}.bn.{i}"
            x = (x - sd[f"{bn}.running_mean"]) * torch.rsqrt(
                sd[f"{bn}.running_var"] + BN_EPS)
            x = torch.relu(x * sd[f"{bn}.weight"] + sd[f"{bn}.bias"])
    return x


def normalize_keypoints(kpts, height, width):
    size = torch.tensor([width, height], dtype=kpts.dtype, device=kpts.device)
    return (kpts - size / 2.0) / (max(height, width) * 0.7)


def _heads(x, h):
    b, n, d = x.shape
    return x.reshape(b, n, d // h, h).transpose(2, 3)   # [B, N, H, D/H]


def _propagate(sd, p, x, source, h):
    q = _heads(F.linear(x, sd[f"{p}.proj_q.weight"], sd[f"{p}.proj_q.bias"]), h)
    k = _heads(F.linear(source, sd[f"{p}.proj_k.weight"],
                        sd[f"{p}.proj_k.bias"]), h)
    v = _heads(F.linear(source, sd[f"{p}.proj_v.weight"],
                        sd[f"{p}.proj_v.bias"]), h)
    scores = torch.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(q.shape[-1])
    msg = torch.einsum("bhnm,bmhd->bnhd", torch.softmax(scores, dim=-1), v)
    b, n, hh, dh = msg.shape
    msg = F.linear(msg.transpose(2, 3).reshape(b, n, hh * dh),
                   sd[f"{p}.merge.weight"], sd[f"{p}.merge.bias"])
    return _mlp(sd, f"{p}.mlp", torch.cat([x, msg], dim=-1), 2)


def log_optimal_transport(scores, alpha, iters):
    """Log-space Sinkhorn with a dustbin row and column. scores [B, M, N]
    → log assignment [B, M+1, N+1]."""
    b, m, n = scores.shape
    one = scores.new_tensor(1.0)
    ms, ns = one * m, one * n
    couplings = torch.cat(
        [torch.cat([scores, alpha.expand(b, m, 1)], dim=-1),
         torch.cat([alpha.expand(b, 1, n), alpha.expand(b, 1, 1)], dim=-1)],
        dim=1)
    norm = -torch.log(ms + ns)
    log_mu = torch.cat([norm.expand(m), (torch.log(ns) + norm)[None]])
    log_nu = torch.cat([norm.expand(n), (torch.log(ms) + norm)[None]])
    log_mu, log_nu = log_mu.expand(b, m + 1), log_nu.expand(b, n + 1)
    u, v = torch.zeros_like(log_mu), torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(couplings + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(couplings + u[:, :, None], dim=1)
    return couplings + u[:, :, None] + v[:, None, :] - norm


def log_assignment(sd, data, cfg):
    """data: keypoints0/1 [B, N, 2], scores0/1, descriptors0/1 [B, N, D],
    mask0/1, shape0/1 (h, w) → [B, N0+1, N1+1] (dustbins last)."""
    n_enc = len(cfg["keypoint_encoder"])
    h = cfg["num_heads"]
    desc = []
    for s in "01":
        kpts = normalize_keypoints(data[f"keypoints{s}"], *data[f"shape{s}"])
        enc = _mlp(sd, "kenc", torch.cat(
            [kpts, data[f"scores{s}"][..., None]], dim=-1), n_enc)
        desc.append(data[f"descriptors{s}"] + enc)
    d0, d1 = desc
    for i in range(cfg["num_gnn_layers"]):
        s0, s1 = (d1, d0) if i % 2 == 1 else (d0, d1)
        delta0 = _propagate(sd, f"gnn.{i}", d0, s0, h)
        delta1 = _propagate(sd, f"gnn.{i}", d1, s1, h)
        d0, d1 = d0 + delta0, d1 + delta1
    m0 = F.linear(d0, sd["final_proj.weight"], sd["final_proj.bias"])
    m1 = F.linear(d1, sd["final_proj.weight"], sd["final_proj.bias"])
    scores = torch.einsum("bnd,bmd->bnm", m0, m1) / math.sqrt(
        cfg["descriptor_dim"])
    scores = torch.where(data["mask0"][:, :, None], scores, -1e9)
    scores = torch.where(data["mask1"][:, None, :], scores, -1e9)
    return log_optimal_transport(scores, sd["bin_score"],
                                 cfg["sinkhorn_iterations"])


def mutual_matches(Z, match_threshold, mask0, mask1) -> Matches:
    inner = Z[:, :-1, :-1]
    idx0, idx1 = inner.argmax(dim=2), inner.argmax(dim=1)
    n0 = idx0.shape[1]
    mutual0 = torch.arange(n0, device=Z.device)[None] == torch.gather(
        idx1, 1, idx0)
    mscores0 = torch.where(mutual0, torch.exp(inner.amax(dim=2)), 0.0)
    valid0 = (mutual0 & (mscores0 > match_threshold) & mask0
              & torch.gather(mask1, 1, idx0))
    return Matches(torch.where(valid0, idx0, -1), mscores0)
