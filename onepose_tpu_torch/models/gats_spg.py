"""GATsSPG graph-attention 2D-3D matcher, inference side, on tensors.

Port of ``onepose_tpu/models/gats_spg.py``: 4 x [GATs, self, cross] layers
(GATs refreshes each 3D point's descriptor from its ``num_leaf`` 2D leaf
observations by additive graph attention; self and cross layers are
elu+1 linear-attention message passing), a final projection, L2
normalization and dual-softmax mutual-max matching.

Tokens are [B, N, D] as in the JAX package. In linear attention channel c
belongs to head ``c % num_heads`` (the reference's ``view(b, dim, heads,
n)`` split); a contiguous split would change the model under converted
weights. The JAX package's block-masked merged-head form is a TPU layout
choice; here each head is computed on its own.

``forward`` and ``forward_match_only`` run under ``torch.no_grad`` for
inference; training differentiates ``forward_train`` (the same
``gnn_body`` and dual softmax), as the JAX package differentiates its
``forward``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from onepose_tpu_torch.ops.match import dual_softmax_argmax

DEFAULT_CONFIG = {
    "descriptor_dim": 256,
    "num_heads": 4,
    "num_blocks": 4,  # each block = [GATs, self, cross]
    "scale_factor": 0.07,
    "match_threshold": 0.2,
    "include_self": True,
    "additional": False,
    "with_linear_transform": False,
    "compute_dtype": "float32",
    # recompute the GATs and attention steps in the backward pass
    # (torch.utils.checkpoint): activation memory for compute
    "remat": False,
}


class MatchOutput(NamedTuple):
    matches0: torch.Tensor          # [B, N1] index into the 3D set, -1 none
    matches1: torch.Tensor          # [B, N2] index into the 2D set, -1 none
    matching_scores0: torch.Tensor  # [B, N1]
    matching_scores1: torch.Tensor  # [B, N2]
    conf_matrix: torch.Tensor       # [B, N1, N2]; [B, 0, 0] from match-only


class GATsLayer(nn.Module):
    """Additive graph attention weights (GATs.py): W [d, d], a [2d, 1]."""

    def __init__(self, d: int):
        super().__init__()
        self.W = nn.Parameter(torch.empty(d, d))
        self.a = nn.Parameter(torch.empty(2 * d, 1))
        std_w = 1.414 * (2.0 / (d + d)) ** 0.5
        std_a = 1.414 * (2.0 / (2 * d + 1)) ** 0.5
        nn.init.normal_(self.W, std=std_w)
        nn.init.normal_(self.a, std=std_a)


class AttentionPropagation(nn.Module):
    """Linear-attention message passing + MLP([2d→2d, InstanceNorm, ReLU,
    2d→d])."""

    def __init__(self, d: int):
        super().__init__()
        self.proj_q = nn.Linear(d, d)
        self.proj_k = nn.Linear(d, d)
        self.proj_v = nn.Linear(d, d)
        self.merge = nn.Linear(d, d)
        self.mlp0 = nn.Linear(2 * d, 2 * d)
        self.mlp1 = nn.Linear(2 * d, d)


class GATsSPG(nn.Module):
    def __init__(self, descriptor_dim: int = 256, num_blocks: int = 4):
        super().__init__()
        d = descriptor_dim
        self.gnn = nn.ModuleList(
            GATsLayer(d) if i % 3 == 0 else AttentionPropagation(d)
            for i in range(3 * num_blocks))
        self.final_proj = nn.Linear(d, d)


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     num_heads: int) -> torch.Tensor:
    """Multi-head O(N) linear attention with the elu(x)+1 feature map on
    [B, N, D] tensors, channel c in head c % num_heads."""
    b, n, d = q.shape
    m = k.shape[1]
    dh = d // num_heads
    qf = (F.elu(q) + 1.0).reshape(b, n, dh, num_heads)
    kf = (F.elu(k) + 1.0).reshape(b, m, dh, num_heads)
    vf = (v / m).reshape(b, m, dh, num_heads)
    kv = torch.einsum("bmdh,bmeh->bdeh", kf, vf)
    z = 1.0 / (torch.einsum("bndh,bdh->bnh", qf, kf.sum(1)) + 1e-6)
    out = torch.einsum("bndh,bdeh->bneh", qf, kv) * z[:, :, None, :]
    return (out * m).reshape(b, n, d)


def _instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm1d over the token axis of [B, N, C], affine=False."""
    mean = x.mean(dim=1, keepdim=True)
    var = x.var(dim=1, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def attention_propagation(p: AttentionPropagation, x: torch.Tensor,
                          source: torch.Tensor,
                          num_heads: int) -> torch.Tensor:
    """One message-passing step; returns the delta (the caller adds the
    residual). Self-attention projects Q, K and V with one fused linear,
    cross-attention K and V."""
    d = x.shape[-1]
    if x is source:
        w = torch.cat([p.proj_q.weight, p.proj_k.weight, p.proj_v.weight])
        bias = torch.cat([p.proj_q.bias, p.proj_k.bias, p.proj_v.bias])
        q, k, v = F.linear(x, w, bias).split(d, dim=-1)
    else:
        w = torch.cat([p.proj_k.weight, p.proj_v.weight])
        bias = torch.cat([p.proj_k.bias, p.proj_v.bias])
        k, v = F.linear(source, w, bias).split(d, dim=-1)
        q = p.proj_q(x)
    message = p.merge(linear_attention(q, k, v, num_heads))
    h = p.mlp0(torch.cat([x, message], dim=-1))
    return p.mlp1(F.relu(_instance_norm(h)))


def gats_layer(p: GATsLayer, h_2d: torch.Tensor, h_3d: torch.Tensor,
               cfg: dict) -> torch.Tensor:
    """Leaf-restricted graph attention: each 3D point attends over {self} ∪
    its num_leaf 2D observations. h_2d [B, N1*L, D], h_3d [B, N1, D] →
    [B, N1, D]."""
    b, n1, d = h_3d.shape
    num_leaf = h_2d.shape[1] // n1
    W, a = p.W, p.a
    h_2d_g = h_2d.reshape(b, n1, num_leaf, d)
    if cfg["with_linear_transform"]:
        wh_2d = h_2d @ W
        wh_3d = h_3d @ W
        a2d = (wh_2d @ a[:d]).reshape(b, n1, num_leaf)
        a3d = wh_3d @ a[d:]
        f_3d, f_2d = wh_3d, wh_2d.reshape(b, n1, num_leaf, d)
    else:
        # h @ W only reaches the attention logits through a, so
        # h @ W @ a collapses to h @ (W a): two [D] vectors (the trained
        # config takes this path)
        a2d = (h_2d @ (W @ a[:d])).reshape(b, n1, num_leaf)
        a3d = h_3d @ (W @ a[d:])
        f_3d, f_2d = h_3d, h_2d_g

    if cfg["include_self"]:
        e = torch.cat([a3d, a2d], dim=-1) + a3d              # [B, N1, 1+L]
        att = torch.softmax(F.leaky_relu(e, 0.2), dim=-1)
        feats = torch.cat([f_3d[:, :, None], f_2d], dim=2)
        h_prime = torch.einsum("bnc,bncd->bnd", att, feats)
        if cfg["additional"]:
            h_prime = h_prime + h_3d
    else:
        att = torch.softmax(F.leaky_relu(a2d + a3d, 0.2), dim=-1)
        h_prime = torch.einsum("bnc,bncd->bnd", att, f_2d) / 2.0 + f_3d
    return F.elu(h_prime)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(
        torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def resolve_config(config: Optional[dict]) -> dict:
    """DEFAULT_CONFIG updated with ``config``; refuses non-fp32 modes."""
    cfg = dict(DEFAULT_CONFIG)
    cfg.update(config or {})
    if str(cfg["compute_dtype"]) != "float32":
        raise NotImplementedError(
            f"compute_dtype={cfg['compute_dtype']}: the PyTorch port runs "
            "fp32 only; bf16 is ROADMAP Queue 1 item 7")
    return cfg


def gnn_body(model: GATsSPG, data: Dict[str, torch.Tensor], cfg: dict):
    """The GNN stack + final projection + L2 norm → (mdesc2d [B,N1,D],
    mdesc3d [B,N2,D]), in the dtype of the model's parameters (fp32; an
    fp64 copy of a model gives a reference)."""
    dtype = model.final_proj.weight.dtype
    d2q = data["descriptors2d_query"].to(dtype)
    d3db = data["descriptors3d_db"].to(dtype)
    d2db = data["descriptors2d_db"].to(dtype)

    def gats_step(p, d2db_, d3db_):
        return gats_layer(p, d2db_, d3db_, cfg)

    def attn_step(p, x, source):
        return attention_propagation(p, x, source, cfg["num_heads"])

    if cfg["remat"] and torch.is_grad_enabled():
        def remat(fn):
            return lambda *args: checkpoint(fn, *args, use_reentrant=False)
        gats_step, attn_step = remat(gats_step), remat(attn_step)

    for i, p in enumerate(model.gnn):
        kind = i % 3
        if kind == 0:
            d3db = gats_step(p, d2db, d3db)
        elif kind == 1:   # self
            delta0 = attn_step(p, d2q, d2q)
            delta1 = attn_step(p, d3db, d3db)
            d2q, d3db = d2q + delta0, d3db + delta1
        else:             # cross
            delta0 = attn_step(p, d2q, d3db)
            delta1 = attn_step(p, d3db, d2q)
            d2q, d3db = d2q + delta0, d3db + delta1
    return _unit(model.final_proj(d2q)), _unit(model.final_proj(d3db))


def _mutual_threshold(indices0, max0, indices1, max1, match_threshold,
                      mask0=None, mask1=None):
    """Mutual-max + threshold filtering from row/column argmaxes."""
    indices0 = indices0.long()
    indices1 = indices1.long()
    n1 = indices0.shape[1]
    n2 = indices1.shape[1]
    ar0 = torch.arange(n1, device=indices0.device)[None]
    ar1 = torch.arange(n2, device=indices0.device)[None]
    mutual0 = ar0 == torch.gather(indices1, 1, indices0)
    mutual1 = ar1 == torch.gather(indices0, 1, indices1)
    mscores0 = torch.where(mutual0, max0, 0.0)
    mscores1 = torch.where(mutual1, torch.gather(mscores0, 1, indices1), 0.0)
    valid0 = mutual0 & (mscores0 > match_threshold)
    if mask0 is not None:
        valid0 = valid0 & mask0
    if mask1 is not None:
        valid0 = valid0 & torch.gather(mask1, 1, indices0)
    valid1 = mutual1 & torch.gather(valid0, 1, indices1)
    matches0 = torch.where(valid0, indices0, -1)
    matches1 = torch.where(valid1, indices1, -1)
    return matches0, matches1, mscores0, mscores1


def dual_softmax_conf(mdesc0: torch.Tensor, mdesc1: torch.Tensor,
                      scale_factor: float) -> torch.Tensor:
    """The [B, N1, N2] dual-softmax confidence matrix."""
    s = torch.einsum("bnd,bmd->bnm", mdesc0, mdesc1) / scale_factor
    return torch.softmax(s, dim=1) * torch.softmax(s, dim=2)


def dual_softmax_match(mdesc0: torch.Tensor, mdesc1: torch.Tensor,
                       scale_factor: float, match_threshold: float,
                       mask0: Optional[torch.Tensor] = None,
                       mask1: Optional[torch.Tensor] = None) -> MatchOutput:
    """Dual-softmax scores + mutual-max + threshold matching, the whole
    [B, N1, N2] conf matrix in memory (plain torch)."""
    conf = dual_softmax_conf(mdesc0, mdesc1, scale_factor)
    out = _mutual_threshold(conf.argmax(2), conf.amax(2), conf.argmax(1),
                            conf.amax(1), match_threshold, mask0, mask1)
    return MatchOutput(*out, conf)


def forward_train(model: GATsSPG, data: Dict[str, torch.Tensor],
                  config: Optional[dict] = None) -> MatchOutput:
    """Match 2D query keypoints against the 3D point DB, with the conf
    matrix, carrying gradients (``remat`` checkpoints the GNN steps).

    data ([B, N, D] tokens): descriptors2d_query [B, N1, D],
    descriptors3d_db [B, N2, D], descriptors2d_db [B, N2*num_leaf, D], and
    optionally mask2d [B, N1], mask3d [B, N2] (bool)."""
    cfg = resolve_config(config)
    m0, m1 = gnn_body(model, data, cfg)
    return dual_softmax_match(m0, m1, cfg["scale_factor"],
                              cfg["match_threshold"], data.get("mask2d"),
                              data.get("mask3d"))


@torch.no_grad()
def forward(model: GATsSPG, data: Dict[str, torch.Tensor],
            config: Optional[dict] = None) -> MatchOutput:
    """:func:`forward_train` without gradients, for inference."""
    return forward_train(model, data, config)


@torch.no_grad()
def forward_match_only(model: GATsSPG, data: Dict[str, torch.Tensor],
                       config: Optional[dict] = None) -> MatchOutput:
    """Inference forward through the fused dual-softmax argmax
    (``ops.match``): the [B, N1, N2] conf matrix is never formed on the
    card, and ``conf_matrix`` is an empty [B, 0, 0] placeholder. The port's
    pipeline always matches through here; the JAX pipeline's
    ``use_pallas_match`` switch has no counterpart."""
    cfg = resolve_config(config)
    m0, m1 = gnn_body(model, data, cfg)
    idx0, max0, idx1, max1 = dual_softmax_argmax(m0, m1, cfg["scale_factor"])
    out = _mutual_threshold(idx0, max0, idx1, max1, cfg["match_threshold"],
                            data.get("mask2d"), data.get("mask3d"))
    return MatchOutput(*out, m0.new_zeros((m0.shape[0], 0, 0)))
