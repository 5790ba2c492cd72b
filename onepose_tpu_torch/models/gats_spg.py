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

``compute_dtype="bfloat16"`` runs the GNN body as the JAX package's bf16
mode does: parameters and inputs cast to bf16, each linear accumulating
in fp32 (bias added in fp32, one rounding back), linear attention's token
sums and the GATs aggregation accumulated and kept in fp32 up to their
outputs, instance-norm statistics in fp32, and ``final_proj``'s output
cast to fp32 before the L2 norm, so the matching head (and the match
kernel) take fp32 descriptors.

``token_group`` (the mesh's model axis, ``parallel/mesh.py``; None: whole
tokens) runs the GNN over 3D tokens sharded across the group's ranks, the
2D stream whole on each: linear attention whose keys are 3D tokens sums
its key statistics over the group, the 3D stream's instance norm takes
its statistics over the group, the GATs layer stays local (a token shard
holds its own point-major leaves), and matching gathers the 3D
descriptors (``forward_match_only``) or takes the column softmax's sums
over the group (``dual_softmax_conf``). The collectives run under
autograd (``parallel/collectives.py``), so training differentiates the
same graph.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from onepose_tpu_torch.ops.match import dual_softmax_argmax
from onepose_tpu_torch.parallel import collectives as comm
from onepose_tpu_torch.utils.profiling import span

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

DEFAULT_CONFIG = {
    "descriptor_dim": 256,
    "num_heads": 4,
    "num_blocks": 4,  # each block = [GATs, self, cross]
    "scale_factor": 0.07,
    "match_threshold": 0.2,
    "include_self": True,
    "additional": False,
    "with_linear_transform": False,
    # "bfloat16": the GNN body in bf16 with fp32 accumulation (module
    # docstring); the dual softmax stays fp32
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


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype products of ``x`` accumulate in: fp32 for bf16 (the JAX
    package's ``preferred_element_type=float32``), else ``x``'s own."""
    return torch.float32 if x.dtype == torch.bfloat16 else x.dtype


def _linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """``lin`` applied to ``x`` in ``x``'s dtype, the parameters cast to
    it. In bf16 the backends accumulate the products in fp32 and round the
    biased sum to bf16 once (``pin_fp32`` turns cuBLAS's reduced-precision
    bf16 reductions off)."""
    return F.linear(x, lin.weight.to(x.dtype), lin.bias.to(x.dtype))


def _tokens(x: torch.Tensor, group) -> int:
    """The token count of ``x`` [B, N, C] over ``group``'s shards (equal
    shards; the local count without a group)."""
    return x.shape[1] * (1 if group is None else comm.group_size(group))


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     num_heads: int, key_group=None) -> torch.Tensor:
    """Multi-head O(N) linear attention with the elu(x)+1 feature map on
    [B, N, D] tensors, channel c in head c % num_heads. Below fp32 it
    rounds where the JAX package's compiled bf16 graph rounds: elu in the
    inputs' dtype, the +1, V / N, K^T V, the normalizer and the output in
    :func:`_acc_dtype`, the key sum rounded to the inputs' dtype, the
    result rounded back once.

    ``key_group``: the keys and values are this rank's shard of the
    group's tokens; K^T V and the key sum are summed over the group in
    one all-reduce, and N is the group's count, so that every rank
    computes what one rank computes on the whole keys (the key sum
    rounded after the sum)."""
    b, n, d = q.shape
    m = _tokens(k, key_group)
    dh = d // num_heads
    acc = _acc_dtype(q)
    qf = (F.elu(q).to(acc) + 1.0).reshape(b, n, dh, num_heads)
    kf = (F.elu(k).to(acc) + 1.0).reshape(b, -1, dh, num_heads)
    vf = (v.to(acc) * (1.0 / m)).reshape(b, -1, dh, num_heads)
    kv = torch.einsum("bmdh,bmeh->bdeh", kf, vf)
    ksum = kf.sum(1)
    if key_group is not None:
        packed = comm.all_reduce_sum(
            torch.cat([kv.reshape(b, -1), ksum.reshape(b, -1)], 1), key_group)
        kv, ksum = (packed[:, :kv[0].numel()].reshape(kv.shape),
                    packed[:, kv[0].numel():].reshape(ksum.shape))
    ksum = ksum.to(q.dtype).to(acc)
    z = 1.0 / (torch.einsum("bndh,bdh->bnh", qf, ksum) + 1e-6)
    out = torch.einsum("bndh,bdeh->bneh", qf, kv) * z[:, :, None, :]
    return (out * m).to(q.dtype).reshape(b, n, d)


def _leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """leaky ReLU with the slope rounded to ``x``'s dtype first, as the
    JAX package's weakly typed constant is."""
    return torch.where(x >= 0, x, x * torch.tensor(slope, dtype=x.dtype))


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis. Below fp32 it rounds as the JAX
    package's compiled bf16 graph does: the max-shifted logits in ``x``'s
    dtype, their exp and its sum in :func:`_acc_dtype`, the sum and each
    term rounded to ``x``'s dtype, the quotient kept in the wider type."""
    acc = _acc_dtype(x)
    if acc == x.dtype:
        return torch.softmax(x, dim=-1)
    e = torch.exp((x - x.amax(-1, keepdim=True)).to(acc))
    return e.to(x.dtype).to(acc) / e.sum(-1, keepdim=True).to(x.dtype).to(acc)


def _instance_norm(x: torch.Tensor, eps: float = 1e-5,
                   group=None) -> torch.Tensor:
    """InstanceNorm1d over the token axis of [B, N, C], affine=False, its
    statistics in :func:`_acc_dtype`. ``group``: the tokens are this
    rank's shard; the mean, then the mean of (x - mean)² (two passes, as
    ``var`` takes them: Σx² - n·mean² loses digits at D=256), are the
    group's."""
    x32 = x.to(_acc_dtype(x))
    if group is None:
        mean = x32.mean(dim=1, keepdim=True)
        var = x32.var(dim=1, unbiased=False, keepdim=True)
    else:
        n = _tokens(x, group)
        mean = comm.all_reduce_sum(x32.sum(1, keepdim=True), group) / n
        var = comm.all_reduce_sum(
            (x32 - mean).square().sum(1, keepdim=True), group) / n
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def attention_propagation(p: AttentionPropagation, x: torch.Tensor,
                          source: torch.Tensor, num_heads: int,
                          x_group=None, source_group=None) -> torch.Tensor:
    """One message-passing step; returns the delta (the caller adds the
    residual). Self-attention projects Q, K and V with one fused linear,
    cross-attention K and V. ``x_group`` / ``source_group``: the group
    whose ranks shard ``x``'s / ``source``'s tokens (None: whole)."""
    d, dtype = x.shape[-1], x.dtype
    if x is source:
        w = torch.cat([p.proj_q.weight, p.proj_k.weight, p.proj_v.weight])
        bias = torch.cat([p.proj_q.bias, p.proj_k.bias, p.proj_v.bias])
        q, k, v = F.linear(x, w.to(dtype), bias.to(dtype)).split(d, dim=-1)
    else:
        w = torch.cat([p.proj_k.weight, p.proj_v.weight])
        bias = torch.cat([p.proj_k.bias, p.proj_v.bias])
        k, v = F.linear(source, w.to(dtype), bias.to(dtype)).split(d, dim=-1)
        q = _linear(x, p.proj_q)
    message = _linear(linear_attention(q, k, v, num_heads, source_group),
                      p.merge)
    h = _linear(torch.cat([x, message], dim=-1), p.mlp0)
    return _linear(F.relu(_instance_norm(h, group=x_group)), p.mlp1)


def gats_layer(p: GATsLayer, h_2d: torch.Tensor, h_3d: torch.Tensor,
               cfg: dict) -> torch.Tensor:
    """Leaf-restricted graph attention: each 3D point attends over {self} ∪
    its num_leaf 2D observations. h_2d [B, N*L, D] (point-major: row
    p·L + l), h_3d [B, N, D] → [B, N, D]. Each point reads its own rows
    only, so a contiguous shard of the points with its leaf rows computes
    its part of the whole."""
    b, n1, d = h_3d.shape
    num_leaf = h_2d.shape[1] // n1
    acc = _acc_dtype(h_3d)
    W, a = p.W.to(h_3d.dtype), p.a.to(h_3d.dtype)
    h_2d_g = h_2d.reshape(b, n1, num_leaf, d)
    if cfg["with_linear_transform"]:
        # the projections accumulate and stay in ``acc``
        wh_2d = h_2d.to(acc) @ W.to(acc)
        wh_3d = h_3d.to(acc) @ W.to(acc)
        a = a.to(acc)
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
        att = _softmax(_leaky_relu(e))
        feats = torch.cat([f_3d[:, :, None].to(acc), f_2d.to(acc)], dim=2)
        h_prime = torch.einsum("bnc,bncd->bnd", att.to(acc), feats)
        if cfg["additional"]:
            h_prime = h_prime + h_3d
    else:
        att = _softmax(_leaky_relu(a2d + a3d))
        h_prime = torch.einsum("bnc,bncd->bnd", att.to(acc),
                               f_2d.to(acc)) / 2.0 + f_3d
    # the aggregation accumulates in ``acc``; back to the compute dtype
    return F.elu(h_prime).to(h_3d.dtype)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(
        torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def resolve_config(config: Optional[dict]) -> dict:
    """DEFAULT_CONFIG updated with ``config``; ``compute_dtype`` must be
    one of :data:`COMPUTE_DTYPES`."""
    cfg = dict(DEFAULT_CONFIG)
    cfg.update(config or {})
    if str(cfg["compute_dtype"]) not in COMPUTE_DTYPES:
        raise ValueError(
            f"compute_dtype must be one of {sorted(COMPUTE_DTYPES)}, got "
            f"{cfg['compute_dtype']!r}")
    return cfg


def gnn_body(model: GATsSPG, data: Dict[str, torch.Tensor], cfg: dict,
             token_group=None):
    """The GNN stack + final projection + L2 norm → (mdesc2d [B,N1,D],
    mdesc3d [B,N2,D]). The body computes in bf16 when ``compute_dtype``
    says so, else in the dtype of the model's parameters (fp32; an fp64
    copy of a model gives a reference); the descriptors it returns are
    fp32 (or fp64) either way. ``token_group``: ``descriptors3d_db`` and
    ``descriptors2d_db`` hold this rank's shard of the group's 3D tokens
    (module docstring), and so does the mdesc3d returned."""
    dtype = model.final_proj.weight.dtype
    if str(cfg.get("compute_dtype", "float32")) == "bfloat16":
        dtype = torch.bfloat16
    d2q = data["descriptors2d_query"].to(dtype)
    d3db = data["descriptors3d_db"].to(dtype)
    d2db = data["descriptors2d_db"].to(dtype)

    def gats_step(p, d2db_, d3db_):
        return gats_layer(p, d2db_, d3db_, cfg)

    def attn_step(p, x, source, x_group=None, source_group=None):
        return attention_propagation(p, x, source, cfg["num_heads"],
                                     x_group, source_group)

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
            delta1 = attn_step(p, d3db, d3db, token_group, token_group)
            d2q, d3db = d2q + delta0, d3db + delta1
        else:             # cross
            delta0 = attn_step(p, d2q, d3db, None, token_group)
            delta1 = attn_step(p, d3db, d2q, token_group, None)
            d2q, d3db = d2q + delta0, d3db + delta1
    out = model.final_proj.weight.dtype
    return (_unit(_linear(d2q, model.final_proj).to(out)),
            _unit(_linear(d3db, model.final_proj).to(out)))


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
                      scale_factor: float, col_group=None) -> torch.Tensor:
    """The [B, N1, N2] dual-softmax confidence matrix. ``col_group``:
    mdesc1 is this rank's shard of the group's N2 tokens, and the result
    its columns; the softmax over N1 is local, the one over N2 takes its
    row max (detached: the shift moves no gradient) and its row sum of
    exponentials over the group."""
    s = torch.einsum("bnd,bmd->bnm", mdesc0, mdesc1) / scale_factor
    if col_group is None:
        return torch.softmax(s, dim=1) * torch.softmax(s, dim=2)
    e = torch.exp(s - comm.all_reduce_max(s.amax(2, keepdim=True),
                                          col_group))
    return torch.softmax(s, dim=1) * (
        e / comm.all_reduce_sum(e.sum(2, keepdim=True), col_group))


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
                       config: Optional[dict] = None,
                       token_group=None) -> MatchOutput:
    """Inference forward through the fused dual-softmax argmax
    (``ops.match``): the [B, N1, N2] conf matrix is never formed on the
    card, and ``conf_matrix`` is an empty [B, 0, 0] placeholder. The port's
    pipeline always matches through here; the JAX pipeline's
    ``use_pallas_match`` switch has no counterpart.

    ``token_group``: the 3D inputs (``mask3d`` too) are this rank's token
    shard (:func:`gnn_body`); mdesc3d and mask3d are all-gathered over the
    group first, as XLA gathers the operands of the unpartitioned
    ``pallas_call``, so the kernel sees whole rows and every rank returns
    the whole outputs."""
    cfg = resolve_config(config)
    with span("match"):
        with span("match.gnn"):
            m0, m1 = gnn_body(model, data, cfg, token_group)
        mask3d = data.get("mask3d")
        if token_group is not None:
            m1 = comm.all_gather_cat(m1, 1, token_group)
            if mask3d is not None:
                mask3d = comm.all_gather_cat(mask3d, 1, token_group)
        with span("match.kernel"):
            idx0, max0, idx1, max1 = dual_softmax_argmax(
                m0, m1, cfg["scale_factor"])
            out = _mutual_threshold(idx0, max0, idx1, max1,
                                    cfg["match_threshold"],
                                    data.get("mask2d"), mask3d)
        return MatchOutput(*out, m0.new_zeros((m0.shape[0], 0, 0)))
