"""SuperGlue 2D-2D matcher, on tensors.

Port of ``onepose_tpu/models/superglue.py``: keypoint normalization, a
keypoint MLP encoder (BatchNorm in eval mode, running statistics) added to
the descriptors, 18 alternating self/cross softmax-attention layers (4
heads), a final projection, log-space Sinkhorn optimal transport with a
learned dustbin score (100 iterations) and mutual-max + threshold
matching.

Tokens are [B, N, D] as in the JAX package. In attention channel c belongs
to head ``c % num_heads`` (``_split_heads`` reshapes to (D/H, H)); a
contiguous split would change the model under converted weights. The JAX
package's fused Q/K/V product is an XLA workaround; here Q, K and V are
three linears. Attention and Sinkhorn have no Pallas kernel in the JAX
package, so they stay plain PyTorch ops (einsum, softmax, logsumexp) in
fp32, in the JAX package's order of operations.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Sequence

import torch
from torch import nn

DEFAULT_CONFIG = {
    "descriptor_dim": 256,
    "keypoint_encoder": (32, 64, 128, 256),
    "num_gnn_layers": 18,  # ['self', 'cross'] * 9
    "num_heads": 4,
    "sinkhorn_iterations": 100,
    "match_threshold": 0.2,
}

BN_EPS = 1e-5
# match_gate: two fp32 runs of the same forward that sum in other orders
# (the card and the CPU, or the JAX package and the port) put their log
# assignments within this fraction of its largest magnitude. Sound runs
# read up to 4.8e-6 (card vs CPU at the outdoor shape); TF32 products read
# 8.6e-4 (the same card run with TF32 allowed) and 4.9e-4 (TF32 rounding
# on the CPU, tests/test_torch_superglue.py). The gate sits about 10x from
# each.
GATE_REL = 5e-5


class SuperGlueOutput(NamedTuple):
    matches0: torch.Tensor          # [B, N0] index into set 1, -1 none
    matches1: torch.Tensor          # [B, N1] index into set 0, -1 none
    matching_scores0: torch.Tensor  # [B, N0]
    matching_scores1: torch.Tensor  # [B, N1]


class MLP(nn.Module):
    """Linears with BatchNorm + ReLU between them (not after the last)."""

    def __init__(self, channels: Sequence[int]):
        super().__init__()
        self.lin = nn.ModuleList(nn.Linear(channels[i - 1], channels[i])
                                 for i in range(1, len(channels)))
        self.bn = nn.ModuleList(nn.BatchNorm1d(c) for c in channels[1:-1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, lin in enumerate(self.lin):
            x = lin(x)
            if i < len(self.bn):
                bn = self.bn[i]
                x = (x - bn.running_mean) * torch.rsqrt(bn.running_var + BN_EPS)
                x = torch.relu(x * bn.weight + bn.bias)
        return x


class AttentionalPropagation(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.proj_q = nn.Linear(d, d)
        self.proj_k = nn.Linear(d, d)
        self.proj_v = nn.Linear(d, d)
        self.merge = nn.Linear(d, d)
        self.mlp = MLP([2 * d, 2 * d, d])


class SuperGlue(nn.Module):
    """The network's weights. ``keypoint_channels`` are the encoder's
    widths after the 3 inputs (x, y, score); the last is the descriptor
    dimension."""

    def __init__(self, keypoint_channels: Sequence[int] = (32, 64, 128, 256),
                 num_gnn_layers: int = 18):
        super().__init__()
        d = keypoint_channels[-1]
        self.kenc = MLP([3, *keypoint_channels])
        self.gnn = nn.ModuleList(AttentionalPropagation(d)
                                 for _ in range(num_gnn_layers))
        self.final_proj = nn.Linear(d, d)
        self.bin_score = nn.Parameter(torch.tensor(1.0))


def normalize_keypoints(kpts: torch.Tensor, height, width) -> torch.Tensor:
    """Centre and scale by 0.7 × the larger side. kpts [B, N, 2]."""
    size = torch.tensor([width, height], dtype=torch.float32,
                        device=kpts.device)
    return (kpts - size / 2.0) / (size.max() * 0.7)


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, N, D] → [B, N, H, D/H], channel c in head c % H."""
    b, n, d = x.shape
    return x.reshape(b, n, d // num_heads, num_heads).transpose(2, 3)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, n, h, dh = x.shape
    return x.transpose(2, 3).reshape(b, n, h * dh)


def softmax_attention(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """q [B,Nq,H,Dh]; k, v [B,Nk,H,Dh] → [B,Nq,H,Dh]."""
    scores = torch.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(q.shape[-1])
    return torch.einsum("bhnm,bmhd->bnhd", torch.softmax(scores, dim=-1), v)


def attention_propagation(p: AttentionalPropagation, x: torch.Tensor,
                          source: torch.Tensor,
                          num_heads: int) -> torch.Tensor:
    """One message-passing step; returns the delta (the caller adds the
    residual)."""
    q = _split_heads(p.proj_q(x), num_heads)
    k = _split_heads(p.proj_k(source), num_heads)
    v = _split_heads(p.proj_v(source), num_heads)
    message = p.merge(_merge_heads(softmax_attention(q, k, v)))
    return p.mlp(torch.cat([x, message], dim=-1))


def log_optimal_transport(scores: torch.Tensor, alpha: torch.Tensor,
                          iters: int) -> torch.Tensor:
    """Log-space Sinkhorn with a learned dustbin row and column.
    scores [B, M, N] fp32 → log assignment [B, M+1, N+1]."""
    b, m, n = scores.shape
    f32 = dict(dtype=torch.float32, device=scores.device)
    ms, ns = torch.tensor(float(m), **f32), torch.tensor(float(n), **f32)
    alpha = alpha.to(torch.float32)
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


def resolve_config(config: Optional[dict]) -> dict:
    cfg = dict(DEFAULT_CONFIG)
    cfg.update(config or {})
    return cfg


@torch.no_grad()
def log_assignment(model: SuperGlue, data: Dict[str, torch.Tensor],
                   cfg: dict) -> torch.Tensor:
    """The encoder, the GNN, the final projection and Sinkhorn →
    [B, N0+1, N1+1] log assignment (dustbins last)."""
    desc0 = data["descriptors0"].float()
    desc1 = data["descriptors1"].float()
    kpts0 = normalize_keypoints(data["keypoints0"].float(), *data["shape0"])
    kpts1 = normalize_keypoints(data["keypoints1"].float(), *data["shape1"])
    desc0 = desc0 + model.kenc(
        torch.cat([kpts0, data["scores0"].float()[..., None]], dim=-1))
    desc1 = desc1 + model.kenc(
        torch.cat([kpts1, data["scores1"].float()[..., None]], dim=-1))

    for i, p in enumerate(model.gnn):
        if i % 2 == 1:  # cross (layers alternate self, cross)
            src0, src1 = desc1, desc0
        else:
            src0, src1 = desc0, desc1
        delta0 = attention_propagation(p, desc0, src0, cfg["num_heads"])
        delta1 = attention_propagation(p, desc1, src1, cfg["num_heads"])
        desc0, desc1 = desc0 + delta0, desc1 + delta1

    mdesc0 = model.final_proj(desc0)
    mdesc1 = model.final_proj(desc1)
    scores = torch.einsum("bnd,bmd->bnm", mdesc0, mdesc1)
    scores = scores / math.sqrt(cfg["descriptor_dim"])

    # padded slots route to the dustbin: a large negative score keeps the
    # Sinkhorn marginals behaving as if the slot were absent
    mask0, mask1 = data.get("mask0"), data.get("mask1")
    if mask0 is not None:
        scores = torch.where(mask0[:, :, None], scores, -1e9)
    if mask1 is not None:
        scores = torch.where(mask1[:, None, :], scores, -1e9)
    return log_optimal_transport(scores, model.bin_score,
                                 cfg["sinkhorn_iterations"])


def mutual_matches(Z: torch.Tensor, match_threshold: float,
                   mask0: Optional[torch.Tensor] = None,
                   mask1: Optional[torch.Tensor] = None) -> SuperGlueOutput:
    """Mutual-max + threshold matching on a log assignment; the first
    index wins ties, as ``jnp.argmax`` does."""
    inner = Z[:, :-1, :-1]
    n0, n1 = inner.shape[1:]
    indices0 = inner.argmax(dim=2)
    indices1 = inner.argmax(dim=1)
    max0 = inner.amax(dim=2)
    ar0 = torch.arange(n0, device=Z.device)[None]
    ar1 = torch.arange(n1, device=Z.device)[None]
    mutual0 = ar0 == torch.gather(indices1, 1, indices0)
    mutual1 = ar1 == torch.gather(indices0, 1, indices1)

    mscores0 = torch.where(mutual0, torch.exp(max0), 0.0)
    mscores1 = torch.where(mutual1, torch.gather(mscores0, 1, indices1), 0.0)
    valid0 = mutual0 & (mscores0 > match_threshold)
    if mask0 is not None:
        valid0 = valid0 & mask0
    if mask1 is not None:
        valid0 = valid0 & torch.gather(mask1, 1, indices0)
    valid1 = mutual1 & torch.gather(valid0, 1, indices1)
    matches0 = torch.where(valid0, indices0, -1).to(torch.int32)
    matches1 = torch.where(valid1, indices1, -1).to(torch.int32)
    return SuperGlueOutput(matches0, matches1, mscores0, mscores1)


@torch.no_grad()
def forward(model: SuperGlue, data: Dict[str, torch.Tensor],
            config: Optional[dict] = None) -> SuperGlueOutput:
    """data ([B, N, D] layout): keypoints0/1 [B, N, 2]; scores0/1 [B, N];
    descriptors0/1 [B, N, D]; shape0/1 (height, width) ints; optionally
    mask0/1 [B, N] bool validity of padded slots."""
    cfg = resolve_config(config)
    Z = log_assignment(model, data, cfg)
    return mutual_matches(Z, cfg["match_threshold"], data.get("mask0"),
                          data.get("mask1"))


@dataclasses.dataclass
class GateResult:
    ok: bool
    same_keypoints: bool  # both runs hold the same keypoint positions
    max_abs_diff: float   # max |Z - ref_Z| over unmasked entries
    max_rel_diff: float   # the same over max |ref_Z|
    diff: int             # rows whose match differs from the reference
    near_ties: int        # rows and columns a change of max_abs_diff flips
    bad: int              # differing rows that no near-tie explains


def _slots(kpts: torch.Tensor, ref_kpts: torch.Tensor):
    """t [B, N] with ``kpts[b, t[b, r]]`` at the position of
    ``ref_kpts[b, r]``, and whether the two hold the same positions.
    Keypoints come sorted by score, so scores within rounding of each
    other may take each other's slots in two runs."""
    def code(k):
        k = k.double().cpu()
        return k[..., 1] * 1e6 + k[..., 0]

    c, rc = code(kpts), code(ref_kpts)
    p = c.argsort(dim=-1, stable=True)
    rp = rc.argsort(dim=-1, stable=True)
    same = torch.equal(c.gather(-1, p), rc.gather(-1, rp))
    return torch.empty_like(rp).scatter_(-1, rp, p), same


def match_gate(matches0: torch.Tensor, Z: torch.Tensor,
               ref_matches0: torch.Tensor, ref_Z: torch.Tensor,
               match_threshold: float, keypoints=None,
               ref_keypoints=None) -> GateResult:
    """Hold one run's matches0 and log assignment Z [B, N0+1, N1+1] to a
    reference run's. With ``keypoints`` = (keypoints0, keypoints1) of each
    run, this run's slots are first put in the reference's order by
    position (both runs must hold the same positions).

    The log assignments must agree within GATE_REL of the reference's
    largest magnitude (masked slots, near -1e9, left out). If they agree
    within d, a row's mutual-max match can change only where the
    reference's top-2 gap in that row, or in the column it is (or was)
    matched to, is below 2d, or where its top is within d of
    log(match_threshold); every differing row must be such a near-tie."""
    inner = Z[:, :-1, :-1].double().cpu()
    ref = ref_Z[:, :-1, :-1].double().cpu()
    m0 = matches0.long().cpu()
    same = True
    if keypoints is not None:
        t0, same0 = _slots(keypoints[0], ref_keypoints[0])
        t1, same1 = _slots(keypoints[1], ref_keypoints[1])
        same = same0 and same1
        n0, n1 = inner.shape[1:]
        inner = inner.gather(1, t0[..., None].expand(-1, -1, n1))
        inner = inner.gather(2, t1[:, None, :].expand(-1, n0, -1))
        back1 = torch.empty_like(t1).scatter_(
            -1, t1, torch.arange(n1).expand_as(t1))
        m0 = m0.gather(1, t0)
        m0 = torch.where(m0 >= 0, back1.gather(1, m0.clamp(min=0)), -1)
    live = ref.abs() < 1e6
    d = float((inner - ref).abs()[live].max()) if live.any() else 0.0
    scale = float(ref.abs()[live].max()) if live.any() else 1.0
    top0 = ref.topk(min(2, ref.shape[2]), dim=2).values
    top1 = ref.topk(min(2, ref.shape[1]), dim=1).values
    row = (top0[..., 0] - top0[..., -1]) <= 2 * d
    if match_threshold > 0:
        row |= (top0[..., 0] - math.log(match_threshold)).abs() <= d
    col = (top1[:, 0] - top1[:, -1]) <= 2 * d

    def col_tie(m):
        return (m >= 0) & torch.gather(col, 1, m.clamp(min=0))

    ref_m0 = ref_matches0.long().cpu()
    diff = m0 != ref_m0
    bad = diff & ~(row | col_tie(m0) | col_tie(ref_m0))
    ok = same and d <= GATE_REL * scale and int(bad.sum()) == 0
    return GateResult(ok, same, d, d / scale, int(diff.sum()),
                      int(row.sum() + col.sum()), int(bad.sum()))
