"""Plain reference of the GATsSPG 2D-3D matcher as the port runs it for
inference, in fp32.

A frozen copy of the fp32 path of ``onepose_tpu_torch/models/gats_spg.py``
(``gnn_body`` then dual-softmax mutual matching) with the whole [B, N1, N2]
confidence matrix formed in plain ops, where the program runs a
hand-written kernel that never writes it. 4 x [GATs, self, cross] layers:
GATs refreshes each 3D point from its leaf observations by additive graph
attention; self and cross layers are elu+1 linear attention, channel c in
head c % num_heads. Weights come from a state dict in the port's module
layout, the benchmark's own.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class Matches(NamedTuple):
    matches0: torch.Tensor          # [B, N1] 3D index, -1 none
    matching_scores0: torch.Tensor  # [B, N1] conf where mutual, else 0
    conf: torch.Tensor              # [B, N1, N2]


def _linear(sd, name, x):
    return F.linear(x, sd[f"{name}.weight"], sd[f"{name}.bias"])


def linear_attention(q, k, v, num_heads):
    b, n, d = q.shape
    m = k.shape[1]
    dh = d // num_heads
    qf = (F.elu(q) + 1.0).reshape(b, n, dh, num_heads)
    kf = (F.elu(k) + 1.0).reshape(b, m, dh, num_heads)
    vf = (v * (1.0 / m)).reshape(b, m, dh, num_heads)
    kv = torch.einsum("bmdh,bmeh->bdeh", kf, vf)
    z = 1.0 / (torch.einsum("bndh,bdh->bnh", qf, kf.sum(1)) + 1e-6)
    out = torch.einsum("bndh,bdeh->bneh", qf, kv) * z[:, :, None, :]
    return (out * m).reshape(b, n, d)


def _instance_norm(x, eps=1e-5):
    mean = x.mean(dim=1, keepdim=True)
    var = x.var(dim=1, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def attention_propagation(sd, p, x, source, num_heads):
    q = _linear(sd, f"{p}.proj_q", x)
    k = _linear(sd, f"{p}.proj_k", source)
    v = _linear(sd, f"{p}.proj_v", source)
    message = _linear(sd, f"{p}.merge", linear_attention(q, k, v, num_heads))
    h = _linear(sd, f"{p}.mlp0", torch.cat([x, message], dim=-1))
    return _linear(sd, f"{p}.mlp1", F.relu(_instance_norm(h)))


def gats_layer(sd, p, h_2d, h_3d, cfg):
    """Each 3D point attends over itself and its leaves (point-major rows
    of h_2d); the trained configuration's path (no linear transform)."""
    b, n, d = h_3d.shape
    leaf = h_2d.shape[1] // n
    W, a = sd[f"{p}.W"], sd[f"{p}.a"]
    if cfg["with_linear_transform"] or cfg["additional"]:
        raise ValueError("the reference covers the trained GATs path only")
    a2d = (h_2d @ (W @ a[:d])).reshape(b, n, leaf)
    a3d = h_3d @ (W @ a[d:])
    feats = torch.cat([h_3d[:, :, None], h_2d.reshape(b, n, leaf, d)], 2)
    if cfg["include_self"]:
        e = torch.cat([a3d, a2d], dim=-1) + a3d
        att = torch.softmax(F.leaky_relu(e, 0.2), dim=-1)
        h = torch.einsum("bnc,bncd->bnd", att, feats)
    else:
        att = torch.softmax(F.leaky_relu(a2d + a3d, 0.2), dim=-1)
        h = torch.einsum("bnc,bncd->bnd", att, feats[:, :, 1:]) / 2.0 + h_3d
    return F.elu(h)


def _unit(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def gnn_body(sd, desc2d, desc3d, leaves, cfg):
    """→ (mdesc2d [B, N1, D], mdesc3d [B, N2, D]), unit norm."""
    d2q, d3db = desc2d, desc3d
    for i in range(3 * cfg["num_blocks"]):
        p = f"gnn.{i}"
        if i % 3 == 0:
            d3db = gats_layer(sd, p, leaves, d3db, cfg)
        elif i % 3 == 1:
            delta0 = attention_propagation(sd, p, d2q, d2q, cfg["num_heads"])
            delta1 = attention_propagation(sd, p, d3db, d3db,
                                           cfg["num_heads"])
            d2q, d3db = d2q + delta0, d3db + delta1
        else:
            delta0 = attention_propagation(sd, p, d2q, d3db, cfg["num_heads"])
            delta1 = attention_propagation(sd, p, d3db, d2q, cfg["num_heads"])
            d2q, d3db = d2q + delta0, d3db + delta1
    return (_unit(_linear(sd, "final_proj", d2q)),
            _unit(_linear(sd, "final_proj", d3db)))


def match(sd, desc2d, mask2d, desc3d, leaves, mask3d, cfg) -> Matches:
    """Dual-softmax confidences, mutual max and threshold. Padded slots
    take part in the softmax statistics; the masks apply afterwards."""
    m0, m1 = gnn_body(sd, desc2d, desc3d, leaves, cfg)
    s = torch.einsum("bnd,bmd->bnm", m0, m1) / cfg["scale_factor"]
    conf = torch.softmax(s, dim=1) * torch.softmax(s, dim=2)
    idx0, max0 = conf.argmax(2), conf.amax(2)
    idx1 = conf.argmax(1)
    n1 = idx0.shape[1]
    mutual0 = torch.arange(n1, device=conf.device)[None] == torch.gather(
        idx1, 1, idx0)
    mscores0 = torch.where(mutual0, max0, 0.0)
    valid0 = (mutual0 & (mscores0 > cfg["match_threshold"]) & mask2d
              & torch.gather(mask3d, 1, idx0))
    return Matches(torch.where(valid0, idx0, -1), mscores0, conf)
