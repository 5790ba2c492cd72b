"""LoFTR's seeded weights and their planting, for the detect-loftr cell.

:func:`loftr_shapes` lists LoFTR's parameters under its module names, each
with LoFTR's own init rule (``kaiming_normal_`` with ``fan_out`` for the
convolutions and ``fine_preprocess``'s matrices, ``xavier_uniform_`` for
the transformers' linears, nn.Linear's default for the biases, LayerNorm
at the identity), and BatchNorm's four vectors drawn near the identity
(γ and σ² in 1 ± 0.25, β and μ in ±0.1), as a trained checkpoint holds
them, so that folding them is exercised. :func:`loftr_weights` draws them
with ``weights.make_weights`` (two large draws on the device).

:func:`plant_loftr` makes a check without a trained checkpoint meaningful
(as ``scenes.plant_superglue`` does for SuperGlue):

- every encoder layer's ``norm2`` γ and β × ``delta``: each layer is near
  the identity (a scaled ``mlp.2`` would be undone by ``norm2``);
- ``layer3_outconv`` whitens the views' 1/8 features (the inverse square
  root of their second moment, eigenvalues floored at a tenth of their
  mean; the convolution has no bias, so the moment is not centred) and
  scales them so that a typical self-match's S = f·f / (d·T) is
  ``self_score``, against about self_score/16 for unrelated cells;
- ``merge_feat``'s window half whitens the views' fine features the same
  way, and it and the token half (with the bias) are scaled so that each
  part's typical |f|²/√d, a heatmap logit's scale, is ``fine_score``.
  A small score flattens the heatmap, whose expectation is then near
  the window's centre. (A large one does not make the centre win: the
  random backbone's fine maps are smooth, and the dot product of the
  centre peaks at a neighbour of larger norm; with whitened windows at
  a score of 50 to 800 on 256² views, 70–77% of the pasted view's
  matches landed 2 or 2.8 px off, on a grid point of the window.)

A pasted view is then found where it was pasted, its cells matched to
the frame's cells at the paste offset, with sub-pixel offsets near 0.
"""
from __future__ import annotations

import math

import torch

from portbench.common import precision
from portbench.reference import loftr as ref
from portbench.weights import make_weights


def _bn(out, name, c):
    for k in ("weight", "bias", "running_mean", "running_var"):
        out[f"{name}.{k}"] = ((c,), ("uniform", 0.25 if k in (
            "weight", "running_var") else 0.1))
    out[f"{name}.num_batches_tracked"] = ((), ("count", 0))


def _conv(out, name, cin, cout, k):
    out[f"{name}.weight"] = ((cout, cin, k, k),
                             ("normal", math.sqrt(2.0 / (cout * k * k))))


def loftr_shapes(cfg: dict) -> dict:
    """name → (shape, rule) of ``models/loftr.LoFTR``'s state dict."""
    r, c, f = cfg["resnetfpn"], cfg["coarse"], cfg["fine"]
    d0 = r["initial_dim"]
    d1, d2, d3 = r["block_dims"]
    out = {}
    _conv(out, "backbone.conv1", 1, d0, 7)
    _bn(out, "backbone.bn1", d0)
    dims = [d0, d1, d2, d3]
    for i in (1, 2, 3):
        for b in (0, 1):
            p, cin = f"backbone.layer{i}.{b}", dims[i - 1] if b == 0 else \
                dims[i]
            _conv(out, f"{p}.conv1", cin, dims[i], 3)
            _conv(out, f"{p}.conv2", dims[i], dims[i], 3)
            _bn(out, f"{p}.bn1", dims[i])
            _bn(out, f"{p}.bn2", dims[i])
            if b == 0 and i > 1:
                _conv(out, f"{p}.downsample.0", cin, dims[i], 1)
                _bn(out, f"{p}.downsample.1", dims[i])
    _conv(out, "backbone.layer3_outconv", d3, d3, 1)
    _conv(out, "backbone.layer2_outconv", d2, d3, 1)
    _conv(out, "backbone.layer2_outconv2.0", d3, d3, 3)
    _bn(out, "backbone.layer2_outconv2.1", d3)
    _conv(out, "backbone.layer2_outconv2.3", d3, d2, 3)
    _conv(out, "backbone.layer1_outconv", d1, d2, 1)
    _conv(out, "backbone.layer1_outconv2.0", d2, d2, 3)
    _bn(out, "backbone.layer1_outconv2.1", d2)
    _conv(out, "backbone.layer1_outconv2.3", d2, d1, 3)
    for name, g in (("loftr_coarse", c), ("loftr_fine", f)):
        d = g["d_model"]
        for i in range(len(g["layer_names"])):
            p = f"{name}.layers.{i}"
            for k, (cin, cout) in (("q_proj", (d, d)), ("k_proj", (d, d)),
                                   ("v_proj", (d, d)), ("merge", (d, d)),
                                   ("mlp.0", (2 * d, 2 * d)),
                                   ("mlp.2", (2 * d, d))):
                out[f"{p}.{k}.weight"] = ((cout, cin), (
                    "uniform", math.sqrt(6.0 / (cin + cout))))
            for k in ("norm1", "norm2"):
                out[f"{p}.{k}.weight"] = ((d,), ("const", 1.0))
                out[f"{p}.{k}.bias"] = ((d,), ("const", 0.0))
    dc, df = c["d_model"], f["d_model"]
    for k, cin in (("down_proj", dc), ("merge_feat", 2 * df)):
        out[f"fine_preprocess.{k}.weight"] = ((df, cin), (
            "normal", math.sqrt(2.0 / df)))
        out[f"fine_preprocess.{k}.bias"] = ((df,), (
            "uniform", math.sqrt(1.0 / cin)))
    return out


def loftr_weights(cfg: dict, seed: int, device) -> dict:
    """The seeded state dict; BatchNorm's γ and σ² moved to 1 ± 0.25."""
    sd = make_weights(loftr_shapes(cfg), seed, "loftr", device)
    for k in sd:
        if k.endswith("running_var") or (
                k.endswith(".weight") and sd[k].dim() == 1
                and k.startswith("backbone.")):
            sd[k] += 1.0
    return sd


def _whitening(x: torch.Tensor) -> torch.Tensor:
    """[N, C] → W with W x of identity second moment (fp64), the moment's
    eigenvalues floored at a tenth of their mean."""
    x = x.double()
    lam, vec = torch.linalg.eigh(x.T @ x / len(x))
    lam = lam.clamp(min=0.1 * float(lam.mean()))
    return vec @ torch.diag(lam.rsqrt()) @ vec.T


def _scaled(white: torch.Tensor, x: torch.Tensor, target: float):
    """white · s, s such that the median of |s·white·x|² is target."""
    sq = (x.double() @ white.T).square().sum(-1).median()
    return (white * math.sqrt(target / float(sq))).float()


def plant_loftr(sd: dict, cfg: dict, views: torch.Tensor, delta: float,
                self_score: float, fine_score: float) -> dict:
    """The planted copy of ``sd`` (module docstring); ``views``
    [V, 1, h, w] on the device."""
    sd = {k: v.clone() for k, v in sd.items()}
    for k in sd:
        if ".norm2." in k:
            sd[k] *= delta
    d = cfg["coarse"]["d_model"]
    with precision(tf32=False):
        # the views' ResNet stages once: layer3_outconv, which the planting
        # sets, is the FPN's first layer
        x1, x2, x3 = ref.backbone_body(sd, views)
        x = x3.permute(0, 2, 3, 1).reshape(-1, d)
        target = self_score * d * cfg["match_coarse"]["dsmax_temperature"]
        sd["backbone.layer3_outconv.weight"] = _scaled(
            _whitening(x), x, target)[..., None, None]
        coarse, fine = ref.backbone_fpn(sd, x1, x2, x3)
        del x1, x2, x3, x
        down = torch.nn.functional.linear(
            ref.add_position_encoding(coarse),
            sd["fine_preprocess.down_proj.weight"],
            sd["fine_preprocess.down_proj.bias"])
    df = cfg["fine"]["d_model"]
    target = fine_score * math.sqrt(df)
    xf = fine.permute(0, 2, 3, 1).reshape(-1, df)[::7]
    w, b = sd["fine_preprocess.merge_feat.weight"], \
        sd["fine_preprocess.merge_feat.bias"]
    w[:, :df] = _scaled(_whitening(xf), xf, target)
    u = torch.nn.functional.linear(down, w[:, df:], b)
    s = math.sqrt(target / float(u.square().sum(-1).median()))
    w[:, df:] *= s
    b *= s
    return sd
