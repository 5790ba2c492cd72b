"""LoFTR, the detector-free coarse-to-fine matcher, on the detector's path.

Sun, Shen, Wang, Bao and Zhou, "LoFTR: Detector-Free Local Feature
Matching with Transformers", CVPR 2021; code github.com/zju3dv/LoFTR,
``src/loftr/``, configuration ``src/config/default.py``
(:data:`DEFAULT_CONFIG` holds the values the forward pass reads, lower-cased
as ``lower_config`` gives them). The modules carry LoFTR's own names
(``backbone.layer1.0.conv1``, ``loftr_coarse.layers.3.mlp.2``,
``fine_preprocess.merge_feat``, ...), so a state dict of the published
code loads by name (``utils/model_io.load_loftr``).

In the detector, set 0 is the DB views [V, 1, h, w] and set 1 one full
frame [1, 1, H, W], paired with each view. :class:`Matcher` computes what
the views give once (their backbone maps, their tokens with the
positional encoding, their fine windows) and then, per frame, as
``loftr.py`` orders it:

1. ``backbone``: ``ResNetFPN_8_2`` of the frame → coarse [256, H/8, W/8],
   fine [128, H/2, W/2].
2. ``coarse``: the sine positional encoding, then the coarse transformer,
   4 × [self, cross] of elu+1 linear attention, the frame's tokens
   expanded over the V pairs. A cross layer updates feat0 from feat1 and
   then feat1 from the *new* feat0.
3. ``match``: the dual softmax of ``coarse_matching.py`` on the match
   kernel (``ops/match.dual_softmax_argmax``: S = f0·f1ᵀ / (d·T), the row
   and column maxima of conf and their first indices), then LoFTR's mask
   rule: view cell i and frame cell j = idx0[i] match where
   max0[i] > thr, idx1[j] = i and neither cell lies within ``border_rm``
   cells of its map's border. The maxima are over the unmasked conf, as
   LoFTR takes them, and its ``mask.max(dim=2)`` picks the first index,
   as the kernel does. The one difference: where a row or a column holds
   its maximum at two cells exactly (equal fp32 conf), LoFTR may keep a
   later tied cell that the first one's border or column rule removes;
   the slate keeps only the first. The result is a static slate over the
   view cells: ``valid`` [V, h/8·w/8], the frame cell ``j`` and ``conf``.
4. ``fine``: for every slot of the slate (static shape; the invalid slots
   are computed and ignored, as their rows are independent of the valid
   ones), the 5×5 windows of stride 4 at both cells of the fine maps,
   ``down_proj`` of both coarse tokens and ``merge_feat``, the fine
   transformer 1 × [self, cross], the heatmap softmax(f0[centre]·f1ᵀ/√d)
   and its spatial expectation on the normalised grid × (W // 2) × 2: the
   frame point's offset from its cell. The view point stays at its cell.

Exact reparametrisations made by :func:`prepare` (equal in exact
arithmetic; fp32 rounds them differently):

- BatchNorm (eval) folded into the convolution before it:
  w·γ/√(σ²+ε) and β − μ·γ/√(σ²+ε), computed in fp64.
- LoFTR's heads are contiguous (channel h·dh + e of q, k, v in head h);
  ``gats_spg.linear_attention`` puts channel c in head c % H. The output
  channels of q_proj, k_proj, v_proj and the input channels of merge are
  permuted h·dh + e → e·H + h, so that the shared function computes
  LoFTR's attention unchanged.
- ``merge_feat`` of [window, coarse token] is split into its two halves:
  the window half is applied to the fine maps before the windows are
  cut (a 1×1 map, the same dot product per pixel; zero padding stays
  zero), the coarse half with the bias to the token.
"""
from __future__ import annotations

import copy
import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from onepose_tpu_torch.models.gats_spg import linear_attention
from onepose_tpu_torch.ops.match import dual_softmax_argmax
from onepose_tpu_torch.utils.profiling import span

BN_EPS = 1e-5
LN_EPS = 1e-5
LEAKY_SLOPE = 0.01   # nn.LeakyReLU's default, as resnet_fpn.py builds it

# the values of src/config/default.py that the forward pass reads
DEFAULT_CONFIG = {
    "resolution": (8, 2),
    "fine_window_size": 5,
    "resnetfpn": {"initial_dim": 128, "block_dims": [128, 196, 256]},
    "coarse": {"d_model": 256, "nhead": 8,
               "layer_names": ["self", "cross"] * 4},
    "match_coarse": {"thr": 0.2, "border_rm": 2, "dsmax_temperature": 0.1},
    "fine": {"d_model": 128, "nhead": 8, "layer_names": ["self", "cross"]},
}
# keys of default.py that choose among the published code's variants: the
# one variant built here. ``temp_bug_fix`` False (the positional encoding
# of LoFTR's first released weights) and the Sinkhorn coarse matching are
# not built.
BUILT_VARIANT = {
    ("backbone_type",): "ResNetFPN",
    ("resolution",): (8, 2),
    ("fine_concat_coarse_feat",): True,
    ("coarse", "attention"): "linear",
    ("coarse", "temp_bug_fix"): True,
    ("match_coarse", "match_type"): "dual_softmax",
    ("fine", "attention"): "linear",
}
# keys of default.py that no forward pass reads, the published one
# included (``d_ffn`` is read by no layer; the Sinkhorn settings only with
# match_type sinkhorn; the rest are training's)
NOT_READ = {
    ("coarse", "d_ffn"), ("fine", "d_ffn"), ("match_coarse", "skh_iters"),
    ("match_coarse", "skh_init_bin_score"), ("match_coarse", "skh_prefilter"),
    ("match_coarse", "train_coarse_percent"),
    ("match_coarse", "train_pad_num_gt_min"),
    ("match_coarse", "sparse_spvs"), ("loss",),
}


def resolve_config(config: Optional[dict] = None) -> dict:
    """:data:`DEFAULT_CONFIG` with ``config``'s entries over it (nested
    groups merged key by key; keys in lower case, as ``lower_config``
    gives them). A key of :data:`BUILT_VARIANT` must hold the variant built
    here, and one of :data:`NOT_READ` is dropped; any other key that
    :data:`DEFAULT_CONFIG` lacks, or another variant, raises
    ``ValueError``: a checkpoint meant for a forward pass that this module
    does not build fails here rather than matching wrongly."""
    out = copy.deepcopy(DEFAULT_CONFIG)
    for k, v in (config or {}).items():
        if (k,) not in NOT_READ and isinstance(v, dict) \
                and isinstance(out.get(k), dict):
            for kk, vv in v.items():
                _set(out[k], (k, kk), vv)
        else:
            _set(out, (k,), v)
    return out


def _set(group: dict, path: tuple, value) -> None:
    name = ".".join(path)
    if path in NOT_READ:
        return
    if path in BUILT_VARIANT:
        built = BUILT_VARIANT[path]
        got = tuple(value) if isinstance(value, (list, tuple)) else value
        if got != built:
            raise ValueError(f"LoFTR config {name}={value!r}: only "
                             f"{built!r} is built")
    elif path[-1] not in group:
        raise ValueError(f"LoFTR config: unknown key {name}")
    if path[-1] in group:
        group[path[-1]] = value


# ---------------------------------------------------------------------------
# The module layout (LoFTR's names)
# ---------------------------------------------------------------------------

def _conv(cin, cout, k, stride=1):
    return nn.Conv2d(cin, cout, k, stride, k // 2, bias=False)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, planes, 3, stride)
        self.conv2 = _conv(planes, planes, 3)
        self.bn1 = nn.BatchNorm2d(planes)
        self.bn2 = nn.BatchNorm2d(planes)
        if stride != 1:
            self.downsample = nn.Sequential(_conv(cin, planes, 1, stride),
                                            nn.BatchNorm2d(planes))


class ResNetFPN_8_2(nn.Module):
    """``backbone/resnet_fpn.py``: to 1/8 (coarse) and 1/2 (fine)."""

    def __init__(self, initial_dim: int = 128, block_dims=(128, 196, 256)):
        super().__init__()
        d1, d2, d3 = block_dims
        self.conv1 = nn.Conv2d(1, initial_dim, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(initial_dim)
        dims = [initial_dim, d1, d2, d3]
        for i, stride in ((1, 1), (2, 2), (3, 2)):
            setattr(self, f"layer{i}", nn.Sequential(
                BasicBlock(dims[i - 1], dims[i], stride),
                BasicBlock(dims[i], dims[i])))
        self.layer3_outconv = _conv(d3, d3, 1)
        self.layer2_outconv = _conv(d2, d3, 1)
        self.layer2_outconv2 = nn.Sequential(
            _conv(d3, d3, 3), nn.BatchNorm2d(d3), nn.LeakyReLU(),
            _conv(d3, d2, 3))
        self.layer1_outconv = _conv(d1, d2, 1)
        self.layer1_outconv2 = nn.Sequential(
            _conv(d2, d2, 3), nn.BatchNorm2d(d2), nn.LeakyReLU(),
            _conv(d2, d1, 3))


class LoFTREncoderLayer(nn.Module):
    def __init__(self, d_model: int):
        super().__init__()
        self.q_proj = nn.Linear(d_model, d_model, bias=False)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model, bias=False)
        self.merge = nn.Linear(d_model, d_model, bias=False)
        self.mlp = nn.Sequential(
            nn.Linear(2 * d_model, 2 * d_model, bias=False), nn.ReLU(),
            nn.Linear(2 * d_model, d_model, bias=False))
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)


class LocalFeatureTransformer(nn.Module):
    def __init__(self, d_model: int, n_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(LoFTREncoderLayer(d_model)
                                    for _ in range(n_layers))


class FinePreprocess(nn.Module):
    def __init__(self, d_coarse: int, d_fine: int):
        super().__init__()
        self.down_proj = nn.Linear(d_coarse, d_fine, bias=True)
        self.merge_feat = nn.Linear(2 * d_fine, d_fine, bias=True)


class LoFTR(nn.Module):
    """The parameters of ``loftr.py::LoFTR`` under its names; the forward
    pass is :class:`Matcher`'s."""

    def __init__(self, config: Optional[dict] = None):
        super().__init__()
        cfg = resolve_config(config)
        self.config = cfg
        r = cfg["resnetfpn"]
        self.backbone = ResNetFPN_8_2(r["initial_dim"], r["block_dims"])
        self.loftr_coarse = LocalFeatureTransformer(
            cfg["coarse"]["d_model"], len(cfg["coarse"]["layer_names"]))
        self.fine_preprocess = FinePreprocess(cfg["coarse"]["d_model"],
                                              cfg["fine"]["d_model"])
        self.loftr_fine = LocalFeatureTransformer(
            cfg["fine"]["d_model"], len(cfg["fine"]["layer_names"]))


# ---------------------------------------------------------------------------
# Load-time reparametrisation
# ---------------------------------------------------------------------------

def _conv_bn_pairs():
    """Each convolution of the backbone and the BatchNorm after it (None:
    none; a block without a downsample has neither)."""
    pairs = [("backbone.conv1", "backbone.bn1")]
    for i in (1, 2, 3):
        for b in (0, 1):
            p = f"backbone.layer{i}.{b}"
            pairs += [(f"{p}.conv1", f"{p}.bn1"), (f"{p}.conv2", f"{p}.bn2"),
                      (f"{p}.downsample.0", f"{p}.downsample.1")]
    for i in (3, 2, 1):
        pairs.append((f"backbone.layer{i}_outconv", None))
    for i in (2, 1):
        pairs += [(f"backbone.layer{i}_outconv2.0",
                   f"backbone.layer{i}_outconv2.1"),
                  (f"backbone.layer{i}_outconv2.3", None)]
    return pairs


def head_permutation(d: int, heads: int) -> torch.Tensor:
    """perm[e·heads + h] = h·(d // heads) + e: the contiguous head layout's
    channel at each channel of ``gats_spg.linear_attention``'s layout."""
    dh = d // heads
    e, h = torch.meshgrid(torch.arange(dh), torch.arange(heads),
                          indexing="ij")
    return (h * dh + e).reshape(-1)


def prepare(sd: dict, config: Optional[dict] = None) -> dict:
    """A state dict under LoFTR's names → the tensors the forward pass
    reads: BatchNorm folded, the attention's channels permuted and
    ``merge_feat`` split (module docstring). Convolutions keep their
    names, with a ``.bias`` where a BatchNorm was folded."""
    cfg = resolve_config(config)
    p = {}
    for conv, bn in _conv_bn_pairs():
        if f"{conv}.weight" not in sd:
            continue        # a block without a downsample
        w = sd[f"{conv}.weight"]
        if bn is None:
            p[f"{conv}.weight"] = w
            continue
        g = sd[f"{bn}.weight"].double() * torch.rsqrt(
            sd[f"{bn}.running_var"].double() + BN_EPS)
        p[f"{conv}.weight"] = (w.double() * g[:, None, None, None]).to(w.dtype)
        p[f"{conv}.bias"] = (sd[f"{bn}.bias"].double()
                             - sd[f"{bn}.running_mean"].double() * g
                             ).to(w.dtype)
    for name in ("coarse", "fine"):
        d, heads = cfg[name]["d_model"], cfg[name]["nhead"]
        perm = head_permutation(d, heads).to(next(iter(sd.values())).device)
        for i in range(len(cfg[name]["layer_names"])):
            pre = f"loftr_{name}.layers.{i}"
            for proj in ("q_proj", "k_proj", "v_proj"):
                p[f"{pre}.{proj}.weight"] = sd[f"{pre}.{proj}.weight"][perm]
            p[f"{pre}.merge.weight"] = sd[f"{pre}.merge.weight"][:, perm]
            for k in ("mlp.0.weight", "mlp.2.weight", "norm1.weight",
                      "norm1.bias", "norm2.weight", "norm2.bias"):
                p[f"{pre}.{k}"] = sd[f"{pre}.{k}"]
    df = cfg["fine"]["d_model"]
    merge = sd["fine_preprocess.merge_feat.weight"]
    p["fine.window.weight"] = merge[:, :df].contiguous()
    p["fine.token.weight"] = merge[:, df:].contiguous()
    p["fine.token.bias"] = sd["fine_preprocess.merge_feat.bias"]
    p["fine.down.weight"] = sd["fine_preprocess.down_proj.weight"]
    p["fine.down.bias"] = sd["fine_preprocess.down_proj.bias"]
    return {k: v.contiguous() for k, v in p.items()}


# ---------------------------------------------------------------------------
# The forward pass, on the prepared tensors
# ---------------------------------------------------------------------------

def _conv2d(p, name, x, stride=1):
    w = p[f"{name}.weight"]
    return F.conv2d(x, w, p.get(f"{name}.bias"), stride, w.shape[-1] // 2)


def _block(p, name, x, stride):
    y = torch.relu(_conv2d(p, f"{name}.conv1", x, stride))
    y = _conv2d(p, f"{name}.conv2", y)
    if f"{name}.downsample.0.weight" in p:
        x = _conv2d(p, f"{name}.downsample.0", x, stride)
    return torch.relu(x + y)


def _up2(x):
    return F.interpolate(x, scale_factor=2.0, mode="bilinear",
                         align_corners=True)


def _outconv2(p, name, x):
    y = F.leaky_relu(_conv2d(p, f"{name}.0", x), LEAKY_SLOPE)
    return _conv2d(p, f"{name}.3", y)


def backbone(p: dict, x: torch.Tensor):
    """[B, 1, H, W] (H, W multiples of 8) → (coarse [B, 256, H/8, W/8],
    fine [B, 128, H/2, W/2])."""
    x0 = torch.relu(_conv2d(p, "backbone.conv1", x, 2))
    x1 = _block(p, "backbone.layer1.1", _block(p, "backbone.layer1.0", x0, 1),
                1)
    x2 = _block(p, "backbone.layer2.1", _block(p, "backbone.layer2.0", x1, 2),
                1)
    x3 = _block(p, "backbone.layer3.1", _block(p, "backbone.layer3.0", x2, 2),
                1)
    x3_out = _conv2d(p, "backbone.layer3_outconv", x3)
    x2_out = _outconv2(p, "backbone.layer2_outconv2",
                       _conv2d(p, "backbone.layer2_outconv", x2) + _up2(x3_out))
    x1_out = _outconv2(p, "backbone.layer1_outconv2",
                       _conv2d(p, "backbone.layer1_outconv", x1) + _up2(x2_out))
    return x3_out, x1_out


def position_encoding(d: int, h: int, w: int) -> torch.Tensor:
    """``utils/position_encoding.py`` with ``temp_bug_fix``, cut to
    [d, h, w] (on the CPU, in fp32, as LoFTR builds its buffer): channels
    4k..4k+3 are sin x, cos x, sin y, cos y at frequency div[k], x and y
    counting from 1."""
    y = torch.ones(h, w).cumsum(0)[None]
    x = torch.ones(h, w).cumsum(1)[None]
    div = torch.exp(torch.arange(0, d // 2, 2).float()
                    * (-math.log(10000.0) / (d // 2)))[:, None, None]
    pe = torch.zeros(d, h, w)
    pe[0::4] = torch.sin(x * div)
    pe[1::4] = torch.cos(x * div)
    pe[2::4] = torch.sin(y * div)
    pe[3::4] = torch.cos(y * div)
    return pe


def tokens(coarse: torch.Tensor, pe: torch.Tensor) -> torch.Tensor:
    """[B, d, h, w] + PE → [B, h·w, d] (row-major cells)."""
    return (coarse + pe).flatten(2).transpose(1, 2).contiguous()


def encoder_layer(p: dict, name: str, x: torch.Tensor, source: torch.Tensor,
                  heads: int) -> torch.Tensor:
    """``LoFTREncoderLayer``: x + norm2(mlp([x, norm1(merge(attn))]))."""
    d = x.shape[-1]
    msg = linear_attention(F.linear(x, p[f"{name}.q_proj.weight"]),
                           F.linear(source, p[f"{name}.k_proj.weight"]),
                           F.linear(source, p[f"{name}.v_proj.weight"]),
                           heads)
    msg = F.layer_norm(F.linear(msg, p[f"{name}.merge.weight"]), (d,),
                       p[f"{name}.norm1.weight"], p[f"{name}.norm1.bias"],
                       LN_EPS)
    msg = F.linear(torch.relu(F.linear(torch.cat([x, msg], -1),
                                       p[f"{name}.mlp.0.weight"])),
                   p[f"{name}.mlp.2.weight"])
    return x + F.layer_norm(msg, (d,), p[f"{name}.norm2.weight"],
                            p[f"{name}.norm2.bias"], LN_EPS)


def transformer(p: dict, name: str, layer_names, feat0, feat1, heads: int):
    """``LocalFeatureTransformer``: each "cross" layer updates feat0 from
    feat1, then feat1 from the updated feat0."""
    for i, kind in enumerate(layer_names):
        layer = f"{name}.layers.{i}"
        if kind == "self":
            feat0 = encoder_layer(p, layer, feat0, feat0, heads)
            feat1 = encoder_layer(p, layer, feat1, feat1, heads)
        else:
            feat0 = encoder_layer(p, layer, feat0, feat1, heads)
            feat1 = encoder_layer(p, layer, feat1, feat0, heads)
    return feat0, feat1


def interior(h: int, w: int, border: int, device=None) -> torch.Tensor:
    """[h·w] bool: the cells at least ``border`` cells from every edge."""
    y = torch.arange(h, device=device)[:, None]
    x = torch.arange(w, device=device)[None]
    keep = ((y >= border) & (y < h - border) & (x >= border)
            & (x < w - border))
    return keep.reshape(-1)


class CoarseMatches(NamedTuple):
    valid: torch.Tensor     # [V, N0] bool
    j: torch.Tensor         # [V, N0] int64, the frame cell of each slot
    conf: torch.Tensor      # [V, N0] the slot's conf (its row maximum)


def coarse_match(feat0, feat1, hw0, hw1, cfg: dict) -> CoarseMatches:
    """The dual softmax on the match kernel and LoFTR's mask rule (module
    docstring), view cells against frame cells."""
    mc = cfg["match_coarse"]
    scale = feat0.shape[-1] * mc["dsmax_temperature"]
    idx0, max0, idx1, _ = dual_softmax_argmax(feat0, feat1, scale)
    j = idx0.long()
    i = torch.arange(feat0.shape[1], device=feat0.device)
    mutual = idx1.long().gather(1, j) == i
    b = mc["border_rm"]
    valid = ((max0 > mc["thr"]) & mutual
             & interior(*hw0, b, feat0.device)[None]
             & interior(*hw1, b, feat0.device)[j])
    return CoarseMatches(valid, j, max0)


def cell_points(cells: torch.Tensor, w: int, stride: int) -> torch.Tensor:
    """Cell indices → their (x, y) in pixels, (i mod w, i div w)·stride."""
    return torch.stack([cells % w, cells // w], -1).float() * stride


def windows(proj: torch.Tensor, cells: torch.Tensor, w_cells: int,
            stride: int, size: int) -> torch.Tensor:
    """The size×size windows (row-major) of ``proj`` [B, Hf, Wf, C]
    centred at ``stride``·(x, y) of each cell, zero outside the map:
    ``F.unfold`` with padding size // 2, taken at ``cells`` [V, N] of map
    v (or of the one map, B = 1) → [V, N, size², C]."""
    r = size // 2
    pad = F.pad(proj, (0, 0, r, r, r, r))
    k = torch.arange(size, device=proj.device)
    rows = (cells // w_cells * stride)[..., None] + k
    cols = (cells % w_cells * stride)[..., None] + k
    b = 0 if proj.shape[0] == 1 else torch.arange(
        cells.shape[0], device=proj.device)[:, None, None, None]
    win = pad[b, rows[..., :, None], cols[..., None, :]]
    return win.flatten(-3, -2)


def expectation_offsets(feat0: torch.Tensor, feat1: torch.Tensor,
                        size: int, scale: float) -> torch.Tensor:
    """``fine_matching.py``: the heatmap softmax(f0[centre]·f1ᵀ/√C) over
    the window [M, size², C] and its spatial expectation on the
    normalised grid (x over columns, y over rows) × (size // 2) × scale →
    [M, 2] pixels."""
    c = feat0.shape[-1]
    centre = feat0[:, size * size // 2]
    sim = torch.einsum("mc,mrc->mr", centre, feat1)
    heat = torch.softmax(sim / math.sqrt(c), dim=1)
    g = torch.linspace(-1.0, 1.0, size, device=heat.device)
    grid = torch.stack([g.repeat(size), g.repeat_interleave(size)], -1)
    return heat @ grid * ((size // 2) * scale)


class Matches(NamedTuple):
    valid: torch.Tensor     # [V, N0] bool: a mutual coarse match
    points0: torch.Tensor   # [V, N0, 2] the view cell's point (px)
    points1: torch.Tensor   # [V, N0, 2] the refined frame point (px)
    conf: torch.Tensor      # [V, N0]
    j: torch.Tensor         # [V, N0] the frame cell


class Matcher:
    """LoFTR against fixed views. Built from a :class:`LoFTR` module (or
    its state dict) and the views [V, 1, h, w] on the module's device; the
    views' backbone, tokens and projected fine maps are computed once,
    here. A call takes one frame [1, 1, H, W] → :class:`Matches`, the
    span ``loftr`` with children ``loftr.backbone``, ``loftr.coarse``,
    ``loftr.match`` and ``loftr.fine``.

    ``last_matches`` is the last frame's count of mutual coarse matches,
    a device tensor (reading it waits for the frame). ``mark``, when set,
    is called with each stage's name at its end (``backbone``,
    ``coarse``, ``match``, ``fine``), for CUDA-event splits. A call given
    a dict ``keep`` puts the frame's maps (``coarse1``, ``fine1``) and the
    coarse transformer's output (``feat0``, ``feat1``) in it."""

    def __init__(self, model, views: torch.Tensor,
                 config: Optional[dict] = None):
        sd = model.state_dict() if isinstance(model, nn.Module) else model
        if isinstance(model, LoFTR) and config is None:
            config = model.config
        self.cfg = resolve_config(config)
        self.p = prepare(sd, self.cfg)
        self.coarse_stride, self.fine_stride = self.cfg["resolution"]
        # a coarse cell's step on the fine map (4): the windows' stride
        self.window_stride = self.coarse_stride // self.fine_stride
        self.mark: Optional[Callable[[str], None]] = None
        self.last_matches: Optional[torch.Tensor] = None
        self._pe = {}
        with torch.no_grad():
            c0, f0 = backbone(self.p, views)
            self.hw0 = tuple(c0.shape[2:])
            self.view_tokens = tokens(c0, self._position(*self.hw0, c0))
            n0 = self.view_tokens.shape[1]
            cells = torch.arange(n0, device=views.device)
            self.view_windows = windows(
                self._project(f0), cells.expand(views.shape[0], n0),
                self.hw0[1], self.window_stride, self.cfg["fine_window_size"])
            self.points0 = cell_points(cells, self.hw0[1],
                                       self.coarse_stride).expand(
                views.shape[0], n0, 2)

    def _position(self, h, w, like):
        if (h, w) not in self._pe:
            self._pe[(h, w)] = position_encoding(like.shape[1], h, w).to(
                like.device, like.dtype)
        return self._pe[(h, w)]

    def _project(self, fine: torch.Tensor) -> torch.Tensor:
        """merge_feat's window half on a fine map [B, C, Hf, Wf] →
        [B, Hf, Wf, C]."""
        return F.linear(fine.permute(0, 2, 3, 1), self.p["fine.window.weight"])

    def _marked(self, name: str) -> None:
        if self.mark is not None:
            self.mark(name)

    def coarse(self, coarse1: torch.Tensor):
        """The frame's coarse map [1, d, h, w] → the transformer's
        (feat0 [V, N0, d], feat1 [V, N1, d])."""
        c = self.cfg["coarse"]
        f1 = tokens(coarse1, self._position(*coarse1.shape[2:], coarse1))
        f1 = f1.expand(self.view_tokens.shape[0], -1, -1).contiguous()
        return transformer(self.p, "loftr_coarse", c["layer_names"],
                           self.view_tokens, f1, c["nhead"])

    def fine(self, fine1, feat0, feat1, j, w1: int) -> torch.Tensor:
        """Every slot's refined frame point [V, N0, 2]: the windows at its
        two cells, their coarse tokens, the fine transformer and the
        expectation."""
        p, cfg = self.p, self.cfg
        size = cfg["fine_window_size"]
        down = lambda f: F.linear(  # noqa: E731
            F.linear(f, p["fine.down.weight"], p["fine.down.bias"]),
            p["fine.token.weight"], p["fine.token.bias"])
        tok1 = feat1.gather(1, j[..., None].expand(-1, -1, feat1.shape[-1]))
        win1 = windows(self._project(fine1), j, w1, self.window_stride,
                       size)
        t0 = self.view_windows + down(feat0)[:, :, None]
        t1 = win1 + down(tok1)[:, :, None]
        v, n0 = j.shape
        f = cfg["fine"]
        t0, t1 = transformer(p, "loftr_fine", f["layer_names"],
                             t0.reshape(v * n0, size * size, -1),
                             t1.reshape(v * n0, size * size, -1), f["nhead"])
        off = expectation_offsets(t0, t1, size, self.fine_stride)
        return (cell_points(j, w1, self.coarse_stride)
                + off.reshape(v, n0, 2))

    @torch.no_grad()
    def __call__(self, frame: torch.Tensor,
                 keep: Optional[dict] = None) -> Matches:
        with span("loftr"):
            with span("loftr.backbone"):
                coarse1, fine1 = backbone(self.p, frame)
                self._marked("backbone")
            with span("loftr.coarse"):
                feat0, feat1 = self.coarse(coarse1)
                self._marked("coarse")
            hw1 = tuple(coarse1.shape[2:])
            with span("loftr.match"):
                m = coarse_match(feat0, feat1, self.hw0, hw1, self.cfg)
                self._marked("match")
            with span("loftr.fine"):
                points1 = self.fine(fine1, feat0, feat1, m.j, hw1[1])
                self._marked("fine")
        self.last_matches = m.valid.sum()
        if keep is not None:
            keep.update(coarse1=coarse1, fine1=fine1, feat0=feat0,
                        feat1=feat1)
        return Matches(m.valid, self.points0, points1, m.conf, m.j)
