"""Plain reference of LoFTR (Sun et al., CVPR 2021; github.com/zju3dv/LoFTR,
``src/loftr/``), in fp32, for tests and the benchmark's check.

Plain ``torch`` operations that follow the published code: ``ResNetFPN_8_2``
with explicit BatchNorm in eval mode, the sine positional encoding built
at its maximum shape and cut, the linear-attention transformer with
contiguous heads, the dual softmax over the full conf matrix with
``mask_border`` and the mutual-nearest mask, ``FinePreprocess``'s
``F.unfold`` windows on the matched rows only, and ``FineMatching``'s
spatial expectation. Weights come from a state dict under LoFTR's module
names. Every public function runs with ``allow_tf32`` off for cuBLAS and
cuDNN (its ``tf32`` argument turns both on, for a control).

Departures from the published code:

- Set 0 is V views and set 1 one frame paired with each of them: the
  frame's backbone runs once and its maps are expanded over the pairs
  (BatchNorm in eval mode treats each image alone, so this equals running
  it V times).
- ``kornia``'s ``create_meshgrid`` and ``spatial_expectation2d`` are
  written out: a grid of ``linspace(-1, 1, W)`` in x over the columns and
  in y over the rows, and the heatmap's weighted sum of it.
- The training-time branches (ground-truth padding of matches, the
  ``std`` of the expectation) and masks for padded images are left out:
  the images are not padded.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
LN_EPS = 1e-5


class _Precision:
    """TF32 for cuBLAS and cuDNN set to ``tf32`` inside, restored after."""

    def __init__(self, tf32: bool):
        self.tf32 = tf32

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
        return False


def _fp32(fn):
    """Run ``fn`` with TF32 off (on with ``tf32=True``), without grad."""
    def run(*args, tf32: bool = False, **kwargs):
        with _Precision(tf32), torch.no_grad():
            return fn(*args, **kwargs)
    run.__name__, run.__doc__ = fn.__name__, fn.__doc__
    return run


# ---- backbone/resnet_fpn.py ------------------------------------------------

def _bn(sd, name, x):
    return F.batch_norm(x, sd[f"{name}.running_mean"],
                        sd[f"{name}.running_var"], sd[f"{name}.weight"],
                        sd[f"{name}.bias"], False, 0.0, BN_EPS)


def _conv(sd, name, x, stride=1):
    w = sd[f"{name}.weight"]
    return F.conv2d(x, w, None, stride, w.shape[-1] // 2)


def _basic_block(sd, name, x, stride):
    y = torch.relu(_bn(sd, f"{name}.bn1", _conv(sd, f"{name}.conv1", x,
                                                stride)))
    y = _bn(sd, f"{name}.bn2", _conv(sd, f"{name}.conv2", y))
    if stride != 1:
        x = _bn(sd, f"{name}.downsample.1",
                _conv(sd, f"{name}.downsample.0", x, stride))
    return torch.relu(x + y)


def _layer(sd, name, x, stride):
    return _basic_block(sd, f"{name}.1",
                        _basic_block(sd, f"{name}.0", x, stride), 1)


def _outconv2(sd, name, x):
    y = _bn(sd, f"{name}.1", _conv(sd, f"{name}.0", x))
    return _conv(sd, f"{name}.3", F.leaky_relu(y, 0.01))


@_fp32
def backbone(sd: dict, x: torch.Tensor):
    """``ResNetFPN_8_2.forward``: [B, 1, H, W] → [coarse 1/8, fine 1/2]."""
    return _fpn(sd, *_body(sd, x))


@_fp32
def backbone_body(sd: dict, x: torch.Tensor):
    """The ResNet half of ``backbone``: [B, 1, H, W] → its three stages'
    outputs (x1 1/2, x2 1/4, x3 1/8)."""
    return _body(sd, x)


@_fp32
def backbone_fpn(sd: dict, x1, x2, x3):
    """The FPN half of ``backbone``: the three stages' outputs →
    [coarse 1/8, fine 1/2]."""
    return _fpn(sd, x1, x2, x3)


def _backbone_sd(sd: dict) -> dict:
    return {k[len("backbone."):]: v for k, v in sd.items()
            if k.startswith("backbone.")}


def _body(sd, x):
    sd = _backbone_sd(sd)
    x0 = torch.relu(_bn(sd, "bn1", _conv(sd, "conv1", x, 2)))
    x1 = _layer(sd, "layer1", x0, 1)
    x2 = _layer(sd, "layer2", x1, 2)
    return x1, x2, _layer(sd, "layer3", x2, 2)


def _fpn(sd, x1, x2, x3):
    sd = _backbone_sd(sd)
    x3_out = _conv(sd, "layer3_outconv", x3)
    x3_out_2x = F.interpolate(x3_out, scale_factor=2.0, mode="bilinear",
                              align_corners=True)
    x2_out = _conv(sd, "layer2_outconv", x2)
    x2_out = _outconv2(sd, "layer2_outconv2", x2_out + x3_out_2x)
    x2_out_2x = F.interpolate(x2_out, scale_factor=2.0, mode="bilinear",
                              align_corners=True)
    x1_out = _conv(sd, "layer1_outconv", x1)
    x1_out = _outconv2(sd, "layer1_outconv2", x1_out + x2_out_2x)
    return x3_out, x1_out


# ---- utils/position_encoding.py --------------------------------------------

def position_encoding(d_model: int, max_shape=(256, 256)) -> torch.Tensor:
    """``PositionEncodingSine`` with ``temp_bug_fix``: the [1, d, 256, 256]
    buffer."""
    pe = torch.zeros((d_model, *max_shape))
    y_position = torch.ones(max_shape).cumsum(0).float().unsqueeze(0)
    x_position = torch.ones(max_shape).cumsum(1).float().unsqueeze(0)
    div_term = torch.exp(torch.arange(0, d_model // 2, 2).float()
                         * (-math.log(10000.0) / (d_model // 2)))
    div_term = div_term[:, None, None]
    pe[0::4, :, :] = torch.sin(x_position * div_term)
    pe[1::4, :, :] = torch.cos(x_position * div_term)
    pe[2::4, :, :] = torch.sin(y_position * div_term)
    pe[3::4, :, :] = torch.cos(y_position * div_term)
    return pe.unsqueeze(0)


def add_position_encoding(x: torch.Tensor) -> torch.Tensor:
    """x [N, C, H, W] + the buffer cut to H×W, as [N, H·W, C]."""
    pe = position_encoding(x.shape[1]).to(x.device)
    x = x + pe[:, :, :x.size(2), :x.size(3)]
    return x.flatten(2).transpose(1, 2)


# ---- loftr_module/linear_attention.py, transformer.py ----------------------

def linear_attention(queries, keys, values, eps=1e-6):
    """``LinearAttention.forward`` on [N, L, H, D] (no masks)."""
    Q = F.elu(queries) + 1
    K = F.elu(keys) + 1
    v_length = values.size(1)
    values = values / v_length
    KV = torch.einsum("nshd,nshv->nhdv", K, values)
    Z = 1 / (torch.einsum("nlhd,nhd->nlh", Q, K.sum(dim=1)) + eps)
    return torch.einsum("nlhd,nhdv,nlh->nlhv", Q, KV, Z) * v_length


def encoder_layer(sd, name, x, source, nhead):
    """``LoFTREncoderLayer.forward``."""
    bs, d = x.size(0), x.size(2)
    dim = d // nhead
    query = F.linear(x, sd[f"{name}.q_proj.weight"]).view(bs, -1, nhead, dim)
    key = F.linear(source, sd[f"{name}.k_proj.weight"]).view(bs, -1, nhead,
                                                             dim)
    value = F.linear(source, sd[f"{name}.v_proj.weight"]).view(bs, -1, nhead,
                                                               dim)
    message = linear_attention(query, key, value)
    message = F.linear(message.reshape(bs, -1, nhead * dim),
                       sd[f"{name}.merge.weight"])
    message = F.layer_norm(message, (d,), sd[f"{name}.norm1.weight"],
                           sd[f"{name}.norm1.bias"], LN_EPS)
    message = F.linear(torch.relu(F.linear(torch.cat([x, message], dim=2),
                                           sd[f"{name}.mlp.0.weight"])),
                       sd[f"{name}.mlp.2.weight"])
    message = F.layer_norm(message, (d,), sd[f"{name}.norm2.weight"],
                           sd[f"{name}.norm2.bias"], LN_EPS)
    return x + message


@_fp32
def transformer(sd, name, layer_names, feat0, feat1, nhead):
    """``LocalFeatureTransformer.forward``."""
    for i, kind in enumerate(layer_names):
        layer = f"{name}.layers.{i}"
        if kind == "self":
            feat0 = encoder_layer(sd, layer, feat0, feat0, nhead)
            feat1 = encoder_layer(sd, layer, feat1, feat1, nhead)
        elif kind == "cross":
            feat0 = encoder_layer(sd, layer, feat0, feat1, nhead)
            feat1 = encoder_layer(sd, layer, feat1, feat0, nhead)
        else:
            raise KeyError(kind)
    return feat0, feat1


# ---- utils/coarse_matching.py ----------------------------------------------

class CoarseMatches(NamedTuple):
    b_ids: torch.Tensor
    i_ids: torch.Tensor
    j_ids: torch.Tensor
    mconf: torch.Tensor
    conf_matrix: torch.Tensor


def mask_border(m, b: int, v):
    """m [N, H0, W0, H1, W1]: the cells within ``b`` of a border set to v."""
    if b <= 0:
        return
    m[:, :b] = v
    m[:, :, :b] = v
    m[:, :, :, :b] = v
    m[:, :, :, :, :b] = v
    m[:, -b:] = v
    m[:, :, -b:] = v
    m[:, :, :, -b:] = v
    m[:, :, :, :, -b:] = v


@_fp32
def coarse_match(feat_c0, feat_c1, hw0_c, hw1_c, thr=0.2, border_rm=2,
                 temperature=0.1) -> CoarseMatches:
    """``CoarseMatching.forward`` (dual softmax) and ``get_coarse_match``
    at inference: the conf matrix, thresholding, ``mask_border``, mutual
    nearest, the first True of each row."""
    feat_c0, feat_c1 = (f / f.shape[-1] ** .5 for f in (feat_c0, feat_c1))
    sim_matrix = torch.einsum("nlc,nsc->nls", feat_c0,
                              feat_c1) / temperature
    conf_matrix = F.softmax(sim_matrix, 1) * F.softmax(sim_matrix, 2)
    n = conf_matrix.shape[0]
    mask = conf_matrix > thr
    mask = mask.reshape(n, *hw0_c, *hw1_c)
    mask_border(mask, border_rm, False)
    mask = mask.reshape(n, hw0_c[0] * hw0_c[1], hw1_c[0] * hw1_c[1])
    mask = mask \
        * (conf_matrix == conf_matrix.max(dim=2, keepdim=True)[0]) \
        * (conf_matrix == conf_matrix.max(dim=1, keepdim=True)[0])
    mask_v, all_j_ids = mask.max(dim=2)
    b_ids, i_ids = torch.where(mask_v)
    j_ids = all_j_ids[b_ids, i_ids]
    mconf = conf_matrix[b_ids, i_ids, j_ids]
    keep = mconf != 0
    return CoarseMatches(b_ids[keep], i_ids[keep], j_ids[keep], mconf[keep],
                         conf_matrix)


def coarse_points(ids, w_c, scale):
    """``mkpts_c``: (i % w, i // w) · scale."""
    return torch.stack([ids % w_c, ids // w_c], dim=1) * scale


# ---- loftr_module/fine_preprocess.py, utils/fine_matching.py ---------------

@_fp32
def fine_preprocess(sd, feat_f0, feat_f1, feat_c0, feat_c1, b_ids, i_ids,
                    j_ids, W=5, stride=4):
    """``FinePreprocess.forward`` with ``fine_concat_coarse_feat``:
    [M, W², C_f] windows of both images for the matched rows."""
    d_f = feat_f0.shape[1]
    if b_ids.shape[0] == 0:
        empty = torch.empty(0, W ** 2, d_f, device=feat_f0.device)
        return empty, empty
    f0 = F.unfold(feat_f0, kernel_size=(W, W), stride=stride, padding=W // 2)
    f0 = f0.reshape(f0.shape[0], d_f, W ** 2, -1).permute(0, 3, 2, 1)
    f1 = F.unfold(feat_f1, kernel_size=(W, W), stride=stride, padding=W // 2)
    f1 = f1.reshape(f1.shape[0], d_f, W ** 2, -1).permute(0, 3, 2, 1)
    f0 = f0[b_ids, i_ids]
    f1 = f1[b_ids, j_ids]
    feat_c_win = F.linear(torch.cat([feat_c0[b_ids, i_ids],
                                     feat_c1[b_ids, j_ids]], 0),
                          sd["fine_preprocess.down_proj.weight"],
                          sd["fine_preprocess.down_proj.bias"])
    feat_cf_win = F.linear(torch.cat([
        torch.cat([f0, f1], 0),
        feat_c_win[:, None, :].expand(-1, W ** 2, -1)], -1),
        sd["fine_preprocess.merge_feat.weight"],
        sd["fine_preprocess.merge_feat.bias"])
    return torch.chunk(feat_cf_win, 2, dim=0)


@_fp32
def fine_offsets(feat_f0, feat_f1, scale=2.0):
    """``FineMatching.forward`` → the offset added to ``mkpts1_c``:
    coords_normalized · (W // 2) · scale, [M, 2]."""
    M, WW, C = feat_f0.shape
    if M == 0:
        return feat_f0.new_zeros(0, 2)
    W = int(math.sqrt(WW))
    feat_f0_picked = feat_f0[:, WW // 2, :]
    sim_matrix = torch.einsum("mc,mrc->mr", feat_f0_picked, feat_f1)
    softmax_temp = 1. / C ** .5
    heatmap = torch.softmax(softmax_temp * sim_matrix, dim=1).view(-1, W, W)
    xs = torch.linspace(-1, 1, W, device=heatmap.device)
    ys = torch.linspace(-1, 1, W, device=heatmap.device)
    pos_x = xs[None, :].expand(W, W).reshape(-1)
    pos_y = ys[:, None].expand(W, W).reshape(-1)
    flat = heatmap.view(M, WW)
    coords_normalized = torch.stack([torch.sum(pos_x * flat, -1),
                                     torch.sum(pos_y * flat, -1)], -1)
    return coords_normalized * (W // 2) * scale


# ---- loftr.py ---------------------------------------------------------------

class Result(NamedTuple):
    coarse0: torch.Tensor       # [V, 256, h0, w0] views' backbone maps
    fine0: torch.Tensor
    coarse1: torch.Tensor       # [1, 256, h1, w1] the frame's
    fine1: torch.Tensor
    feat_c0: torch.Tensor       # [V, N0, 256] the coarse transformer's out
    feat_c1: torch.Tensor       # [V, N1, 256]
    matches: CoarseMatches
    mkpts0_f: torch.Tensor      # [M, 2] view points of the matches
    mkpts1_f: torch.Tensor      # [M, 2] refined frame points


def match(sd: dict, views: torch.Tensor, frame: torch.Tensor, config: dict,
          tf32: bool = False) -> Result:
    """``LoFTR.forward`` on V pairs (view b, the frame): views [V, 1, h, w],
    frame [1, 1, H, W]; ``config`` as ``models/loftr.DEFAULT_CONFIG``."""
    c, mc = config["coarse"], config["match_coarse"]
    coarse0, fine0 = backbone(sd, views, tf32=tf32)
    coarse1, fine1 = backbone(sd, frame, tf32=tf32)
    v = views.shape[0]
    hw0, hw1 = tuple(coarse0.shape[2:]), tuple(coarse1.shape[2:])
    feat_c0, feat_c1 = transformer(
        sd, "loftr_coarse", c["layer_names"], add_position_encoding(coarse0),
        add_position_encoding(coarse1).expand(v, -1, -1), c["nhead"],
        tf32=tf32)
    m = coarse_match(feat_c0, feat_c1, hw0, hw1, mc["thr"], mc["border_rm"],
                     mc["dsmax_temperature"], tf32=tf32)
    mkpts0_f, mkpts1_f = fine(sd, config, fine0, fine1.expand(v, -1, -1, -1),
                              feat_c0, feat_c1, m, hw0, hw1, tf32=tf32)
    return Result(coarse0, fine0, coarse1, fine1, feat_c0, feat_c1, m,
                  mkpts0_f, mkpts1_f)


def fine(sd, config, fine0, fine1, feat_c0, feat_c1, m, hw0, hw1,
         tf32: bool = False):
    """The fine stage of the matches ``m`` (b_ids, i_ids, j_ids):
    (mkpts0_f, mkpts1_f), each [M, 2]."""
    f = config["fine"]
    s_c, s_f = config["resolution"]
    W = config["fine_window_size"]
    f0, f1 = fine_preprocess(sd, fine0, fine1, feat_c0, feat_c1, m.b_ids,
                             m.i_ids, m.j_ids, W, s_c // s_f, tf32=tf32)
    if f0.shape[0] != 0:
        f0, f1 = transformer(sd, "loftr_fine", f["layer_names"], f0, f1,
                             f["nhead"], tf32=tf32)
    mkpts0 = coarse_points(m.i_ids, hw0[1], s_c).float()
    mkpts1 = coarse_points(m.j_ids, hw1[1], s_c).float()
    return mkpts0, mkpts1 + fine_offsets(f0, f1, float(s_f), tf32=tf32)
