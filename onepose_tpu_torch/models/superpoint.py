"""SuperPoint keypoint detector and descriptor, on tensors.

Port of ``onepose_tpu/models/superpoint.py``: VGG-style shared encoder,
65-channel detector head with channel softmax and 8x depth-to-space,
two-round max-pool NMS, threshold and border masks, a static top-K with
the lower index winning ties, and bilinear descriptor sampling. Every
image yields exactly ``max_keypoints`` slots with a validity mask.

Images come in NHWC ``[B, H, W, 1]`` as in the JAX package; the encoder
runs NCHW inside. In fp32 (the default) the stem (conv1a, conv1b, pool)
goes through ``ops.stem.fused_stem``: the hand-written kernel on a CUDA
tensor, its plain version on a CPU one. ``stem_dtype="bfloat16"`` runs the
stem's convolutions in bf16, and ``compute_dtype="bfloat16"`` the whole
encoder, with ``F.conv2d`` as the JAX package runs XLA convolutions there
(no Pallas kernel computes in bf16). The JAX package's polyphase stem and
two-stage top-k are TPU reformulations of the same math and are not
ported: ``stem="polyphase"`` computes the direct stem.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from onepose_tpu_torch.ops.stem import fused_stem

DEFAULT_CONFIG = {
    "descriptor_dim": 256,
    "nms_radius": 4,
    "keypoint_threshold": 0.005,
    "max_keypoints": 1024,
    "remove_borders": 4,
    # "bfloat16": the encoder in bf16; the detector softmax and the
    # descriptor normalization stay fp32
    "compute_dtype": "float32",
    # "bfloat16": conv1a and conv1b in bf16, the rest at compute_dtype
    "stem_dtype": "float32",
    # "polyphase" (the JAX default, a TPU layout) and "direct" compute the
    # same stem here
    "stem": "polyphase",
}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
STEMS = ("polyphase", "direct")

# (name, in, out); "pool" entries mark 2x2 max-pool boundaries
ENCODER_CHANNELS = [
    ("conv1a", 1, 64), ("conv1b", 64, 64), ("pool",),
    ("conv2a", 64, 64), ("conv2b", 64, 64), ("pool",),
    ("conv3a", 64, 128), ("conv3b", 128, 128), ("pool",),
    ("conv4a", 128, 128), ("conv4b", 128, 128),
]
HEADS = [("convPa", 128, 256, 3), ("convPb", 256, 65, 1),
         ("convDa", 128, 256, 3)]


class SuperPointOutput(NamedTuple):
    keypoints: torch.Tensor    # [B, K, 2] (x, y); image centre where ~mask
    scores: torch.Tensor       # [B, K]; 0 where ~mask
    descriptors: torch.Tensor  # [B, K, D] unit norm; all ones where ~mask
    mask: torch.Tensor         # [B, K] bool


class SuperPoint(nn.Module):
    """The network's weights, named as in the reference checkpoint
    (``superpoint_v1.pth``), so its state dict loads as it is."""

    def __init__(self, descriptor_dim: int = 256):
        super().__init__()
        for entry in ENCODER_CHANNELS:
            if entry[0] != "pool":
                name, cin, cout = entry
                setattr(self, name, nn.Conv2d(cin, cout, 3, padding=1))
        for name, cin, cout, k in HEADS:
            setattr(self, name, nn.Conv2d(cin, cout, k, padding=k // 2))
        self.convDb = nn.Conv2d(256, descriptor_dim, 1)


def _dtype(config: dict, key: str) -> torch.dtype:
    name = str(config.get(key, "float32"))
    if name not in DTYPES:
        raise ValueError(f"{key}={name}: the port computes SuperPoint in "
                         f"{' or '.join(DTYPES)}")
    return DTYPES[name]


def check_config(config: dict) -> None:
    """Refuse a dtype or stem that the port does not have."""
    _dtype(config, "compute_dtype")
    _dtype(config, "stem_dtype")
    if config.get("stem", "polyphase") not in STEMS:
        raise ValueError(f"stem={config['stem']}: one of {STEMS}")


def entry_preset(cfg) -> dict:
    """SuperPoint's dtypes and stem in the eval entries, as the root
    ``inference.py`` and ``inference_demo.py`` set them: a bf16 direct stem
    and a bf16 encoder by default; ``stem_dtype=float32`` alone selects the
    polyphase stem and an fp32 encoder; each key may also be set alone."""
    stem_dtype = str(cfg.get("stem_dtype", "bfloat16"))
    bf16 = stem_dtype == "bfloat16"
    return {"stem_dtype": stem_dtype,
            "stem": str(cfg.get("stem", "direct" if bf16 else "polyphase")),
            "compute_dtype": str(cfg.get("compute_dtype",
                                         "bfloat16" if bf16 else "float32"))}


def _hwio(conv: nn.Conv2d) -> torch.Tensor:
    return conv.weight.permute(2, 3, 1, 0).contiguous()


def _conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
          padding: int) -> torch.Tensor:
    """A convolution in x's dtype: in fp32 with the bias inside the
    product (``nn.Conv2d``'s), in bf16 with the bias added after the
    product is rounded to bf16 (XLA's ``conv + b``)."""
    if x.dtype == torch.float32:
        return F.conv2d(x, weight, bias, padding=padding)
    return (F.conv2d(x, weight.to(x.dtype), padding=padding)
            + bias.to(x.dtype)[:, None, None])


def _relu_conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    return F.relu(_conv(x, conv.weight, conv.bias, conv.padding[0]))


def dense_heads(model: SuperPoint, images: torch.Tensor,
                compute_dtype: str = "float32",
                stem_dtype: str = "float32", stem: str = "polyphase"):
    """Shared encoder + both heads.

    images [B, H, W, 1] in [0, 1], H and W divisible by 8 → (scores
    [B, H, W], desc_coarse [B, H/8, W/8, D] unit norm), both fp32.

    The JAX package's ``dense_heads`` modes: all fp32 (the stem kernel);
    ``stem_dtype="bfloat16"`` under an fp32 encoder (the stem's convs and
    pool in bf16, cast to fp32); ``compute_dtype="bfloat16"`` (weights and
    images in bf16, the stem kernel skipped, the detector logits and the
    descriptor conv cast to fp32 before the softmax and the norm)."""
    cfg = {"compute_dtype": compute_dtype, "stem_dtype": stem_dtype,
           "stem": stem}
    check_config(cfg)
    cdt = _dtype(cfg, "compute_dtype")
    sdt = _dtype(cfg, "stem_dtype") if cdt == torch.float32 else cdt
    if sdt == torch.float32:
        x = fused_stem(images.float(), _hwio(model.conv1a),
                       model.conv1a.bias, _hwio(model.conv1b),
                       model.conv1b.bias).permute(0, 3, 1, 2)
    else:   # the direct stem in bf16
        x = images.permute(0, 3, 1, 2).to(sdt)
        x = _relu_conv(_relu_conv(x, model.conv1a), model.conv1b)
        x = F.max_pool2d(x, 2).to(cdt)
    for entry in ENCODER_CHANNELS[3:]:
        if entry[0] == "pool":
            x = F.max_pool2d(x, 2)
        else:
            x = _relu_conv(x, getattr(model, entry[0]))

    # both heads' first convs read the same trunk output: one 128→512 conv
    w_heads = torch.cat([model.convPa.weight, model.convDa.weight])
    b_heads = torch.cat([model.convPa.bias, model.convDa.bias])
    heads = F.relu(_conv(x, w_heads, b_heads, 1))
    cpa, cda = heads[:, :256], heads[:, 256:]
    logits = _conv(cpa, model.convPb.weight, model.convPb.bias, 0)
    desc = _conv(cda, model.convDb.weight, model.convDb.bias, 0)

    # detector head: 65-channel softmax, dustbin dropped, 8x depth-to-space
    probs = torch.softmax(logits.float(), dim=1)[:, :-1]
    scores = F.pixel_shuffle(probs, 8)[:, 0]

    desc = desc.float()
    desc = desc / torch.clamp(
        torch.linalg.vector_norm(desc, dim=1, keepdim=True), min=1e-12)
    return scores, desc.permute(0, 2, 3, 1)


def _maxpool_same(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Max-pool [B, H, W] with window 2r+1, stride 1, SAME (-inf) padding."""
    k = 2 * radius + 1
    return F.max_pool2d(x[:, None], k, stride=1, padding=radius)[:, 0]


def _maxpool_or(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Boolean dilation of [B, H, W] with window 2r+1, stride 1, SAME."""
    return _maxpool_same(mask.to(torch.float32), radius) > 0


def simple_nms(scores: torch.Tensor, nms_radius: int) -> torch.Tensor:
    """Max-pool NMS with the reference's two suppression rounds, each
    re-admitting local maxima of the suppressed map."""
    zeros = torch.zeros_like(scores)
    max_mask = scores == _maxpool_same(scores, nms_radius)
    for _ in range(2):
        supp_mask = _maxpool_or(max_mask, nms_radius)
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == _maxpool_same(supp_scores, nms_radius)
        max_mask = max_mask | (new_max_mask & ~supp_mask)
    return torch.where(max_mask, scores, zeros)


def _bilinear_sample_desc(desc: torch.Tensor, kpts_xy: torch.Tensor,
                          s: int = 8) -> torch.Tensor:
    """Sample coarse descriptors at keypoint pixels.

    The reference coordinate map ((kpt - s/2 + 0.5) / (dim*s - s/2 - 0.5))
    * 2 - 1, bilinear with align_corners=True and zero padding, then L2
    normalization. desc [B, Hc, Wc, D]; kpts_xy [B, K, 2] → [B, K, D]."""
    b, hc, wc, d = desc.shape
    denom = torch.tensor([wc * s - s / 2.0 - 0.5, hc * s - s / 2.0 - 0.5],
                         dtype=torch.float32, device=desc.device)
    g = (kpts_xy - s / 2.0 + 0.5) / denom * 2.0 - 1.0
    fx = (g[..., 0] + 1.0) * 0.5 * (wc - 1)
    fy = (g[..., 1] + 1.0) * 0.5 * (hc - 1)
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    bi = torch.arange(b, device=desc.device)[:, None]

    def gather(yi, xi):
        inb = (yi >= 0) & (yi < hc) & (xi >= 0) & (xi < wc)
        vals = desc[bi, yi.clamp(0, hc - 1).long(), xi.clamp(0, wc - 1).long()]
        return torch.where(inb[..., None], vals, 0.0)

    out = (gather(y0, x0) * ((1 - tx) * (1 - ty))
           + gather(y0, x0 + 1) * (tx * (1 - ty))
           + gather(y0 + 1, x0) * ((1 - tx) * ty)
           + gather(y0 + 1, x0 + 1) * (tx * ty))
    return out / torch.clamp(
        torch.linalg.vector_norm(out, dim=-1, keepdim=True), min=1e-12)


def select_keypoints(scores: torch.Tensor, desc: torch.Tensor,
                     config: dict) -> SuperPointOutput:
    """Static top-K keypoint selection, batched.

    scores [B, H, W] after NMS; desc [B, Hc, Wc, D]."""
    b, h, w = scores.shape
    k = config["max_keypoints"]
    border = config["remove_borders"]
    dev = scores.device
    row = torch.arange(h, device=dev)[:, None]
    col = torch.arange(w, device=dev)[None, :]
    border_ok = ((row >= border) & (row < h - border)
                 & (col >= border) & (col < w - border))
    masked = torch.where(border_ok & (scores > config["keypoint_threshold"]),
                         scores, -1.0).reshape(b, h * w)
    # the lower index wins ties, as in jax.lax.top_k: simple_nms keeps
    # every pixel of a tied plateau, and torch.topk promises no tie order
    top_scores, top_idx = torch.sort(masked, dim=1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    kpts = torch.stack([(top_idx % w).float(), (top_idx // w).float()], -1)
    valid = top_scores > 0.0

    descs = _bilinear_sample_desc(desc, kpts)
    # invalid slots: dustbin descriptors, score 0, parked at the centre
    descs = torch.where(valid[..., None], descs, 1.0)
    out_scores = torch.where(valid, top_scores, 0.0)
    centre = torch.tensor([w / 2.0, h / 2.0], device=dev)
    kpts = torch.where(valid[..., None], kpts, centre)
    return SuperPointOutput(kpts, out_scores, descs, valid)


@torch.no_grad()
def extract(model: SuperPoint, images: torch.Tensor,
            config: dict | None = None) -> SuperPointOutput:
    """images [B, H, W, 1] in [0, 1] → static-shape keypoints."""
    cfg = dict(DEFAULT_CONFIG)
    cfg.update(config or {})
    if cfg["max_keypoints"] is None or cfg["max_keypoints"] < 0:
        raise ValueError("SuperPoint needs a static max_keypoints budget")
    scores, desc = dense_heads(model, images, cfg["compute_dtype"],
                               cfg["stem_dtype"], cfg["stem"])
    return select_keypoints(simple_nms(scores, cfg["nms_radius"]), desc, cfg)
