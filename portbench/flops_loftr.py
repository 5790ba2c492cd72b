"""Operations of LoFTR's work in the detector, from the configuration's
shapes alone, counted as ``portbench/flops.py`` counts them (two per
multiply-add of every matrix product and convolution, nothing for
elementwise work, softmax, norms or gathers; the match kernel's product
once). ``portbench/tests/test_pb_loftr.py`` holds the counts to
``FlopCounterMode`` over the port on the CPU at small sizes."""
from __future__ import annotations

from portbench import flops


def backbone(b, h, w, initial=128, dims=(128, 196, 256)):
    """``ResNetFPN_8_2`` on [b, 1, h, w]: the 7×7 stem to 1/2, two
    BasicBlocks a stage (the first of stages 2 and 3 strided, with a 1×1
    downsample), the FPN's 1×1 and 3×3 convolutions at 1/8, 1/4 and 1/2."""
    d1, d2, d3 = dims
    h2, w2, h4, w4, h8, w8 = h // 2, w // 2, h // 4, w // 4, h // 8, w // 8
    n = flops.conv(b, h2, w2, 1, initial, 7)
    n += flops.conv(b, h2, w2, initial, d1, 3) + 3 * flops.conv(
        b, h2, w2, d1, d1, 3)
    n += flops.conv(b, h4, w4, d1, d2, 3) + 3 * flops.conv(b, h4, w4, d2, d2,
                                                           3)
    n += flops.conv(b, h4, w4, d1, d2, 1)                       # downsample
    n += flops.conv(b, h8, w8, d2, d3, 3) + 3 * flops.conv(b, h8, w8, d3, d3,
                                                           3)
    n += flops.conv(b, h8, w8, d2, d3, 1)                       # downsample
    n += flops.conv(b, h8, w8, d3, d3, 1)                       # layer3_out
    n += flops.conv(b, h4, w4, d2, d3, 1) + flops.conv(b, h4, w4, d3, d3, 3) \
        + flops.conv(b, h4, w4, d3, d2, 3)                      # layer2_out
    n += flops.conv(b, h2, w2, d1, d2, 1) + flops.conv(b, h2, w2, d2, d2, 3) \
        + flops.conv(b, h2, w2, d2, d1, 3)                      # layer1_out
    return n


def transformer(b, n0, n1, d, heads, layer_names):
    """``LocalFeatureTransformer``: each layer is GATsSPG's linear
    attention step (Q, K, V, elu+1 attention, merge, the 2d MLP), "self"
    on both sets, "cross" each set against the other."""
    n = 0
    for kind in layer_names:
        pairs = ((n0, n0), (n1, n1)) if kind == "self" else ((n0, n1),
                                                             (n1, n0))
        for n_x, n_s in pairs:
            n += flops.linear_attention_step(b, n_x, n_s, d, heads)
    return n


def fine(m, window, d_coarse, d_fine, heads, layer_names):
    """The fine stage over ``m`` slots: ``down_proj`` and ``merge_feat``'s
    token half of both coarse tokens, the fine transformer on the
    window² tokens of both sides, the heatmap's products and the
    expectation. (``merge_feat``'s window half is a 1×1 map of the fine
    maps: :func:`window_projection`.)"""
    ww = window * window
    n = 2 * 2 * m * d_coarse * d_fine + 2 * 2 * m * d_fine * d_fine
    n += transformer(m, ww, ww, d_fine, heads, layer_names)
    return n + 2 * m * ww * d_fine + 2 * m * ww * 2


def window_projection(b, hf, wf, d_fine):
    return 2 * b * hf * wf * d_fine * d_fine


def views(v, h, w, cfg):
    """The set-up's work on the views: their backbone and projection."""
    r = cfg["resnetfpn"]
    return backbone(v, h, w, r["initial_dim"], r["block_dims"]) + \
        window_projection(v, h // 2, w // 2, cfg["fine"]["d_model"])


def frame(v, view, size, cfg):
    """One frame [size] against ``v`` views of shape ``view``: the frame's
    backbone, the coarse transformer over the v pairs, one S, the
    projection of the frame's fine map and the fine stage over every slot
    of the slate (v × the view's cells)."""
    (vh, vw), (h, w) = view, size
    s_c, s_f = cfg["resolution"]
    c, f, r = cfg["coarse"], cfg["fine"], cfg["resnetfpn"]
    n0, n1 = vh // s_c * (vw // s_c), h // s_c * (w // s_c)
    n = backbone(1, h, w, r["initial_dim"], r["block_dims"])
    n += transformer(v, n0, n1, c["d_model"], c["nhead"], c["layer_names"])
    n += flops.match(v, n0, n1, c["d_model"])
    n += window_projection(1, h // s_f, w // s_f, f["d_model"])
    return n + fine(v * n0, cfg["fine_window_size"], c["d_model"],
                    f["d_model"], f["nhead"], f["layer_names"])
