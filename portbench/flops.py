"""Operations and bytes of the models' work, from the configuration's
shapes alone.

Operations are counted as ``torch.utils.flop_counter`` counts them: two
per multiply-add of every matrix product and convolution, and nothing for
elementwise work, softmax, norms, NMS or sorting. A product that a kernel
of the program computes is counted once, whatever the kernel does inside
(the stem and the match kernel run three TF32 products for each fp32
one). Bytes are a kernel's inputs read once and outputs written once, in
fp32. ``portbench/tests/test_pb_flops.py`` holds the counts to
``FlopCounterMode`` over the port on the CPU at small widths.
"""
from __future__ import annotations

F32 = 4


def conv(b, h, w, cin, cout, k):
    """A stride-1 SAME convolution producing [b, cout, h, w]."""
    return 2 * b * h * w * cin * cout * k * k


def stem(b, h, w):
    """conv1a (1→64) and conv1b (64→64), 3x3, at full resolution."""
    return conv(b, h, w, 1, 64, 3) + conv(b, h, w, 64, 64, 3)


def stem_bytes(b, h, w):
    """Image, both convolutions' weights and biases, pooled output."""
    weights = 9 * 64 + 64 + 9 * 64 * 64 + 64
    return F32 * (b * h * w + weights + b * (h // 2) * (w // 2) * 64)


def superpoint(b, h, w, d=256):
    """The VGG encoder (stem included) and both heads."""
    n = stem(b, h, w)
    n += conv(b, h // 2, w // 2, 64, 64, 3) * 2
    n += conv(b, h // 4, w // 4, 64, 128, 3) + conv(b, h // 4, w // 4, 128,
                                                    128, 3)
    hc, wc = h // 8, w // 8
    n += conv(b, hc, wc, 128, 128, 3) * 2
    n += conv(b, hc, wc, 128, 256, 3) * 2           # convPa, convDa
    n += conv(b, hc, wc, 256, 65, 1) + conv(b, hc, wc, 256, d, 1)
    return n


def linear_attention_step(b, n_x, n_s, d, heads):
    """One GATsSPG message-passing step of ``n_x`` tokens over ``n_s``
    source tokens: Q, K, V, elu+1 linear attention, merge, the MLP."""
    dh = d // heads
    n = 2 * b * n_x * d * d                          # Q
    n += 2 * b * n_s * d * 2 * d                     # K, V
    n += 2 * b * n_s * d * dh                        # K^T V
    n += 2 * b * n_x * d                             # normalizer
    n += 2 * b * n_x * d * dh                        # Q (K^T V)
    n += 2 * b * n_x * d * d                         # merge
    n += 2 * b * n_x * 2 * d * 2 * d                 # mlp0
    n += 2 * b * n_x * 2 * d * d                     # mlp1
    return n


def gats_layer(b, n2, leaf, d):
    """The trained GATs path: h @ (W a) for both halves, then the
    attention-weighted sum over each point and its leaves."""
    n = 2 * (2 * d * d)                              # W @ a[:d], W @ a[d:]
    n += 2 * b * n2 * leaf * d + 2 * b * n2 * d      # logits
    n += 2 * b * n2 * (1 + leaf) * d                 # aggregation
    return n


def gats_spg(b, n1, n2, leaf, d=256, heads=4, blocks=4):
    """GATsSPG's body, final projection and one S = m0 m1^T."""
    n = 0
    for _ in range(blocks):
        n += gats_layer(b, n2, leaf, d)
        for n_x, n_s in ((n1, n1), (n2, n2), (n1, n2), (n2, n1)):
            n += linear_attention_step(b, n_x, n_s, d, heads)
    n += 2 * b * (n1 + n2) * d * d
    return n + match(b, n1, n2, d)


def match(b, n1, n2, d):
    """S = mdesc0 · mdesc1^T, the dual-softmax kernel's product."""
    return 2 * b * n1 * n2 * d


def match_bytes(b, n1, n2, d):
    """Both descriptor sets in; argmax and max of every row and column
    out."""
    return F32 * b * (n1 + n2) * d + 2 * F32 * b * (n1 + n2)


def _mlp(b, n, channels):
    return sum(2 * b * n * channels[i - 1] * channels[i]
               for i in range(1, len(channels)))


def superglue(b, n0, n1, d=256, encoder=(32, 64, 128, 256), layers=18):
    """SuperGlue over b pairs: keypoint encoder on both sets, ``layers``
    softmax-attention layers on both sets, final projection and scores."""
    n = _mlp(b, n0, [3, *encoder]) + _mlp(b, n1, [3, *encoder])
    for i in range(layers):
        for n_x, n_other in ((n0, n1), (n1, n0)):
            n_s = n_other if i % 2 else n_x          # cross, self
            n += 2 * b * n_x * d * d + 2 * b * n_s * d * 2 * d   # Q; K, V
            n += 2 * 2 * b * n_x * n_s * d                       # QK^T, AV
            n += 2 * b * n_x * d * d                             # merge
            n += _mlp(b, n_x, [2 * d, 2 * d, d])
    n += 2 * b * (n0 + n1) * d * d
    return n + 2 * b * n0 * n1 * d
