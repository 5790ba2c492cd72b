"""The analytic operation counts against FlopCounterMode over the port's
models on the CPU, at small widths."""
from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import flops, weights


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("b,h,w,d", [(2, 64, 96, 64), (1, 48, 40, 256)])
def test_superpoint(b, h, w, d):
    from onepose_tpu_torch.models import superpoint

    sd = weights.make_weights(weights.superpoint_shapes(
        {"descriptor_dim": d}), 1, "sp", "cpu")
    model = weights.load_module(superpoint.SuperPoint, sd, d)
    img = torch.rand(b, h, w, 1)
    assert counted(lambda: superpoint.dense_heads(model, img)) == \
        flops.superpoint(b, h, w, d)


def test_stem_is_part_of_superpoint():
    assert flops.stem(8, 512, 512) == 2 * 8 * 512 * 512 * 9 * (64 + 64 * 64)
    assert flops.stem_bytes(8, 512, 512) == 4 * (8 * 512 * 512 + 37568
                                                 + 8 * 256 * 256 * 64)


@pytest.mark.parametrize("b,n1,n2,leaf,d,blocks", [(2, 40, 24, 3, 32, 2),
                                                   (1, 16, 32, 8, 64, 1)])
def test_gats_spg(b, n1, n2, leaf, d, blocks):
    from onepose_tpu_torch.models import gats_spg

    cfg = dict(gats_spg.DEFAULT_CONFIG, descriptor_dim=d, num_blocks=blocks)
    sd = weights.make_weights(weights.gats_spg_shapes(cfg), 1, "g", "cpu")
    model = weights.load_module(gats_spg.GATsSPG, sd, d, blocks)
    data = {"descriptors2d_query": torch.randn(b, n1, d),
            "descriptors3d_db": torch.randn(b, n2, d),
            "descriptors2d_db": torch.randn(b, n2 * leaf, d),
            "mask2d": torch.ones(b, n1, dtype=torch.bool),
            "mask3d": torch.ones(b, n2, dtype=torch.bool)}
    assert counted(lambda: gats_spg.forward_match_only(model, data, cfg)) \
        == flops.gats_spg(b, n1, n2, leaf, d, 4, blocks)


@pytest.mark.parametrize("b,n0,n1,layers", [(2, 30, 20, 4), (1, 16, 16, 3)])
def test_superglue(b, n0, n1, layers):
    from onepose_tpu_torch.models import superglue

    enc = (8, 16, 32)
    cfg = dict(superglue.DEFAULT_CONFIG, descriptor_dim=32,
               keypoint_encoder=enc, num_gnn_layers=layers,
               sinkhorn_iterations=3)
    sd = weights.make_weights(weights.superglue_shapes(cfg), 1, "s", "cpu")
    model = weights.load_module(superglue.SuperGlue, sd, enc, layers)
    data = {"keypoints0": torch.rand(b, n0, 2) * 64,
            "keypoints1": torch.rand(b, n1, 2) * 64,
            "scores0": torch.rand(b, n0), "scores1": torch.rand(b, n1),
            "descriptors0": torch.randn(b, n0, 32),
            "descriptors1": torch.randn(b, n1, 32),
            "mask0": torch.ones(b, n0, dtype=torch.bool),
            "mask1": torch.ones(b, n1, dtype=torch.bool),
            "shape0": (64, 64), "shape1": (64, 64)}
    assert counted(lambda: superglue.log_assignment(model, data, cfg)) == \
        flops.superglue(b, n0, n1, 32, enc, layers)


def test_match_counts_one_product():
    assert flops.match(8, 1024, 2000, 256) == 2 * 8 * 1024 * 2000 * 256
    assert flops.match_bytes(1, 2, 3, 4) == 4 * 5 * 4 + 8 * 5
