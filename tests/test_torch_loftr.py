"""LoFTR in the port (``models/loftr.py``, ``detector.LoFTRObjectDetector``)
against its plain reference (``reference/loftr.py``), on the CPU.

Published widths (ResNet-FPN 128-196-256, coarse d 256 with 8 heads, fine
d 128 with 8 heads, window 5) on small images: 3 views of 64×64 against a
96×128 frame with one view pasted at an 8-px step, seeded random weights
with BatchNorm statistics drawn away from the identity, the coarse
features whitened and each encoder layer's ``norm2`` scaled down so that
the matcher finds mutual matches above its 0.2 threshold.

Tolerances, with their reasons (fp32 on both sides; the port folds
BatchNorm, permutes heads and splits ``merge_feat``, so it rounds
differently, about 1e-7 relative per layer):

- maps and features: largest |Δ| over the reference's largest magnitude
  ≤ 1e-5 (the readings are 1e-7 to 1e-6; TF32 operands would read 1e-3);
- the positional encoding: equal (the same fp32 operations);
- the coarse slate: the same matches and frame cells, conf within 1e-5
  relative (the planted margins keep rounding from flipping a match);
- refined frame points within 1e-3 px (offsets lie within ±4 px);
- the detector's box and inlier count equal to the reference matches'
  under the same RANSAC noise.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from onepose_tpu_torch import detector
from onepose_tpu_torch.feature_matching_object_detector import (
    load_matcher, make_detector)
from onepose_tpu_torch.config import Config
from onepose_tpu_torch.models import gats_spg, loftr
from onepose_tpu_torch.ops import similarity
from onepose_tpu_torch.reference import loftr as ref
from onepose_tpu_torch.utils import model_io

REL = 1e-5
CFG = loftr.resolve_config()
VIEW, FRAME, AT = (64, 64), (96, 128), (16, 40)    # paste at (y, x)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _weights(seed=0, bn_identity=False):
    torch.manual_seed(seed)
    sd = loftr.LoFTR().state_dict()
    g = torch.Generator().manual_seed(seed + 1)
    for k, v in sd.items():
        if bn_identity:
            continue
        if k.endswith("running_mean"):
            sd[k] = torch.randn(v.shape, generator=g) * 0.1
        elif k.endswith("running_var"):
            sd[k] = torch.rand(v.shape, generator=g) + 0.5
        elif k.endswith(".weight") and v.dim() == 1 and "norm" not in k:
            sd[k] = torch.rand(v.shape, generator=g) + 0.5    # BN gamma
        elif k.endswith(".bias") and v.dim() == 1 and "norm" not in k and \
                "fine_preprocess" not in k:
            sd[k] = torch.randn(v.shape, generator=g) * 0.1   # BN beta
    return sd


def _scene(seed=0):
    g = torch.Generator().manual_seed(seed)
    views = torch.rand(3, 1, *VIEW, generator=g)
    frame = torch.rand(1, 1, *FRAME, generator=g)
    y, x = AT
    frame[0, 0, y:y + VIEW[0], x:x + VIEW[1]] = views[1, 0]
    return views, frame


def _plant(sd, views):
    """Whiten the coarse features (layer3_outconv) so that a self-match's
    S is about 50, and scale each encoder layer's norm2 by 1e-3."""
    sd = dict(sd)
    for k in sd:
        if ".norm2." in k:
            sd[k] = sd[k] * 1e-3
    sd["backbone.layer3_outconv.weight"] = torch.eye(256)[:, :, None, None]
    x3, _ = ref.backbone(sd, views)
    x = x3.permute(0, 2, 3, 1).reshape(-1, 256).double()
    lam, vec = torch.linalg.eigh(x.T @ x / len(x))
    lam = lam.clamp(min=0.1 * float(lam.mean()))
    white = vec @ torch.diag(lam.rsqrt()) @ vec.T
    s = (50 * 25.6 / (x @ white).square().sum(-1).median()).sqrt()
    sd["backbone.layer3_outconv.weight"] = (white * s).float()[..., None,
                                                               None]
    return sd


@pytest.fixture(scope="module")
def planted():
    views, frame = _scene()
    sd = _plant(_weights(), views)
    return sd, views, frame, ref.match(sd, views, frame, CFG)


@pytest.mark.parametrize("bn_identity", [True, False],
                         ids=["bn-identity", "bn-drawn"])
def test_backbone_with_batchnorm_folded(bn_identity):
    sd = _weights(3, bn_identity)
    _, frame = _scene(3)
    p = loftr.prepare(sd)
    assert "backbone.bn1.weight" not in p and "backbone.conv1.bias" in p
    for got, want in zip(loftr.backbone(p, frame), ref.backbone(sd, frame)):
        assert got.shape == want.shape
        assert _rel(got, want) <= REL
    assert loftr.backbone(p, frame)[0].shape[1:] == (256, 12, 16)
    assert loftr.backbone(p, frame)[1].shape[1:] == (128, 48, 64)


def test_position_encoding_is_the_buffer_cut():
    pe = ref.position_encoding(256)[0]
    for h, w in ((12, 16), (8, 8), (180, 240)):
        assert torch.equal(loftr.position_encoding(256, h, w),
                           pe[:, :h, :w])


def test_linear_attention_under_the_head_permutation():
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(2, n, 256, generator=g) for n in (40, 70, 70))
    want = ref.linear_attention(*(t.view(2, -1, 8, 32) for t in (q, k, v)))
    perm = loftr.head_permutation(256, 8)
    assert sorted(perm.tolist()) == list(range(256))
    assert perm[1] == 32 and perm[8] == 1      # (e 0, h 1), (e 1, h 0)
    got = gats_spg.linear_attention(q[..., perm], k[..., perm], v[..., perm],
                                    8)
    inverse = torch.argsort(perm)
    assert _rel(got[..., inverse], want.reshape(2, 40, 256)) <= REL
    # a layer with the permuted weights equals the reference's layer
    sd = _weights(6)
    p = loftr.prepare(sd)
    name = "loftr_coarse.layers.0"
    assert _rel(loftr.encoder_layer(p, name, q, k, 8),
                ref.encoder_layer(sd, name, q, k, 8)) <= REL


def _simultaneous(p, name, layer_names, f0, f1, heads):
    """A cross layer that updates feat1 from the old feat0: not LoFTR."""
    for i, kind in enumerate(layer_names):
        layer = f"{name}.layers.{i}"
        src0, src1 = (f0, f1) if kind == "self" else (f1, f0)
        f0, f1 = (loftr.encoder_layer(p, layer, f0, src0, heads),
                  loftr.encoder_layer(p, layer, f1, src1, heads))
    return f0, f1


def test_the_cross_update_is_sequential(planted):
    sd, views, frame, r = planted
    p = loftr.prepare(sd)
    names = CFG["coarse"]["layer_names"]
    t0 = ref.add_position_encoding(r.coarse0)
    t1 = ref.add_position_encoding(r.coarse1).expand(3, -1, -1)
    got = loftr.transformer(p, "loftr_coarse", names, t0, t1, 8)
    assert _rel(got[0], r.feat_c0) <= REL and _rel(got[1], r.feat_c1) <= REL
    # feat1 from the old feat0 moves feat1 far beyond the tolerance
    sd_u = {k: (v * 1e3 if ".norm2." in k else v) for k, v in sd.items()}
    p_u = loftr.prepare(sd_u)
    seq = loftr.transformer(p_u, "loftr_coarse", names, t0, t1, 8)
    sim = _simultaneous(p_u, "loftr_coarse", names, t0, t1, 8)
    want = ref.transformer(sd_u, "loftr_coarse", names, t0, t1, 8)
    assert _rel(seq[1], want[1]) <= REL
    assert _rel(sim[1], want[1]) > 1e-2
    # in one self + cross pair, feat0 agrees and only feat1 differs
    one = _simultaneous(p_u, "loftr_coarse", names[:2], t0, t1, 8)
    want = ref.transformer(sd_u, "loftr_coarse", names[:2], t0, t1, 8)
    assert _rel(one[0], want[0]) <= REL and _rel(one[1], want[1]) > 1e-2


def _slate_pairs(m):
    b, i = torch.nonzero(m.valid, as_tuple=True)
    return list(zip(b.tolist(), i.tolist(), m.j[b, i].tolist()))


def test_coarse_slate_against_the_mask_rule(planted):
    sd, views, frame, r = planted
    hw0, hw1 = (8, 8), (12, 16)
    m = loftr.coarse_match(r.feat_c0, r.feat_c1, hw0, hw1, CFG)
    want = list(zip(r.matches.b_ids.tolist(), r.matches.i_ids.tolist(),
                    r.matches.j_ids.tolist()))
    assert _slate_pairs(m) == want and len(want) > 5
    b, i = r.matches.b_ids, r.matches.i_ids
    assert _rel(m.conf[b, i], r.matches.mconf) <= REL


def test_coarse_slate_with_a_planted_tie_and_border_cells():
    """Features of norm 36 (a self-match's S is 50), view cells copied
    into frame cells: 0 (a corner) and 9 (within 2 cells of the border) to
    interior cells, 27 to two interior cells (an exact tie, the lower
    frame cell first), 18 to one, 36 to a frame border cell. Only 27 and
    18 match, the tie going to its first cell, in both; the rest of the
    slate (random features' chance matches) is the reference's too."""
    g = torch.Generator().manual_seed(9)
    f0 = torch.randn(1, 64, 256, generator=g)
    f0 = f0 / f0.norm(dim=-1, keepdim=True) * 36.0
    f1 = torch.randn(1, 192, 256, generator=g)
    f1 = f1 / f1.norm(dim=-1, keepdim=True) * 36.0
    hw0, hw1 = (8, 8), (12, 16)
    for i, j in ((0, 100), (9, 120), (27, 70), (27, 90), (18, 40),
                 (36, 16 * 11 + 5)):
        f1[0, j] = f0[0, i]
    m = loftr.coarse_match(f0, f1, hw0, hw1, CFG)
    r = ref.coarse_match(f0, f1, hw0, hw1)
    got = _slate_pairs(m)
    assert got == list(zip(r.b_ids.tolist(), r.i_ids.tolist(),
                           r.j_ids.tolist()))
    assert (0, 27, 70) in got and (0, 18, 40) in got
    assert not {i for _, i, _ in got} & {0, 9, 36}
    assert bool(r.conf_matrix[0, 27, 70] == r.conf_matrix[0, 27, 90])


def test_fine_points_on_the_matched_rows(planted):
    sd, views, frame, r = planted
    matcher = loftr.Matcher(sd, views, CFG)
    out = matcher(frame)
    b, i = r.matches.b_ids, r.matches.i_ids
    assert _slate_pairs(out) == list(zip(b.tolist(), i.tolist(),
                                         r.matches.j_ids.tolist()))
    assert torch.equal(out.points0[b, i], r.mkpts0_f)
    assert float((out.points1[b, i] - r.mkpts1_f).abs().max()) <= 1e-3
    assert int(matcher.last_matches) == len(b)
    # the refinement moved the points off their cells
    assert float((r.mkpts1_f % 8).abs().max()) > 0.1


def test_no_match_leaves_an_empty_slate(planted):
    sd, views, frame, _ = planted
    cfg = loftr.resolve_config({"match_coarse": {"thr": 1.0}})
    out = loftr.Matcher(sd, views, cfg)(frame)
    r = ref.match(sd, views, frame, cfg)
    assert not out.valid.any() and int(out.valid.sum()) == 0
    assert len(r.matches.b_ids) == 0 and r.mkpts1_f.shape == (0, 2)
    assert torch.isfinite(out.points1).all()


def test_detect_bbox_against_the_reference_matches(planted):
    sd, views, frame, r = planted
    model = loftr.LoFTR()
    model.load_state_dict(sd)
    det = detector.LoFTRObjectDetector(model, list(views[:, 0].numpy()),
                                       device="cpu")
    noise = torch.rand((3, 256, 64), generator=torch.Generator().manual_seed(
        4))
    bbox, inliers = det.detect_bbox(frame[0, 0].numpy(), noise=noise)
    valid = torch.zeros(3, 64, dtype=torch.bool)
    dst = torch.zeros(3, 64, 2)
    b, i = r.matches.b_ids, r.matches.i_ids
    valid[b, i] = True
    dst[b, i] = r.mkpts1_f
    fits = similarity.ransac_similarity(det.matcher.points0, dst, valid,
                                        noise=noise)
    want_box, want_inliers = det.box(fits, FRAME)
    assert inliers == want_inliers and inliers > 0
    np.testing.assert_array_equal(bbox, want_box)
    res = det.detect(frame[0, 0].numpy(), np.eye(3), crop_size=32,
                     noise=noise)
    np.testing.assert_array_equal(res.bbox, want_box)


def test_load_loftr_by_name_and_the_config_selects_it(tmp_path):
    sd = _weights(7)
    torch.save({"state_dict": {f"matcher.{k}": v for k, v in sd.items()}},
               tmp_path / "loftr.ckpt")
    model = model_io.load_loftr(str(tmp_path / "loftr.ckpt"))
    got = model.state_dict()
    assert set(got) == set(sd)
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    assert "loftr_coarse.layers.3.mlp.2.weight" in got
    assert "backbone.layer2.0.downsample.1.running_var" in got
    cfg = Config({"detector_matcher": "loftr", "device": "cpu",
                  "model": Config({"loftr_model_path":
                                   str(tmp_path / "loftr.ckpt")})})
    sg_model, loaded = load_matcher(cfg)
    assert sg_model is None and isinstance(loaded, loftr.LoFTR)
    views, _ = _scene()
    det = make_detector(cfg, list(views[:, 0].numpy()), loftr_model=loaded)
    assert isinstance(det, detector.LoFTRObjectDetector)
    assert det.matcher.view_tokens.shape == (3, 64, 256)
    with pytest.raises(ValueError, match="detector_matcher"):
        load_matcher(Config({"detector_matcher": "lightglue"}))


def test_config_refuses_variants_the_port_does_not_build():
    """default.py's whole LoFTR group, lower-cased, resolves; a variant
    the forward pass does not build (the first released weights' PE
    without temp_bug_fix, Sinkhorn matching, another backbone or stride)
    or an unknown key raises, so that such a checkpoint cannot match
    wrongly without an error."""
    published = {
        "backbone_type": "ResNetFPN", "resolution": (8, 2),
        "fine_window_size": 5, "fine_concat_coarse_feat": True,
        "resnetfpn": {"initial_dim": 128, "block_dims": [128, 196, 256]},
        "coarse": {"d_model": 256, "d_ffn": 256, "nhead": 8,
                   "layer_names": ["self", "cross"] * 4,
                   "attention": "linear", "temp_bug_fix": True},
        "match_coarse": {"thr": 0.2, "border_rm": 2,
                         "match_type": "dual_softmax",
                         "dsmax_temperature": 0.1, "skh_iters": 3,
                         "skh_init_bin_score": 1.0, "skh_prefilter": False,
                         "train_coarse_percent": 0.2,
                         "train_pad_num_gt_min": 200, "sparse_spvs": True},
        "fine": {"d_model": 128, "d_ffn": 128, "nhead": 8,
                 "layer_names": ["self", "cross"], "attention": "linear"},
        "loss": {"coarse_type": "focal", "coarse_weight": 1.0}}
    assert loftr.resolve_config(published) == CFG
    for bad, why in (({"coarse": {"temp_bug_fix": False}}, "temp_bug_fix"),
                     ({"match_coarse": {"match_type": "sinkhorn"}},
                      "match_type"),
                     ({"backbone_type": "ResNet"}, "backbone_type"),
                     ({"resolution": [16, 4]}, "resolution"),
                     ({"fine_concat_coarse_feat": False}, "concat"),
                     ({"fine": {"attention": "full"}}, "attention"),
                     ({"coarse": {"dropout": 0.1}}, "unknown key"),
                     ({"match_thr": 0.2}, "unknown key")):
        with pytest.raises(ValueError, match=why):
            loftr.resolve_config(bad)
    with pytest.raises(ValueError, match="temp_bug_fix"):
        loftr.LoFTR({"coarse": {"temp_bug_fix": False}})
