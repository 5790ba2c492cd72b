"""The port's CUDA kernels against their plain PyTorch versions, and the
paths that run them (pipeline, serving, detector) and the tracker against
the CPU, on a card.

Needs an NVIDIA GPU and nvcc; skips without a card. This file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: the stem within the fused-stem gate's max|Δ| < 1e-4·max(|ref|,
1) (3xTF32 on the tensor cores, fp32-class), and its error against an fp64
reference at most twice cuDNN fp32's (TF32 off); the match kernel under
``match.match_gate``: each max conf within GATE_REL = 3e-5 of the plain
max of its row or column, indices equal except in relative near-ties
(fp32-class products agree to about 1e-5, TF32 ones do not); the serve
step's matches and poses equal to per-object pipelines (poses within
1e-4); the detector's box and inliers equal to the CPU's, its log
assignment within superglue.GATE_REL = 5e-5 of the CPU's scale and
matches0 equal except in the near-ties that difference explains
(``superglue.match_gate``); the tracker's LK points within 1e-3 px of the
CPU's with equal status, its matches and assignments equal and its poses
within 1e-4 of the CPU's, uint8 frames bit-identical to float32 ones;
SfM's DLT null vectors within 1e-4 of the CPU's up to sign (over more
systems than one eigh call takes), and extract_to_h5's features at the
same keypoint positions, descriptors and scores within 1e-5."""
import copy

import numpy as np
import pytest
import torch

from onepose_tpu_torch.ops import match, stem
from onepose_tpu_torch.ops.precision import pin_fp32

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pin_fp32()
    return torch.device("cuda")


def _stem_args(rng, shape, dev, weight_scale=1.0):
    arrs = (rng.uniform(0, 1, shape),
            rng.normal(size=(3, 3, 1, 64)) * 0.3 * weight_scale,
            rng.normal(size=64) * 0.1,
            rng.normal(size=(3, 3, 64, 64)) * 0.06 * weight_scale,
            rng.normal(size=64) * 0.1)
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs]


# widths that are not a multiple of the kernel's 64 columns and heights
# that are not a multiple of its 4 rows, besides the original shapes
@pytest.mark.parametrize("shape", [(2, 64, 128, 1), (1, 40, 72, 1),
                                   (3, 16, 16, 1), (1, 2, 2, 1),
                                   (1, 34, 130, 1), (2, 18, 66, 1),
                                   (1, 1440, 1920, 1)])
def test_stem_kernel_matches_plain(cuda, shape):
    args = _stem_args(np.random.default_rng(0), shape, cuda)
    before = stem.fused_stem.launches
    got = stem.fused_stem(*args)
    assert stem.fused_stem.launches == before + 1
    ref = stem.stem_reference(*args)
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) < 1e-4 * max(
        float(ref.abs().max()), 1.0)


def test_stem_kernel_large_activations(cuda):
    """Weights ×4: activations about 16× larger, where a relative error
    shows in absolute terms."""
    args = _stem_args(np.random.default_rng(2), (2, 34, 130, 1), cuda, 4.0)
    got = stem.fused_stem(*args)
    ref = stem.stem_reference(*args)
    assert float(ref.abs().max()) > 10
    assert float((got - ref).abs().max()) < 1e-4 * float(ref.abs().max())


@pytest.mark.parametrize("shape", [(2, 64, 128, 1), (1, 34, 130, 1)])
def test_stem_kernel_is_fp32_class(cuda, shape):
    """Against an fp64 reference the kernel's 3xTF32 products err at most
    twice as much as cuDNN's fp32 convolutions with TF32 off."""
    args = _stem_args(np.random.default_rng(3), shape, cuda)
    ref64 = stem.stem_reference(*(a.double() for a in args))
    kernel = float((stem.fused_stem(*args).double() - ref64).abs().max())
    plain = float((stem.stem_reference(*args).double() - ref64).abs().max())
    assert kernel <= 2 * plain, (kernel, plain)


def test_stem_wrapper_refuses_bad_input(cuda):
    args = _stem_args(np.random.default_rng(1), (1, 16, 16, 1), cuda)
    with pytest.raises(ValueError, match="even"):
        stem.fused_stem(args[0][:, :15], *args[1:])
    with pytest.raises(ValueError, match="float32"):
        stem.fused_stem(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        stem.fused_stem(args[0].transpose(1, 2), *args[1:])


def _unit(rng, shape, dev):
    x = rng.normal(size=shape).astype(np.float32)
    return torch.from_numpy(x / np.linalg.norm(x, axis=-1,
                                               keepdims=True)).to(dev)


def _check_match(d0, d1, scale=0.07):
    got = match.dual_softmax_argmax(d0, d1, scale)
    assert got[0].dtype == got[2].dtype == torch.int32
    gate = match.match_gate(got, d0, d1, scale)
    assert gate.ok, gate
    return got


@pytest.mark.parametrize("b,n1,n2,d", [
    (2, 200, 144, 32), (1, 70, 48, 16), (2, 1000, 1990, 256),
    (1, 1, 3, 256), (1, 65, 129, 40), (1, 50, 300, 13)])
def test_match_kernel_matches_plain(cuda, b, n1, n2, d):
    rng = np.random.default_rng(n1)
    before = match.dual_softmax_argmax.launches
    _check_match(_unit(rng, (b, n1, d), cuda), _unit(rng, (b, n2, d), cuda))
    assert match.dual_softmax_argmax.launches == before + 1


@pytest.mark.parametrize("n0,n1,copies,extra", [
    (70, 100, 2, 0),     # ties inside one tile
    (128, 128, 3, 5),    # ties at offsets of one and two 128-wide tiles
])
def test_match_kernel_first_index_wins_ties(cuda, n0, n1, copies, extra):
    """Rows repeated every n0 and columns every n1 make exact ties: the
    lower index wins in both argmaxes, however the blocks happen to be
    scheduled. With n0 = n1 = 128 (the kernel's tile) the tied entries sit
    at the same place in different tiles, and there are four tiles on each
    side."""
    rng = np.random.default_rng(3)
    d0 = torch.cat([_unit(rng, (1, n0, 64), cuda)] * copies
                   + [_unit(rng, (1, extra, 64), cuda)], 1)
    d1 = torch.cat([_unit(rng, (1, n1, 64), cuda)] * copies
                   + [_unit(rng, (1, extra, 64), cuda)], 1)
    idx0, _, idx1, _ = _check_match(d0, d1)
    dup_col = (idx0 >= n1) & (idx0 < copies * n1)
    dup_row = (idx1 >= n0) & (idx1 < copies * n0)
    assert not dup_col.any() and not dup_row.any()
    # the ties were exercised: most argmaxes fall in the repeated block
    assert float((idx0 < n1).float().mean()) > 0.9
    assert float((idx1 < n0).float().mean()) > 0.9


def test_match_gate_refuses_tf32_matmul(cuda):
    """The plain version with TF32 matmuls allowed is not fp32-class, and
    the gate says so."""
    rng = np.random.default_rng(5)
    d0, d1 = _unit(rng, (2, 300, 256), cuda), _unit(rng, (2, 500, 256), cuda)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        got = match.match_reference(d0, d1, 0.07)
    finally:
        pin_fp32()
    gate = match.match_gate(got, d0, d1, 0.07)
    assert not gate.ok and gate.max_rel_err > match.GATE_REL, gate


def test_match_wrapper_refuses_bad_input(cuda):
    d = _unit(np.random.default_rng(6), (1, 64, 256), cuda)
    with pytest.raises(ValueError, match="contiguous"):
        match.dual_softmax_argmax(d.transpose(1, 2).contiguous()
                                  .transpose(1, 2), d, 0.07)
    with pytest.raises(ValueError, match="float32"):
        match.dual_softmax_argmax(d.double(), d, 0.07)
    buf = torch.empty(64 * 256 + 1, device=cuda)
    shifted = buf[1:].view(1, 64, 256)
    shifted.copy_(d)
    with pytest.raises(ValueError, match="aligned"):
        match.dual_softmax_argmax(d, shifted, 0.07)
    before = match.dual_softmax_argmax.launches
    match.dual_softmax_argmax(d, d, 0.07)
    assert match.dual_softmax_argmax.launches == before + 1


def test_pipeline_on_card_matches_cpu(cuda):
    """The whole path at a small size, injected noise: same keypoints and
    matches as the CPU port, poses within 1e-3."""
    from onepose_tpu_torch import pipeline
    from onepose_tpu_torch.datasets import anno
    from onepose_tpu_torch.models import convert
    from onepose_tpu_torch.ops import epnp

    rng = np.random.default_rng(0)
    sp = convert.superpoint_from_jax(convert.init_superpoint_params(rng))
    gats = convert.gats_spg_from_jax(convert.init_gats_spg_params(
        rng, {"num_blocks": 2}))
    P, leaf = 40, 4
    idxs = rng.integers(2, 10, P)
    total = int(idxs.sum())
    db = anno.build_object_db(
        avg_keypoints3d=rng.normal(size=(P, 3)).astype(np.float32),
        avg_descriptors3d=rng.normal(size=(256, P)).astype(np.float32),
        avg_scores3d=rng.uniform(0, 1, (P, 1)).astype(np.float32),
        clt_descriptors=rng.normal(size=(256, total)).astype(np.float32),
        clt_scores=rng.uniform(0, 1, (total, 1)).astype(np.float32),
        idxs=idxs, num_leaf=leaf, shape3d=48)
    kw = dict(sp_config={"max_keypoints": 64},
              gats_config={"num_blocks": 2, "match_threshold": 1e-3},
              num_hypotheses=32, refine_iters=2)
    images = rng.uniform(0, 1, (2, 64, 64, 1)).astype(np.float32)
    Ks = np.broadcast_to(np.array([[120.0, 0, 32], [0, 120.0, 32],
                                   [0, 0, 1]], np.float32), (2, 3, 3)).copy()
    noise = epnp.draw_noise(2, 64, 32, 64, torch.Generator().manual_seed(0))
    cpu = pipeline.PosePipeline(sp, gats, db, device="cpu", **kw)(
        images, Ks, noise=noise)
    card = pipeline.PosePipeline(sp, gats, db, device=cuda, **kw)(
        images, Ks, noise=epnp.RansacNoise(*(n.to(cuda) for n in noise)))
    torch.testing.assert_close(card.keypoints2d.cpu(), cpu.keypoints2d,
                               rtol=0, atol=0)
    torch.testing.assert_close(card.matches0.cpu(), cpu.matches0,
                               rtol=0, atol=0)
    torch.testing.assert_close(card.poses.cpu(), cpu.poses, rtol=0,
                               atol=1e-3)


def _random_db(rng, points=44, shape3d=48, leaf=2):
    from onepose_tpu_torch.datasets import anno

    idxs = rng.integers(2, 6, points)
    total = int(idxs.sum())
    return anno.build_object_db(
        avg_keypoints3d=rng.uniform(-0.1, 0.1, (points, 3)).astype(np.float32),
        avg_descriptors3d=rng.normal(size=(256, points)).astype(np.float32),
        avg_scores3d=rng.uniform(0, 1, (points, 1)).astype(np.float32),
        clt_descriptors=rng.normal(size=(256, total)).astype(np.float32),
        clt_scores=rng.uniform(0, 1, (total, 1)).astype(np.float32),
        idxs=idxs, num_leaf=leaf, shape3d=shape3d)


def test_serve_step_per_element_dbs_match_pipelines(cuda):
    """A mixed batch (a DB per batch element, gathered on the card) gives
    each request what a card PosePipeline holding only its object gives,
    and the match kernel launches on the gathered rows."""
    from onepose_tpu_torch import pipeline, serving
    from onepose_tpu_torch.models import convert
    from onepose_tpu_torch.ops import epnp

    rng = np.random.default_rng(4)
    sp = convert.superpoint_from_jax(convert.init_superpoint_params(rng))
    gats = convert.gats_spg_from_jax(convert.init_gats_spg_params(
        rng, {"num_blocks": 2}))
    dbs = {f"obj{i}": _random_db(rng) for i in range(3)}
    kw = dict(sp_config={"max_keypoints": 64},
              gats_config={"num_blocks": 2, "match_threshold": 0.0},
              num_hypotheses=32, refine_iters=2)
    K = np.array([[120.0, 0, 32], [0, 120.0, 32], [0, 0, 1]], np.float32)
    images = rng.uniform(0, 1, (4, 64, 64)).astype(np.float32)
    names = ["obj2", "obj0", "obj1", "obj0"]
    reqs = [serving.PoseRequest(n, im, K) for n, im in zip(names, images)]
    noise = epnp.draw_noise(4, 64, 32, 64, torch.Generator().manual_seed(1))
    noise = epnp.RansacNoise(*(n.to(cuda) for n in noise))
    server = serving.PoseServer(sp, gats, dbs, batch_size=4, device=cuda,
                                **kw)
    before = match.dual_softmax_argmax.launches
    out = server.run(reqs, noise)
    assert match.dual_softmax_argmax.launches == before + 1
    assert int(out.num_matches.min()) > 0
    Ks = np.broadcast_to(K, (4, 3, 3)).copy()
    for b, name in enumerate(names):
        ref = pipeline.PosePipeline(sp, gats, dbs[name], device=cuda, **kw)(
            images[..., None], Ks, noise=noise)
        torch.testing.assert_close(out.matches0[b], ref.matches0[b],
                                   rtol=0, atol=0)
        torch.testing.assert_close(out.poses[b], ref.poses[b], rtol=0,
                                   atol=1e-4)


def test_detect_bbox_card_matches_cpu(cuda):
    """One DB view pasted into a black frame, SuperGlue with small random
    GNN deltas and a planted final projection (convert.plant_superglue):
    the same box and inliers on the card as on the CPU, matches0 equal
    outside near-ties."""
    from onepose_tpu_torch import detector
    from onepose_tpu_torch.models import convert, superglue

    rng = np.random.default_rng(5)
    sp = convert.superpoint_from_jax(convert.init_superpoint_params(rng))
    params = convert.init_superglue_params(rng, {"num_gnn_layers": 4})
    views = [rng.uniform(0, 1, (256, 256)).astype(np.float32)
             for _ in range(3)]
    frame = np.zeros((480, 640), np.float32)
    frame[96:352, 160:416] = views[1]
    probe = detector.LocalFeatureObjectDetector(
        sp, convert.superglue_from_jax(params), views, max_keypoints=256,
        device="cpu")
    params = convert.plant_superglue(params, probe.db_det, 0.05)
    noise = torch.rand((3, 256, 256), generator=torch.Generator().manual_seed(6))
    out = {}
    for side, dev in (("card", cuda), ("cpu", torch.device("cpu"))):
        det = detector.LocalFeatureObjectDetector(
            copy.deepcopy(sp), convert.superglue_from_jax(params), views,
            max_keypoints=256, device=dev)
        q = det.extract(torch.from_numpy(frame).to(dev)[None, :, :, None])
        data = det.match_data(q, frame.shape)
        Z = superglue.log_assignment(det.sg_model, data, det.sg_config)
        m0 = superglue.forward(det.sg_model, data, det.sg_config).matches0
        out[side] = (det.detect_bbox(frame, noise.to(dev)), m0.cpu(), Z.cpu(),
                     (data["keypoints0"].cpu(), data["keypoints1"].cpu()))
    (box, inl), m0, Z, kp = out["card"]
    (ref_box, ref_inl), ref_m0, ref_Z, ref_kp = out["cpu"]
    np.testing.assert_array_equal(box, ref_box)
    assert inl == ref_inl >= 50
    assert np.abs(box - [160, 96, 416, 352]).max() <= 2
    # keypoints come sorted by score: near-equal scores may swap slots, so
    # the gate puts the card's slots in the CPU's order by position
    gate = superglue.match_gate(m0, Z, ref_m0, ref_Z, 0.2, kp, ref_kp)
    assert gate.ok, gate


# ---------------------------------------------------------------------------
# the tracker (no kernel of its own: LK, NN, PnP and LM are torch ops)
# ---------------------------------------------------------------------------

def _plane(hw=160, frames=4):
    from onepose_tpu_torch.utils.synthetic import plane_sequence

    return plane_sequence(np.random.default_rng(0), frames, hw=hw,
                          focal=150.0 * hw / 160, n_points=48, slots=64,
                          desc_dim=64, rot_step=(0.06, 0.1, 0.02),
                          trans_step=(0.01, -0.005))


def test_lk_on_card_matches_cpu(cuda):
    """LK at the demo's 512x512 with 400 points: the same status, points
    within 1e-3 px (the same gathers; fp32 blends in another order)."""
    from onepose_tpu_torch.utils.synthetic import plane_sequence
    from onepose_tpu_torch.ops import lk_flow

    _, _, frames = plane_sequence(np.random.default_rng(1), 2)
    args = [torch.from_numpy(x) for x in (frames[0]["image"],
                                          frames[1]["image"],
                                          frames[0]["keypoints"])]
    cpu = lk_flow.pyramid_lk(*args)
    card = lk_flow.pyramid_lk(*(a.to(cuda) for a in args))
    status = cpu.status
    assert torch.equal(card.status.cpu(), status) and status.sum() >= 300
    torch.testing.assert_close(card.points.cpu()[status], cpu.points[status],
                               rtol=0, atol=1e-3)


def _run_tracker(device, frames, K, pts3d, noises, as_uint8=False):
    from onepose_tpu_torch.tracker import BATracker

    tr = BATracker(win_size=6, pnp_hypotheses=128, ba_iterations=6,
                   device=device)
    out = []
    for i, fr in enumerate(frames):
        img = fr["image"]
        if as_uint8 is not None:
            u8 = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
            img = u8 if as_uint8 else u8.astype(np.float32) / np.float32(255)
        if i == 0:
            assert tr.add_keyframe(img, fr["keypoints"], fr["descriptors"],
                                   fr["mask"], fr["pose"], K, mkpts3d=pts3d,
                                   kpt_indices=np.arange(len(pts3d)))
            continue
        noise = type(noises[i - 1])(*(type(n)(*(x.to(device) for x in n))
                                      for n in noises[i - 1]))
        pose, info = tr.track(img, fr["keypoints"], fr["descriptors"],
                              fr["mask"], K, noise=noise)
        assert pose is not None, info
        out.append((pose, info["step"]))
    return out


def _noises(n):
    from onepose_tpu_torch.tracker import draw_track_noise

    gen = torch.Generator().manual_seed(0)
    return [draw_track_noise(64, 64, 128, gen) for _ in range(n)]


def test_tracker_on_card_matches_cpu(cuda):
    """Four frames of the plane, the same injected noise: the same matches
    and gated assignments, poses within 1e-4 and within 1.5 cm / 1.5 deg
    of the truth."""
    from onepose_tpu_torch.utils import geometry as geo

    K, pts3d, frames = _plane()
    noises = _noises(3)
    cpu = _run_tracker("cpu", frames, K, pts3d, noises, as_uint8=None)
    card = _run_tracker(cuda, frames, K, pts3d, noises, as_uint8=None)
    for i, ((pc, sc), (pg, sg)) in enumerate(zip(cpu, card)):
        assert torch.equal(sc.m0, sg.m0) and torch.equal(sc.keep, sg.keep)
        np.testing.assert_allclose(pg, pc, atol=1e-4)
        r, t = geo.query_pose_error(pg, frames[i + 1]["pose"])
        assert r < 1.5 and t < 1.5


def test_tracker_uint8_bit_identical_on_card(cuda):
    """uint8 frames, converted on the card, give the same bits as their
    float32 frames converted on the host (ROADMAP Queue 1 item 10)."""
    K, pts3d, frames = _plane()
    noises = _noises(3)
    u8 = _run_tracker(cuda, frames, K, pts3d, noises, as_uint8=True)
    f32 = _run_tracker(cuda, frames, K, pts3d, noises, as_uint8=False)
    for (p8, s8), (p32, s32) in zip(u8, f32):
        np.testing.assert_array_equal(p8, p32)
        for a, b in zip(s8, s32):
            assert torch.equal(a, b)


def test_segment_sum_repeats_its_bits_on_card(cuda):
    """The LM's segment sums (rows sorted by segment, each segment added
    in a fixed order in fp64, no atomics) give the same bits run after
    run on the card, so a card run can be compared with itself bit for
    bit; against the CPU they differ in summation order only."""
    from onepose_tpu_torch.ops import lm

    rng = np.random.default_rng(3)
    data = torch.from_numpy(rng.normal(size=(4096, 6, 6)).astype(
        np.float32)).to(cuda)
    seg = lm.segment_matrix(torch.from_numpy(rng.integers(0, 10, 4096)), 10)
    runs = [lm.segment_sum(data, seg.to(cuda)) for _ in range(5)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    torch.testing.assert_close(runs[0].cpu(),
                               lm.segment_sum(data.cpu(), seg),
                               rtol=0, atol=1e-3)


def test_dlt_null_vectors_on_card_match_cpu(cuda):
    """Systems Q diag(0, 1, 2, 3) Q^T with random rotations Q, more of
    them than one eigh call takes: on the card and on the CPU the null
    vector is Q's first column, up to sign, within 1e-4."""
    from onepose_tpu_torch.sfm import triangulate

    rng = np.random.default_rng(4)
    n = 3 * triangulate.EIGH_BATCH + 5
    Q = np.linalg.qr(rng.normal(size=(n, 4, 4)))[0]
    AtA = torch.from_numpy((Q * np.arange(4.0)[None, None]) @ Q.transpose(
        0, 2, 1)).float()
    truth = torch.from_numpy(Q[:, :, 0]).float()
    for got in (triangulate.null_vectors(AtA.to(cuda)).cpu(),
                triangulate.null_vectors(AtA)):
        sign = torch.sign((got * truth).sum(-1, keepdim=True))
        torch.testing.assert_close(got * sign, truth, rtol=0, atol=1e-4)


def test_extract_to_h5_on_card_matches_cpu(cuda, tmp_path):
    from onepose_tpu_torch.models import convert
    from onepose_tpu_torch.sfm import extract
    from onepose_tpu_torch.utils import hdf5

    rng = np.random.default_rng(5)
    model = convert.superpoint_from_jax(convert.init_superpoint_params(rng))
    names = [f"/v/{i}.png" for i in range(3)]
    images = {n: rng.uniform(0, 1, (128, 160)).astype(np.float32)
              for n in names}
    feats = []
    for dev in (cuda, torch.device("cpu")):
        path = str(tmp_path / f"{dev.type}.h5")
        extract.extract_to_h5(copy.deepcopy(model), names, path,
                              batch_size=2, images=images, device=dev)
        with hdf5.File(path) as f:
            feats.append({n: {k: f[n][k][()] for k in f[n]} for n in names})
    for n in names:
        c, h = feats[0][n], feats[1][n]
        co = np.lexsort((c["keypoints"][:, 0], c["keypoints"][:, 1]))
        ho = np.lexsort((h["keypoints"][:, 0], h["keypoints"][:, 1]))
        np.testing.assert_array_equal(c["keypoints"][co], h["keypoints"][ho])
        np.testing.assert_allclose(c["descriptors"][:, co],
                                   h["descriptors"][:, ho], atol=1e-5)
        np.testing.assert_allclose(c["scores"][co], h["scores"][ho],
                                   atol=1e-5)
        np.testing.assert_array_equal(c["image_size"], [160, 128])
