"""The port's CUDA kernels against their plain PyTorch versions, and the
paths that run them (pipeline, serving, detector) and the tracker against
the CPU, on a card.

Needs an NVIDIA GPU and nvcc; skips without a card. This file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: the stem and the encoder's convolutions within the fused-stem
gate's max|Δ| < 1e-4·max(|ref|, 1) (3xTF32 on the tensor cores,
fp32-class), and their error against an fp64 reference at most twice
cuDNN fp32's (TF32 off); the match kernel under
``match.match_gate``: each max conf within GATE_REL = 3e-5 of the plain
max of its row or column, indices equal except in relative near-ties
(fp32-class products agree to about 1e-5, TF32 ones do not); the
Sinkhorn kernel's log assignment within 1e-5 of the plain loop's scale
and against an fp64 loop at most twice the plain fp32 loop's error; the serve
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

from onepose_tpu_torch.ops import encoder, match, stem
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


# SuperPoint's seven convolutions after the stem: (Cin, Cout, pool)
ENCODER_WIDTHS = [(64, 64, False), (64, 64, True), (64, 128, False),
                  (128, 128, True), (128, 128, False), (128, 128, False),
                  (128, 512, False)]


def _encoder_args(seed, shape, dev):
    """An input like the stem's output (non-negative) and He-scaled random
    weights of the encoder's widths."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand(shape, generator=g, device=dev)
    layers = [encoder.Conv3x3(
        torch.randn((3, 3, cin, cout), generator=g, device=dev)
        * (2 / (9 * cin)) ** 0.5,
        torch.randn(cout, generator=g, device=dev) * 0.1, pool)
        for cin, cout, pool in ENCODER_WIDTHS]
    return x, layers


# the main path's shapes: the pose batch of 128 crops, the detector's frame
# (its 480 and 240 columns are not a multiple of the kernel's 64), the DB
# views and the demo's crop
ENCODER_MAIN_SHAPES = [(128, 256, 256, 64), (1, 720, 960, 64),
                       (15, 256, 256, 64), (1, 256, 256, 64)]


@pytest.mark.parametrize("shape", ENCODER_MAIN_SHAPES + [(2, 20, 132, 64),
                                                         (1, 4, 4, 64)])
def test_encoder_kernel_matches_plain(cuda, shape):
    """Within the stem's gate of the plain version (cuDNN fp32); one launch
    a convolution; ragged tiles down to a 1x1 map."""
    x, layers = _encoder_args(0, shape, cuda)
    before = encoder.encoder_conv.launches
    got = encoder.encoder_conv(x, layers)
    assert encoder.encoder_conv.launches == before + 7
    ref = encoder.encoder_reference(x, layers)
    assert got.shape == ref.shape == (shape[0], shape[1] // 4,
                                      shape[2] // 4, 512)
    err = float((got - ref).abs().max())
    assert err < 1e-4 * max(float(ref.abs().max()), 1.0), err


@pytest.mark.parametrize("shape", ENCODER_MAIN_SHAPES)
def test_encoder_kernel_is_fp32_class(cuda, shape):
    """Against an fp64 reference the kernel errs at most twice as much as
    cuDNN's fp32 convolutions with TF32 off, at the main path's shapes.
    (Where a convolution sums only a few terms, as at a 1x1 map, the hi/lo
    split's 22 bits, not the sums, set the kernel's error: a few times
    fp32 FMA's, far inside the gate above.)"""
    x, layers = _encoder_args(0, shape, cuda)
    ref64 = encoder.encoder_reference(x.double(), [
        encoder.Conv3x3(w.double(), b.double(), p) for w, b, p in layers])
    kernel = float((encoder.encoder_conv(x, layers).double() - ref64)
                   .abs().max())
    plain = float((encoder.encoder_reference(x, layers).double() - ref64)
                  .abs().max())
    assert kernel <= 2 * plain, (kernel, plain)


def test_encoder_rows_do_not_depend_on_the_batch(cuda):
    """A frame's encoder output is the same bits at batch 4 and inside
    batch 8: the kernel's tiles never cross images."""
    x, layers = _encoder_args(1, (8, 64, 64, 64), cuda)
    four = encoder.encoder_conv(x[:4].contiguous(), layers)
    eight = encoder.encoder_conv(x, layers)
    assert torch.equal(four, eight[:4])


def test_extract_launches_the_encoder_seven_times(cuda):
    """fp32 ``extract`` takes the kernel for all seven 3x3 convolutions;
    the bf16 encoder takes none."""
    from onepose_tpu_torch.models import superpoint

    torch.manual_seed(0)
    model = superpoint.SuperPoint().to(cuda).eval()
    images = torch.rand(2, 64, 64, 1, device=cuda)
    before = encoder.encoder_conv.launches
    superpoint.extract(model, images, {"max_keypoints": 64})
    assert encoder.encoder_conv.launches == before + 7
    superpoint.extract(model, images, {"max_keypoints": 64,
                                       "compute_dtype": "bfloat16",
                                       "stem_dtype": "bfloat16"})
    assert encoder.encoder_conv.launches == before + 7


def test_encoder_wrapper_refuses_bad_input(cuda):
    x, layers = _encoder_args(2, (1, 16, 16, 64), cuda)
    with pytest.raises(ValueError, match="Cin in"):
        encoder.encoder_conv(x[..., :32].contiguous(), layers)
    with pytest.raises(ValueError, match="even"):
        encoder.encoder_conv(x[:, :15, :15].contiguous(), layers[1:2])
    with pytest.raises(ValueError, match="float32"):
        encoder.encoder_conv(x.double(), layers)
    with pytest.raises(ValueError, match="contiguous"):
        encoder.encoder_conv(x.transpose(1, 2), layers)


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


# (scores shape, iterations, what is masked to -1e9): the detector's shape
# with padded keypoint slots in some views, ragged shapes, one SfM pair at
# the largest bucket and two at the next (one block an SM: longer rows),
# 0 and 1 iterations, a wholly masked row and column
SINKHORN_CASES = {
    "detect_padded": ((15, 1024, 1024), 100, "padded"),
    "ragged_300x700": ((1, 300, 700), 100, None),
    "ragged_1024x517": ((3, 1024, 517), 100, None),
    "sfm_pair_4096": ((1, 4096, 4096), 100, None),
    "sfm_bucket_2048": ((2, 600, 2048), 100, None),
    "iters_0": ((15, 1024, 1024), 0, "padded"),
    "iters_1": ((2, 200, 330), 1, None),
    "masked_row_and_column": ((2, 64, 80), 100, "row_and_column"),
}


def _sinkhorn_scores(shape, masked, dev):
    """Scores at SuperGlue's scale (its products over sqrt(256) reach a
    few units), with -1e9 where ``superglue._scores`` masks."""
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    scores = torch.randn(shape, generator=g, device=dev) * 3
    if masked == "padded":      # trailing slots of every third view
        scores[::3, 900:] = -1e9
        scores[1::3, :, 950:] = -1e9
    elif masked == "row_and_column":
        scores[:, 5] = -1e9
        scores[:, :, 7] = -1e9
    return scores


def _live_err(z, ref):
    """max |z − ref| over entries no mask sends to -1e9, and over the
    largest such |ref|."""
    live = ref.abs() < 1e6
    d = float((z.double() - ref.double()).abs()[live].max())
    return d, d / float(ref.abs()[live].max())


@pytest.mark.parametrize("case", list(SINKHORN_CASES))
def test_sinkhorn_kernel_matches_plain(cuda, case):
    """Within 1e-5 of the plain fp32 version's scale (sound fp32 runs
    differ by about 1e-6; superglue.GATE_REL is 5e-5), masked entries
    still masked, and against an fp64 plain Sinkhorn at most twice the
    plain fp32 version's error."""
    from onepose_tpu_torch.ops import sinkhorn

    shape, iters, masked = SINKHORN_CASES[case]
    scores = _sinkhorn_scores(shape, masked, cuda)
    alpha = torch.tensor(1.0, device=cuda)
    before = sinkhorn.log_sinkhorn.launches
    got = sinkhorn.log_sinkhorn(scores, alpha, iters)
    assert sinkhorn.log_sinkhorn.launches == before + 1
    ref = sinkhorn.sinkhorn_reference(scores, alpha, iters)
    assert got.shape == ref.shape == (shape[0], shape[1] + 1, shape[2] + 1)
    assert torch.equal(got.abs() < 1e6, ref.abs() < 1e6)
    _, rel = _live_err(got, ref)
    assert rel <= 1e-5, rel
    ref64 = sinkhorn.sinkhorn_reference(scores.double(), alpha.double(),
                                        iters)
    kernel64, _ = _live_err(got, ref64)
    plain64, _ = _live_err(ref, ref64)
    assert kernel64 <= 2 * plain64, (kernel64, plain64)


def test_sinkhorn_on_card_never_waits(cuda):
    """``log_optimal_transport`` on a card makes no synchronising call (the
    plain loop's scalar uploads do), launches the kernel once a call, and
    SuperGlue's forward still matches the CPU's."""
    from onepose_tpu_torch.models import convert, superglue
    from onepose_tpu_torch.ops import sinkhorn

    scores = _sinkhorn_scores((3, 256, 300), "padded", cuda)
    alpha = torch.tensor(0.5, device=cuda)
    superglue.log_optimal_transport(scores, alpha, 3)   # builds the library
    torch.cuda.synchronize()
    before = sinkhorn.log_sinkhorn.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [superglue.log_optimal_transport(scores, alpha, 100)
                for _ in range(3)]
        with pytest.raises(RuntimeError, match="synchroniz"):
            sinkhorn.sinkhorn_reference(scores, alpha, 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert sinkhorn.log_sinkhorn.launches == before + 3
    assert all(torch.equal(z, outs[0]) for z in outs[1:])

    rng = np.random.default_rng(11)
    model = convert.superglue_from_jax(
        convert.init_superglue_params(rng, {"num_gnn_layers": 4}))
    data = {f"keypoints{i}": torch.from_numpy(
                rng.uniform(0, 256, (2, n, 2)).astype(np.float32))
            for i, n in ((0, 200), (1, 230))}
    data.update({f"scores{i}": torch.from_numpy(
                     rng.uniform(0, 1, (2, n)).astype(np.float32))
                 for i, n in ((0, 200), (1, 230))})
    data.update({f"descriptors{i}": torch.from_numpy(
                     _unit(rng, (2, n, 256), "cpu").numpy())
                 for i, n in ((0, 200), (1, 230))})
    data["shape0"] = data["shape1"] = (256, 256)
    cfg = superglue.resolve_config({"num_gnn_layers": 4})
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        d = {k: v.to(dev) if torch.is_tensor(v) else v
             for k, v in data.items()}
        m = copy.deepcopy(model).to(dev)
        runs[dev.type] = (superglue.forward(m, d, cfg).matches0.cpu(),
                          superglue.log_assignment(m, d, cfg).cpu())
    gate = superglue.match_gate(*runs["cuda"], *runs["cpu"], 0.2)
    assert gate.ok, gate


def test_sinkhorn_wrapper_refuses_bad_input(cuda):
    from onepose_tpu_torch.ops import sinkhorn

    scores = _sinkhorn_scores((2, 40, 50), None, cuda)
    alpha = torch.tensor(1.0, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        sinkhorn.log_sinkhorn(scores.transpose(1, 2), alpha, 5)
    with pytest.raises(ValueError, match="float32"):
        sinkhorn.log_sinkhorn(scores.double(), alpha, 5)
    with pytest.raises(ValueError, match="CUDA"):
        sinkhorn.log_sinkhorn(scores, alpha.cpu(), 5)
    with pytest.raises(ValueError, match="no kernel"):
        sinkhorn.log_sinkhorn(scores[:, :0].contiguous(), alpha, 5)
    with pytest.raises(ValueError, match="no kernel"):
        sinkhorn.log_sinkhorn(
            torch.zeros((1, 4, 20000), device=cuda), alpha, 5)


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


def test_match_kernel_at_the_loftr_shape(cuda):
    """LoFTR's coarse match in the detector: 15 views' 4,096 cells against
    a 1440x1920 frame's 43,200, d 256, scale 256·0.1, 2.65 G entries of S
    a call. Descriptors of norm 16 (LayerNorm's scale: S = 10 for a
    self-match), with 2,000 of each view's cells copied into the frame's
    set so that rows and columns have peaks. Judged per view (one conf
    matrix at a time) under match_gate."""
    gen = torch.Generator(device=cuda).manual_seed(19)
    b, n0, n1, d = 15, 4096, 43200, 256
    d0 = torch.randn(b, n0, d, device=cuda, generator=gen)
    d0 = d0 / d0.norm(dim=-1, keepdim=True) * 16.0
    d1 = torch.randn(b, n1, d, device=cuda, generator=gen)
    d1 = d1 / d1.norm(dim=-1, keepdim=True) * 16.0
    src = torch.randperm(n0, device=cuda, generator=gen)[:2000]
    dst = torch.randperm(n1, device=cuda, generator=gen)[:2000]
    d1[:, dst] = d0[:, src]
    before = match.dual_softmax_argmax.launches
    got = match.dual_softmax_argmax(d0, d1, 25.6)
    assert match.dual_softmax_argmax.launches == before + 1
    assert int(got[0].max()) < n1 and int(got[2].max()) < n0
    for v in range(b):
        gate = match.match_gate(tuple(t[v:v + 1] for t in got),
                                d0[v:v + 1], d1[v:v + 1], 25.6)
        assert gate.ok, (v, gate)
    # the planted peaks are found: each copied cell's row picks its copy
    assert float((got[0][:, src] == dst).float().mean()) > 0.99


def _loftr_planted(views):
    """Seeded LoFTR weights planted as tests/test_torch_loftr.py plants
    them: norm2 scaled by 1e-3, layer3_outconv whitening the views' coarse
    features so that a self-match's S is about 50 (on the CPU); and
    merge_feat scaled by 0.05, so that the fine heatmap's logits are of
    order 1 and its expectation does not amplify rounding."""
    from onepose_tpu_torch.models import loftr

    torch.manual_seed(0)
    sd = loftr.LoFTR().state_dict()
    for k in sd:
        if ".norm2." in k:
            sd[k] = sd[k] * 1e-3
    sd["backbone.layer3_outconv.weight"] = torch.eye(256)[..., None, None]
    x3, _ = loftr.backbone(loftr.prepare(sd), views)
    x = x3.permute(0, 2, 3, 1).reshape(-1, 256).double()
    lam, vec = torch.linalg.eigh(x.T @ x / len(x))
    lam = lam.clamp(min=0.1 * float(lam.mean()))
    white = vec @ torch.diag(lam.rsqrt()) @ vec.T
    s = (50 * 25.6 / (x @ white).square().sum(-1).median()).sqrt()
    sd["backbone.layer3_outconv.weight"] = (white * s).float()[..., None,
                                                               None]
    for k in ("weight", "bias"):
        sd[f"fine_preprocess.merge_feat.{k}"] *= 0.05
    return sd


def test_loftr_matcher_on_card_matches_cpu(cuda):
    """The LoFTR matcher at published widths on 3 views of 128x128
    against a 192x256 frame: the card's slate equals the CPU's, conf
    within 2e-4 relative (the two backbones differ by about 1e-5 relative,
    cuDNN's convolutions against the CPU's, which moves S, 50 for a
    self-match, by about 1e-3; 3.6e-5 read on an H100), refined points
    within 1e-3 px; one match-kernel launch a frame."""
    from onepose_tpu_torch.models import loftr

    g = torch.Generator().manual_seed(2)
    views = torch.rand(3, 1, 128, 128, generator=g)
    frame = torch.rand(1, 1, 192, 256, generator=g)
    frame[0, 0, 32:160, 64:192] = views[2, 0]
    sd, out = _loftr_planted(views), {}
    for dev in (torch.device("cpu"), cuda):
        m = loftr.Matcher({k: v.to(dev) for k, v in sd.items()},
                          views.to(dev))
        before = match.dual_softmax_argmax.launches
        out[dev.type] = m(frame.to(dev))
        if dev.type == "cuda":
            assert match.dual_softmax_argmax.launches == before + 1
            assert int(m.last_matches) == int(out["cuda"].valid.sum())
    cpu, card = out["cpu"], out["cuda"]
    assert torch.equal(card.valid.cpu(), cpu.valid) and bool(cpu.valid.any())
    v = cpu.valid
    assert torch.equal(card.j.cpu()[v], cpu.j[v])
    rel = (card.conf.cpu()[v] - cpu.conf[v]).abs() / cpu.conf[v]
    assert float(rel.max()) <= 2e-4
    assert float((card.points1.cpu()[v] - cpu.points1[v]).abs().max()) <= 1e-3
