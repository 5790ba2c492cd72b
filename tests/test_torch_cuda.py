"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Needs an NVIDIA GPU and nvcc; skips without a card. This file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: the stem within the fused-stem gate's max|Δ| < 1e-4·max(|ref|,
1) (3xTF32 on the tensor cores, fp32-class), and its error against an fp64
reference at most twice cuDNN fp32's (TF32 off); the match kernel under
``match.match_gate``: each max conf within GATE_REL = 3e-5 of the plain
max of its row or column, indices equal except in relative near-ties
(fp32-class products agree to about 1e-5, TF32 ones do not)."""
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
                                   (1, 34, 130, 1), (2, 18, 66, 1)])
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
