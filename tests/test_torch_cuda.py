"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Needs an NVIDIA GPU and nvcc; skips without a card. This file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: the stem within the fused-stem gate's max|Δ| < 1e-4·max(|ref|,
1) (fp32 FMA in another order, no TF32); the match indices equal except
where conf's top-2 gap is below 1e-6, max values within 1e-6."""
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


def _stem_args(rng, shape, dev):
    arrs = (rng.uniform(0, 1, shape), rng.normal(size=(3, 3, 1, 64)) * 0.3,
            rng.normal(size=64) * 0.1, rng.normal(size=(3, 3, 64, 64)) * 0.06,
            rng.normal(size=64) * 0.1)
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs]


@pytest.mark.parametrize("shape", [(2, 64, 128, 1), (1, 40, 72, 1),
                                   (3, 16, 16, 1), (1, 2, 2, 1)])
def test_stem_kernel_matches_plain(cuda, shape):
    args = _stem_args(np.random.default_rng(0), shape, cuda)
    before = stem.fused_stem.launches
    got = stem.fused_stem(*args)
    assert stem.fused_stem.launches == before + 1
    ref = stem.stem_reference(*args)
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) < 1e-4 * max(
        float(ref.abs().max()), 1.0)


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
    ref = match.match_reference(d0, d1, scale)
    s = torch.einsum("bnd,bmd->bnm", d0, d1) / scale
    conf = torch.softmax(s, 1) * torch.softmax(s, 2)
    top_r = conf.topk(min(2, conf.shape[2]), dim=2).values
    top_c = conf.topk(min(2, conf.shape[1]), dim=1).values
    tie_r = (top_r[..., 0] - top_r[..., -1]) < 1e-6
    tie_c = (top_c[:, 0] - top_c[:, -1]) < 1e-6
    assert got[0].dtype == got[2].dtype == torch.int32
    assert not ((got[0] != ref[0]) & ~tie_r).any()
    assert not ((got[2] != ref[2]) & ~tie_c).any()
    assert float((got[1] - ref[1]).abs().max()) < 1e-6
    assert float((got[3] - ref[3]).abs().max()) < 1e-6
    return got


@pytest.mark.parametrize("b,n1,n2,d", [
    (2, 200, 144, 32), (1, 70, 48, 16), (2, 1000, 1990, 256),
    (1, 1, 3, 256), (1, 65, 129, 40)])
def test_match_kernel_matches_plain(cuda, b, n1, n2, d):
    rng = np.random.default_rng(n1)
    before = match.dual_softmax_argmax.launches
    _check_match(_unit(rng, (b, n1, d), cuda), _unit(rng, (b, n2, d), cuda))
    assert match.dual_softmax_argmax.launches == before + 1


def test_match_kernel_first_index_wins_ties(cuda):
    """Duplicated rows and columns make exact ties: the lower index wins
    in both argmaxes, however the blocks happen to be scheduled."""
    rng = np.random.default_rng(3)
    d0 = _unit(rng, (1, 70, 64), cuda)
    d1 = _unit(rng, (1, 100, 64), cuda)
    d0 = torch.cat([d0, d0], 1)
    d1 = torch.cat([d1, d1], 1)
    idx0, _, idx1, _ = match.dual_softmax_argmax(d0, d1, 0.07)
    assert (idx0 < 100).all() and (idx1 < 70).all()


def test_pipeline_on_card_matches_cpu(cuda):
    """The whole path at a small size, injected noise: same keypoints and
    matches as the CPU port, poses within 1e-3."""
    from onepose_tpu.datasets import anno
    from onepose_tpu_torch import pipeline
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
    cpu = pipeline.PosePipeline(sp, gats, db, **kw)(images, Ks, noise=noise)
    card = pipeline.PosePipeline(sp, gats, db, device=cuda, **kw)(
        images, Ks, noise=epnp.RansacNoise(*(n.to(cuda) for n in noise)))
    torch.testing.assert_close(card.keypoints2d.cpu(), cpu.keypoints2d,
                               rtol=0, atol=0)
    torch.testing.assert_close(card.matches0.cpu(), cpu.matches0,
                               rtol=0, atol=0)
    torch.testing.assert_close(card.poses.cpu(), cpu.poses, rtol=0,
                               atol=1e-3)
