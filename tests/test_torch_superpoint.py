"""The port's SuperPoint (models/superpoint.py) against the JAX package's,
fp32, ``stem="direct"`` (the plain math the port runs), weights bridged
from ``superpoint.init_params``.

Tolerances: dense scores and descriptors within 2e-6 (measured max 4.0e-7
at 64x64: fp32 convolutions summed in different orders); NMS exact (max
pooling does not round); keypoint sets and their order exact."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from onepose_tpu.models import superpoint as jsp
from onepose_tpu_torch.models import convert
from onepose_tpu_torch.models import gats_spg as tgats
from onepose_tpu_torch.models import superpoint as tsp


@pytest.fixture(scope="module")
def models():
    params = jsp.init_params(jax.random.PRNGKey(0))
    return params, convert.superpoint_from_jax(jax.tree.map(np.asarray,
                                                            params))


@pytest.mark.parametrize("hw,k", [(64, 64), (128, 128)])
def test_extract_matches_jax(models, hw, k):
    params, model = models
    rng = np.random.default_rng(hw)
    img = rng.uniform(0, 1, (2, hw, hw, 1)).astype(np.float32)
    s_j, d_j = jsp.dense_heads(params, jnp.asarray(img), stem="direct")
    s_t, d_t = tsp.dense_heads(model, torch.from_numpy(img))
    np.testing.assert_allclose(s_t.detach().numpy(), np.asarray(s_j),
                               atol=2e-6)
    np.testing.assert_allclose(d_t.detach().numpy(), np.asarray(d_j),
                               atol=2e-6)

    cfg = {"max_keypoints": k, "nms_radius": 3}
    ref = jsp.extract(params, jnp.asarray(img), {**cfg, "stem": "direct"})
    got = tsp.extract(model, torch.from_numpy(img), cfg)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(got.keypoints.numpy(),
                                  np.asarray(ref.keypoints))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores),
                               atol=2e-6)
    np.testing.assert_allclose(got.descriptors.numpy(),
                               np.asarray(ref.descriptors), atol=1e-5)


@pytest.mark.parametrize("radius", [3, 4])
def test_simple_nms_matches_jax(radius):
    rng = np.random.default_rng(1)
    scores = rng.uniform(0, 1, (2, 48, 56)).astype(np.float32)
    scores[0, 10:14, 10:14] = 0.99          # a tied plateau survives whole
    np.testing.assert_array_equal(
        tsp.simple_nms(torch.from_numpy(scores), radius).numpy(),
        np.asarray(jsp.simple_nms(jnp.asarray(scores), radius)))


def test_tie_plateau_lower_index_wins():
    """A constant plateau above the threshold survives NMS whole; a static
    top-K must take its pixels in row-major order (jax.lax.top_k's rule),
    which torch.topk does not promise."""
    h = w = 32
    scores = np.zeros((1, h, w), np.float32)
    scores[0, 8:18, 6:16] = 0.5
    desc = np.random.default_rng(0).normal(size=(1, 4, 4, 8)).astype(
        np.float32)
    cfg = dict(tsp.DEFAULT_CONFIG, max_keypoints=16)
    got = tsp.select_keypoints(torch.from_numpy(scores),
                               torch.from_numpy(desc), cfg)
    ref = jsp._select_keypoints_single(jnp.asarray(scores[0]),
                                       jnp.asarray(desc[0]), cfg)
    np.testing.assert_array_equal(got.keypoints[0].numpy(),
                                  np.asarray(ref.keypoints))
    ys, xs = np.divmod(np.arange(16), 10)
    np.testing.assert_array_equal(got.keypoints[0].numpy(),
                                  np.stack([xs + 6, ys + 8], 1))


def test_invalid_slots_follow_dustbin_convention(models):
    """Fewer candidates than K: the extra slots are masked, score 0,
    all-ones descriptors, parked at the image centre."""
    _, model = models
    img = torch.zeros((1, 32, 48, 1))
    out = tsp.extract(model, img, {"max_keypoints": 64,
                                   "keypoint_threshold": 0.5})
    invalid = ~out.mask[0]
    assert invalid.all()
    assert (out.scores[0] == 0).all()
    assert (out.descriptors[0] == 1).all()
    assert (out.keypoints[0] == torch.tensor([24.0, 16.0])).all()


def test_bf16_is_refused(models):
    """SuperPoint and GATsSPG compute in bf16 too
    (tests/test_torch_superpoint_bf16.py, test_torch_gats_spg_bf16.py); a
    dtype or stem that the port does not have is refused."""
    _, model = models
    assert tgats.resolve_config(
        {"compute_dtype": "bfloat16"})["compute_dtype"] == "bfloat16"
    with pytest.raises(ValueError, match="compute_dtype"):
        tgats.resolve_config({"compute_dtype": "float16"})
    for cfg in ({"stem_dtype": "float16"}, {"compute_dtype": "float16"},
                {"stem": "xla"}):
        with pytest.raises(ValueError):
            tsp.extract(model, torch.zeros((1, 16, 16, 1)), cfg)
