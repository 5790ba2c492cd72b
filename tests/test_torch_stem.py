"""The port's stem (ops/stem.py) against the JAX package's fused Pallas
stem (interpret mode) and its XLA reference, on the CPU, where the port's
wrapper takes its plain PyTorch version.

Tolerance: the fused-stem gate's, max|Δ| < 1e-4·max(|ref|, 1)
(onepose_tpu/models/superpoint.py::fused_stem_supported): both sides are
fp32 convolutions summed in different orders."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from onepose_tpu.models import superpoint as jsp
from onepose_tpu.ops.pallas_stem import fused_stem_tiled
from onepose_tpu_torch.ops import stem
from test_pallas_stem import reference_stem


def _gate_bound(ref):
    return 1e-4 * max(float(np.abs(ref).max()), 1.0)


def _weights(params):
    return [np.array(params[n][k]) for n in ("conv1a", "conv1b")
            for k in ("w", "b")]


def test_plain_stem_matches_pallas_tiled_at_gate_shape():
    """[2,64,256,1] with init_params weights: the gate's own check."""
    rng = np.random.default_rng(0)
    params = jsp.init_params(jax.random.PRNGKey(0))
    w1a, b1a, w1b, b1b = _weights(params)
    imgs = rng.uniform(0, 1, (2, 64, 256, 1)).astype(np.float32)
    ref = np.asarray(fused_stem_tiled(
        jnp.asarray(imgs), w1a, b1a, w1b, b1b, interpret=True))
    got = stem.fused_stem(*map(torch.from_numpy,
                               (imgs, w1a, b1a, w1b, b1b))).numpy()
    assert got.shape == ref.shape == (2, 32, 128, 64)
    assert np.abs(got - ref).max() < _gate_bound(ref)


@pytest.mark.parametrize("shape", [(2, 64, 128, 1), (1, 40, 72, 1)])
def test_plain_stem_matches_xla_reference(shape):
    """vs tests/test_pallas_stem.py::reference_stem, including a size that
    is not a multiple of the CUDA kernel's 16-pixel tile."""
    rng = np.random.default_rng(1)
    imgs = rng.uniform(0, 1, shape).astype(np.float32)
    w1a = (rng.normal(size=(3, 3, 1, 64)) * 0.2).astype(np.float32)
    b1a = (rng.normal(size=64) * 0.1).astype(np.float32)
    w1b = (rng.normal(size=(3, 3, 64, 64)) * 0.05).astype(np.float32)
    b1b = (rng.normal(size=64) * 0.1).astype(np.float32)
    ref = np.asarray(reference_stem(jnp.asarray(imgs), w1a, b1a, w1b, b1b))
    got = stem.stem_reference(*map(torch.from_numpy,
                                   (imgs, w1a, b1a, w1b, b1b))).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < _gate_bound(ref)


def test_stem_dispatch_is_by_device():
    """A CPU tensor takes the plain version and counts no launch; a device
    with no kernel raises instead of falling back."""
    rng = np.random.default_rng(2)
    args = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.uniform(0, 1, (1, 16, 16, 1)), rng.normal(size=(3, 3, 1, 64)),
        rng.normal(size=64), rng.normal(size=(3, 3, 64, 64)),
        rng.normal(size=64))]
    before = stem.fused_stem.launches
    torch.testing.assert_close(stem.fused_stem(*args),
                               stem.stem_reference(*args), rtol=0, atol=0)
    assert stem.fused_stem.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        stem.fused_stem(*(a.to("meta") for a in args))
