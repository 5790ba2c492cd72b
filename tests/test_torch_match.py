"""The port's dual-softmax argmax (ops/match.py) against the JAX package's
Pallas kernel in interpret mode, on the CPU, where the port's wrapper takes
its plain PyTorch version; and the port's forward_match_only against its
forward and against the JAX forward.

Tolerances: indices exactly equal (seeded inputs whose top-2 gaps are far
above fp32 rounding); max values within 1e-6, as tests/test_pallas_match.py
holds the Pallas kernel."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from onepose_tpu.models import gats_spg as jgs
from onepose_tpu.ops.pallas_match import dual_softmax_argmax as pallas_match
from onepose_tpu_torch.models import convert
from onepose_tpu_torch.models import gats_spg as tgs
from onepose_tpu_torch.ops import match


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("b,n1,n2,d,tile,seed", [
    (2, 200, 144, 32, 64, 0),   # tests/test_pallas_match.py::test_matches_reference
    (1, 70, 48, 16, 32, 1),     # ::test_ragged_n1
])
def test_plain_match_matches_pallas(b, n1, n2, d, tile, seed):
    rng = np.random.default_rng(seed)
    d0 = _unit(rng.normal(size=(b, n1, d)))
    d1 = _unit(rng.normal(size=(b, n2, d)))
    ref = pallas_match(jnp.asarray(d0), jnp.asarray(d1), 0.07, tile_n1=tile,
                       interpret=True)
    got = match.dual_softmax_argmax(torch.from_numpy(d0),
                                    torch.from_numpy(d1), 0.07)
    for i in (0, 2):
        assert got[i].dtype == torch.int32
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref[i]))
    for i in (1, 3):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]),
                                   atol=1e-6)


def test_first_index_wins_ties():
    """Duplicated DB descriptors make exact ties; the lower index wins, as
    in the strict ``>`` of the Pallas kernel."""
    rng = np.random.default_rng(3)
    d0 = _unit(rng.normal(size=(1, 8, 16)))
    d1 = _unit(rng.normal(size=(1, 6, 16)))
    d1 = np.concatenate([d1, d1], axis=1)          # columns j and j+6 tie
    d0 = np.concatenate([d0, d0], axis=1)          # rows i and i+8 tie
    idx0, _, idx1, _ = match.dual_softmax_argmax(
        torch.from_numpy(d0), torch.from_numpy(d1), 0.07)
    assert (idx0 < 6).all() and (idx1 < 8).all()
    ref = pallas_match(jnp.asarray(d0), jnp.asarray(d1), 0.07, tile_n1=8,
                       interpret=True)
    np.testing.assert_array_equal(idx0.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(idx1.numpy(), np.asarray(ref[2]))


def test_match_dispatch_raises_without_kernel():
    x = torch.zeros((1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        match.dual_softmax_argmax(x, x, 0.07)


def test_forward_match_only_agrees_with_forward_and_jax():
    """tests/test_pallas_match.py::test_forward_match_only_agrees_with_forward
    on the port, plus the JAX forward. A low match threshold gives random
    weights matches to compare (their conf stays far below 0.2)."""
    rng = np.random.default_rng(2)
    params = jgs.init_params(jax.random.PRNGKey(0), {"num_blocks": 1})
    model = convert.gats_spg_from_jax(jax.tree.map(np.asarray, params))
    B, N1, N2, L = 2, 64, 48, 2
    data = {
        "descriptors2d_query": _unit(rng.normal(size=(B, N1, 256))),
        "descriptors3d_db": _unit(rng.normal(size=(B, N2, 256))),
        "descriptors2d_db": _unit(rng.normal(size=(B, N2 * L, 256))),
        "mask2d": np.arange(N1)[None, :] < np.array([[50], [64]]),
    }
    cfg = {"num_blocks": 1, "match_threshold": 1e-3}
    tdata = {k: torch.from_numpy(v) for k, v in data.items()}
    full = tgs.forward(model, tdata, cfg)
    fast = tgs.forward_match_only(model, tdata, cfg)
    ref = jgs.forward(params, {k: jnp.asarray(v) for k, v in data.items()},
                      cfg)
    assert (full.matches0 >= 0).sum() > 10
    assert fast.conf_matrix.shape == (B, 0, 0)
    for got in (full, fast):
        np.testing.assert_array_equal(got.matches0.numpy(),
                                      np.asarray(ref.matches0))
        np.testing.assert_array_equal(got.matches1.numpy(),
                                      np.asarray(ref.matches1))
        np.testing.assert_allclose(got.matching_scores0.numpy(),
                                   np.asarray(ref.matching_scores0),
                                   atol=1e-6)
