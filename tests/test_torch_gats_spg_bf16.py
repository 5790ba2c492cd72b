"""GATsSPG's ``compute_dtype="bfloat16"`` in the port against the JAX
package's bf16 mode, on the CPU, D = 256, weights bridged from
``gats_spg.init_params``, the same unit descriptors on both sides.

The port rounds where the JAX package's compiled bf16 graph rounds (the
module docstring of ``onepose_tpu_torch/models/gats_spg.py``), so the two
bf16 runs differ only where an fp32 sum taken in another order lands on
the other side of a bf16 rounding. Tolerances:

- final descriptors at 1 block (3 layers): the root-mean-square of the
  port's difference from JAX bf16 at most a quarter of JAX's own
  bf16-vs-fp32 difference (2.4% of it measured). Deeper, a rounding that
  an fp32 sum in another order flips in one layer moves the next layers'
  roundings, and the two bf16 runs part as two XLA backends would: 0.37
  of that difference at 2 blocks, 0.55 at 4 (measured). So at 1, 2 and
  4 blocks the port's bf16 error against JAX fp32 is held within 5% of
  JAX bf16's own error (0.0%, 0.5% and 1.4% measured);
- match indices equal outside relative near-ties of ``match_gate``'s
  ``GATE_REL`` in JAX's bf16 conf matrix;
- one bf16 train step's loss (jitted on the JAX side, as its train step
  runs) within 1e-5 relative of JAX's and within a quarter of JAX's own
  bf16-vs-fp32 loss gap (2.2e-6 relative and 5% of that gap measured),
  its gradients finite.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_tpu.models import gats_spg as jgs
from onepose_tpu.train import trainer as jt
from onepose_tpu_torch.models import convert
from onepose_tpu_torch.models import gats_spg as tgs
from onepose_tpu_torch.ops.match import GATE_REL
from onepose_tpu_torch.train import trainer as tt

BF16 = {"compute_dtype": "bfloat16"}


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _inputs(rng, b=2, n1=64, n2=48, leaf=4, d=256):
    return {
        "descriptors2d_query": _unit(rng.normal(size=(b, n1, d))),
        "descriptors3d_db": _unit(rng.normal(size=(b, n2, d))),
        "descriptors2d_db": _unit(rng.normal(size=(b, n2 * leaf, d))),
        "mask2d": np.arange(n1)[None, :] < np.array([[n1 - 7], [n1]]),
        "mask3d": np.arange(n2)[None, :] < np.array([[n2], [n2 - 5]]),
    }


def _world(num_blocks):
    rng = np.random.default_rng(num_blocks)
    params = jgs.init_params(jax.random.PRNGKey(num_blocks),
                             {"num_blocks": num_blocks})
    model = convert.gats_spg_from_jax(jax.tree.map(np.asarray, params))
    return params, model, _inputs(rng)


def _jax_body(params, data, cfg):
    cfg = {**jgs.DEFAULT_CONFIG, **cfg}
    return [np.asarray(x) for x in jax.jit(
        lambda p, x: jgs.gnn_body(p, x, cfg))(
            params, {k: jnp.asarray(v) for k, v in data.items()})]


def _port_body(model, data, cfg):
    with torch.no_grad():
        out = tgs.gnn_body(model, {k: torch.from_numpy(np.asarray(v))
                                   for k, v in data.items()},
                           tgs.resolve_config(cfg))
    return out


def _rms(a, b):
    return float(np.sqrt(np.mean([np.mean((x - y) ** 2)
                                  for x, y in zip(a, b)])))


def _bodies(num_blocks):
    params, model, data = _world(num_blocks)
    cfg = {"num_blocks": num_blocks}
    ref32 = _jax_body(params, data, cfg)
    ref16 = _jax_body(params, data, {**cfg, **BF16})
    got = _port_body(model, data, {**cfg, **BF16})
    assert all(g.dtype == torch.float32 for g in got)
    got = [g.numpy() for g in got]
    for g in got:   # unit descriptors for the fp32 matching head
        np.testing.assert_allclose(np.linalg.norm(g, axis=-1), 1.0,
                                   atol=1e-5)
    assert _rms(ref16, ref32) > 1e-5   # bf16 really differs from fp32
    return ref32, ref16, got


def test_gnn_body_bf16_matches_jax():
    ref32, ref16, got = _bodies(1)
    jax_gap, port_gap = _rms(ref16, ref32), _rms(got, ref16)
    assert port_gap <= 0.25 * jax_gap, (port_gap, jax_gap)


@pytest.mark.parametrize("num_blocks", [1, 2, 4])
def test_gnn_body_bf16_error_is_jax_bf16s(num_blocks):
    ref32, ref16, got = _bodies(num_blocks)
    jax_err, port_err = _rms(ref16, ref32), _rms(got, ref32)
    assert abs(port_err - jax_err) <= 0.05 * jax_err, (port_err, jax_err)


def test_bf16_match_indices_equal_outside_near_ties():
    """``forward`` in bf16: matches equal to JAX's except at rows or
    columns whose conf top-2 gap in JAX's bf16 conf is a relative near-tie
    (``GATE_REL``), and the match-only path returns the same matches."""
    params, model, data = _world(1)
    cfg = {"num_blocks": 1, "match_threshold": 1e-3, **BF16}
    ref = jax.jit(lambda p, x: jgs.forward(p, x, cfg))(
        params, {k: jnp.asarray(v) for k, v in data.items()})
    tdata = {k: torch.from_numpy(np.asarray(v)) for k, v in data.items()}
    got = tgs.forward(model, tdata, cfg)
    conf = np.asarray(ref.conf_matrix)
    assert got.conf_matrix.dtype == torch.float32
    near = {}
    for name, axis in (("matches0", 2), ("matches1", 1)):
        top = -np.sort(-conf, axis=axis)
        top1, top2 = np.take(top, 0, axis), np.take(top, 1, axis)
        near[name] = (top1 - top2) < GATE_REL * top1
    ties = near["matches0"].any(1, keepdims=True) | near["matches1"].any(
        1, keepdims=True)
    assert (got.matches0 >= 0).sum() > 10
    for name in ("matches0", "matches1"):
        a = getattr(got, name).numpy()
        b = np.asarray(getattr(ref, name))
        assert ((a == b) | ties).all(), name
    only = tgs.forward_match_only(model, tdata, cfg)
    assert torch.equal(only.matches0, got.matches0)


def test_bf16_train_step_loss_matches_jax():
    """The training loss in bf16 (``trainer.compute_loss``) against the
    JAX package's on the same batch, and its gradient reaching the fp32
    parameters (finite, not all zero)."""
    params, model, data = _world(1)
    rng = np.random.default_rng(3)
    batch = {k: data[k] for k in ("descriptors2d_query", "descriptors3d_db",
                                  "descriptors2d_db")}
    batch["conf_gt"] = (rng.uniform(size=(2, 64, 48)) < 0.05).astype(
        np.int32)
    cfg = {"num_blocks": 1, **BF16}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(c):   # jitted, as the JAX train step runs it
        c = {**jgs.DEFAULT_CONFIG, **c}
        return float(jax.jit(lambda p, b: jt.compute_loss(p, b, c))(
            params, jbatch))

    ref, ref32 = jloss(cfg), jloss({"num_blocks": 1})
    loss = tt.compute_loss(model, {k: torch.from_numpy(v)
                                   for k, v in batch.items()}, cfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref, rtol=1e-5)
    assert abs(loss.item() - ref) <= 0.25 * abs(ref - ref32), (ref, ref32)
    grads = [p.grad for p in model.parameters()]
    assert all(g is not None and g.dtype == torch.float32
               and torch.isfinite(g).all() for g in grads)
    assert any(float(g.abs().max()) > 0 for g in grads)


def test_bf16_remat_matches_standard():
    _, model, data = _world(1)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in data.items()}
    out = []
    for remat in (False, True):
        model.zero_grad()
        m0, m1 = tgs.gnn_body(model, batch, tgs.resolve_config(
            {"num_blocks": 1, "remat": remat, **BF16}))
        (m0.sum() + m1.square().sum()).backward()
        out.append([m0.detach(), m1.detach()]
                   + [p.grad.clone() for p in model.parameters()])
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
