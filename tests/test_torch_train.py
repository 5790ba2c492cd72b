"""Training with the port (onepose_tpu_torch/train/*) against the JAX
package's training (onepose_tpu/train/*, the root train.py), on the CPU.

Seeded numpy inputs go through both; the JAX package's initial parameters
are carried across by ``models/convert.py``. GATsSPG at 1 block, D=32,
the dataset of ``tests/test_torch_gats_dataset.py``
(shape2d 24, shape3d 40, leaf 4). Tolerances:

- focal loss within 1e-6 relative, its gradient within 1e-7 absolute
  (one op chain, fp32 rounding);
- loss and gradients of the GNN within 1e-5 relative to their largest
  entry (fp32 sums in another order: per-head einsums in the port, one
  block-masked product in JAX);
- the optimizer fed the same gradients within 5e-7 of optax's parameters
  at an LR of 1 (a few fp32 ulps);
- after train steps: each parameter entry within 2e-6 plus what Adam
  makes of the gradient tolerance δ (1e-5 of the largest clipped
  gradient, as above): a step moves an entry by lr·m̂/(√v̂+ε), which moves by up to
  2δ/(√v̂+ε) when each gradient moves by δ, at most 2 (read from JAX's
  final v̂, doubled for the updates before it). Entries whose gradient is
  near zero take the whole step of either sign: among them the biases
  that instance norm cancels (proj_v, merge and mlp0 of every attention
  layer), whose gradient is rounding noise in both packages;
- leaf sampling with JAX's uniforms injected, and batch materialization:
  exact.
"""
import json
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from onepose_tpu.models import gats_spg as jgats
from onepose_tpu.train import callbacks as jcb, trainer as jt
from onepose_tpu.train.loss import focal_loss as jfocal
from onepose_tpu_torch.datasets import gats_dataset as tds
from onepose_tpu_torch.models import convert, gats_spg as tgats
from onepose_tpu_torch.train import callbacks as tcb, entry, trainer as tt
from onepose_tpu_torch.train.loss import focal_loss as tfocal
from onepose_tpu_torch.utils import model_io
from test_torch_gats_dataset import KW, LEAF, SHAPE2D, SHAPE3D, train_json  # noqa: F401

CFG = {"num_blocks": 1, "descriptor_dim": 32}
# their gradient is rounding noise: instance norm cancels these biases
CANCELLED = ("proj_v.bias", "merge.bias", "mlp0.bias")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree) -> dict:
    """A JAX parameter (or gradient) tree as the port's named tensors."""
    return dict(convert.gats_spg_from_jax(_np_tree(tree)).named_parameters())


def _dense_batch(train_json, seed=7):  # noqa: F811
    ds = tds.GATsSPGDataset(train_json, split="train", **KW)
    return next(ds.batches(2, shuffle=True, seed=seed, num_threads=1))


# --------------------------------------------------------------------------
# focal loss
# --------------------------------------------------------------------------

@pytest.mark.parametrize("gt", ["random", "no_positives", "no_negatives"])
def test_focal_loss_matches_jax(gt):
    rng = np.random.default_rng(0)
    pred = rng.uniform(0.001, 0.999, (2, 16, 24)).astype(np.float32)
    pred[0, 0, :2] = [1e-13, 1e-30]    # under the fp32 clip
    conf_gt = {"random": (rng.uniform(size=pred.shape) < 0.1),
               "no_positives": np.zeros(pred.shape),
               "no_negatives": np.ones(pred.shape)}[gt].astype(np.int32)
    ref, ref_grad = jax.value_and_grad(
        lambda p: jfocal(p, jnp.asarray(conf_gt)))(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    got = tfocal(p, torch.from_numpy(conf_gt))
    got.backward()
    assert np.isfinite(got.item())
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_grad),
                               rtol=0, atol=1e-7)


def test_focal_loss_clip_keeps_fp32_rounding():
    """1 - 1e-12 is 1.0 in fp32: a prediction of exactly 1 on a negative
    gives an infinite loss in both packages."""
    pred = np.full((1, 2, 2), 0.5, np.float32)
    pred[0, 0, 0] = 1.0
    gt = np.zeros((1, 2, 2), np.int32)
    ref = float(jfocal(jnp.asarray(pred), jnp.asarray(gt)))
    got = tfocal(torch.from_numpy(pred), torch.from_numpy(gt)).item()
    assert np.isinf(ref) and np.isinf(got)


# --------------------------------------------------------------------------
# optimizer rules on a toy tree
# --------------------------------------------------------------------------

def _toy(rng):
    shapes = {"a": (5, 3), "b": (7,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    # micro-steps 0, 3, 6 large (clipped), the others under the clip norm
    grads = [{k: (rng.normal(size=s) * (1.0 if i % 3 == 0 else 0.05)
                  ).astype(np.float32) for k, s in shapes.items()}
             for i in range(8)]
    return params, grads


@pytest.mark.parametrize("accumulate,weight_decay",
                         [(1, 0.0), (2, 0.0), (2, 0.1), (3, 0.0)])
def test_optimizer_rules_match_optax(accumulate, weight_decay):
    """Clip (optax's rule, no epsilon), decay, Adam (fp32 bias
    corrections), the multi-step LR and accumulation over 8 micro-steps of
    a toy tree, fed the same gradients: parameters within 5e-7 at LR 1."""
    params, grads = _toy(np.random.default_rng(0))
    kw = dict(base_lr=1.0, milestones_steps=[2], accumulate_steps=accumulate,
              weight_decay=weight_decay)
    tx = jt.make_optimizer(**kw)
    state, ref = tx.init(params), params
    got = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
           for k, v in params.items()}
    opt = tt.make_optimizer(**kw)(list(got.items()))
    applied = []
    for g in grads:
        upd, state = tx.update(g, state, ref)
        ref = optax.apply_updates(ref, upd)
        for k in got:
            got[k].grad = torch.from_numpy(g[k])
        applied.append(opt.step())
        for k in got:
            np.testing.assert_allclose(got[k].detach().numpy(),
                                       np.asarray(ref[k]), rtol=0, atol=5e-7)
    assert applied == [i % accumulate == accumulate - 1 for i in range(8)]


def test_accumulation_and_schedule_count_updates():
    """base_lr 1, milestone 2, accumulation 2: updates land on micro-steps
    1, 3, 5 and 7, and the LR halves at the third update (micro-step 5),
    once the update count reaches the milestone."""
    params, grads = _toy(np.random.default_rng(1))
    p = {k: torch.nn.Parameter(torch.from_numpy(v)) for k, v in
         params.items()}
    opt = tt.make_optimizer(base_lr=1.0, milestones_steps=[2],
                            accumulate_steps=2)(list(p.items()))
    lrs, applied = [], []
    for g in grads:
        for k in p:
            p[k].grad = torch.from_numpy(g[k])
        lrs.append(float(opt.schedule(opt.updates)))
        applied.append(opt.step())
    assert [i for i, a in enumerate(applied) if a] == [1, 3, 5, 7]
    assert lrs == [1.0] * 4 + [0.5] * 4
    sched = jt.multistep_schedule(1.0, [2], 0.5)
    mine = tt.multistep_schedule(1.0, [2], 0.5)
    assert [float(sched(c)) for c in range(6)] == [float(mine(c))
                                                   for c in range(6)]


def test_adam_bias_correction_is_optax_fp32():
    """The first update of the port's Adam is optax's to 1e-7 relative;
    torch.optim.Adam's (bias corrections in fp64) is 6.6e-6 away."""
    g = np.random.default_rng(2).normal(size=64).astype(np.float32)
    tx = optax.chain(optax.scale_by_adam(), optax.scale(-1.0))
    ref = np.asarray(tx.update(jnp.asarray(g), tx.init(jnp.zeros(64)))[0])
    p = torch.nn.Parameter(torch.zeros(64))
    p.grad = torch.from_numpy(g)
    tt.make_optimizer(base_lr=1.0, grad_clip=1e9)([("p", p)]).step()
    np.testing.assert_allclose(p.detach().numpy(), ref, rtol=1e-7)
    q = torch.nn.Parameter(torch.zeros(64))
    q.grad = torch.from_numpy(g)
    torch.optim.Adam([q], lr=1.0).step()
    rel = np.abs(q.detach().numpy() / ref - 1)
    assert rel.min() > 3e-6, rel.min()


# --------------------------------------------------------------------------
# the model's loss, gradients and train steps
# --------------------------------------------------------------------------

def _adam_state(opt_state):
    return next(x for x in jax.tree.leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(x, optax.ScaleByAdamState))


def _assert_params_close(got: dict, jstate, lr_sum: float):
    """``got`` against JAX's parameters within the tolerance of the module
    docstring; ``lr_sum`` is the sum of the LRs of the updates made."""
    adam = _adam_state(jstate.opt_state)
    count = max(int(adam.count), 1)
    nu_hat = {n: v.detach().numpy() / (1 - 0.999 ** count)
              for n, v in _port(adam.nu).items()}
    delta = 1e-5 * max(float(np.sqrt(v).max()) for v in nu_hat.values())
    for name, r in _port(jstate.params).items():
        moved = 2 * np.minimum(2.0, 2 * delta / (np.sqrt(nu_hat[name])
                                                  + 1e-8))
        err = np.abs(got[name].detach().numpy() - r.detach().numpy())
        bad = err > 2e-6 + lr_sum * moved
        assert not bad.any(), (name, float(err.max()))


def test_loss_and_gradients_match_jax(train_json):  # noqa: F811
    batch = _dense_batch(train_json)
    params = jgats.init_params(jax.random.PRNGKey(0), CFG)
    cfg = {**jgats.DEFAULT_CONFIG, **CFG}
    ref_loss, ref_grads = jax.value_and_grad(jt.compute_loss)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, cfg)
    model = convert.gats_spg_from_jax(_np_tree(params))
    loss = tt.compute_loss(model, {k: torch.from_numpy(v)
                                   for k, v in batch.items()}, CFG)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    ref_g = _port(ref_grads)
    scale = max(float(g.detach().abs().max()) for g in ref_g.values())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_g[name].detach().numpy(),
                                   rtol=0, atol=1e-5 * scale, err_msg=name)
        if name.endswith(CANCELLED):
            assert float(ref_g[name].abs().max()) < 1e-6 * scale, name


def test_train_steps_match_jax(train_json):  # noqa: F811
    """Three micro-steps of ``train_step`` with accumulation 2 (one
    update, on micro-step 1): losses, each micro-step's gradients and the
    parameters against JAX's ``make_optimizer`` and ``train_step``."""
    batches = [_dense_batch(train_json, seed) for seed in (7, 8, 9)]
    kw = dict(base_lr=1e-3, milestones_steps=[1], accumulate_steps=2)
    tx = jt.make_optimizer(**kw)
    jstate = jt.init_train_state(jax.random.PRNGKey(0), tx, CFG)
    model = convert.gats_spg_from_jax(_np_tree(jstate.params))
    grads = []

    def keep(names, gs):
        grads.append(dict(zip(names, (g.clone() for g in gs))))
        return gs

    state = tt.init_train_state(tt.make_optimizer(**kw, grad_transforms=[
        keep]), CFG, model=model, device="cpu")
    jstep, tstep = jt.make_train_step(tx, CFG), tt.make_train_step(CFG)
    cfg = {**jgats.DEFAULT_CONFIG, **CFG}
    for i, batch in enumerate(batches):
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        ref_g = _port(jax.grad(jt.compute_loss)(jstate.params, jbatch, cfg))
        jstate, ref_loss = jstep(jstate, jbatch)
        state, loss = tstep(state, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
        scale = max(float(g.detach().abs().max()) for g in ref_g.values())
        for name, g in grads[i].items():
            np.testing.assert_allclose(
                g.numpy(), ref_g[name].detach().numpy(), rtol=0,
                atol=1e-5 * scale, err_msg=f"micro-step {i}: {name}")
        assert state.step == int(jstate.step) == i + 1
        _assert_params_close(dict(state.model.named_parameters()), jstate,
                             kw["base_lr"] * state.optimizer.updates)
    assert state.optimizer.updates == 1


def test_remat_matches_standard(train_json):  # noqa: F811
    batch = {k: torch.from_numpy(v)
             for k, v in _dense_batch(train_json).items()}
    grads = []
    for remat in (False, True):
        model = convert.gats_spg_from_jax(convert.init_gats_spg_params(
            np.random.default_rng(0), CFG))
        loss = tt.compute_loss(model, batch, {**CFG, "remat": remat})
        loss.backward()
        grads.append((loss.item(), [p.grad.clone()
                                    for p in model.parameters()]))
    assert grads[0][0] == grads[1][0]
    for a, b in zip(grads[0][1], grads[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_unfreeze_after_matches_jax(train_json):  # noqa: F811
    """``unfreeze_after`` counts micro-steps (chained outside the
    accumulation in JAX): with the GNN frozen for 3 micro-steps and
    accumulation 2, the first update leaves the GNN alone and its Adam
    moments zero; the second moves it, as JAX's chain does."""
    batches = [_dense_batch(train_json, s) for s in (7, 8, 9, 10)]
    kw = dict(base_lr=1e-3, accumulate_steps=2)
    tx = optax.chain(jcb.unfreeze_after(3, {"gnn": True,
                                            "final_proj": False}),
                     jt.make_optimizer(**kw))
    jstate = jt.init_train_state(jax.random.PRNGKey(1), tx, CFG)
    model = convert.gats_spg_from_jax(_np_tree(jstate.params))
    frozen0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = tt.init_train_state(
        tt.make_optimizer(**kw, grad_transforms=[tcb.unfreeze_after(
            3, ["gnn"])]), CFG, model=model, device="cpu")
    jstep, tstep = jt.make_train_step(tx, CFG), tt.make_train_step(CFG)
    for i, batch in enumerate(batches):
        jstate, _ = jstep(jstate, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
        state, _ = tstep(state, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
        named = dict(state.model.named_parameters())
        _assert_params_close(named, jstate,
                             kw["base_lr"] * state.optimizer.updates)
        if i == 1:      # after the first update
            for n, p in named.items():
                moved = not torch.equal(p.detach(), frozen0[n])
                assert moved == (not n.startswith("gnn.")), n
            mu = dict(zip(state.optimizer.names, state.optimizer.mu))
            assert all(float(mu[n].abs().max()) == 0 for n in mu
                       if n.startswith("gnn."))
    assert state.optimizer.grad_transforms[0].count == 4
    assert not torch.equal(dict(state.model.named_parameters())[
        "gnn.0.W"].detach(), frozen0["gnn.0.W"])


# --------------------------------------------------------------------------
# the device-resident input path
# --------------------------------------------------------------------------

def _jax_uniform(seed, shape3d=SHAPE3D, num_leaf=LEAF):
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(int(seed)),
                                         (num_leaf, shape3d)))


def test_sample_leaves_matches_jax():
    """With JAX's uniforms injected the port picks JAX's rows exactly,
    one item at a time or a batch at once."""
    shape3d, num_leaf = 12, 4
    counts = np.array([0, 1, 3, 4, 9, 2, 7, 0, 5, 4, 1, 6], np.int32)
    offsets = (np.cumsum(counts) - counts).astype(np.int32)
    dustbin = int(counts.sum()) + 3
    us, refs = [], []
    for seed in range(6):
        us.append(_jax_uniform(seed, shape3d, num_leaf))
        refs.append(np.asarray(jt.sample_leaves_on_device(
            jnp.uint32(seed), jnp.asarray(counts), jnp.asarray(offsets),
            num_leaf, dustbin)))
        got = tt.sample_leaves_on_device(
            torch.from_numpy(us[-1]), torch.from_numpy(counts),
            torch.from_numpy(offsets), num_leaf, dustbin)
        np.testing.assert_array_equal(got.numpy(), refs[-1])
    got = tt.sample_leaves_on_device(
        torch.from_numpy(np.stack(us)),
        torch.from_numpy(counts).expand(6, -1),
        torch.from_numpy(offsets).expand(6, -1), num_leaf, dustbin)
    np.testing.assert_array_equal(got.numpy(), np.stack(refs))
    assert got.dtype == torch.int32


def test_leaf_uniforms_are_seeded_and_in_range():
    a = tt.leaf_uniforms([3, 4], LEAF, SHAPE3D)
    assert a.shape == (2, LEAF, SHAPE3D) and a.dtype == np.float32
    assert (a >= 0).all() and (a < 1).all()
    np.testing.assert_array_equal(a, tt.leaf_uniforms([3, 4], LEAF, SHAPE3D))
    assert not np.array_equal(a[0], a[1])


def _light(ds, on_device_leaves, seed=3):
    db, obj_index = ds.device_db()
    light = next(ds.light_batches(obj_index, db["t_max"], 2, seed=seed,
                                  on_device_leaves=on_device_leaves))
    return db, light


@pytest.mark.parametrize("on_device_leaves", [False, True])
def test_materialize_light_batch_matches_jax(train_json,  # noqa: F811
                                             on_device_leaves):
    """The port's gathered batch equals JAX's exactly (JAX's uniforms
    injected where the leaves are sampled on the device); with leaf
    indices it also equals the host path's dense batch."""
    ds = tds.GATsSPGDataset(train_json, split="train", **KW)
    db, light = _light(ds, on_device_leaves)
    keys = ["clt_stack", "avg_stack", "count_stack", "offset_stack"]
    ref = jt.materialize_light_batch(
        {k: jnp.asarray(db[k]) for k in keys},
        {k: jnp.asarray(v) for k, v in light.items()}, SHAPE2D, SHAPE3D,
        num_leaf=LEAF)
    tlight = {k: torch.from_numpy(np.asarray(v, np.int64)
                                  if k == "leaf_seed" else v)
              for k, v in light.items()}
    if on_device_leaves:
        tlight["leaf_uniform"] = torch.from_numpy(np.stack(
            [_jax_uniform(s) for s in light["leaf_seed"]]))
    got = tt.materialize_light_batch(
        {k: torch.from_numpy(db[k]) for k in keys}, tlight, SHAPE2D,
        SHAPE3D, num_leaf=LEAF)
    host = next(tds.GATsSPGDataset(train_json, split="train", **KW).batches(
        2, shuffle=True, seed=3, num_threads=1))
    for k in ("descriptors2d_query", "descriptors3d_db", "descriptors2d_db",
              "conf_gt"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
        if not on_device_leaves:
            np.testing.assert_array_equal(got[k].numpy(), host[k],
                                          err_msg=k)


def test_out_of_bounds_pairs_are_dropped():
    """Padding pairs (shape2d, shape3d) are dropped, negative indices wrap
    first (JAX's mode="drop" scatter), and a saturated item keeps its
    corner; the pad region takes pad_val."""
    s2, s3 = 4, 5
    pairs = np.array([[[0, 1], [s2, s3], [-1, -1], [3, 9], [2, 2]],
                      [[s2, s3]] * 5], np.int32)
    light = {"obj_idx": np.zeros(2, np.int32),
             "leaf_idx": np.zeros((2, s3), np.int32),
             "descriptors2d_query": np.zeros((2, s2, 3), np.float32),
             "pairs": pairs, "num2d": np.array([4, 2], np.int32),
             "num3d": np.array([5, 3], np.int32)}
    db = {"clt_stack": np.ones((1, 2, 3), np.float32),
          "avg_stack": np.ones((1, s3, 3), np.float32)}
    for pad_val in (0, -1):
        ref = jt.materialize_light_batch(
            {k: jnp.asarray(v) for k, v in db.items()},
            {k: jnp.asarray(v) for k, v in light.items()}, s2, s3,
            pad_val=pad_val, num_leaf=1)["conf_gt"]
        got = tt.materialize_light_batch(
            {k: torch.from_numpy(v) for k, v in db.items()},
            {k: torch.from_numpy(v) for k, v in light.items()}, s2, s3,
            pad_val=pad_val, num_leaf=1)["conf_gt"]
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert got[0, 3, 4] == 1 and got[0, 0, 1] == 1


def test_gather_step_matches_host_step(train_json):  # noqa: F811
    """A gather step and a dense step from the same parameters and the
    same samples give the same loss and the same parameters."""
    ds = tds.GATsSPGDataset(train_json, split="train", **KW)
    db, light = _light(ds, False)
    host = next(tds.GATsSPGDataset(train_json, split="train", **KW).batches(
        2, shuffle=True, seed=3, num_threads=1))
    out = []
    for gather in (False, True):
        model = convert.gats_spg_from_jax(convert.init_gats_spg_params(
            np.random.default_rng(0), CFG))
        state = tt.init_train_state(tt.make_optimizer(), CFG, model=model,
                                    device="cpu")
        if gather:
            step = tt.make_gather_train_step(
                CFG, {k: torch.from_numpy(db[k])
                      for k in ("clt_stack", "avg_stack")},
                SHAPE2D, SHAPE3D, num_leaf=LEAF)
            batch = {k: torch.from_numpy(v) for k, v in light.items()}
        else:
            step = tt.make_train_step(CFG)
            batch = {k: torch.from_numpy(host[k]) for k in
                     ("descriptors2d_query", "descriptors3d_db",
                      "descriptors2d_db", "conf_gt")}
        state, loss = step(state, batch)
        out.append((loss.item(), [p.detach() for p in
                                  state.model.parameters()]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# --------------------------------------------------------------------------
# the train entry
# --------------------------------------------------------------------------

def _entry_cfg(cls, root, train_json, tag, **extra):  # noqa: F811
    def wrap(d):
        return cls({k: wrap(v) if isinstance(v, dict) else v
                    for k, v in d.items()})
    return wrap({
        "type": "train", "seed": 0, "parallel": {"n_devices": 1},
        "model": {"descriptor_dim": 32, "scale_factor": 0.07,
                  "match_threshold": 0.2, "include_self": True,
                  "additional": False, "with_linear_transform": False,
                  "lr": 1e-3, "weight_decay": 0.0, "milestones": [1],
                  "gamma": 0.5,
                  "spp_model_path": osp.join(root, "missing.pth")},
        "trainer": {"max_epochs": 1, "gradient_clip_val": 0.5,
                    "accumulate_grad_batches": 2, "log_every_n_steps": 1},
        "datamodule": {"train_anno_file": train_json,
                       "val_anno_file": osp.join(root, "missing.json"),
                       "batch_size": 1, "num_leaf": LEAF,
                       "shape2d": SHAPE2D, "shape3d": SHAPE3D,
                       "assign_pad_val": 0},
        "checkpoint": {"dirpath": osp.join(root, tag, "ckpts")},
        "logging": {"log_dir": osp.join(root, tag, "logs")}, **extra})


def _log(root, tag):
    with open(osp.join(root, tag, "logs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_entry_matches_the_root_script(train_json, tmp_path,  # noqa: F811
                                             monkeypatch):
    """The port's entry and the root train.py on the fixture at their
    defaults (device-resident DB, leaves sampled on the device with the
    JAX run's uniforms injected, accumulation 2, batch 1: five micro-steps,
    two updates, the LR halved at milestone epoch 1 = micro-step 5): the
    same initial parameters give per-step losses within 1e-5 relative and
    the same logged LR; the final parameters as in the train steps' test;
    the checkpoint loads with ``load_gats_spg`` and the entry resumes from
    it."""
    import train as root_train
    from onepose_tpu.config import Config as JConfig
    from onepose_tpu_torch.config import Config

    root = str(tmp_path)
    monkeypatch.setitem(jgats.DEFAULT_CONFIG, "num_blocks", 1)
    monkeypatch.setitem(tgats.DEFAULT_CONFIG, "num_blocks", 1)
    jstate, jmetrics = root_train.train(_entry_cfg(JConfig, root, train_json,
                                                   "jax"))
    params0 = jgats.init_params(jax.random.PRNGKey(0), {"descriptor_dim": 32})
    cfg = _entry_cfg(Config, root, train_json, "port", device="cpu")
    state, metrics = entry.train(
        cfg, model=convert.gats_spg_from_jax(_np_tree(params0)),
        leaf_uniform=lambda seeds: np.stack([_jax_uniform(s) for s in seeds]))

    ref, got = _log(root, "jax"), _log(root, "port")
    assert [r["step"] for r in ref] == [g["step"] for g in got] == [
        1, 2, 3, 4, 5]
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g["train_loss"], r["train_loss"],
                                   rtol=1e-5)
        assert g["lr"] == r["lr"] and g["epoch"] == r["epoch"]
    assert [g["lr"] for g in got] == [np.float32(1e-3).item()] * 4 + [
        np.float32(5e-4).item()]
    np.testing.assert_allclose(metrics["train_loss"],
                               jmetrics["train_loss"], rtol=1e-5)
    assert state.step == 5 and state.optimizer.updates == 2
    _assert_params_close(dict(state.model.named_parameters()), jstate,
                         1e-3 + 5e-4)

    ckpt = osp.join(root, "port", "ckpts", "epoch=0.ckpt")
    assert model_io.latest_checkpoint(osp.dirname(ckpt)) == ckpt
    loaded = model_io.load_gats_spg(ckpt)
    for a, b in zip(loaded.parameters(), state.model.parameters()):
        torch.testing.assert_close(a, b.detach(), rtol=0, atol=0)
    last = model_io.load_gats_spg(osp.join(root, "port", "ckpts",
                                           "last.ckpt"))
    assert all(torch.equal(a, b) for a, b in zip(last.parameters(),
                                                 loaded.parameters()))

    # a second run with max_epochs 2 resumes at epoch 1
    cfg.trainer.max_epochs = 2
    resumed, _ = entry.train(cfg)
    # the accumulation carries across epochs: 10 micro-steps, 5 updates
    assert resumed.step == 10 and resumed.optimizer.updates == 5
    assert model_io.latest_checkpoint(osp.dirname(ckpt)).endswith(
        "epoch=1.ckpt")
    assert [g["step"] for g in _log(root, "port")][-5:] == [6, 7, 8, 9, 10]


def test_train_entry_host_batches(train_json, tmp_path):  # noqa: F811
    """``device_resident=false`` (dense host batches) and host leaf
    sampling both train and log a finite loss."""
    from onepose_tpu_torch.config import Config

    for tag, dm in (("dense", {"device_resident": False}),
                    ("host_leaves", {"device_leaf_sampling": False})):
        cfg = _entry_cfg(Config, str(tmp_path), train_json, tag,
                         device="cpu")
        cfg.datamodule.update(dm)
        _, metrics = entry.train(cfg)
        assert np.isfinite(metrics["train_loss"])


def test_train_entry_raises_without_a_card(train_json, tmp_path):  # noqa: F811
    from onepose_tpu_torch.config import Config

    cfg = _entry_cfg(Config, str(tmp_path), train_json, "x")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry.train(cfg)
    cfg = _entry_cfg(Config, str(tmp_path), train_json, "x", device="cpu",
                     parallel={"n_devices": 2})
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        entry.train(cfg)


def test_validate_runs_the_pipeline(train_json, tmp_path):  # noqa: F811
    """``validate`` on the fixture's frames through ``PosePipeline`` on the
    CPU: cmd1/3/5, the match heatmap metrics and the match figures."""
    import glob

    from onepose_tpu_torch.config import Config

    sp = convert.superpoint_from_jax(convert.init_superpoint_params(
        np.random.default_rng(0), descriptor_dim=32))
    sp_path = str(tmp_path / "sp.pth")
    torch.save(sp.state_dict(), sp_path)
    cfg = _entry_cfg(Config, str(tmp_path), train_json, "val", device="cpu")
    cfg.model.spp_model_path = sp_path
    cfg.datamodule.val_anno_file = train_json
    model = convert.gats_spg_from_jax(convert.init_gats_spg_params(
        np.random.default_rng(1), CFG))
    metrics = entry.validate(cfg, model, {"num_blocks": 1,
                                          "descriptor_dim": 32,
                                          "match_threshold": 0.0},
                             epoch=0, n_plots=2)
    assert {"1cm@1degree", "3cm@3degree", "5cm@5degree",
            "val_f1/match_correct"} <= set(metrics)
    assert glob.glob(osp.join(str(tmp_path), "val", "logs", "val_plots",
                              "*.png"))


def test_multirun_sweeps_and_picks_the_best(monkeypatch, capsys):
    runs = []

    def run_one(overrides):
        runs.append(overrides)
        return {"model.lr=1e-3": 0.5, "model.lr=5e-4": 0.25}[overrides[1]]

    monkeypatch.setattr(entry, "run_one", run_one)
    monkeypatch.setattr("sys.argv", [
        "train", "-m", "+experiment=train_GATsSPG", "model.lr=1e-3,5e-4",
        "optimize_direction=minimize"])
    assert entry.main() == 0.25
    assert len(runs) == 2 and "best" in capsys.readouterr().out


def test_chip_smoke_trains_the_yaml_configuration():
    """chip_smoke.py's phase 12 trains configs/experiment/train_GATsSPG.yaml
    (its values copied, as the card's machine has no yaml)."""
    import chip_smoke
    from onepose_tpu_torch.config import load_config

    cfg = load_config(["+experiment=train_GATsSPG"],
                      config_dir=osp.join(osp.dirname(osp.dirname(
                          osp.abspath(__file__))), "configs"))
    for group, values in chip_smoke.TRAIN_YAML.items():
        for key, value in values.items():
            got = cfg[group][key]
            if isinstance(value, float):
                got = float(got)      # yaml reads 1e-3 as a string
            assert got == value, (group, key, got, value)
