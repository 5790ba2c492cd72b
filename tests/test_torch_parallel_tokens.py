"""GATsSPG's 3D tokens sharded over the mesh's model axis, on the CPU: one
world of 4 spawned gloo ranks on a (2, 2) ("data", "model") mesh
(``parallel.launch.run_local``) runs every check in one rank function,
held against one rank and against the JAX package's runs on a (2, 2)
mesh of its virtual CPU devices (tests/conftest.py), which shard the
same tensors with ``tests/test_mp4.py``'s specs:

- (i) the collectives under autograd (``all_reduce_sum``,
  ``all_gather_cat``, ``all_reduce_max``) over the model groups, in fp64:
  values and gradients those of one process;
- (ii) ``gnn_body`` and ``forward_match_only`` on token-sharded inputs
  (each rank its data row and its half of the tokens) against one rank
  on the whole tokens and against JAX ``gnn_body`` / ``forward`` on the
  sharded mesh: matches equal, descriptors within 1e-5;
- (iii) ``PosePipeline(mesh=(2, 2))`` on tests/test_torch_parallel_paths.py's
  scene with the JAX run's RANSAC noise injected, against one rank and
  the JAX ``PosePipeline`` on the mesh: matches, success and inliers
  equal, poses within 1e-4 (that file's bound against JAX), every rank
  holding N2/2 of the DB's token rows;
- (iv) a DB of 47 tokens, which the model axis does not divide: every
  rank holds the whole DB, outputs equal to one rank's;
- (v) the dense train step at ``test_mp4.py::
  test_train_step_mp4_smoke_tiny_shapes``'s shape (b=4, n1=64, n2=128,
  leaf 4, 1 block), that test's rule: gradients within rtol 1e-3 and
  atol 1e-3·max|g| of one rank's and of JAX's, the loss within 1e-4
  relative, and the ranks stepping bit-equal;
- (vi) the gather step at shape3d 40 on a synthetic device DB against
  one rank's: the loss within 1e-5 relative and the gradients within
  1e-5 of their largest entry (token-sharded sums reorder fp32).

Besides: the GATs layer on a contiguous token shard with its leaf rows
equals those rows of the whole layer (point-major leaves), and
``token_rows`` lays shards out by model index.

The rank function sits at module level (the spawn start method imports
this module in every rank) and this module imports nothing of JAX at its
top, so no rank does."""
import traceback

import numpy as np
import pytest
import torch

from onepose_tpu_torch import pipeline as tpipe
from onepose_tpu_torch.datasets import anno as tanno
from onepose_tpu_torch.models import convert, gats_spg as tgats
from onepose_tpu_torch.parallel import collectives as comm
from onepose_tpu_torch.parallel import launch
from onepose_tpu_torch.parallel import mesh as pmesh
from onepose_tpu_torch.train import trainer as tt
from test_torch_parallel import FakeMesh
from test_torch_parallel_paths import (GATS_CFG, KMAT, PNP, SP_CFG,
                                       _assert_outputs, _outputs, _port_db)

TIMEOUT = 240
MESH = (2, 2)
GNN = dict(b=2, n1=24, n2=32, leaf=4)
GNN_CFG = {"num_blocks": 2, "match_threshold": 1e-3}
TRAIN = dict(b=4, n1=64, n2=128, leaf=4)
TRAIN_CFG = {"num_blocks": 1}
GATHER_CFG = {"num_blocks": 1, "descriptor_dim": 32}
GATHER = dict(objects=2, shape2d=24, shape3d=40, leaf=4, b=4)


def _specs():
    from jax.sharding import PartitionSpec as P

    return {"descriptors2d_query": P("data", None, None),
            "descriptors3d_db": P("data", "model", None),
            "descriptors2d_db": P("data", "model", None),
            "mask2d": P("data", None), "mask3d": P("data", "model"),
            "conf_gt": P("data", None, "model")}


# --------------------------------------------------------------------------
# the rank
# --------------------------------------------------------------------------

def _collectives(mesh, coll):
    group = pmesh.axis_group(mesh, "model")
    r = comm.get_rank()
    x = torch.from_numpy(coll["x"][r]).requires_grad_()
    y = comm.all_reduce_sum(x, group)
    (torch.from_numpy(coll["w"][r]) * y).sum().backward()
    g = torch.from_numpy(coll["g"][r]).requires_grad_()
    cat = comm.all_gather_cat(g, 1, group)
    (torch.from_numpy(coll["wg"][r]) * cat).sum().backward()
    top = comm.all_reduce_max(x, group)
    return {"sum": y.detach(), "sum_grad": x.grad, "cat": cat.detach(),
            "cat_grad": g.grad, "max": top, "max_grad": top.requires_grad}


def _local(mesh, batch, n2):
    """This rank's data rows and token shard of a [B, ...] batch."""
    rows = pmesh.data_rows(mesh, len(next(iter(batch.values()))))
    local = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
    local.update(pmesh.token_shard(mesh, n2, {
        k: local[k] for k in ("descriptors3d_db", "descriptors2d_db", "mask3d")
        if k in local}, dim=1))
    if "conf_gt" in local:
        local.update(pmesh.token_shard(mesh, n2, {
            "conf_gt": local["conf_gt"]}, dim=2))
    return local


def _gnn(mesh, gats_np, data):
    group = pmesh.token_group(mesh, GNN["n2"])
    model = convert.gats_spg_from_jax(gats_np).eval()
    local = _local(mesh, data, GNN["n2"])
    cfg = tgats.resolve_config(GNN_CFG)
    with torch.no_grad():
        m0, m1 = tgats.gnn_body(model, local, cfg, group)
    out = tgats.forward_match_only(model, local, GNN_CFG, group)
    return {"m0": m0, "m1": m1, "matches0": out.matches0,
            "matches1": out.matches1, "scores0": out.matching_scores0}


def _pipeline(mesh, sp_np, gats_np, dbs, images, Ks, noise):
    out = {}
    for name, db in dbs.items():
        pipe = tpipe.PosePipeline(
            convert.superpoint_from_jax(sp_np),
            convert.gats_spg_from_jax(gats_np), db, sp_config=SP_CFG,
            gats_config=GATS_CFG, device="cpu", mesh=mesh, **PNP)
        out[name] = _outputs(pipe(images, Ks, noise=noise))
        out[name + " held"] = {k: len(v) for k, v in pipe.db.items()}
        out[name + " sharded"] = pipe.token_group is not None
    return out


def _grad_keeper():
    grads = []

    def keep(names, gs):
        grads.append(dict(zip(names, (g.clone() for g in gs))))
        return gs
    return grads, keep


def _train(mesh, params_np, batch):
    grads, keep = _grad_keeper()
    state = tt.init_train_state(
        tt.make_optimizer(grad_transforms=[keep]), TRAIN_CFG,
        model=convert.gats_spg_from_jax(params_np), device="cpu")
    state, loss = tt.make_train_step(TRAIN_CFG, mesh=mesh)(
        state, _local(mesh, batch, TRAIN["n2"]))
    return {"loss": loss.item(), "grads": grads[0],
            "params": {n: p.detach() for n, p in
                       state.model.named_parameters()}}


def _gather(mesh, params_np, db, light):
    grads, keep = _grad_keeper()
    state = tt.init_train_state(
        tt.make_optimizer(grad_transforms=[keep]), GATHER_CFG,
        model=convert.gats_spg_from_jax(params_np), device="cpu")
    step = tt.make_gather_train_step(
        GATHER_CFG, {k: torch.from_numpy(v) for k, v in db.items()},
        GATHER["shape2d"], GATHER["shape3d"], num_leaf=GATHER["leaf"],
        mesh=mesh)
    rows = pmesh.data_rows(mesh, GATHER["b"])
    state, loss = step(state, {k: torch.from_numpy(v[rows])
                               for k, v in light.items()})
    return {"loss": loss.item(), "grads": grads[0]}


def _tokens_rank(inputs):
    """Every check of the module in one rank; a check that raises leaves
    its traceback in place of its result, so that the others still run
    (each raises on every rank alike, so none leaves a collective
    half-joined)."""
    mesh = pmesh.make_mesh(4, MESH)
    checks = {"collectives": lambda: _collectives(mesh, inputs["coll"]),
              "gnn": lambda: _gnn(mesh, inputs["gats"], inputs["gnn"]),
              "pipeline": lambda: _pipeline(mesh, *inputs["pipeline"]),
              "train": lambda: _train(mesh, *inputs["train"]),
              "gather": lambda: _gather(mesh, *inputs["gather"])}
    out = {"rank": comm.get_rank(),
           "model_index": pmesh.axis_index(mesh, "model"),
           "token_rows": pmesh.token_rows(mesh, 48)}
    for name, fn in checks.items():
        try:
            out[name] = fn()
        except Exception:
            out[name] = traceback.format_exc()
    return out


# --------------------------------------------------------------------------
# inputs and references (the test process, with JAX)
# --------------------------------------------------------------------------

def _coll_inputs(rng):
    return {"x": rng.normal(size=(4, 3, 5)), "w": rng.normal(size=(4, 3, 5)),
            "g": rng.normal(size=(4, 3, 2)), "wg": rng.normal(size=(4, 3, 4))}


def _gnn_inputs(rng):
    b, n1, n2, leaf, d = (*GNN.values(), 256)
    mask2d = np.ones((b, n1), bool)
    mask2d[:, n1 - 3:] = False
    mask3d = np.ones((b, n2), bool)
    mask3d[:, n2 - 5:] = False
    return {"descriptors2d_query": rng.normal(size=(b, n1, d)).astype(
                np.float32),
            "descriptors3d_db": rng.normal(size=(b, n2, d)).astype(
                np.float32),
            "descriptors2d_db": rng.normal(size=(b, n2 * leaf, d)).astype(
                np.float32),
            "mask2d": mask2d, "mask3d": mask3d}


def _gather_inputs(rng):
    """A device DB of 2 objects (each point 0-5 observations, the last row
    of clt_stack the dustbin) and a light batch of 4 with leaf uniforms
    (``trainer.materialize_light_batch``'s inputs)."""
    o, s2, s3, leaf, b = GATHER.values()
    d = GATHER_CFG["descriptor_dim"]
    counts = rng.integers(0, 6, (o, s3))
    offsets = np.cumsum(counts, 1) - counts
    t = int(counts.sum(1).max())
    db = {"clt_stack": np.concatenate([rng.normal(size=(o, t, d)),
                                       np.ones((o, 1, d))], 1).astype(
                                           np.float32),
          "avg_stack": rng.normal(size=(o, s3, d)).astype(np.float32),
          "count_stack": counts.astype(np.int32),
          "offset_stack": offsets.astype(np.int32)}
    pairs = np.stack([np.stack([rng.permutation(s2)[:12],
                                rng.permutation(s3)[:12]], -1)
                      for _ in range(b)])
    light = {"obj_idx": np.array([0, 1, 1, 0], np.int32),
             "leaf_uniform": rng.uniform(size=(b, leaf, s3)).astype(
                 np.float32),
             "descriptors2d_query": rng.normal(size=(b, s2, d)).astype(
                 np.float32),
             "pairs": pairs.astype(np.int32),
             "num2d": np.array([24, 20, 24, 18], np.int32),
             "num3d": np.array([40, 33, 38, 40], np.int32)}
    return db, light


@pytest.fixture(scope="module")
def tokens_world():
    """The world's results and the inputs and JAX references they are
    held to."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from onepose_tpu import pipeline as jpipe
    from onepose_tpu.datasets import anno as janno
    from onepose_tpu.models import gats_spg as jgats, superpoint as jsp
    from onepose_tpu.parallel import mesh as jmesh
    from onepose_tpu.train import trainer as jt
    from test_mp4 import _train_batch
    from test_torch_epnp import _jax_noise, _stack_noise

    jm = jmesh.make_mesh(4, MESH)
    specs = _specs()

    def put(batch):
        return {k: jax.device_put(jnp.asarray(v), NamedSharding(jm, specs[k]))
                for k, v in batch.items()}

    rng = np.random.default_rng(9)
    ref, inputs = {}, {"coll": _coll_inputs(rng)}

    # (ii) the GNN
    gats_params = jgats.init_params(jax.random.PRNGKey(3),
                                    {"num_blocks": GNN_CFG["num_blocks"]})
    cfg = {**jgats.DEFAULT_CONFIG, **GNN_CFG}
    inputs["gnn"] = data = _gnn_inputs(rng)
    inputs["gats"] = jax.tree.map(np.asarray, gats_params)
    body = jax.jit(lambda p, x: jgats.gnn_body(p, x, cfg))(gats_params,
                                                           put(data))
    fwd = jax.jit(lambda p, x: jgats.forward(p, x, cfg))(gats_params,
                                                         put(data))
    ref["gnn"] = {"m0": np.asarray(body[0]), "m1": np.asarray(body[1]),
                  "matches0": np.asarray(fwd.matches0),
                  "matches1": np.asarray(fwd.matches1)}

    # (iii), (iv) the pipeline
    key = jax.random.PRNGKey(0)
    sp_params, pgats = jsp.init_params(key), jgats.init_params(key)
    P, leaf, D = 40, 4, 256
    idxs = rng.integers(2, 10, P)
    total = int(idxs.sum())
    arrays = dict(
        avg_keypoints3d=rng.normal(size=(P, 3)).astype(np.float32),
        avg_descriptors3d=rng.normal(size=(D, P)).astype(np.float32),
        avg_scores3d=rng.uniform(0, 1, (P, 1)).astype(np.float32),
        clt_descriptors=rng.normal(size=(D, total)).astype(np.float32),
        clt_scores=rng.uniform(0, 1, (total, 1)).astype(np.float32),
        idxs=idxs, num_leaf=leaf)
    jdb = janno.build_object_db(**arrays, shape3d=48)
    dbs = {"even": _port_db(jdb),
           "odd": tanno.build_object_db(**arrays, shape3d=47)}
    B = 4
    images = rng.uniform(0, 1, (B, 64, 64, 1)).astype(np.float32)
    Ks = np.broadcast_to(KMAT, (B, 3, 3)).copy()
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    jpipe_mesh = jpipe.PosePipeline(
        sp_params, pgats, jdb, sp_config={**SP_CFG, "stem": "direct"},
        gats_config=GATS_CFG, mesh=jm, **PNP)
    assert jpipe_mesh.db["descriptors3d"].sharding.spec[0] == "model"
    out = jpipe_mesh(images, Ks, keys)
    ref["pipeline"] = {k: np.asarray(v) for k, v in out._asdict().items()}
    noise = _stack_noise([_jax_noise(k, SP_CFG["max_keypoints"],
                                     PNP["num_hypotheses"]) for k in keys])
    sp_np, pgats_np = (jax.tree.map(np.asarray, p) for p in (sp_params,
                                                             pgats))
    inputs["pipeline"] = (sp_np, pgats_np, dbs, images, Ks, noise)

    # (v) the dense train step: JAX's gradient and step on the mesh
    batch = _train_batch(np.random.default_rng(0), **TRAIN)
    tx = jt.make_optimizer()
    jstate = jt.init_train_state(jax.random.PRNGKey(0), tx, TRAIN_CFG)
    tcfg = {**jgats.DEFAULT_CONFIG, **TRAIN_CFG}
    params_np = jax.tree.map(np.asarray, jstate.params)
    grads = jax.jit(jax.grad(lambda p, x: jt.compute_loss(p, x, tcfg)))(
        jstate.params, put(batch))
    _, jloss = jt.make_train_step(tx, TRAIN_CFG)(    # donates its state
        jmesh.replicate(jm, jstate), put(batch))
    ref["train"] = {"loss": float(jloss), "grads": dict(
        convert.gats_spg_from_jax(jax.tree.map(np.asarray, grads))
        .named_parameters())}
    inputs["train"] = (params_np, batch)
    jax.clear_caches()

    # (vi) the gather step
    gparams = convert.init_gats_spg_params(np.random.default_rng(1),
                                           GATHER_CFG)
    inputs["gather"] = (gparams, *_gather_inputs(rng))

    ranks = launch.run_local(_tokens_rank, 4, inputs, device="cpu",
                             timeout=TIMEOUT, threads=1)
    return inputs, ref, ranks


def _result(ranks, check):
    for r in ranks:
        if isinstance(r[check], str):
            pytest.fail(f"rank {r['rank']}: {check} raised:\n{r[check]}")
    return [r[check] for r in ranks]


def _group(rank):
    """The global ranks of ``rank``'s model group: (2i, 2i + 1)."""
    return (rank - rank % 2, rank - rank % 2 + 1)


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------

def test_token_rows_are_contiguous_by_model_index(tokens_world):
    _, _, ranks = tokens_world
    assert [r["model_index"] for r in ranks] == [0, 1, 0, 1]
    assert [r["token_rows"] for r in ranks] == [slice(0, 24), slice(24, 48)] * 2
    assert pmesh.token_rows(None, 47) == slice(0, 47)
    assert pmesh.token_group(None, 48) is None


def test_gats_layer_shard_holds_its_leaves():
    """descriptors2d_db is point-major (row p·L + l): a contiguous shard of
    the points with rows [lo·L, hi·L) gives those points' rows of the
    whole GATs layer, at every shard of 4."""
    rng = np.random.default_rng(2)
    b, n, leaf, d = 2, 12, 4, 32
    cfg = tgats.resolve_config({"descriptor_dim": d})
    layer = tgats.GATsLayer(d).double()
    h2 = torch.from_numpy(rng.normal(size=(b, n * leaf, d)))
    h3 = torch.from_numpy(rng.normal(size=(b, n, d)))
    with torch.no_grad():
        whole = tgats.gats_layer(layer, h2, h3, cfg)
        for lo in range(0, n, 3):
            part = tgats.gats_layer(layer, h2[:, lo * leaf:(lo + 3) * leaf],
                                    h3[:, lo:lo + 3], cfg)
            torch.testing.assert_close(part, whole[:, lo:lo + 3], rtol=0,
                                       atol=1e-12)
        # a shard cut across a point's leaves reads another point's
        cut = tgats.gats_layer(layer, h2[:, 1:1 + 3 * leaf], h3[:, :3], cfg)
    assert (cut - whole[:, :3]).abs().max() > 1e-3


def test_collectives_under_autograd_fp64(tokens_world):
    """Over each model group (ranks 2i, 2i+1): values and gradients of
    the three collectives those of one process holding both ranks'
    tensors."""
    inputs, _, ranks = tokens_world
    c = {k: torch.from_numpy(v) for k, v in inputs["coll"].items()}
    for r, got in zip(range(4), _result(ranks, "collectives")):
        grp = _group(r)
        x = [c["x"][i].clone().requires_grad_() for i in grp]
        y = x[0] + x[1]
        sum(((c["w"][i] * y).sum() for i in grp)).backward()
        g = [c["g"][i].clone().requires_grad_() for i in grp]
        cat = torch.cat(g, 1)
        sum(((c["wg"][i] * cat).sum() for i in grp)).backward()
        mine = grp.index(r)
        torch.testing.assert_close(got["sum"], y.detach(), rtol=0, atol=0)
        torch.testing.assert_close(got["sum_grad"], x[mine].grad, rtol=0,
                                   atol=0)
        torch.testing.assert_close(got["cat"], cat.detach(), rtol=0, atol=0)
        torch.testing.assert_close(got["cat_grad"], g[mine].grad, rtol=0,
                                   atol=0)
        torch.testing.assert_close(got["max"], torch.maximum(
            c["x"][grp[0]], c["x"][grp[1]]), rtol=0, atol=0)
        assert got["sum"].dtype == torch.float64
        assert got["max_grad"] is False


def test_gnn_token_sharded_matches_one_rank_and_jax(tokens_world):
    inputs, ref, ranks = tokens_world
    data = {k: torch.from_numpy(v) for k, v in inputs["gnn"].items()}
    model = convert.gats_spg_from_jax(inputs["gats"]).eval()
    with torch.no_grad():
        m0, m1 = tgats.gnn_body(model, data, tgats.resolve_config(GNN_CFG))
    one = tgats.forward_match_only(model, data, GNN_CFG)
    assert (one.matches0 >= 0).sum() >= 4
    per = GNN["n2"] // 2
    for r, got in zip(range(4), _result(ranks, "gnn")):
        row, tok = r // 2, slice(r % 2 * per, (r % 2 + 1) * per)
        for want in (m0.numpy(), ref["gnn"]["m0"]):
            np.testing.assert_allclose(got["m0"][0], want[row], rtol=0,
                                       atol=1e-5)
        for want in (m1.numpy(), ref["gnn"]["m1"]):
            np.testing.assert_allclose(got["m1"][0], want[row, tok],
                                       rtol=0, atol=1e-5)
        for name in ("matches0", "matches1"):
            np.testing.assert_array_equal(got[name][0],
                                          getattr(one, name)[row])
            np.testing.assert_array_equal(got[name][0], ref["gnn"][name][row])
        np.testing.assert_allclose(got["scores0"][0],
                                   one.matching_scores0[row], rtol=1e-4,
                                   atol=1e-6)


def test_pipeline_token_sharded_matches_one_rank_and_jax(tokens_world):
    inputs, ref, ranks = tokens_world
    sp_np, gats_np, dbs, images, Ks, noise = inputs["pipeline"]
    one = tpipe.PosePipeline(
        convert.superpoint_from_jax(sp_np), convert.gats_spg_from_jax(gats_np),
        dbs["even"], sp_config=SP_CFG, gats_config=GATS_CFG, device="cpu",
        **PNP)
    one = _outputs(one(images, Ks, noise=noise))
    assert (one["num_matches"] >= 8).all() and one["success"].any()
    for got in _result(ranks, "pipeline"):
        assert got["even sharded"]
        assert got["even held"] == {"keypoints3d": 48, "descriptors3d": 24,
                                    "descriptors2d_db": 24 * 4, "mask3d": 24}
        _assert_outputs(got["even"], one, atol=1e-4)
        _assert_outputs(got["even"], ref["pipeline"], atol=1e-4)


def test_pipeline_indivisible_tokens_replicate(tokens_world):
    """47 tokens over a model axis of 2: every rank holds the whole DB and
    computes what one rank computes."""
    inputs, _, ranks = tokens_world
    sp_np, gats_np, dbs, images, Ks, noise = inputs["pipeline"]
    one = tpipe.PosePipeline(
        convert.superpoint_from_jax(sp_np), convert.gats_spg_from_jax(gats_np),
        dbs["odd"], sp_config=SP_CFG, gats_config=GATS_CFG, device="cpu",
        **PNP)
    one = _outputs(one(images, Ks, noise=noise))
    assert (one["num_matches"] >= 8).all()
    for got in _result(ranks, "pipeline"):
        assert not got["odd sharded"]
        assert got["odd held"] == {"keypoints3d": 47, "descriptors3d": 47,
                                   "descriptors2d_db": 47 * 4, "mask3d": 47}
        _assert_outputs(got["odd"], one, atol=1e-5)


def _assert_grads(got, want, name):
    scale = max(float(g.detach().abs().max()) for g in want.values())
    for k, g in want.items():
        np.testing.assert_allclose(got[k].numpy(), g.detach().numpy(),
                                   rtol=1e-3, atol=1e-3 * scale,
                                   err_msg=f"{name}: {k}")


def test_train_step_token_sharded_matches_one_rank_and_jax(tokens_world):
    """The trap: every rank computes the 2D stream; the step is right only
    because each rank's loss is its own columns' share and the gradients
    are summed once over the world."""
    inputs, ref, ranks = tokens_world
    params_np, batch = inputs["train"]
    grads, keep = _grad_keeper()
    one = tt.init_train_state(
        tt.make_optimizer(grad_transforms=[keep]), TRAIN_CFG,
        model=convert.gats_spg_from_jax(params_np), device="cpu")
    one, loss = tt.make_train_step(TRAIN_CFG)(
        one, {k: torch.from_numpy(v) for k, v in batch.items()})
    got = _result(ranks, "train")
    for r in got:
        np.testing.assert_allclose(r["loss"], loss.item(), rtol=1e-4)
        np.testing.assert_allclose(r["loss"], ref["train"]["loss"], rtol=1e-4)
        _assert_grads(r["grads"], grads[0], "one rank")
        _assert_grads(r["grads"], ref["train"]["grads"], "JAX")
    for r in got[1:]:       # every rank stepped the same way
        for name, p in r["params"].items():
            torch.testing.assert_close(p, got[0]["params"][name], rtol=0,
                                       atol=0)


def test_gather_step_token_sharded_matches_one_rank(tokens_world):
    inputs, _, ranks = tokens_world
    params_np, db, light = inputs["gather"]
    grads, keep = _grad_keeper()
    one = tt.init_train_state(
        tt.make_optimizer(grad_transforms=[keep]), GATHER_CFG,
        model=convert.gats_spg_from_jax(params_np), device="cpu")
    one, loss = tt.make_gather_train_step(
        GATHER_CFG, {k: torch.from_numpy(v) for k, v in db.items()},
        GATHER["shape2d"], GATHER["shape3d"], num_leaf=GATHER["leaf"])(
            one, {k: torch.from_numpy(v) for k, v in light.items()})
    scale = max(float(g.abs().max()) for g in grads[0].values())
    for r in _result(ranks, "gather"):
        np.testing.assert_allclose(r["loss"], loss.item(), rtol=1e-5)
        for k, g in grads[0].items():
            torch.testing.assert_close(r["grads"][k], g, rtol=0,
                                       atol=1e-5 * scale)
    with pytest.raises(ValueError, match="not divisible by the model axis"):
        tt.make_gather_train_step(GATHER_CFG, db, 24, 39, mesh=FakeMesh(2, 2))
