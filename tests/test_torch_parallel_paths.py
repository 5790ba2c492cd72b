"""The port's paths over several ranks (``mesh=`` / ``n_devices``) on the
CPU, each world spawned gloo ranks (``parallel.launch.run_local``), held
against one rank and against the JAX package's mesh runs on its virtual
CPU devices (tests/conftest.py).

- the pipeline at world 2 (data axis): the same batch and injected noise
  as the JAX ``PosePipeline(mesh=make_mesh(2, (2, 1)))``
  (tests/test_pipeline.py's data-mesh setting, at the scene of
  tests/test_torch_pipeline.py, JAX with the port's stem math); and
  world 2 against world 1 when the noise is drawn from a generator;
- serving at world 4 (2 x 2): 5 objects padded to 6 over a model axis of
  2, fp32 and bf16 catalogs, against one process and against the JAX
  server on a (2, 2) mesh (tests/test_serving.py's sharded-catalog
  setting) under the JAX key chain (its random DB points leave RANSAC's
  pose chaotic, so against JAX the matches, success and inliers are
  compared, and poses between world sizes only);
- ``MultiHostPoseServer`` at world 2 against one process over a request
  sequence, and its frontend errors (the other rank returns, no hang);
- SfM extraction and matching at world 2: the HDF5 files opened for
  writing by rank 0 only, and equal by keypoint position to world 1;
- the train step at world 2 on a batch whose first rank holds about 3x
  the positives of the second: equal to world 1 and to the JAX step on a
  2-device data mesh (tests/test_train.py's data-parallel setting), where
  a mean of the ranks' own losses (DDP's rule) is not; the gather step on
  the dataset fixture equal to world 1;
- the train entry at ``parallel.n_devices=2 device=cpu``: one checkpoint
  set and one log, written by rank 0, its losses those of one process;
- the eval entry at ``n_devices=2`` against the root ``inference.py`` at
  ``n_devices=2`` (a JAX data mesh) on tests/test_torch_inference_entry.py's
  world with the JAX run's noise injected: every frame's pose, cmd1/3/5
  and the report rank 0 writes.

Tolerances: keypoints, matches, success and inlier counts exactly equal;
poses within 1e-5 between world sizes (the same arithmetic on fewer rows)
and within 1e-4 against JAX (tests/test_torch_pipeline.py's fp32 bound);
losses within 1e-6 relative between world sizes and 1e-5 against JAX
(tests/test_torch_train.py's bound), parameters within that file's
Adam-step bound, gradients between world sizes within 1e-6 of their
largest entry (two partial sums added in another order).

The ranks' functions sit at module level (the spawn start method imports
this module in every rank), and this module imports nothing of JAX at
its top, so that no rank does: JAX runs in the test process only."""
import dataclasses
import os
import os.path as osp

import numpy as np
import pytest
import torch

from onepose_tpu_torch import pipeline as tpipe
from onepose_tpu_torch import serving as tserving
from onepose_tpu_torch.datasets import anno as tanno
from onepose_tpu_torch.models import convert
from onepose_tpu_torch.parallel import collectives as comm
from onepose_tpu_torch.parallel import launch
from onepose_tpu_torch.parallel import mesh as pmesh
from onepose_tpu_torch.parallel import serve_launch
from onepose_tpu_torch.train import trainer as tt

TIMEOUT = 240
SP_CFG = {"max_keypoints": 64}
GATS_CFG = {"match_threshold": 1e-3}
PNP = dict(num_hypotheses=32, refine_iters=2)
KMAT = np.array([[120.0, 0, 32], [0, 120.0, 32], [0, 0, 1]], np.float32)
SERVE_K = np.array([[460.0, 0, 32], [0, 460.0, 32], [0, 0, 1]], np.float32)
TRAIN_CFG = {"num_blocks": 1}
SG_CONF = {"match_threshold": 1e-3}   # random SuperGlue weights match weakly


def _port_db(db) -> tanno.ObjectDB:
    return tanno.ObjectDB(**{f.name: getattr(db, f.name)
                             for f in dataclasses.fields(tanno.ObjectDB)})


def _outputs(out) -> dict:
    return {k: v.numpy() for k, v in out._asdict().items()}


def _assert_outputs(got: dict, ref, atol=None):
    """Equal keypoints, matches, success and inliers; poses within
    ``atol`` unless it is None."""
    for name in ("kpt_mask", "keypoints2d", "matches0", "success",
                 "num_inliers"):
        np.testing.assert_array_equal(got[name], np.asarray(ref[name]),
                                      err_msg=name)
    if atol is not None:
        np.testing.assert_allclose(got["poses"], np.asarray(ref["poses"]),
                                   atol=atol)


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------

def _pipeline_rank(sp_np, gats_np, db, images, Ks, noise):
    mesh = pmesh.make_mesh(2, (2, 1))
    pipe = tpipe.PosePipeline(
        convert.superpoint_from_jax(sp_np), convert.gats_spg_from_jax(gats_np),
        db, sp_config=SP_CFG, gats_config=GATS_CFG, device="cpu", mesh=mesh,
        **PNP)
    injected = pipe(images, Ks, noise=noise)
    drawn = pipe(images, Ks, generator=torch.Generator().manual_seed(7))
    return _outputs(injected), _outputs(drawn)


def _serving_rank(sp_np, gats_np, dbs, reqs, noise):
    mesh = pmesh.make_mesh(4, (2, 2))
    out = {}
    for dtype in ("float32", "bfloat16"):
        server = tserving.PoseServer(
            convert.superpoint_from_jax(sp_np),
            convert.gats_spg_from_jax(gats_np), dbs, sp_config=SP_CFG,
            gats_config=GATS_CFG, batch_size=4, seed=9, db_dtype=dtype,
            device="cpu", mesh=mesh, **PNP)
        out[dtype] = _outputs(server.run(reqs, noise=noise))
        out[dtype + " drawn"] = server.infer_batch(reqs)
        out["held"] = (server.first_object,
                       len(server.db_stack["keypoints3d"]),
                       server.db_stack["descriptors3d"].dtype)
    return out


def _multihost_rank(sp_np, gats_np, dbs, batches):
    mesh = pmesh.make_mesh(2, (1, 2))
    server = serve_launch.MultiHostPoseServer(
        convert.superpoint_from_jax(sp_np), convert.gats_spg_from_jax(gats_np),
        dbs, sp_config=SP_CFG, gats_config=GATS_CFG, batch_size=4, seed=5,
        device="cpu", mesh=mesh, **PNP)
    root = comm.is_main_process()
    delivered = []
    queue = iter(batches)
    served = serve_launch.serve_forever(
        server, (64, 64), next_batch=(lambda: next(queue, None)) if root
        else None, deliver=delivered.extend if root else None)
    img = batches[0][0].image

    def bad_name():
        return [tserving.PoseRequest("no_such_object", img, SERVE_K)]

    def bad_shape():
        return [tserving.PoseRequest("obj0", img[:32, :32], SERVE_K)]

    def raising():
        raise RuntimeError("frontend down")

    outcomes = []
    for frontend in (bad_name, bad_shape, raising):
        try:
            outcomes.append(serve_launch.serve_forever(
                server, (64, 64), next_batch=frontend if root else None))
        except Exception as e:    # rank 0 re-raises what its frontend threw
            outcomes.append(f"{type(e).__name__}: {e}")
    return {"served": served, "results": delivered, "outcomes": outcomes}


def _sfm_rank(sp_np, sg_np, names, images, pairs, out_dir):
    from onepose_tpu_torch.sfm import extract, match
    from onepose_tpu_torch.utils import hdf5

    mesh = pmesh.make_mesh(2)
    opened = []
    real = hdf5.File

    def spy(path, mode="r"):
        opened.append((osp.basename(path), mode))
        return real(path, mode)

    hdf5.File = spy
    feats = osp.join(out_dir, "feats.h5")
    extract.extract_to_h5(convert.superpoint_from_jax(sp_np), names, feats,
                          conf=_sfm_conf(), batch_size=4, images=images,
                          device="cpu", mesh=mesh)
    match.match_pairs_to_h5(convert.superglue_from_jax(sg_np), pairs, feats,
                            osp.join(out_dir, "matches.h5"), conf=SG_CONF,
                            batch_size=4, device="cpu", mesh=mesh)
    return opened


def _sfm_conf():
    return {"preprocessing": {"resize_h": 64, "resize_w": 64},
            "conf": {"max_keypoints": 64, "nms_radius": 3,
                     "keypoint_threshold": 0.005}}


def _train_rank(params_np, batch, light, db, light_cfg):
    mesh = pmesh.make_mesh(2)
    rows = pmesh.data_rows(mesh, len(batch["conf_gt"]))
    local = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
    model = convert.gats_spg_from_jax(params_np)
    state = tt.init_train_state(tt.make_optimizer(base_lr=1e-4), TRAIN_CFG,
                                model=model, device="cpu")
    # DDP's rule for contrast: the mean of each rank's own loss
    own = tt.compute_loss(convert.gats_spg_from_jax(params_np), local,
                          TRAIN_CFG).detach()
    ddp = comm.all_reduce(own.clone()) / 2
    state, loss = tt.make_train_step(TRAIN_CFG, mesh=mesh)(state, local)
    positives = comm.all_gather(local["conf_gt"].sum())

    gstate, grads = _gather_state(light_cfg)
    step = tt.make_gather_train_step(
        light_cfg, {k: torch.from_numpy(v) for k, v in db.items()}, 24, 40,
        num_leaf=4, mesh=mesh)
    lrows = pmesh.data_rows(mesh, len(light["obj_idx"]))
    gstate, gloss = step(gstate, {k: torch.from_numpy(v[lrows])
                                  for k, v in light.items()})
    return {"loss": loss.item(), "ddp_loss": ddp.item(),
            "positives": positives.tolist(),
            "params": {n: p.detach() for n, p in
                       state.model.named_parameters()},
            "updates": state.optimizer.updates,
            "gather_loss": gloss.item(), "gather_grads": grads}


def _gather_state(light_cfg):
    """A train state for the gather step and the list that its
    optimizer fills with each micro-step's (all-reduced) gradients."""
    grads = []

    def keep(names, gs):
        grads.append([g.clone() for g in gs])
        return gs

    model = convert.gats_spg_from_jax(convert.init_gats_spg_params(
        np.random.default_rng(0), light_cfg))
    return tt.init_train_state(tt.make_optimizer(grad_transforms=[keep]),
                               light_cfg, model=model, device="cpu"), grads


def _eval_rank(cfg, args, sp_np, gats_np, noises):
    from onepose_tpu_torch import inference
    from onepose_tpu_torch.models import gats_spg

    # random weights score every pair far below the trained 0.2
    gats_spg.DEFAULT_CONFIG["match_threshold"] = 0.0
    frames = []
    evaluate = inference_evaluator().evaluate

    def record(self, pose, gt):
        frames.append(pose)
        return evaluate(self, pose, gt)

    inference_evaluator().evaluate = record
    res = inference.inference_core(cfg, *args,
                                   convert.superpoint_from_jax(sp_np),
                                   convert.gats_spg_from_jax(gats_np),
                                   noises=noises)
    return res, frames


def inference_evaluator():
    from onepose_tpu_torch.evaluators import Evaluator

    return Evaluator


# --------------------------------------------------------------------------
# pipeline
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pipeline_scene():
    import jax

    from onepose_tpu.datasets import anno as janno
    from onepose_tpu.models import gats_spg, superpoint

    rng = np.random.default_rng(1)
    key = jax.random.PRNGKey(0)
    sp_params = superpoint.init_params(key)
    gats_params = gats_spg.init_params(key)
    P, leaf, D = 40, 4, 256
    idxs = rng.integers(2, 10, P)
    total = int(idxs.sum())
    db = janno.build_object_db(
        avg_keypoints3d=rng.normal(size=(P, 3)).astype(np.float32),
        avg_descriptors3d=rng.normal(size=(D, P)).astype(np.float32),
        avg_scores3d=rng.uniform(0, 1, (P, 1)).astype(np.float32),
        clt_descriptors=rng.normal(size=(D, total)).astype(np.float32),
        clt_scores=rng.uniform(0, 1, (total, 1)).astype(np.float32),
        idxs=idxs, num_leaf=leaf, shape3d=48)
    B = 4
    images = rng.uniform(0, 1, (B, 64, 64, 1)).astype(np.float32)
    Ks = np.broadcast_to(KMAT, (B, 3, 3)).copy()
    return sp_params, gats_params, db, images, Ks


def test_pipeline_world2_matches_one_rank_and_jax_mesh(pipeline_scene):
    import jax

    from onepose_tpu import pipeline as jpipe
    from onepose_tpu.parallel import mesh as jmesh
    from test_torch_epnp import _jax_noise, _stack_noise

    sp_params, gats_params, db, images, Ks = pipeline_scene
    keys = jax.random.split(jax.random.PRNGKey(3), len(images))
    ref = jpipe.PosePipeline(
        sp_params, gats_params, db, sp_config={**SP_CFG, "stem": "direct"},
        gats_config=GATS_CFG, mesh=jmesh.make_mesh(2, (2, 1)), **PNP)(
            images, Ks, keys)
    ref = {k: np.asarray(v) for k, v in ref._asdict().items()}
    jax.clear_caches()
    noise = _stack_noise([_jax_noise(k, 64, PNP["num_hypotheses"])
                          for k in keys])
    sp_np, gats_np = (jax.tree.map(np.asarray, p)
                      for p in (sp_params, gats_params))
    ranks = launch.run_local(_pipeline_rank, 2, sp_np, gats_np, _port_db(db),
                             images, Ks, noise, device="cpu",
                             timeout=TIMEOUT)
    one = tpipe.PosePipeline(
        convert.superpoint_from_jax(sp_np), convert.gats_spg_from_jax(gats_np),
        _port_db(db), sp_config=SP_CFG, gats_config=GATS_CFG, device="cpu",
        **PNP)
    one_injected = _outputs(one(images, Ks, noise=noise))
    one_drawn = _outputs(one(images, Ks,
                             generator=torch.Generator().manual_seed(7)))
    assert (one_injected["num_matches"] >= 8).all()
    for injected, drawn in ranks:      # every rank holds the whole batch
        _assert_outputs(injected, one_injected, atol=1e-5)
        _assert_outputs(injected, ref, atol=1e-4)
        _assert_outputs(drawn, one_drawn, atol=1e-5)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def serving_world():
    import jax

    from onepose_tpu.models import gats_spg, superpoint
    from test_serving import make_db

    key = jax.random.PRNGKey(5)
    params = (superpoint.init_params(key), gats_spg.init_params(key))
    rng = np.random.default_rng(5)
    dbs = {f"obj{i}": make_db(rng) for i in range(5)}     # pads 5 -> 6
    return params, dbs, rng


def _serve_requests(rng, names):
    return [tserving.PoseRequest(
        n, rng.uniform(0, 1, (64, 64)).astype(np.float32), SERVE_K)
        for n in names]


def test_serving_world4_sharded_catalog(serving_world):
    """2 x 2: each data rank serves 2 of the 4 requests; the catalog's 6
    padded objects split 3 and 3 over the model axis, so requests for
    obj4 and obj3 fetch their rows from the other model rank."""
    import jax

    from onepose_tpu import serving as jserving
    from onepose_tpu.parallel import mesh as jmesh
    from test_torch_serving import _key_chain_noise

    (sp_params, gats_params), dbs, rng = serving_world
    reqs = _serve_requests(rng, ["obj0", "obj4", "obj3", "obj1"])
    noise = _key_chain_noise(9)
    jserver = jserving.PoseServer(
        sp_params, gats_params, dbs, sp_config={**SP_CFG, "stem": "direct"},
        gats_config=GATS_CFG, batch_size=4, seed=9,
        mesh=jmesh.make_mesh(4, (2, 2)), **PNP)
    ref, _ = jserver._launch(jserver._assemble(reqs, to_device=False))
    ref = {k: np.asarray(v) for k, v in ref._asdict().items()}
    jax.clear_caches()

    sp_np, gats_np = (jax.tree.map(np.asarray, p)
                      for p in (sp_params, gats_params))
    pdbs = {n: _port_db(db) for n, db in dbs.items()}
    ranks = launch.run_local(_serving_rank, 4, sp_np, gats_np, pdbs, reqs,
                             noise, device="cpu", timeout=TIMEOUT, threads=1)
    assert [r["held"][:2] for r in ranks] == [(0, 3), (3, 3), (0, 3), (3, 3)]
    assert ranks[0]["held"][2] == torch.bfloat16
    for dtype in ("float32", "bfloat16"):
        one = tserving.PoseServer(
            convert.superpoint_from_jax(sp_np),
            convert.gats_spg_from_jax(gats_np), pdbs, sp_config=SP_CFG,
            gats_config=GATS_CFG, batch_size=4, seed=9, db_dtype=dtype,
            device="cpu", **PNP)
        one_run = _outputs(one.run(reqs, noise=noise))
        one_drawn = one.infer_batch(reqs)
        assert (one_run["num_matches"] >= 8).all()
        for r in ranks:
            _assert_outputs(r[dtype], one_run, atol=1e-5)
            if dtype == "float32":   # the DBs' random points: RANSAC's
                _assert_outputs(r[dtype], ref)   # pose is chaotic here
            for a, b in zip(r[dtype + " drawn"], one_drawn):
                assert (a["success"], a["num_inliers"]) == (
                    b["success"], b["num_inliers"])
                if a["pose"] is not None:
                    np.testing.assert_allclose(a["pose"], b["pose"],
                                               atol=1e-5)


def test_multihost_server_world2(serving_world):
    """Three batches through ``serve_forever`` at world 2 (catalog over a
    model axis of 2) equal to one process's ``infer_batch`` with the same
    seed; then three frontend failures on rank 0: rank 0 re-raises each,
    rank 1 leaves its loop having served nothing."""
    import jax

    (sp_params, gats_params), dbs, _ = serving_world
    rng = np.random.default_rng(21)
    batches = [_serve_requests(rng, names) for names in (
        ["obj0", "obj3", "obj4", "obj1"], ["obj2", "obj2"],
        ["obj4", "obj0", "obj1"])]
    sp_np, gats_np = (jax.tree.map(np.asarray, p)
                      for p in (sp_params, gats_params))
    pdbs = {n: _port_db(db) for n, db in dbs.items()}
    ranks = launch.run_local(_multihost_rank, 2, sp_np, gats_np, pdbs,
                             batches, device="cpu", timeout=TIMEOUT)
    one = tserving.PoseServer(
        convert.superpoint_from_jax(sp_np), convert.gats_spg_from_jax(gats_np),
        pdbs, sp_config=SP_CFG, gats_config=GATS_CFG, batch_size=4, seed=5,
        device="cpu", **PNP)
    want = [res for reqs in batches for res in one.infer_batch(reqs)]
    root, other = ranks
    assert root["served"] == other["served"] == 3
    assert len(root["results"]) == len(want) == 9 and other["results"] == []
    assert any(r["success"] for r in want)
    for a, b in zip(root["results"], want):
        assert (a["success"], a["num_inliers"]) == (b["success"],
                                                    b["num_inliers"])
        if a["pose"] is not None:
            np.testing.assert_allclose(a["pose"], b["pose"], atol=1e-5)
    assert root["outcomes"][0].startswith("KeyError")
    assert root["outcomes"][1].startswith("ValueError") and (
        "image_shape" in root["outcomes"][1])
    assert root["outcomes"][2] == "RuntimeError: frontend down"
    assert other["outcomes"] == [0, 0, 0]


def test_multihost_server_requires_a_mesh(serving_world):
    import jax

    (sp_params, gats_params), dbs, _ = serving_world
    with pytest.raises(ValueError, match="requires mesh="):
        serve_launch.MultiHostPoseServer(
            convert.superpoint_from_jax(jax.tree.map(np.asarray, sp_params)),
            convert.gats_spg_from_jax(jax.tree.map(np.asarray, gats_params)),
            {n: _port_db(db) for n, db in dbs.items()}, device="cpu")


# --------------------------------------------------------------------------
# SfM
# --------------------------------------------------------------------------

def _h5(path):
    from onepose_tpu_torch.utils import hdf5

    out = {}
    with hdf5.File(path, "r") as f:
        def visit(group, prefix):
            for name in group:
                item = group[name]
                if isinstance(item, hdf5.Group):
                    visit(item, f"{prefix}{name}/")
                else:
                    out[prefix + name] = item[()]
        visit(f, "")
    return out


def _k(name, field):
    """A dataset's key as ``_h5`` lists it (no leading slash)."""
    return f"{name.lstrip('/')}/{field}"


def _by_position(feats, name):
    """An image's keypoint rows sorted by position (x, then y), and the
    permutation that sorts them."""
    kp = feats[_k(name, "keypoints")]
    order = np.lexsort((kp[:, 1], kp[:, 0]))
    return order, kp[order]


def test_sfm_extract_match_world2_equal_by_position(tmp_path):
    """7 images in batches of 4 (a tail of 3 padded to 4) and 7 pairs in
    batches of 4, at world 2 and world 1: keypoints, scores and
    descriptors equal by keypoint position, each match the same pair of
    positions; only rank 0 opens a file for writing."""
    from onepose_tpu_torch.sfm import extract, match

    rng = np.random.default_rng(5)
    sp_np = convert.init_superpoint_params(rng)
    sg_np = convert.init_superglue_params(rng)
    names = [f"/x/color/{i}.png" for i in range(7)]
    images = {n: rng.uniform(0, 1, (64, 64)).astype(np.float32)
              for n in names}
    pairs = [(names[i], names[j]) for i in range(7)
             for j in range(i + 1, 7)][:7]
    one = str(tmp_path / "one")
    os.makedirs(one)
    extract.extract_to_h5(convert.superpoint_from_jax(sp_np), names,
                          osp.join(one, "feats.h5"), conf=_sfm_conf(),
                          batch_size=4, images=images, device="cpu")
    match.match_pairs_to_h5(convert.superglue_from_jax(sg_np), pairs,
                            osp.join(one, "feats.h5"),
                            osp.join(one, "matches.h5"), conf=SG_CONF,
                            batch_size=4, device="cpu")
    two = str(tmp_path / "two")
    os.makedirs(two)
    opened = launch.run_local(_sfm_rank, 2, sp_np, sg_np, names, images,
                              pairs, two, device="cpu", timeout=TIMEOUT)
    assert {m for _, m in opened[0]} == {"w", "r"}
    assert sorted(f for f, m in opened[0] if m == "w") == [
        "feats.h5", "matches.h5"]
    assert all(m == "r" for _, m in opened[1])

    f1, f2 = _h5(osp.join(one, "feats.h5")), _h5(osp.join(two, "feats.h5"))
    m1, m2 = (_h5(osp.join(d, "matches.h5")) for d in (one, two))
    assert f1.keys() == f2.keys() and m1.keys() == m2.keys()
    for n in names:
        o1, k1 = _by_position(f1, n)
        o2, k2 = _by_position(f2, n)
        np.testing.assert_array_equal(k1, k2)
        assert len(k1) > 0
        np.testing.assert_allclose(f1[_k(n, "scores")][o1],
                                   f2[_k(n, "scores")][o2], atol=1e-6)
        np.testing.assert_allclose(f1[_k(n, "descriptors")][:, o1],
                                   f2[_k(n, "descriptors")][:, o2],
                                   atol=1e-6)
        np.testing.assert_array_equal(f1[_k(n, "image_size")],
                                      f2[_k(n, "image_size")])
    n_matches = 0
    for (a, b) in pairs:
        key = _k(match.names_to_pair(a, b), "matches0")

        def positions(feats, matches, name0, name1):
            m = matches[key]
            kp0 = feats[_k(name0, "keypoints")]
            kp1 = feats[_k(name1, "keypoints")]
            return {(tuple(kp0[i]), tuple(kp1[j]))
                    for i, j in enumerate(m) if j >= 0}

        got, ref = positions(f2, m2, a, b), positions(f1, m1, a, b)
        assert got == ref
        n_matches += len(ref)
    assert n_matches > 0


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def _unequal_batch(rng, b=8, n1=16, n2=8, d=256):
    """tests/test_train.py's tiny batch, with rows 4-7 keeping only 3, 3,
    2 and 2 of their 8 matches: the first half holds 32 positives, the
    second 10."""
    from test_train import _tiny_batch

    batch = _tiny_batch(rng, b=b, n1=n1, n2=n2, d=d)
    for row, keep in zip(range(4, 8), (3, 3, 2, 2)):
        for i in range(keep, min(n1, n2)):
            batch["conf_gt"][row, i, i] = 0
    return batch


@pytest.fixture(scope="module")
def train_json(tmp_path_factory):
    from onepose_tpu_torch.datasets.merge import merge_anno
    from test_cli_integration import build_dataset

    tmp = tmp_path_factory.mktemp("gats_ds")
    build_dataset(tmp, np.random.default_rng(4), dim=32)
    out = str(tmp / "data" / "cache" / "t" / "train.json")
    assert merge_anno(str(tmp / "data" / "sfm_model"), ["0001-obj-box"],
                      out) == 5
    return out


def test_train_step_world2_global_batch(train_json):
    """Trap: the focal loss divides by the counts of the whole batch. At
    world 2 with 32 and 10 positives on the two ranks, the step equals one
    rank's and the JAX step over a 2-device data mesh, while a mean of
    the ranks' own losses (DDP's rule) does not; the gather step on the
    dataset fixture equals one rank's."""
    import jax

    from onepose_tpu.parallel import mesh as jmesh
    from onepose_tpu.train import trainer as jt
    from onepose_tpu_torch.datasets import gats_dataset as tds
    from test_torch_train import _assert_params_close

    batch = _unequal_batch(np.random.default_rng(2))
    tx = jt.make_optimizer(base_lr=1e-4)
    jstate = jt.init_train_state(jax.random.PRNGKey(0), tx, TRAIN_CFG)
    params_np = jax.tree.map(np.asarray, jstate.params)
    mesh = jmesh.make_mesh(2)
    jstate, jloss = jt.make_train_step(tx, TRAIN_CFG)(
        jmesh.replicate(mesh, jstate), jmesh.shard_batch(mesh, batch))
    jstate = jax.tree.map(np.asarray, jstate)
    jax.clear_caches()

    light_cfg = {"num_blocks": 1, "descriptor_dim": 32}
    ds = tds.GATsSPGDataset(train_json, split="train", num_leaf=4,
                            shape2d=24, shape3d=40, seed=5)
    db_np, obj_index = ds.device_db()
    light = next(ds.light_batches(obj_index, db_np["t_max"], 2, seed=3,
                                  on_device_leaves=True))
    light["leaf_uniform"] = tt.leaf_uniforms(light.pop("leaf_seed"), 4, 40)
    db = {k: db_np[k] for k in ("clt_stack", "avg_stack", "count_stack",
                                "offset_stack")}
    ranks = launch.run_local(_train_rank, 2, params_np, batch, light, db,
                             light_cfg, device="cpu", timeout=TIMEOUT)

    one = tt.init_train_state(tt.make_optimizer(base_lr=1e-4), TRAIN_CFG,
                              model=convert.gats_spg_from_jax(params_np),
                              device="cpu")
    one, one_loss = tt.make_train_step(TRAIN_CFG)(
        one, {k: torch.from_numpy(v) for k, v in batch.items()})
    gone, gone_grads = _gather_state(light_cfg)
    gone, gone_loss = tt.make_gather_train_step(
        light_cfg, {k: torch.from_numpy(v) for k, v in db.items()}, 24, 40,
        num_leaf=4)(gone, {k: torch.from_numpy(v) for k, v in light.items()})

    for r in ranks:
        assert r["positives"] == [32, 10]
        np.testing.assert_allclose(r["loss"], one_loss.item(), rtol=1e-6)
        np.testing.assert_allclose(r["loss"], float(jloss), rtol=1e-5)
        # DDP's mean of the ranks' own losses is another number here
        assert abs(r["ddp_loss"] - one_loss.item()) > 1e-3 * one_loss.item()
        assert r["updates"] == one.optimizer.updates == 1
        _assert_params_close(r["params"], jstate, 1e-4)
        _assert_params_close(dict(one.model.named_parameters()), jstate,
                             1e-4)
        np.testing.assert_allclose(r["gather_loss"], gone_loss.item(),
                                   rtol=1e-6)
        scale = max(float(g.abs().max()) for g in gone_grads[0])
        for a, b in zip(r["gather_grads"][0], gone_grads[0]):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * scale)
    # both ranks stepped the same way on the same gradients
    for name in ranks[0]["params"]:
        torch.testing.assert_close(ranks[0]["params"][name],
                                   ranks[1]["params"][name], rtol=0, atol=0)


def test_train_entry_two_ranks(train_json, tmp_path):
    """``parallel.n_devices=2`` on the CPU: two ranks, one checkpoint set
    and one metrics log (rank 0's), the logged losses those of one
    process on the same global batches, and the returned state rank 0's
    checkpoint."""
    import json

    from onepose_tpu_torch.config import Config
    from onepose_tpu_torch.train import entry
    from onepose_tpu_torch.utils import model_io
    from test_torch_train import _entry_cfg

    root = str(tmp_path)
    logs = {}
    for tag, n in (("one", 1), ("two", 2)):
        cfg = _entry_cfg(Config, root, train_json, tag, device="cpu",
                         parallel={"n_devices": n})
        cfg.datamodule.batch_size = 2
        state, metrics = entry.train(cfg)
        with open(osp.join(root, tag, "logs", "metrics.jsonl")) as f:
            logs[tag] = [json.loads(line) for line in f]
        assert np.isfinite(metrics["train_loss"])
    assert sorted(os.listdir(osp.join(root, "two", "ckpts"))) == [
        "epoch=0.ckpt", "last.ckpt"]
    assert [r["step"] for r in logs["two"]] == [r["step"] for r in
                                                logs["one"]] == [1, 2]
    for a, b in zip(logs["two"], logs["one"]):
        np.testing.assert_allclose(a["train_loss"], b["train_loss"],
                                   rtol=1e-6)
        assert a["lr"] == b["lr"]
    assert state.step == 2 and state.optimizer.updates == 1
    loaded = model_io.load_gats_spg(osp.join(root, "two", "ckpts",
                                             "epoch=0.ckpt"))
    for a, b in zip(loaded.parameters(), state.model.parameters()):
        torch.testing.assert_close(a, b.detach(), rtol=0, atol=0)


# --------------------------------------------------------------------------
# the eval entry
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def eval_world(tmp_path_factory):
    from test_torch_inference_entry import build_world

    return build_world(tmp_path_factory.mktemp("eval_world"))


def test_eval_entry_n_devices_matches_the_root_script(eval_world,
                                                      monkeypatch):
    """``n_devices=2``: the root entry runs a 2-device data mesh, the port
    two ranks fed the root run's noise; per frame the same poses (1e-5),
    cmd1/3/5 and the report equal, rank 0 alone evaluating. A batch that
    the devices do not divide is refused with the root entry's message."""
    import jax

    import inference as root_inference
    from onepose_tpu import evaluators as jeval, pipeline as jpipe
    from onepose_tpu.config import Config as JConfig
    from onepose_tpu.models import gats_spg as jgats
    from onepose_tpu_torch import inference
    from onepose_tpu_torch.config import Config
    from test_torch_epnp import _jax_noise, _stack_noise
    from test_torch_inference_entry import (KPTS, N_FRAMES, PNP, _args, _cfg,
                                            _record_evaluations)

    tmp, sp, gats = eval_world
    monkeypatch.setitem(jgats.DEFAULT_CONFIG, "match_threshold", 0.0)
    batch_keys, call = [], jpipe.PosePipeline.__call__

    def call_and_record(self, images, Ks, keys=None):
        batch_keys.append(keys)
        return call(self, images, Ks, keys)

    monkeypatch.setattr(jpipe.PosePipeline, "__call__", call_and_record)
    ref_frames = _record_evaluations(monkeypatch, jeval.Evaluator)
    ref = root_inference.inference_core(
        _cfg(tmp, JConfig, n_devices=2), *_args(tmp),
        jax.tree.map(np.asarray, sp), jax.tree.map(np.asarray, gats))
    jax.clear_caches()
    noises = [_stack_noise([_jax_noise(k, KPTS, PNP["num_hypotheses"])
                            for k in keys]) for keys in batch_keys]
    cfg = _cfg(tmp, Config, device="cpu", n_devices=2)
    ranks = launch.run_local(_eval_rank, 2, cfg, _args(tmp), sp, gats,
                             noises, device="cpu", timeout=TIMEOUT)
    (got, frames), (other, other_frames) = ranks
    assert other is None and other_frames == []
    assert len(frames) == len(ref_frames) == N_FRAMES
    assert ref_frames[0][0] is not None
    for i, (g, (r, _)) in enumerate(zip(frames, ref_frames)):
        assert (g is None) == (r is None), i
        if r is not None:
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-5,
                                       err_msg=f"frame {i}")
    assert got == ref
    reports = [open(osp.join(str(tmp / "eval" / m), "0001-plane-boxplane-1"
                             ".txt")).read() for m in (Config.__module__,
                                                       JConfig.__module__)]
    assert reports[0] == reports[1]
    with pytest.raises(ValueError) as err:
        inference.inference_core(_cfg(tmp, Config, device="cpu",
                                      n_devices=3), *_args(tmp), None, None)
    with pytest.raises(ValueError) as ref_err:
        root_inference.inference_core(_cfg(tmp, JConfig, n_devices=3),
                                      *_args(tmp), None, None)
    assert str(err.value) == str(ref_err.value)
