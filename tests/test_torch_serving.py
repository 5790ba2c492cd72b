"""The port's multi-object server (serving.py) against the JAX package's
and against its own per-object pipelines, on the CPU, at batch 4, 64x64
images, K=64, shape3d=48, leaf 2, weights bridged from the JAX inits.

The JAX side runs with ``stem="direct"`` (the port's stem math), both with
a match threshold of 1e-3 (random weights keep conf far below the trained
0.2). Where poses are compared, each object's 3D points are planted so
that the matches its frames make agree with a known pose per frame (as in
chip_smoke.py phase 6). RANSAC noise follows the JAX server's key chain
(``PoseServer._launch``: split the server key, split the sub-key per
frame) through ``test_torch_epnp._jax_noise``.

Tolerances: matches0, success and inlier counts exactly equal; poses
within 1e-4, as in tests/test_torch_pipeline.py; the bf16 catalog against
the fp32 one by tests/test_serving.py's contract."""
import dataclasses
import time

import numpy as np
import pytest
import torch

import jax

from onepose_tpu import serving as jserving
from onepose_tpu.models import gats_spg, superpoint
from onepose_tpu_torch import pipeline as tpipe
from onepose_tpu_torch import serving as tserving
from onepose_tpu_torch.models import convert
from onepose_tpu_torch.models import gats_spg as tgs
from onepose_tpu_torch.utils import geometry as geo
from test_serving import make_db
from test_torch_epnp import _jax_noise, _stack_noise
from test_torch_parallel import FakeMesh

SP_CFG = {"max_keypoints": 64}
GATS_CFG = {"match_threshold": 1e-3}
KW = dict(batch_size=4, num_hypotheses=32, refine_iters=2)
K = np.array([[460.0, 0, 32], [0, 460.0, 32], [0, 0, 1]], np.float32)


@pytest.fixture(scope="module")
def world():
    key = jax.random.PRNGKey(0)
    sp_params = superpoint.init_params(key)
    gats_params = gats_spg.init_params(key)
    rng = np.random.default_rng(0)
    dbs = {"objA": make_db(rng), "objB": make_db(rng), "objC": make_db(rng)}
    port = (convert.superpoint_from_jax(jax.tree.map(np.asarray, sp_params)),
            convert.gats_spg_from_jax(jax.tree.map(np.asarray, gats_params)))
    return (sp_params, gats_params), port, dbs


def _server(world, **kw):
    _, (sp, gats), dbs = world
    return tserving.PoseServer(sp, gats, dbs, sp_config=SP_CFG,
                               gats_config=GATS_CFG, device="cpu",
                               **{**KW, **kw})


def _requests(rng, names):
    return [tserving.PoseRequest(
        n, rng.uniform(0, 1, (64, 64)).astype(np.float32), K) for n in names]


def _key_chain_noise(seed, batch=4, n=64, hyp=32):
    """The RANSAC noise of the JAX server's first launch with ``seed``."""
    _, sub = jax.random.split(jax.random.PRNGKey(seed))
    return _stack_noise([_jax_noise(k, n, hyp)
                         for k in jax.random.split(sub, batch)])


def _planted(world, reqs, seed):
    """Copies of the world's DBs whose 3D points are the back-projections,
    at depth 0.4-0.6 under frame b's known pose, of the keypoints frame b
    matched to them (the first frame to claim a point keeps it). Matching
    reads descriptors only, so the same matches follow, now consistent
    with one pose per frame."""
    rng = np.random.default_rng(seed)
    out = _server(world).run(reqs, noise=_key_chain_noise(seed))
    m0, kp = out.matches0.numpy(), out.keypoints2d.numpy()
    kinv = np.linalg.inv(K.astype(np.float64))
    dbs = dict(world[2])
    pts = {n: db.keypoints3d.copy() for n, db in dbs.items()}
    taken = {n: np.zeros(len(p), bool) for n, p in pts.items()}
    for b, r in enumerate(reqs):
        pose = np.concatenate([geo.rodrigues(rng.normal(size=3) * 0.3),
                               [[0.0], [0.0], [0.5]]], 1)
        for k in np.flatnonzero(m0[b] >= 0):
            j = m0[b, k]
            if not taken[r.object_name][j]:
                cam = (kinv @ [kp[b, k, 0], kp[b, k, 1], 1.0]
                       * rng.uniform(0.4, 0.6))
                pts[r.object_name][j] = pose[:, :3].T @ (cam - pose[:, 3])
                taken[r.object_name][j] = True
    return {n: dataclasses.replace(db, keypoints3d=pts[n].astype(np.float32))
            for n, db in dbs.items()}


def _assert_same(got, ref, atol=1e-4):
    for name in ("matches0", "success", "num_inliers", "kpt_mask"):
        np.testing.assert_array_equal(
            np.asarray(getattr(got, name)), np.asarray(getattr(ref, name)),
            err_msg=name)
    np.testing.assert_allclose(np.asarray(got.poses), np.asarray(ref.poses),
                               atol=atol)


@pytest.mark.parametrize("db_dtype", ["float32", "bfloat16"])
def test_mixed_batch_matches_jax_server(world, db_dtype):
    """The same mixed batch through JAX's PoseServer and the port's, under
    the JAX key chain: the same matches and poses. With a bf16 catalog
    both round the descriptors alike, so they agree as exactly."""
    (sp_params, gats_params), port, _ = world
    reqs = _requests(np.random.default_rng(1), ["objA", "objB", "objC",
                                                "objA"])
    dbs = _planted(world, reqs, 7)
    jserver = jserving.PoseServer(
        sp_params, gats_params, dbs, sp_config={**SP_CFG, "stem": "direct"},
        gats_config=GATS_CFG, seed=7, db_dtype=db_dtype, **KW)
    ref, n_real = jserver._launch(jserver._assemble(reqs, to_device=False))
    got = _server((None, port, dbs), seed=7, db_dtype=db_dtype).run(
        reqs, noise=_key_chain_noise(7))
    assert n_real == 4
    assert (got.num_matches >= 8).all() and got.success.all()
    _assert_same(got, ref)


def test_mixed_batch_matches_per_object_pipelines(world):
    """Each request of a mixed batch gets what a PosePipeline holding only
    its object gives the same frame with the same noise row."""
    _, (sp, gats), _ = world
    reqs = _requests(np.random.default_rng(2), ["objC", "objA", "objB",
                                                "objA"])
    dbs = _planted(world, reqs, 3)
    noise = _key_chain_noise(3)
    got = _server((None, (sp, gats), dbs)).run(reqs, noise=noise)
    assert got.success.all()
    images = np.stack([r.image for r in reqs])[..., None]
    Ks = np.stack([r.K for r in reqs])
    for b, r in enumerate(reqs):
        pipe = tpipe.PosePipeline(sp, gats, dbs[r.object_name],
                                  sp_config=SP_CFG, gats_config=GATS_CFG,
                                  num_hypotheses=32, refine_iters=2,
                                  device="cpu")
        ref = pipe(images, Ks, noise=noise)
        torch.testing.assert_close(got.matches0[b], ref.matches0[b],
                                   rtol=0, atol=0)
        torch.testing.assert_close(got.poses[b], ref.poses[b], rtol=0,
                                   atol=1e-4)
        assert bool(got.success[b]) == bool(ref.success[b])


def test_uniform_fast_path_matches_mixed_step(world):
    """A batch whose requests all name one object takes its DB row once,
    expanded; the gathered step gives the same results."""
    server = _server(world)
    reqs = _requests(np.random.default_rng(3), ["objB"] * 4)
    staged = server._assemble(reqs, to_device=False)
    assert staged.uniform
    noise = _key_chain_noise(9)
    fast = server._launch(staged, noise)
    mixed = server._launch(staged._replace(uniform=False), noise)
    _assert_same(fast, mixed, atol=0)
    mixed_reqs = _requests(np.random.default_rng(3), ["objB", "objA"] * 2)
    assert not server._assemble(mixed_reqs, to_device=False).uniform


def test_bf16_catalog_close_to_fp32(world):
    """tests/test_serving.py's contract: same success, inlier counts within
    max(3, 20%); descriptors stored bf16, keypoints3d fp32."""
    s32 = _server(world, seed=5)
    s16 = _server(world, seed=5, db_dtype="bfloat16")
    assert s16.db_stack["descriptors3d"].dtype == torch.bfloat16
    assert s16.db_stack["descriptors2d_db"].dtype == torch.bfloat16
    assert s16.db_stack["keypoints3d"].dtype == torch.float32
    reqs = _requests(np.random.default_rng(4), ["objA", "objB", "objC",
                                                "objB"])
    for a, b in zip(s32.infer_batch(reqs), s16.infer_batch(reqs)):
        assert a["success"] == b["success"]
        assert abs(a["num_inliers"] - b["num_inliers"]) <= max(
            3, 0.2 * a["num_inliers"])


def test_infer_many_matches_infer_batch(world):
    """The staged, windowed path gives what serial infer_batch calls give
    with the same generator: two full batches and a padded tail."""
    rng = np.random.default_rng(5)
    reqs = _requests(rng, ["objA", "objB", "objC", "objA", "objB"])
    many = _server(world, batch_size=2, seed=7).infer_many(
        reqs, depth=2, max_in_flight=2)
    server = _server(world, batch_size=2, seed=7)
    serial = [r for i in range(0, 5, 2)
              for r in server.infer_batch(reqs[i:i + 2])]
    assert len(many) == len(serial) == 5
    for a, b in zip(many, serial):
        assert a["success"] == b["success"]
        assert a["num_inliers"] == b["num_inliers"]
        if a["pose"] is not None:
            np.testing.assert_allclose(a["pose"], b["pose"], atol=1e-5)
    with pytest.raises(KeyError):
        server.infer_many(_requests(rng, ["objA", "nope"]))


def test_assembly_timeout_behavior(world):
    """(a) A partial batch dispatches once max_latency_s expires; (b) a
    full batch dispatches without waiting out the deadline; futures of a
    failing batch get its exception."""
    timeout_s = 0.25
    server = _server(world, max_latency_s=timeout_s)
    rng = np.random.default_rng(6)
    server.infer_batch(_requests(rng, ["objA"]))   # warm up
    server.start()
    try:
        t0 = time.perf_counter()
        res = server.submit(_requests(rng, ["objA"])[0]).result(timeout=60)
        partial_wall = time.perf_counter() - t0
        assert res["success"] in (True, False)
        assert partial_wall < timeout_s * 10, partial_wall

        server.max_latency_s = 30.0
        t0 = time.perf_counter()
        futs = [server.submit(r) for r in _requests(rng, ["objB"] * 4)]
        for f in futs:
            assert "num_inliers" in f.result(timeout=60)
        assert time.perf_counter() - t0 < 15.0

        server.max_latency_s = 0.05
        bad = server.submit(_requests(rng, ["nope"])[0])
        with pytest.raises(KeyError):
            bad.result(timeout=60)
        assert "success" in server.submit(
            _requests(rng, ["objC"])[0]).result(timeout=60)
    finally:
        server.stop()
    assert not server._worker.is_alive()


def test_match_kernel_gets_contiguous_aligned_rows(world, monkeypatch):
    """After the per-request gather and the GNN, both the mixed and the
    uniform step hand the match wrapper contiguous fp32 tensors that start
    on a 16-byte boundary (what the kernel takes on a card)."""
    seen = []
    real = tgs.dual_softmax_argmax

    def spy(m0, m1, scale):
        seen.append([(t.is_contiguous(), t.data_ptr() % 16, t.dtype)
                     for t in (m0, m1)])
        return real(m0, m1, scale)

    monkeypatch.setattr(tgs, "dual_softmax_argmax", spy)
    server = _server(world, db_dtype="bfloat16")
    rng = np.random.default_rng(7)
    server.infer_batch(_requests(rng, ["objA", "objB"]))
    server.infer_batch(_requests(rng, ["objC"] * 4))
    assert len(seen) == 2
    for pair in seen:
        assert pair == [(True, 0, torch.float32)] * 2




def test_server_refuses_bad_setups(world):
    _, (sp, gats), dbs = world
    rng = np.random.default_rng(8)
    with pytest.raises(ValueError, match="shape3d"):
        tserving.PoseServer(sp, gats, {"a": make_db(rng, shape3d=48),
                                       "b": make_db(rng, shape3d=56)},
                            device="cpu")
    with pytest.raises(ValueError, match="num_leaf"):
        tserving.PoseServer(sp, gats, {"a": make_db(rng, leaf=2),
                                       "b": make_db(rng, leaf=4)},
                            device="cpu")
    with pytest.raises(ValueError, match="not divisible by data axis 3"):
        tserving.PoseServer(sp, gats, dbs, mesh=FakeMesh(3), device="cpu")
    with pytest.raises(ValueError, match="db_dtype"):
        tserving.PoseServer(sp, gats, dbs, db_dtype="float16", device="cpu")
    with pytest.raises(ValueError, match="object DB"):
        tserving.PoseServer(sp, gats, {}, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserving.PoseServer(sp, gats, dbs)
