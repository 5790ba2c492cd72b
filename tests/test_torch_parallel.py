"""The port's multi-card layer (onepose_tpu_torch/parallel/*) on the CPU:
launch keys and errors against the JAX package's launch module, mesh
shapes, and the collectives at world 2.

Each world is spawned gloo ranks (``launch.run_local``) that meet through
a store bound on a free port, one or two threads each, so that tests
running side by side in several processes neither share a port nor
oversubscribe the cores. The ranks' functions sit at module level here
(the spawn start method imports them), and this module imports nothing
of JAX at its top, so that a rank does not. Collectives move exact
values: results are compared exactly."""
import multiprocessing as mp
import os
import socket

import numpy as np
import pytest
import torch

from onepose_tpu_torch.parallel import collectives as comm
from onepose_tpu_torch.parallel import launch
from onepose_tpu_torch.parallel import mesh as pmesh

TIMEOUT = 120


class FakeMesh:
    """What the port's paths read of a mesh before any collective: its
    axis names and sizes (the refusals are tested with it)."""
    mesh_dim_names = ("data", "model")

    def __init__(self, n_data, n_model=1):
        self.shape = (n_data, n_model)

    def size(self, dim):
        return self.shape[dim]


# --------------------------------------------------------------------------
# launch: keys, precedence, errors (no world)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cfg,env", [
    ({}, {}),
    ({"coordinator": "h:1"}, {}),
    ({}, {"ONEPOSE_COORDINATOR": "e:2"}),
    ({"coordinator": "h:1"}, {"ONEPOSE_COORDINATOR": "e:2"}),
    ({"coordinator": None}, {"ONEPOSE_COORDINATOR": "e:2"}),
    ({"coordinator": ""}, {"ONEPOSE_COORDINATOR": ""}),
    (None, {"ONEPOSE_COORDINATOR": "e:3"}),
])
def test_cfg_or_env_matches_jax(monkeypatch, cfg, env):
    """Config over environment, empty values as absent: the JAX launch
    module's rule."""
    from onepose_tpu.parallel import launch as jlaunch

    for key in launch.ENV_KEYS.values():
        monkeypatch.delenv(key, raising=False)
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    for key, var in launch.ENV_KEYS.items():
        assert launch._cfg_or_env(cfg, key, var) == jlaunch._cfg_or_env(
            cfg, key, var)


def test_maybe_initialize_noop_and_errors(monkeypatch):
    from onepose_tpu.parallel import launch as jlaunch

    for key in launch.ENV_KEYS.values():
        monkeypatch.delenv(key, raising=False)
    assert launch.maybe_initialize(None) is False
    assert launch.maybe_initialize({"n_devices": 2}) is False
    for cfg in ({"coordinator": "localhost:1"},
                {"coordinator": "localhost:1", "num_processes": 2}):
        with pytest.raises(ValueError) as got:
            launch.maybe_initialize(cfg, device="cpu")
        with pytest.raises(ValueError) as ref:
            jlaunch.maybe_initialize(cfg)
        assert str(got.value) == str(ref.value)
    monkeypatch.setenv("ONEPOSE_COORDINATOR", "localhost:1")
    monkeypatch.setenv("ONEPOSE_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="process_id"):
        launch.maybe_initialize(None, device="cpu")
    assert not torch.distributed.is_initialized()


def test_pick_backend():
    assert launch.pick_backend("cuda", 4, 4) == "nccl"
    assert launch.pick_backend("cuda", 2, 1) == "gloo"   # ranks share a card
    assert launch.pick_backend("cpu", 2, 0) == "gloo"


def test_single_process_degrades():
    """No world: one rank, the collectives are the JAX package's
    single-process no-ops."""
    assert comm.get_world_size() == 1 and comm.get_rank() == 0
    assert comm.is_main_process()
    comm.synchronize()
    tree = {"a": np.arange(3), "b": [np.ones((2, 2))]}
    got = comm.all_gather_arrays(tree)
    assert got["a"].shape == (1, 3) and got["b"][0].shape == (1, 2, 2)
    assert comm.reduce_dict({"x": 1.5}) == {"x": 1.5}
    t = torch.arange(4.0)
    assert torch.equal(comm.psum_metrics({"t": t})["t"], t)
    assert torch.equal(comm.all_gather(t), t[None])
    assert 0 <= comm.shared_random_seed() < 2 ** 31
    assert pmesh.axis_size(None, "data") == 1
    assert pmesh.data_rows(None, 8) == slice(0, 8)


def test_make_mesh_refuses_bad_shapes():
    with pytest.raises(ValueError, match=r"axis_shapes \(3, 1\) != 4"):
        pmesh.make_mesh(4, (3, 1))
    with pytest.raises(ValueError, match="world of 2 ranks"):
        pmesh.make_mesh(2)      # no world of two here


# --------------------------------------------------------------------------
# world 2
# --------------------------------------------------------------------------

def _collectives_rank():
    """Every collective at world 2; returns what each rank saw."""
    rank = comm.get_rank()
    out = {"rank": rank, "world": comm.get_world_size(),
           "main": comm.is_main_process()}
    with pytest.raises(ValueError, match="!= 2 devices"):
        pmesh.make_mesh(2, (1, 1))
    mesh = pmesh.make_mesh(2, (2, 1))
    out["mesh"] = (tuple(mesh.mesh_dim_names), pmesh.axis_size(mesh, "data"),
                   pmesh.axis_size(mesh, "model"),
                   pmesh.axis_index(mesh, "data"),
                   pmesh.axis_index(mesh, "model"))
    out["rows"] = pmesh.data_rows(mesh, 6)
    mesh12 = pmesh.make_mesh(None, (1, 2))
    out["mesh12"] = (pmesh.axis_size(mesh12, "data"),
                     pmesh.axis_index(mesh12, "model"))
    out["gather"] = comm.all_gather_arrays(
        {"x": np.full((2, 3), rank, np.int64), "m": [np.array([rank == 1])],
         "f": np.float32(rank) + np.arange(2, dtype=np.float32)})
    out["reduce_mean"] = comm.reduce_dict({"b": float(rank), "a": 2.0 + rank})
    out["reduce_sum"] = comm.reduce_dict({"b": float(rank)}, average=False)
    np.random.seed(100 + rank)
    out["seed"] = comm.shared_random_seed()
    out["psum"] = comm.psum_metrics({"n": torch.tensor([rank + 1.0])},
                                    mesh, "data")["n"]
    out["psum_model"] = comm.psum_metrics({"n": torch.tensor([rank + 1.0])},
                                          mesh, "model")["n"]
    flags = torch.tensor([rank == 0, True])
    out["bool_reduce"] = comm.all_reduce(flags.clone(), "max")
    out["bcast"] = comm.broadcast(torch.tensor([rank + 5, rank]), 0)
    out["bcast_bool"] = comm.broadcast(torch.tensor([rank == 1]), 1)
    module = torch.nn.Linear(2, 2)
    torch.nn.init.constant_(module.weight, float(rank))
    rep = pmesh.replicate(mesh, {"m": module, "a": np.full(3, rank)}, "cpu")
    out["replicated"] = (rep["m"].weight.detach().clone(), rep["a"])
    out["shard"] = pmesh.shard_batch(mesh, {"x": np.arange(3)}, "cpu")["x"]
    comm.synchronize()
    return out


@pytest.fixture(scope="module")
def world2():
    return launch.run_local(_collectives_rank, 2, device="cpu",
                            timeout=TIMEOUT, threads=1)


def test_world2_ranks_and_mesh(world2):
    assert [r["rank"] for r in world2] == [0, 1]
    assert [r["world"] for r in world2] == [2, 2]
    assert [r["main"] for r in world2] == [True, False]
    # row-major, as the JAX package reshapes its device list
    assert [r["mesh"] for r in world2] == [(("data", "model"), 2, 1, 0, 0),
                                           (("data", "model"), 2, 1, 1, 0)]
    assert [r["rows"] for r in world2] == [slice(0, 3), slice(3, 6)]
    assert [r["mesh12"] for r in world2] == [(1, 0), (1, 1)]


def test_world2_all_gather_arrays(world2):
    for r in world2:
        g = r["gather"]
        np.testing.assert_array_equal(g["x"], np.stack(
            [np.zeros((2, 3)), np.ones((2, 3))]).astype(np.int64))
        assert g["x"].dtype == np.int64
        np.testing.assert_array_equal(g["m"][0], [[False], [True]])
        np.testing.assert_array_equal(g["f"], [[0, 1], [1, 2]])


def test_world2_reduce_dict_and_seed(world2):
    for r in world2:
        assert r["reduce_mean"] == {"a": 2.5, "b": 0.5}
        assert list(r["reduce_mean"]) == ["a", "b"]      # sorted keys
        assert r["reduce_sum"] == {"b": 1.0}
    np.random.seed(100)
    assert world2[0]["seed"] == world2[1]["seed"] == np.random.randint(
        0, 2 ** 31)


def test_world2_tensor_collectives(world2):
    for r in world2:
        assert r["psum"].tolist() == [3.0]
        assert r["psum_model"].tolist() == [float(r["rank"] + 1)]
        assert r["bool_reduce"].tolist() == [True, True]
        assert r["bcast"].tolist() == [5, 0]
        assert r["bcast_bool"].tolist() == [True]
        assert torch.equal(r["replicated"][0], torch.zeros(2, 2))
        assert r["replicated"][1].tolist() == [0, 0, 0]
        assert r["shard"].tolist() == [0, 1, 2]


def _raising_rank():
    if comm.get_rank() == 1:
        raise KeyError("rank one's fault")
    comm.synchronize()      # rank 0 waits for a partner that is gone


def test_run_local_reports_a_failed_rank():
    """A rank's exception reaches the caller with its traceback; the rank
    left waiting in a collective is stopped, not left to hang."""
    with pytest.raises(RuntimeError, match="rank one's fault"):
        launch.run_local(_raising_rank, 2, device="cpu", timeout=TIMEOUT,
                         threads=1)


def _joined_rank(parallel_cfg, results):
    torch.set_num_threads(1)
    try:
        joined = launch.maybe_initialize(parallel_cfg, device="cpu")
        t = torch.tensor([comm.get_rank() + 1.0])
        comm.all_reduce(t)
        results.put((comm.get_rank(), joined, comm.get_world_size(),
                     t.item()))
        torch.distributed.destroy_process_group()
    except BaseException as e:
        results.put(repr(e))


def test_maybe_initialize_joins_a_world():
    """Two processes join one world through ``parallel.coordinator`` (a
    free port bound at 0) and their ranks from the config, one of them
    from the environment instead."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    cfgs = [{"coordinator": f"127.0.0.1:{port}", "num_processes": 2,
             "process_id": 0}, None]
    env = {"ONEPOSE_COORDINATOR": f"127.0.0.1:{port}",
           "ONEPOSE_NUM_PROCESSES": "2", "ONEPOSE_PROCESS_ID": "1"}
    procs = []
    saved = {k: os.environ.get(k) for k in env}
    try:
        for i, cfg in enumerate(cfgs):
            if i == 1:
                os.environ.update(env)     # the child copies it at start
            procs.append(ctx.Process(target=_joined_rank,
                                     args=(cfg, results)))
            procs[-1].start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    got = sorted(results.get(timeout=TIMEOUT) for _ in procs)
    for p in procs:
        p.join(timeout=30)
        if p.is_alive():
            p.terminate()
    assert got == [(0, True, 2, 3.0), (1, True, 2, 3.0)]
