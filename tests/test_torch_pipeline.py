"""The port's whole frame→pose path (pipeline.py, inference.py) against
the JAX pipeline, on the CPU.

The scene is tests/test_pipeline.py::tiny_pipeline, weights bridged from
``superpoint.init_params`` / ``gats_spg.init_params``, the JAX side with
``stem="direct"`` (the port's stem math) and both sides with a match
threshold of 1e-3 (random weights keep conf far below the trained 0.2,
which would leave nothing to compare). RANSAC gets JAX's draws injected.

Tolerances: keypoints and matches exactly equal; poses within 1e-4
(fp32 rounding of the same hypotheses)."""
import os.path as osp

import numpy as np
import pytest
import torch

import jax

from onepose_tpu import pipeline as jpipe
from onepose_tpu.config import Config
from onepose_tpu.datasets import anno
from onepose_tpu.models import gats_spg, superpoint
from onepose_tpu_torch import pipeline as tpipe
from onepose_tpu_torch.models import convert
from onepose_tpu_torch.ops import epnp
from test_cli_integration import build_dataset
from test_torch_epnp import _jax_noise, _stack_noise

SP_CFG = {"max_keypoints": 64}
GATS_CFG = {"match_threshold": 1e-3}
PNP = dict(num_hypotheses=32, refine_iters=2)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(1)
    key = jax.random.PRNGKey(0)
    sp_params = superpoint.init_params(key)
    gats_params = gats_spg.init_params(key)
    P, leaf, D = 40, 4, 256
    idxs = rng.integers(2, 10, P)
    total = int(idxs.sum())
    db = anno.build_object_db(
        avg_keypoints3d=rng.normal(size=(P, 3)).astype(np.float32),
        avg_descriptors3d=rng.normal(size=(D, P)).astype(np.float32),
        avg_scores3d=rng.uniform(0, 1, (P, 1)).astype(np.float32),
        clt_descriptors=rng.normal(size=(D, total)).astype(np.float32),
        clt_scores=rng.uniform(0, 1, (total, 1)).astype(np.float32),
        idxs=idxs, num_leaf=leaf, shape3d=48)
    jax_pipe = jpipe.PosePipeline(
        sp_params, gats_params, db, sp_config={**SP_CFG, "stem": "direct"},
        gats_config=GATS_CFG, **PNP)
    port = tpipe.PosePipeline(
        convert.superpoint_from_jax(jax.tree.map(np.asarray, sp_params)),
        convert.gats_spg_from_jax(jax.tree.map(np.asarray, gats_params)),
        db, sp_config=SP_CFG, gats_config=GATS_CFG, device="cpu", **PNP)
    return jax_pipe, port


def test_pipeline_matches_jax(scene):
    jax_pipe, port = scene
    rng = np.random.default_rng(2)
    B = 2
    images = rng.uniform(0, 1, (B, 64, 64, 1)).astype(np.float32)
    Ks = np.broadcast_to(np.array(
        [[120.0, 0, 32], [0, 120.0, 32], [0, 0, 1]], np.float32),
        (B, 3, 3)).copy()
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    ref = jax_pipe(images, Ks, keys)
    noise = _stack_noise([_jax_noise(k, 64, PNP["num_hypotheses"])
                          for k in keys])
    got = port(images, Ks, noise=noise)

    np.testing.assert_array_equal(got.kpt_mask.numpy(),
                                  np.asarray(ref.kpt_mask))
    np.testing.assert_array_equal(got.keypoints2d.numpy(),
                                  np.asarray(ref.keypoints2d))
    np.testing.assert_array_equal(got.matches0.numpy(),
                                  np.asarray(ref.matches0))
    assert (got.num_matches >= 8).all()
    np.testing.assert_array_equal(got.success.numpy(),
                                  np.asarray(ref.success))
    np.testing.assert_array_equal(got.num_inliers.numpy(),
                                  np.asarray(ref.num_inliers))
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(ref.poses),
                               atol=1e-4)


def test_pipeline_generator_is_deterministic(scene):
    _, port = scene
    rng = np.random.default_rng(4)
    images = rng.uniform(0, 1, (1, 64, 64, 1)).astype(np.float32)
    Ks = np.array([[[120.0, 0, 32], [0, 120.0, 32], [0, 0, 1]]], np.float32)
    outs = [port(images, Ks, generator=torch.Generator().manual_seed(7))
            for _ in range(2)]
    torch.testing.assert_close(outs[0].poses, outs[1].poses, rtol=0, atol=0)
    assert outs[0].poses.shape == (1, 3, 4)


def test_poses_from_matches_shared_db_broadcasts():
    """A shared [N2, 3] DB and a per-frame [B, N2, 3] copy give the same
    RANSAC input and so the same poses."""
    rng = np.random.default_rng(5)
    B, K, N2 = 2, 32, 40
    kpts = torch.from_numpy(rng.uniform(0, 64, (B, K, 2)).astype(np.float32))
    mask = torch.ones(B, K, dtype=torch.bool)
    m0 = torch.from_numpy(rng.integers(-1, N2, (B, K)))
    pts = torch.from_numpy(rng.normal(size=(N2, 3)).astype(np.float32))
    Ks = torch.eye(3).expand(B, 3, 3)
    noise = epnp.draw_noise(B, K, 16, 8, torch.Generator().manual_seed(0))
    a = tpipe.poses_from_matches(kpts, mask, m0, pts, Ks, noise=noise,
                                 num_hypotheses=16)
    b = tpipe.poses_from_matches(kpts, mask, m0, pts.expand(B, N2, 3), Ks,
                                 noise=noise, num_hypotheses=16)
    torch.testing.assert_close(a.pose, b.pose, rtol=0, atol=0)


def _cli_config(root, **extra):
    return Config({
        "network": Config({"detection": "superpoint",
                           "matching": "superglue"}),
        "num_leaf": 4, "shape3d": 32, "max_keypoints": 64,
        "object_detect_mode": "GT_box", "batch_size": 2,
        "pnp": Config({"reproj_threshold": 5.0, "num_hypotheses": 32,
                       "refine_iters": 2}),
        "save_wis3d": True,
        "output": Config({"eval_dir": osp.join(root, "runs/eval"),
                          "vis_dir": osp.join(root, "runs/vis")}),
        **extra,
    })


def test_inference_cli_on_synthetic_dataset(tmp_path):
    """tests/test_cli_integration.py's dataset through the port's entry:
    cmd1/3/5, the per-sequence report and the scene export."""
    from onepose_tpu_torch import inference

    build_dataset(tmp_path, np.random.default_rng(0))
    root = str(tmp_path)
    rng = np.random.default_rng(0)
    sp_model = convert.superpoint_from_jax(convert.init_superpoint_params(rng))
    gats_model = convert.gats_spg_from_jax(convert.init_gats_spg_params(rng))
    data_root = osp.join(root, "data/onepose_datasets/test_data/0001-obj-box")
    args = (data_root, osp.join(data_root, "obj-1"),
            osp.join(root, "data/sfm_model/0001-obj-box"), sp_model,
            gats_model)
    res = inference.inference_core(_cli_config(root, device="cpu"), *args)
    assert set(res) == {"cmd1", "cmd3", "cmd5"}
    assert "cmd1" in open(osp.join(root, "runs/eval",
                                   "0001-obj-boxobj-1.txt")).read()
    assert osp.exists(osp.join(root, "runs/vis", "0001-obj-box_obj-1.html"))

    with pytest.raises(NotImplementedError, match="fp32 only"):
        inference.inference_core(
            _cli_config(root, compute_dtype="bfloat16"), *args)
