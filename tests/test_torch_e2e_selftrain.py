"""The port end to end, as ``tests/test_e2e_selftrain.py`` runs the JAX
package: a synthetic multi-view scene → the port's triangulation and
postprocess → a merged training index → the port TRAINS the GATsSPG
matcher on those files → pose inference on held-out views with the
trained weights → cmd metrics, all on the CPU. Slow (as the JAX one is):
40 epochs of training.
"""
import json
import os.path as osp
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, osp.dirname(__file__))

from test_sfm import make_scene, write_fixture_h5  # noqa: E402

from onepose_tpu_torch import pipeline  # noqa: E402
from onepose_tpu_torch.datasets import anno  # noqa: E402
from onepose_tpu_torch.datasets.gats_dataset import GATsSPGDataset  # noqa: E402
from onepose_tpu_torch.evaluators import Evaluator  # noqa: E402
from onepose_tpu_torch.models import gats_spg  # noqa: E402
from onepose_tpu_torch.ops import epnp  # noqa: E402
from onepose_tpu_torch.sfm import postprocess, triangulate  # noqa: E402
from onepose_tpu_torch.train import trainer  # noqa: E402
from onepose_tpu_torch.utils import geometry as geo  # noqa: E402

DIM = 32  # the fixture's descriptor dim (write_fixture_h5)


@pytest.mark.slow
def test_selftrain_end_to_end(tmp_path):
    rng = np.random.default_rng(0)

    # ---- 1. synthetic capture + SfM → annotation files
    pts3d, K, poses, uvs, perms = make_scene(
        rng, n_points=48, n_cams=12, noise_px=0.3)
    names, feat_p, match_p, pair_list, Ks, poses_d, sizes = \
        write_fixture_h5(tmp_path, rng, pts3d, K, poses, uvs, perms,
                         outlier_matches=2)
    model_dir = str(tmp_path / "sfm_ws" / "model")
    triangulate.triangulate_from_h5(
        feat_p, match_p, pair_list, Ks, poses_d, sizes, model_dir,
        verbose=False, device="cpu")
    anno_dir = str(tmp_path / "anno")
    pp = postprocess.postprocess(model_dir, feat_p, names, anno_dir)
    assert pp["num_points"] >= 40

    # ---- 2. merged training index over the per-image annos
    with open(osp.join(anno_dir, "anno_2d.json")) as f:
        annos = json.load(f)
    images = [{"id": i + 1, "img_file": a["img_file"]}
              for i, a in enumerate(annos)]
    annotations = [{
        "image_id": i + 1, "id": i + 1, "pose_file": a["pose_file"],
        "anno2d_file": a["anno_file"],
        "avg_anno3d_file": osp.join(anno_dir, "anno_3d_average.npz"),
        "collect_anno3d_file": osp.join(anno_dir, "anno_3d_collect.npz"),
        "idxs_file": osp.join(anno_dir, "idxs.npy")}
        for i, a in enumerate(annos)]
    train_json = str(tmp_path / "train.json")
    with open(train_json, "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)

    # ---- 3. train the matcher on the files
    shape2d, shape3d, leaf = 64, 64, 2
    ds = GATsSPGDataset(train_json, num_leaf=leaf, split="train",
                        shape2d=shape2d, shape3d=shape3d, seed=0)
    cfg = {"num_blocks": 1, "descriptor_dim": DIM}
    state = trainer.init_train_state(
        trainer.make_optimizer(base_lr=2e-3, grad_clip=0.5), cfg, seed=0,
        device="cpu")
    step = trainer.make_train_step(cfg)
    losses = []
    for epoch in range(40):
        for batch_np in ds.batches(4, shuffle=True, seed=epoch):
            state, loss = step(state, {
                k: torch.from_numpy(batch_np[k]) for k in (
                    "descriptors2d_query", "descriptors3d_db",
                    "descriptors2d_db", "conf_gt")})
            losses.append(loss.item())
    assert losses[-1] < losses[0] * 0.2, (losses[0], losses[-1])

    # ---- 4. held-out views of the same object
    db = anno.load_object_db(
        osp.join(anno_dir, "anno_3d_average.npz"),
        osp.join(anno_dir, "anno_3d_collect.npz"),
        osp.join(anno_dir, "idxs.npy"), num_leaf=leaf, shape3d=shape3d)
    avg = np.load(osp.join(anno_dir, "anno_3d_average.npz"))
    point_desc = np.asarray(avg["descriptors3d"], np.float32).T  # [P, D]
    merged_xyz = np.asarray(avg["keypoints3d"], np.float32)
    P = merged_xyz.shape[0]
    model = state.model.eval()

    evaluator = Evaluator()
    gen = torch.Generator().manual_seed(0)
    for trial in range(6):
        theta = 2 * np.pi * (trial + 0.5) / 6
        center = np.array([0.55 * np.cos(theta), 0.55 * np.sin(theta), 0.35])
        z = -center / np.linalg.norm(center)
        x = np.cross(z, np.array([0.0, 0.0, 1.0]))
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        pose_gt = np.concatenate([R, (-R @ center)[:, None]], axis=1)

        uv = geo.project_points(merged_xyz, K, pose_gt)
        uv += rng.normal(size=uv.shape) * 0.3
        q_desc = point_desc + 0.05 * rng.normal(
            size=point_desc.shape).astype(np.float32)
        q_desc /= np.linalg.norm(q_desc, axis=1, keepdims=True)
        n_pad = shape2d - P
        kpts2d = np.concatenate(
            [uv, rng.uniform(0, 512, (n_pad, 2))]).astype(np.float32)
        desc2d = np.concatenate([q_desc, np.ones((n_pad, DIM), np.float32)])
        mask2d = np.zeros(shape2d, bool)
        mask2d[:P] = True

        t = torch.from_numpy
        match = gats_spg.forward(model, {
            "descriptors2d_query": t(desc2d[None]),
            "descriptors3d_db": t(db.descriptors3d[None]),
            "descriptors2d_db": t(db.descriptors2d_db[None]),
            "mask2d": t(mask2d[None]), "mask3d": t(db.mask3d[None])}, cfg)
        n_matches = int((match.matches0[0] >= 0).sum())
        assert n_matches >= P // 2, (trial, n_matches)

        res = pipeline.poses_from_matches(
            t(kpts2d[None]), t(mask2d[None]), match.matches0,
            t(db.keypoints3d), t(np.asarray(K, np.float32)[None]),
            noise=epnp.draw_noise(1, shape2d, 128, 64, gen),
            num_hypotheses=128, refine_iters=3)
        evaluator.evaluate(res.pose[0].numpy() if bool(res.success[0])
                           else None, pose_gt)

    metrics = evaluator.summarize(verbose=False)
    assert metrics["cmd5"] >= 5 / 6, metrics
    assert metrics["cmd1"] >= 4 / 6, metrics
