"""The port's own copies of the host modules against their JAX-package
counterparts, on the CPU.

Each copy is numpy and stdlib code; on seeded numpy inputs it must give
exactly what the original gives (arrays equal, the same file text, the
same config dict), except the float geometry, held to 1e-12."""
import os
import os.path as osp

import numpy as np
import pytest

from onepose_tpu import config as jconfig
from onepose_tpu import evaluators as jeval
from onepose_tpu.datasets import anno as janno
from onepose_tpu.runtime import loader as jloader
from onepose_tpu.sfm import extract as jextract
from onepose_tpu.utils import geometry as jgeo
from onepose_tpu.utils import path_utils as jpath
from onepose_tpu.utils import vis_utils as jvis
from onepose_tpu_torch import config as tconfig
from onepose_tpu_torch import evaluators as teval
from onepose_tpu_torch.datasets import anno as tanno
from onepose_tpu_torch.runtime import loader as tloader
from onepose_tpu_torch.sfm import extract as textract
from onepose_tpu_torch.utils import geometry as tgeo
from onepose_tpu_torch.utils import path_utils as tpath
from onepose_tpu_torch.utils import vis_utils as tvis

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def _db_inputs(rng, points, dim=32):
    idxs = rng.integers(1, 12, points)
    total = int(idxs.sum())
    return dict(
        avg_keypoints3d=rng.normal(size=(points, 3)).astype(np.float32),
        avg_descriptors3d=rng.normal(size=(dim, points)).astype(np.float32),
        avg_scores3d=rng.uniform(0, 1, (points, 1)).astype(np.float32),
        clt_descriptors=rng.normal(size=(dim, total)).astype(np.float32),
        clt_scores=rng.uniform(0, 1, (total, 1)).astype(np.float32),
        idxs=idxs)


def _assert_db_equal(got, ref):
    for field in ("keypoints3d", "descriptors3d", "scores3d",
                  "descriptors2d_db", "scores2d_db", "mask3d"):
        a, b = getattr(got, field), getattr(ref, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert (got.num_leaf, got.num_points) == (ref.num_leaf, ref.num_points)


@pytest.mark.parametrize("points,leaf,shape3d,seed", [
    (37, 4, None, 12345), (40, 8, 48, 7), (5, 2, 8, 0)])
def test_build_object_db_equal(points, leaf, shape3d, seed):
    kw = dict(_db_inputs(np.random.default_rng(points), points),
              num_leaf=leaf, shape3d=shape3d, seed=seed)
    _assert_db_equal(tanno.build_object_db(**kw), janno.build_object_db(**kw))


def test_sample_leaf_indices_equal():
    idxs = np.random.default_rng(0).integers(0, 9, 50)
    got = tanno.sample_leaf_indices(idxs, 6, np.random.default_rng(3))
    ref = janno.sample_leaf_indices(idxs, 6, np.random.default_rng(3))
    np.testing.assert_array_equal(got, ref)


def test_load_object_db_equal(tmp_path):
    d = _db_inputs(np.random.default_rng(1), 30)
    avg, clt, idx = (str(tmp_path / n) for n in
                     ("avg.npz", "clt.npz", "idxs.npy"))
    np.savez(avg, descriptors3d=d["avg_descriptors3d"],
             scores3d=d["avg_scores3d"])
    np.savez(clt, keypoints3d=d["avg_keypoints3d"],
             descriptors3d=d["clt_descriptors"], scores3d=d["clt_scores"])
    np.save(idx, d["idxs"])
    kw = dict(num_leaf=4, shape3d=32)
    _assert_db_equal(tanno.load_object_db(avg, clt, idx, **kw),
                     janno.load_object_db(avg, clt, idx, **kw))


def _poses(rng, n):
    out = []
    for _ in range(n):
        R = jgeo.rodrigues(rng.normal(size=3))
        out.append(np.concatenate([R, rng.normal(size=(3, 1)) * 0.1], 1))
    return out


def test_rodrigues_equal():
    rng = np.random.default_rng(2)
    for rvec in [*rng.normal(size=(20, 3)), np.zeros(3), np.full(3, 1e-14)]:
        np.testing.assert_allclose(tgeo.rodrigues(rvec), jgeo.rodrigues(rvec),
                                   rtol=0, atol=1e-12)


def test_query_pose_error_and_projection_equal():
    rng = np.random.default_rng(3)
    poses = _poses(rng, 12)
    K = np.array([[400.0, 0, 64], [0, 410.0, 60], [0, 0, 1]])
    pts = rng.uniform(-0.1, 0.1, (50, 3)) + np.array([0, 0, 0.5])
    for a, b in zip(poses, poses[1:] + [np.vstack([poses[0], [0, 0, 0, 1]])]):
        np.testing.assert_allclose(tgeo.query_pose_error(a, b),
                                   jgeo.query_pose_error(a, b),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(tgeo.project_points(pts, K, a),
                                   jgeo.project_points(pts, K, a),
                                   rtol=0, atol=1e-12)
    errs = {"R_errs": rng.uniform(0, 6, 40), "t_errs": rng.uniform(0, 6, 40)}
    assert tgeo.aggregate_metrics(errs) == jgeo.aggregate_metrics(errs)


def test_evaluator_and_report_equal(tmp_path):
    rng = np.random.default_rng(4)
    gts = _poses(rng, 30)
    preds = [None if i % 7 == 3 else
             np.concatenate([jgeo.rodrigues(rng.normal(size=3) * 0.03) @ g[:, :3],
                             g[:, 3:] + rng.normal(size=(3, 1)) * 0.02], 1)
             for i, g in enumerate(gts)]
    results = []
    for mod in (teval, jeval):
        ev = mod.Evaluator()
        for p, g in zip(preds, gts):
            ev.evaluate(p, g)
        res = ev.summarize(verbose=False)
        out = tmp_path / mod.__name__.split(".")[0]
        mod.record_eval_result(str(out), "obj", "seq", res)
        results.append((res, (out / "objseq.txt").read_text()))
    assert results[0] == results[1]
    assert 0 < results[0][0]["cmd5"] < 1


@pytest.mark.parametrize("overrides", [
    ["+experiment=test_sample"], ["+experiment=test_GATsSPG"],
    ["+experiment=test_demo"], ["+experiment=train_GATsSPG"],
    ["+preprocess=sfm_spp_spg_sample", "sfm.covis_num=4"],
])
def test_load_config_equal(overrides):
    args = [*overrides, "print_config=False"]
    cdir = osp.join(REPO, "configs")
    got = tconfig.load_config(args, config_dir=cdir)
    ref = jconfig.load_config(args, config_dir=cdir)
    assert got == ref
    assert isinstance(got, tconfig.Config) and got.type == ref.type


def test_confs_equal():
    assert textract.CONFS == jextract.CONFS


def test_path_utils_equal():
    for mode, p in (("GT_box", "/d/obj/seq-1/color/12.png"),
                    ("feature_matching", "/d/obj/seq-1/color_det/3.png")):
        assert (tpath.get_intrin_path_by_color(p, mode)
                == jpath.get_intrin_path_by_color(p, mode))
        assert (tpath.get_gt_pose_path_by_color(p, mode)
                == jpath.get_gt_pose_path_by_color(p, mode))
    assert (tpath.get_anno_dir("/m/obj", "superpoint", "superglue")
            == jpath.get_anno_dir("/m/obj", "superpoint", "superglue"))


def test_prefetch_loader_equal():
    items = list(range(11))
    load = lambda i: np.full((4, 4, 1), i, np.float32)  # noqa: E731
    got = list(tloader.PrefetchLoader(items, load, batch_size=4))
    ref = list(jloader.PrefetchLoader(items, load, batch_size=4))
    assert len(got) == len(ref) == 3
    for (gb, gc, gn), (rb, rc, rn) in zip(got, ref):
        np.testing.assert_array_equal(gb, rb)
        assert (gc, gn) == (rc, rn)


def test_export_scene_html_equal(tmp_path):
    rng = np.random.default_rng(5)
    kw = dict(points3d=rng.normal(size=(300, 3)), poses=_poses(rng, 4),
              box3d_corners=rng.normal(size=(8, 3)), name="obj/seq",
              max_points=100)
    got = tvis.export_scene_html(str(tmp_path / "t.html"), **kw)
    ref = jvis.export_scene_html(str(tmp_path / "j.html"), **kw)
    assert open(got).read() == open(ref).read()
    assert os.path.getsize(got) > 1000
