"""The port's GATsSPG training dataset (onepose_tpu_torch/datasets/
gats_dataset.py, a numpy copy) against the JAX package's, on the CPU.

Both read the same merged annotation index of
``tests/test_cli_integration.py::build_dataset`` (five frames of one
object, descriptors of D=32) at shape2d 24, shape3d 40, leaf 4, and draw
from the same seeded numpy streams, so every array is equal exactly:
items, dense batches (serial and threaded), light batches (leaf indices
or leaf seeds), the device DB, the padding helpers and validation
queries.
"""
import os.path as osp
import sys

import numpy as np
import pytest

from onepose_tpu.datasets import gats_dataset as jds
from onepose_tpu_torch.datasets import gats_dataset as tds
from onepose_tpu_torch.datasets.merge import merge_anno

sys.path.insert(0, osp.dirname(osp.abspath(__file__)))
from test_cli_integration import build_dataset  # noqa: E402

DIM, SHAPE2D, SHAPE3D, LEAF = 32, 24, 40, 4
KW = dict(num_leaf=LEAF, shape2d=SHAPE2D, shape3d=SHAPE3D, seed=5)


@pytest.fixture(scope="module")
def train_json(tmp_path_factory):
    """The fixture's merged index (``train.json``) of one object."""
    tmp = tmp_path_factory.mktemp("gats_ds")
    build_dataset(tmp, np.random.default_rng(4), dim=DIM)
    out = str(tmp / "data" / "cache" / "t" / "train.json")
    assert merge_anno(str(tmp / "data" / "sfm_model"), ["0001-obj-box"],
                      out) == 5
    return out


def _equal(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]),
                                      err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(ref[k]).dtype, k


def test_padding_helpers_equal():
    rng = np.random.default_rng(0)
    kpts = rng.uniform(0, 96, (10, 2)).astype(np.float32)
    descs = rng.normal(size=(10, DIM)).astype(np.float32)
    scores = rng.uniform(0, 1, 10).astype(np.float32)
    for target in (6, 10, 24):
        got = tds.pad_keypoints2d_random(kpts, descs, scores, 512, 512,
                                         target, np.random.default_rng(1))
        ref = jds.pad_keypoints2d_random(kpts, descs, scores, 512, 512,
                                         target, np.random.default_rng(1))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(
            tds.pad_keypoints3d_random(kpts[:, :1].repeat(3, 1), target,
                                       np.random.default_rng(2)),
            jds.pad_keypoints3d_random(kpts[:, :1].repeat(3, 1), target,
                                       np.random.default_rng(2)))
    assign = np.array([[0, 5, 23, 30, 2], [1, 39, 7, 3, 45]])
    for num2d, num3d in ((20, 30), (30, 50), (0, 0)):
        np.testing.assert_array_equal(
            tds.reshape_assign_matrix(assign, num2d, num3d, SHAPE2D, SHAPE3D),
            jds.reshape_assign_matrix(assign, num2d, num3d, SHAPE2D, SHAPE3D))


def test_items_and_index_equal(train_json):
    assert tds.load_anno_index(train_json) == jds.load_anno_index(train_json)
    t = tds.GATsSPGDataset(train_json, split="train", **KW)
    j = jds.GATsSPGDataset(train_json, split="train", **KW)
    assert len(t) == len(j) == 5
    for i in range(len(t)):
        _equal(t.get(i), j.get(i))
    tq = tds.GATsSPGDataset(train_json, split="val", load_pose_gt=True, **KW)
    jq = jds.GATsSPGDataset(train_json, split="val", load_pose_gt=True, **KW)
    _equal(tq.get(1), jq.get(1))
    _equal(tq.get_query(2), jq.get_query(2))


@pytest.mark.parametrize("num_threads", [1, 3])
def test_batches_equal(train_json, num_threads):
    t = tds.GATsSPGDataset(train_json, split="train", **KW)
    j = jds.GATsSPGDataset(train_json, split="train", **KW)
    got = list(t.batches(2, shuffle=True, seed=7, num_threads=num_threads))
    ref = list(j.batches(2, shuffle=True, seed=7, num_threads=num_threads))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        _equal(g, r)


@pytest.mark.parametrize("on_device_leaves", [False, True])
def test_light_batches_and_device_db_equal(train_json, on_device_leaves):
    t = tds.GATsSPGDataset(train_json, split="train", **KW)
    j = jds.GATsSPGDataset(train_json, split="train", **KW)
    (tdb, tidx), (jdb, jidx) = t.device_db(), j.device_db()
    assert tidx == jidx
    _equal(tdb, jdb)
    got = list(t.light_batches(tidx, tdb["t_max"], 2, seed=3,
                               on_device_leaves=on_device_leaves))
    ref = list(j.light_batches(jidx, jdb["t_max"], 2, seed=3,
                               on_device_leaves=on_device_leaves))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        _equal(g, r)
        assert ("leaf_seed" in g) == on_device_leaves
