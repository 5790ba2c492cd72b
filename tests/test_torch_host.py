"""The port's own copies of the host modules against their JAX-package
counterparts, on the CPU.

Each copy is numpy and stdlib code; on seeded numpy inputs it must give
exactly what the original gives (arrays equal, the same file text, the
same config dict), except the float geometry, held to 1e-12."""
import json
import os
import os.path as osp
import sqlite3

import numpy as np
import pytest

from onepose_tpu import config as jconfig
from onepose_tpu import evaluators as jeval
from onepose_tpu.datasets import anno as janno
from onepose_tpu.datasets import merge as jmerge
from onepose_tpu.runtime import native as jnative
from onepose_tpu.sfm import pairs as jpairs, postprocess as jpost
from onepose_tpu.utils import colmap_db as jdb
from onepose_tpu.runtime import loader as jloader
from onepose_tpu.sfm import extract as jextract
from onepose_tpu.utils import colmap_io as jcolmap
from onepose_tpu.utils import geometry as jgeo
from onepose_tpu.utils import path_utils as jpath
from onepose_tpu.utils import vis_utils as jvis
from onepose_tpu_torch import config as tconfig
from onepose_tpu_torch import evaluators as teval
from onepose_tpu_torch.datasets import anno as tanno
from onepose_tpu_torch.datasets import merge as tmerge
from onepose_tpu_torch.runtime import native as tnative
from onepose_tpu_torch.sfm import pairs as tpairs, postprocess as tpost
from onepose_tpu_torch.utils import colmap_db as tdb
from onepose_tpu_torch.runtime import loader as tloader
from onepose_tpu_torch.sfm import extract as textract
from onepose_tpu_torch.utils import colmap_io as tcolmap
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
    assert (tpath.get_intrin_full_path("/d/obj/seq-1")
            == jpath.get_intrin_full_path("/d/obj/seq-1"))
    assert tpath.get_3d_box_path("/d/obj") == jpath.get_3d_box_path("/d/obj")


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


def test_demo_rendering_equal(tmp_path):
    """reproj, draw_3d_box, save_demo_image and make_video: the same
    pixels, files and video as the originals."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(8)
    K = np.array([[200.0, 0, 80], [0, 200.0, 60], [0, 0, 1]])
    pose = _poses(rng, 1)[0]
    box = rng.uniform(-0.1, 0.1, (8, 3))
    np.testing.assert_array_equal(tvis.reproj(K, pose, box),
                                  jvis.reproj(K, pose, box))
    assert tvis.BOX_EDGES == jvis.BOX_EDGES
    img = rng.integers(0, 256, (120, 160), np.uint8)
    for draw in (True, False):
        outs = []
        for name, mod in (("t", tvis), ("j", jvis)):
            d = tmp_path / f"{name}{int(draw)}"
            outs.append(mod.save_demo_image(pose, K, img, box, draw,
                                            str(d / "0.png")))
            mod.save_demo_image(pose, K, img, box, draw, str(d / "1.png"))
            mod.make_video(str(d), str(d / "v.mp4"))
            outs.append(cv2.imread(str(d / "0.png")))
            outs.append(os.path.getsize(d / "v.mp4"))
        for a, b in zip(outs[:3], outs[3:]):
            np.testing.assert_array_equal(a, b)
    assert tvis.make_video(str(tmp_path / "none"), str(tmp_path / "x.mp4")) \
        is None


@pytest.mark.parametrize("rot,shift,inv", [
    (0.0, (0.0, 0.0), False), (17.5, (0.1, -0.2), False),
    (-30.0, (0.0, 0.0), True)])
def test_get_affine_transform_equal(rot, shift, inv):
    rng = np.random.default_rng(6)
    for _ in range(5):
        center = rng.uniform(0, 600, 2)
        scale = rng.uniform(20, 400, 2)
        out = rng.integers(64, 640, 2)
        np.testing.assert_array_equal(
            tgeo.get_affine_transform(center, scale, rot, out, shift, inv),
            jgeo.get_affine_transform(center, scale, rot, out, shift, inv))
    np.testing.assert_array_equal(
        tgeo.get_affine_transform([5, 6], 100.0, rot, [64, 48]),
        jgeo.get_affine_transform([5, 6], 100.0, rot, [64, 48]))


def test_crop_resize_and_K_equal(tmp_path):
    pytest.importorskip("cv2")
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    K = np.array([[300.0, 0, 80], [0, 310.0, 60], [0, 0, 1]])
    for box, shape in (([10, 20, 90, 100], (64, 64)),
                       ([-5, 3, 170, 90], (48, 80))):
        for got, ref in zip(tgeo.get_image_crop_resize(img, box, shape),
                            jgeo.get_image_crop_resize(img, box, shape)):
            np.testing.assert_array_equal(got, ref)
        for k in (K, np.concatenate([K, np.ones((3, 1))], 1)):
            for got, ref in zip(tgeo.get_K_crop_resize(box, k, shape),
                                jgeo.get_K_crop_resize(box, k, shape)):
                np.testing.assert_array_equal(got, ref)
    path = tmp_path / "intrinsics.txt"
    path.write_text("fx: 501.5\nfy: 499.25\ncx: 320.0\ncy: 241.75\n")
    for got, ref in zip(tgeo.get_K(str(path)), jgeo.get_K(str(path))):
        np.testing.assert_array_equal(got, ref)


def test_colmap_readers_equal(tmp_path):
    """A model written by the JAX package's writers reads back the same
    through both packages' readers, field by field."""
    rng = np.random.default_rng(8)
    cams = {i: jcolmap.Camera(i, m, 640, 480, rng.normal(size=n))
            for i, (m, n) in enumerate([("PINHOLE", 4), ("OPENCV", 8),
                                        ("SIMPLE_RADIAL", 4)], start=1)}
    images = {}
    for i in range(1, 6):
        n = int(rng.integers(0, 20))
        images[i] = jcolmap.Image(
            i, rng.normal(size=4), rng.normal(size=3), 1 + i % 3,
            f"seq-{i}/color/{i * 7}.png", rng.uniform(0, 640, (n, 2)),
            rng.integers(-1, 50, n).astype(np.int64))
    points = {}
    for pid in range(40):
        t = int(rng.integers(1, 6))
        points[pid] = jcolmap.Point3D(
            pid, rng.normal(size=3), rng.integers(0, 256, 3).astype(np.uint8),
            float(rng.uniform(0, 2)), rng.integers(1, 6, t).astype(np.int32),
            rng.integers(0, 20, t).astype(np.int32))
    jcolmap.write_model(cams, images, points, str(tmp_path))
    got = tcolmap.read_model(str(tmp_path))
    ref = jcolmap.read_model(str(tmp_path))
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in g:
            for f in vars(r[k]):
                a, b = getattr(g[k], f), getattr(r[k], f)
                if isinstance(b, np.ndarray):
                    assert a.dtype == b.dtype, f
                    np.testing.assert_array_equal(a, b, err_msg=f)
                else:
                    assert a == b, f
    assert len(got[1]) == 5 and len(got[2]) == 40


def test_sample_ref_views_equal(tmp_path):
    """The detector entry's view sampling reads the SfM model with the
    port's reader and picks what the root script picks."""
    import feature_matching_object_detector as jfm
    from onepose_tpu_torch import feature_matching_object_detector as tfm

    model_dir = tmp_path / "obj" / "outputs_superpoint_superglue" / "sfm_ws"
    images = {i: jcolmap.Image(i, np.zeros(4), np.zeros(3), 1,
                               f"/data/db/{i}.png", np.zeros((0, 2)),
                               np.zeros(0, np.int64))
              for i in (4, 1, 9, 2, 7, 3, 5)}
    jcolmap.write_model({1: jcolmap.Camera(1, "PINHOLE", 8, 8, np.ones(4))},
                        images, {}, str(model_dir / "model"))
    for n in (1, 3, 15):
        args = (str(tmp_path / "obj"), "superpoint", "superglue", n)
        assert tfm.sample_ref_views(*args) == jfm.sample_ref_views(*args)


# ---------------------------------------------------------------------------
# The SfM slice's copies
# ---------------------------------------------------------------------------

def test_quaternions_equal():
    rng = np.random.default_rng(9)
    for rvec in [*rng.normal(size=(20, 3)) * 2, np.zeros(3),
                 np.array([np.pi, 0, 0])]:
        R = jgeo.rodrigues(rvec)
        np.testing.assert_array_equal(tgeo.rotmat2qvec(R),
                                      jgeo.rotmat2qvec(R))
        q = jgeo.rotmat2qvec(R)
        np.testing.assert_array_equal(tgeo.qvec2rotmat(q),
                                      jgeo.qvec2rotmat(q))


def _random_model(rng):
    cams = {i: jcolmap.Camera(i, m, 640, 480, rng.normal(size=n))
            for i, (m, n) in enumerate([("PINHOLE", 4), ("OPENCV", 8),
                                        ("SIMPLE_PINHOLE", 3)], start=1)}
    images = {}
    for i in (3, 1, 2, 5):
        n = int(rng.integers(0, 20))
        images[i] = jcolmap.Image(
            i, rng.normal(size=4), rng.normal(size=3), 1 + i % 3,
            f"seq-{i}/color/{i * 7}.png", rng.uniform(0, 640, (n, 2)),
            rng.integers(-1, 50, n).astype(np.int64))
    points = {}
    for pid in range(1, 30):
        t = int(rng.integers(1, 6))
        points[pid] = jcolmap.Point3D(
            pid, rng.normal(size=3), rng.integers(0, 256, 3).astype(np.uint8),
            float(rng.uniform(0, 2)), rng.integers(1, 6, t).astype(np.int32),
            rng.integers(0, 20, t).astype(np.int32))
    return cams, images, points


def test_colmap_writers_equal(tmp_path):
    """Both packages' writers write the same bytes, and the JAX readers
    read the port's model back as written."""
    cams, images, points = _random_model(np.random.default_rng(10))
    for name, mod in (("j", jcolmap), ("t", tcolmap)):
        mod.write_model(cams, images, points, str(tmp_path / name))
        mod.write_points_ply(points, str(tmp_path / name / "model.ply"))
    for f in ("cameras.bin", "images.bin", "points3D.bin", "model.ply"):
        assert ((tmp_path / "t" / f).read_bytes()
                == (tmp_path / "j" / f).read_bytes()), f
    assert tcolmap.CAMERA_MODEL_IDS == jcolmap.CAMERA_MODEL_IDS
    back = jcolmap.read_model(str(tmp_path / "t"))
    assert back[0].keys() == cams.keys() and back[2].keys() == points.keys()
    np.testing.assert_array_equal(back[1][5].xys, images[5].xys)


@pytest.mark.parametrize("with_library", [True, False])
def test_union_find_equal(monkeypatch, with_library):
    """The port's track builder, its C++ library and its Python union-find,
    against the JAX package's."""
    rng = np.random.default_rng(11)
    n = 300
    edges = rng.integers(0, n, (500, 2))
    node_img = rng.integers(0, 12, n).astype(np.int32)
    ref = (jnative.uf_components(n, edges),
           jnative.uf_components_imgsafe(n, edges, node_img))
    if with_library:
        assert tnative.load_library() is not None
        assert tnative.BUILD_DIR.endswith(osp.join("build",
                                                   "onepose_tpu_torch"))
    else:
        monkeypatch.setattr(tnative, "load_library", lambda: None)
    got = (tnative.uf_components(n, edges),
           tnative.uf_components_imgsafe(n, edges, node_img))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert len(np.unique(ref[1])) > len(np.unique(ref[0]))


def _ring_poses(n):
    Rs, ts = [], []
    for i in range(n):
        th = 2 * np.pi * i / n
        c = np.array([0.6 * np.cos(th), 0.6 * np.sin(th), 0.3])
        z = -c / np.linalg.norm(c)
        x = np.cross(z, [0.0, 0.0, 1.0])
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        Rs.append(R)
        ts.append(-R @ c)
    return np.stack(Rs), np.stack(ts)


@pytest.mark.parametrize("n,num_matched,seqs", [(14, 4, 1), (40, 10, 2),
                                                 (9, 10, 1)])
def test_covis_pairs_equal(tmp_path, n, num_matched, seqs):
    names = [f"/d/seq{i % seqs}/color/{i}.png" for i in range(n)]
    kw = dict(num_matched=num_matched, poses=_ring_poses(n))
    got = tpairs.covis_pairs(names, **kw)
    assert got == jpairs.covis_pairs(names, **kw) and got
    tpairs.write_pairs(got, str(tmp_path / "t.txt"))
    jpairs.write_pairs(got, str(tmp_path / "j.txt"))
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    assert tpairs.read_pairs(str(tmp_path / "j.txt")) == got


def test_postprocess_pieces_equal():
    rng = np.random.default_rng(12)
    _, images, points = _random_model(rng)
    for cap in (5, 20, 100):
        assert (tpost.select_track_length(points, cap)
                == jpost.select_track_length(points, cap))
    xyzs = rng.uniform(-0.1, 0.1, (200, 3))
    xyzs[100:110] = xyzs[:10] + 1e-4          # close pairs that merge
    ids = np.arange(200) * 3
    corners = np.array([[-1, -1, -1], [-1, 1, -1], [1, 1, -1], [1, -1, -1],
                        [-1, -1, 1], [-1, 1, 1], [1, 1, 1], [1, -1, 1]]) * 0.08
    for got, ref in zip(tpost.filter_by_3d_box(xyzs, ids, corners),
                        jpost.filter_by_3d_box(xyzs, ids, corners)):
        np.testing.assert_array_equal(got, ref)
    g_xyz, g_idx = tpost.merge_points(xyzs, ids)
    r_xyz, r_idx = jpost.merge_points(xyzs, ids)
    np.testing.assert_array_equal(g_xyz, r_xyz)
    assert g_idx.keys() == r_idx.keys() and len(r_xyz) <= 190
    for k in r_idx:
        np.testing.assert_array_equal(g_idx[k], r_idx[k])


def test_export_database_equal(tmp_path):
    """The same COLMAP database, table by table, from the same feature and
    match files and verified geometry."""
    import h5py

    from onepose_tpu.sfm.match import names_to_pair

    rng = np.random.default_rng(13)
    names = [f"/d/s/color/{i}.png" for i in range(4)]
    feat, match = str(tmp_path / "f.h5"), str(tmp_path / "m.h5")
    with h5py.File(feat, "w") as f:
        for n in names:
            f.create_group(n).create_dataset(
                "keypoints", data=rng.uniform(0, 512, (30, 2)).astype(
                    np.float32))
    pairs = [(names[0], names[1]), (names[1], names[0]), (names[2], names[3]),
             (names[1], names[3])]
    verified = {}
    with h5py.File(match, "w") as f:
        for a, b in pairs[::2] + pairs[3:]:
            m0 = rng.integers(-1, 30, 30)
            f.create_group(names_to_pair(a, b)).create_dataset(
                "matches0", data=m0)
            idx = np.stack([np.flatnonzero(m0 >= 0), m0[m0 >= 0]], 1)[:10]
            verified[(a, b)] = ({"matches": idx, "F": rng.normal(size=(3, 3)),
                                 "E": rng.normal(size=(3, 3)), "H": np.eye(3),
                                 "qvec": rng.normal(size=4),
                                 "tvec": rng.normal(size=3)}
                                if a == names[0] else idx)
    Ks = {n: np.array([[500.0, 0, 256], [0, 500, 256], [0, 0, 1]])
          for n in names}
    sizes = {n: (512, 512) for n in names}
    tables = []
    for name, mod in (("t", tdb), ("j", jdb)):
        path = str(tmp_path / f"{name}.db")
        ids = mod.export_database(feat, match, pairs, Ks, sizes, verified,
                                  path)
        conn = sqlite3.connect(path)
        tables.append((ids, {t: conn.execute(
            f"SELECT * FROM {t}").fetchall() for t in (
            "cameras", "images", "keypoints", "descriptors", "matches",
            "two_view_geometries")}))
        conn.close()
    assert tables[0] == tables[1]
    assert len(tables[1][1]["two_view_geometries"]) == 3
    assert tdb.pair_id_of(3, 1) == jdb.pair_id_of(3, 1)


def test_merge_anno_equal(tmp_path):
    rng = np.random.default_rng(14)
    for obj in ("a", "b"):
        d = tmp_path / obj / "outputs_superpoint_superglue" / "anno"
        d.mkdir(parents=True)
        for f in ("anno_3d_average.npz", "anno_3d_collect.npz", "idxs.npy"):
            (d / f).write_bytes(b"")
        json.dump([{"anno_id": i, "anno_file": f"{obj}/{i}.json",
                    "img_file": f"{obj}/{i}.png",
                    "pose_file": f"{obj}/{i}.txt"}
                   for i in range(int(rng.integers(1, 5)))],
                  open(d / "anno_2d.json", "w"))
    names = ["a", "missing", "b"]
    got = tmerge.merge_anno(str(tmp_path), names, str(tmp_path / "t.json"))
    ref = jmerge.merge_anno(str(tmp_path), names, str(tmp_path / "j.json"))
    assert got == ref > 0
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = osp.join(d, f)
            out[osp.relpath(p, root)] = (os.readlink(p) if osp.islink(p)
                                         else open(p, "rb").read())
    return out


def test_parse_scanned_data_equal(tmp_path):
    """Both ingest entries on the same synthetic ARKit capture write the
    same files (poses, boxes, crops, intrinsics, transforms)."""
    pytest.importorskip("cv2")
    import parse_scanned_data as jpsd
    from onepose_tpu_torch import parse_scanned_data as tpsd
    from test_parse_scanned_data import synth_capture

    trees = []
    for name, mod in (("t", tpsd), ("j", jpsd)):
        root = tmp_path / name / "0999-obj-box"
        synth_capture(root / "obj-annotate", np.random.default_rng(15),
                      n_frames=4)
        synth_capture(root / "obj-test", np.random.default_rng(16),
                      n_frames=3)
        mod.data_process_anno(str(root / "obj-annotate"))
        mod.data_process_test(str(root / "obj-test"))
        tree = _tree(str(tmp_path / name))
        # the *_ba links name their own tree
        trees.append({k: v.replace(str(tmp_path / name), "") if
                      isinstance(v, str) else v for k, v in tree.items()})
    assert trees[0] == trees[1]
    assert len([k for k in trees[1] if k.endswith(".png")]) >= 11


def test_video2img_equal(tmp_path):
    cv2 = pytest.importorskip("cv2")
    import video2img as jv2i
    from onepose_tpu_torch import video2img as tv2i

    video = str(tmp_path / "v.mp4")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 30,
                             (64, 48))
    rng = np.random.default_rng(17)
    for _ in range(7):
        writer.write(rng.integers(0, 256, (48, 64, 3), np.uint8))
    writer.release()
    assert (tv2i.video2img(video, str(tmp_path / "t"), 2)
            == jv2i.video2img(video, str(tmp_path / "j"), 2) == 4)
    assert _tree(str(tmp_path / "t")) == _tree(str(tmp_path / "j"))


# --------------------------------------------------------------------------
# the training slice's host copies
# --------------------------------------------------------------------------

@pytest.mark.parametrize("overrides", [
    ["model.lr=1e-3,5e-4", "+experiment=train_GATsSPG", "seed=1,2,3"],
    ["model.milestones=[5,10],[1]", "trainer.max_epochs=2"], []])
def test_expand_multirun_equal(overrides):
    assert (tconfig.expand_multirun(overrides)
            == jconfig.expand_multirun(overrides))


def test_stage_ahead_equal():
    from onepose_tpu_torch.runtime.loader import DeviceStager

    def stage(b):
        return b * 2

    batches = [np.full(3, i) for i in range(5)]
    got = list(tloader.stage_ahead(iter(batches), stage))
    ref = list(jloader.stage_ahead(iter(batches), stage))
    assert [g.tolist() for g in got] == [r.tolist() for r in ref]

    def broken():
        yield np.zeros(1)
        raise KeyError("source")

    for mod in (tloader, jloader):
        with pytest.raises(KeyError, match="source"):
            list(mod.stage_ahead(broken(), stage))
    staged = list(tloader.stage_ahead(
        iter([{"a": np.arange(4)}]), DeviceStager("cpu")))
    assert staged[0].ready is None
    np.testing.assert_array_equal(staged[0].wait()["a"].numpy(),
                                  np.arange(4))


def test_normalized_dataset_equal(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from onepose_tpu.datasets.normalized_dataset import \
        NormalizedDataset as JDs
    from onepose_tpu_torch.datasets.normalized_dataset import \
        NormalizedDataset as TDs

    rng = np.random.default_rng(18)
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"{i}.png"))
        cv2.imwrite(paths[-1], rng.integers(0, 256, (24, 32), np.uint8))
    t, j = TDs(paths, resize_hw=(16, 20)), JDs(paths, resize_hw=(16, 20))
    assert len(t) == len(j) == 3
    for i in range(3):
        g, r = t[i], j[i]
        assert g["path"] == r["path"]
        np.testing.assert_array_equal(g["image"], r["image"])
        np.testing.assert_array_equal(g["size"], r["size"])
    for (gb, gc, gn), (rb, rc, rn) in zip(t.loader(2), j.loader(2)):
        np.testing.assert_array_equal(gb, rb)
        assert (gc, gn) == (rc, rn)


def test_draw_matches_equal(tmp_path):
    pytest.importorskip("cv2")
    rng = np.random.default_rng(19)
    img0 = rng.uniform(0, 1, (40, 50)).astype(np.float32)
    img1 = rng.integers(0, 256, (30, 60), np.uint8)
    k0, k1 = rng.uniform(0, 30, (6, 2)), rng.uniform(0, 30, (6, 2))
    conf = rng.uniform(0, 1, 6)
    got = tvis.draw_matches(img0, k0, img1, k1, conf,
                            save_path=str(tmp_path / "t" / "m.png"))
    ref = jvis.draw_matches(img0, k0, img1, k1, conf,
                            save_path=str(tmp_path / "j" / "m.png"))
    np.testing.assert_array_equal(got, ref)
    assert ((tmp_path / "t" / "m.png").read_bytes()
            == (tmp_path / "j" / "m.png").read_bytes())


def test_classification_callbacks_equal(tmp_path):
    from onepose_tpu.train import callbacks as jcb
    from onepose_tpu_torch.train import callbacks as tcb

    assert tcb.MATCH_CLASS_NAMES == jcb.MATCH_CLASS_NAMES
    rng = np.random.default_rng(20)
    hm_t = tcb.ClassificationHeatmaps(tcb.MATCH_CLASS_NAMES)
    hm_j = jcb.ClassificationHeatmaps(jcb.MATCH_CLASS_NAMES)
    for _ in range(3):
        args = (rng.integers(-1, 30, 50), rng.uniform(size=50) < 0.8,
                rng.uniform(0, 64, (50, 2)), rng.uniform(0, 64, (30, 2)),
                rng.uniform(size=30) < 0.9)
        got = tcb.match_classification_labels(*args)
        ref = jcb.match_classification_labels(*args)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
        hm_t.update(*got)
        hm_j.update(*ref)
    np.testing.assert_array_equal(hm_t.confusion_matrix(),
                                  hm_j.confusion_matrix())
    assert hm_t.emit(epoch=1) == hm_j.emit(epoch=1)


def test_param_norms_and_logger_equal(tmp_path):
    import jax

    from onepose_tpu.models import gats_spg as jgats
    from onepose_tpu.train import callbacks as jcb
    from onepose_tpu.train.logging import MetricLogger as JLogger
    from onepose_tpu_torch.models import convert
    from onepose_tpu_torch.train import callbacks as tcb
    from onepose_tpu_torch.train.logging import MetricLogger as TLogger

    params = jgats.init_params(jax.random.PRNGKey(0),
                               {"num_blocks": 1, "descriptor_dim": 32})
    model = convert.gats_spg_from_jax(jax.tree.map(np.asarray, params))
    got, ref = tcb.param_norms(model), jcb.param_norms(params)
    assert sorted(got) == sorted(ref) == ["params_norm/final_proj",
                                          "params_norm/gnn"]
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6)
    for name, cls in (("t", TLogger), ("j", JLogger)):
        logger = cls(str(tmp_path / name), use_tensorboard=False)
        watcher = (tcb if name == "t" else jcb).ModelWatcher(logger, 2)
        assert watcher.step(1, model if name == "t" else params) is None
        logger.log(3, {"epoch": 0, "train_loss": 0.5, "lr": 1e-3})
        logger.close()
    assert ((tmp_path / "t" / "metrics.jsonl").read_text()
            == (tmp_path / "j" / "metrics.jsonl").read_text())


def test_timer_equal(monkeypatch, capsys):
    """``utils/profiling.Timer`` against the original on one scripted
    clock: the same totals, counts, summary and report text."""
    from onepose_tpu.utils import profiling as jprof
    from onepose_tpu_torch.utils import profiling as tprof

    out = []
    for mod in (jprof, tprof):
        clock = iter([0.0, 0.25, 1.0, 1.5, 2.0, 2.125, 3.0, 3.75])
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        timer = mod.Timer()
        timer.tick("a")
        dt = timer.tock("a")
        with timer.scope("b"):
            pass
        timer.tick("a")
        timer.tock("a")
        with timer.scope("default"):
            pass
        timer.report()
        out.append((dt, timer.summary(), capsys.readouterr().out))
    assert out[0] == out[1]
    assert out[1][1]["a"] == {"total_s": 0.375, "count": 2, "mean_ms": 187.5}


def test_block_and_time_and_trace(tmp_path):
    """``block_and_time`` returns the call's output and a time; ``trace``
    writes a Chrome trace that names the ops run under it."""
    import torch

    from onepose_tpu_torch.utils import profiling as tprof

    x = torch.ones(64, 64)
    dt, out = tprof.block_and_time(lambda a: {"y": [a @ a]}, x)
    assert dt >= 0 and torch.equal(out["y"][0], x @ x)
    with tprof.trace(str(tmp_path / "tr")) as prof:
        torch.mm(x, x)
    assert prof is not None
    text = open(tmp_path / "tr" / "trace.json").read()
    assert "aten::mm" in text and json.loads(text)["traceEvents"]
    with tprof.trace(str(tmp_path / "off"), enabled=False) as prof:
        pass
    assert prof is None and not (tmp_path / "off").exists()


@pytest.mark.parametrize("symmetric", [False, True])
def test_add_metric_equal(symmetric):
    rng = np.random.default_rng(11)
    pts = rng.uniform(-0.1, 0.1, (200, 3))
    for gt in _poses(rng, 3):
        pred = np.concatenate(
            [jgeo.rodrigues(rng.normal(size=3) * 0.05) @ gt[:, :3],
             gt[:, 3:] + rng.normal(size=(3, 1)) * 0.01], 1)
        got = teval.add_metric(pred, gt, pts, symmetric=symmetric)
        assert got == jeval.add_metric(pred, gt, pts, symmetric=symmetric)
        assert got > 0
        assert teval.add_metric(gt, gt, pts, symmetric=symmetric) < 1e-12


def test_path_getters_equal():
    for mode, p in (("GT_box", "/d/obj/seq-1/color/12.png"),
                    ("feature_matching", "/d/obj/seq-1/color_det/3.png")):
        assert (tpath.get_img_full_path_by_color(p, mode)
                == jpath.get_img_full_path_by_color(p, mode))
    for seq in ("/d/obj/seq-1", "rel/seq-2/"):
        assert tpath.get_intrin_dir(seq) == jpath.get_intrin_dir(seq)
        assert tpath.get_gt_pose_dir(seq) == jpath.get_gt_pose_dir(seq)


def test_export_scene_equal(tmp_path):
    """The PLY and the JSON manifest byte for byte, written in turn to
    the same directory (the manifest names the PLY's path)."""
    rng = np.random.default_rng(12)
    kw = dict(points3d=rng.normal(size=(50, 3)), poses=_poses(rng, 3),
              K=np.array([[500.0, 0, 256], [0, 500.0, 256], [0, 0, 1]]),
              box3d_corners=rng.normal(size=(8, 3)), name="obj")
    files = []
    for mod in (jvis, tvis):
        path = mod.export_scene(str(tmp_path), **kw)
        files.append((open(path, "rb").read(),
                      open(tmp_path / "obj_points.ply", "rb").read()))
    assert files[0] == files[1]
    assert tvis.export_scene(str(tmp_path / "e"), name="e") == \
        str(tmp_path / "e" / "e.json")


def test_draw_2d_box_equal():
    pytest.importorskip("cv2")
    rng = np.random.default_rng(13)
    img = rng.integers(0, 256, (80, 90, 3), np.uint8)
    for box, kw in (([5, 5, 60, 60], {}),
                    ([10.7, 3.2, 88.9, 70.1], dict(color=(255, 0, 0),
                                                   thickness=3))):
        got = tvis.draw_2d_box(img.copy(), box, **kw)
        np.testing.assert_array_equal(got,
                                      jvis.draw_2d_box(img.copy(), box, **kw))
        assert (got != img).any()


def test_dump_wis3d_equal(monkeypatch, capsys):
    """Absent: None and the same printed skip. Present (a fake module):
    the same calls with the same arguments."""
    import sys
    import types

    kpts = np.array([[10.0, 10], [20.0, 30], [40.0, 5]])
    reproj = kpts + np.array([[0.5, 0], [0, 0.5], [3.0, 0]])
    conf = np.array([0.9, 0.8, 0.2])
    img = np.zeros((50, 60), np.uint8)
    full = np.zeros((50, 60, 3), np.uint8)
    args = ("vis", "seq", img, img, full, kpts, reproj, conf)

    monkeypatch.setitem(sys.modules, "wis3d", None)
    printed = []
    for mod in (tvis, jvis):
        assert mod.dump_wis3d(0, *args, inliers=[0, 1]) is None
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1] != ""

    def fake_module(log):
        class FakeWis3D:
            def __init__(self, vis_dir, seq_name):
                log.append(("init", vis_dir, seq_name))

            def set_scene_id(self, idx):
                log.append(("scene_id", idx))

            def add_keypoint_correspondences(self, img0, img1, k0, k1,
                                             metrics=None, booleans=None,
                                             meta=None, name=None):
                log.append(("corr", np.asarray(img0).tolist(),
                            np.asarray(k0).tolist(), np.asarray(k1).tolist(),
                            metrics, booleans, meta, name))

            def add_image(self, image, name=None):
                log.append(("image", np.asarray(image).tolist(), name))

        fake = types.ModuleType("wis3d")
        fake.Wis3D = FakeWis3D
        return fake

    logs = []
    for mod in (tvis, jvis):
        log = []
        monkeypatch.setitem(sys.modules, "wis3d", fake_module(log))
        assert mod.dump_wis3d(3, *args, inliers=[0, 1]) is not None
        logs.append(log)
    assert logs[0] == logs[1]
    assert [e[0] for e in logs[0]] == ["init", "scene_id", "corr", "image"]
