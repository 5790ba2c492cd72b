"""The port's SfM back end and entries against the JAX package's, on the
CPU: postprocess (sfm/postprocess.py), global BA (sfm/global_ba.py),
``runner.run_sfm`` through the port's ``run`` entry against the root
``run.py`` (types ``sfm`` and ``merge_anno``).

Tolerances: postprocess is host code on the same model and features, so
its files are equal (the averaged descriptors within 1e-6). BA is held by
cost and residuals, not by parameters: the full Schur path fixes six of
BA's seven gauge freedoms, so its scale is rounding luck on either side
(tests/test_torch_tracking_ops.py::test_lm_schur_converges_with_jax);
final costs within 1e-4 relative, initial costs within 1e-6, residuals
within 5e-3 px. The entries run the same random weights (full-width
SuperPoint, SuperGlue at 2 layers planted on the capture's descriptors)
on a tiny capture read at 128x128; their feature files agree by keypoint
position (keypoints exactly, descriptors and scores within 1e-5), their
matches by position exactly, their models' points within 1e-4 m, and
the pair list and empty model are equal.
"""
import json
import os
import os.path as osp

import h5py
import numpy as np
import pytest
import torch

from onepose_tpu.models import superglue as jsg, superpoint as jsp
from onepose_tpu.sfm import extract as jextract, global_ba as jba
from onepose_tpu.sfm import postprocess as jpost
from onepose_tpu.sfm import triangulate as jtri
from onepose_tpu.utils import colmap_io as jcolmap
from onepose_tpu_torch.config import Config
from onepose_tpu_torch.models import convert, superpoint as tsp
from onepose_tpu_torch.sfm.extract import CONFS, load_gray
from onepose_tpu_torch.sfm import global_ba as tba, postprocess as tpost
from onepose_tpu_torch.utils import colmap_io, geometry as geo
from test_torch_sfm_triangulate import make_scene, write_fixture_h5

cv2 = pytest.importorskip("cv2")


def _files(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = osp.join(d, n)
            out[osp.relpath(p, root)] = open(p, "rb").read()
    return out


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_postprocess_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    pts3d, K, poses, uvs, perms = make_scene(rng)
    # image paths under tmp_path: postprocess writes a json per image
    # next to its sequence
    names, feat, match, pairs, Ks, poses_d, sizes = write_fixture_h5(
        tmp_path, rng, pts3d, K, poses, uvs, perms, names=[
            str(tmp_path / "seq" / "color" / f"{i}.png")
            for i in range(len(poses))])
    jtri.triangulate_from_h5(feat, match, pairs, Ks, poses_d, sizes,
                             str(tmp_path / "model"), verbose=False)
    # a box that cuts the cloud
    box = np.array([[-0.08, -0.08, -0.08], [-0.08, 0.08, -0.08],
                    [0.08, 0.08, -0.08], [0.08, -0.08, -0.08],
                    [-0.08, -0.08, 0.08], [-0.08, 0.08, 0.08],
                    [0.08, 0.08, 0.08], [0.08, -0.08, 0.08]])
    np.savetxt(str(tmp_path / "box.txt"), box)

    outs = {}
    for name, mod in (("j", jpost), ("t", tpost)):
        stats = mod.postprocess(str(tmp_path / "model"), feat, names,
                                str(tmp_path / name / "anno"),
                                box_path=str(tmp_path / "box.txt"),
                                max_num_points=2500)
        outs[name] = (stats, _files(str(tmp_path / name)),
                      _files(str(tmp_path / "seq" / "anno_superpoint")))
    (ref, ref_files, ref_2d), (got, got_files, got_2d) = outs["j"], outs["t"]
    assert got == ref and 10 < ref["num_points"] < 35
    assert got_files.keys() == ref_files.keys()
    assert got_2d == ref_2d and len(ref_2d) == len(names)
    for rel in ref_files:
        if rel.endswith(".npz"):
            g, r = (_npz(str(tmp_path / s / rel)) for s in "tj")
            assert g.keys() == r.keys()
            np.testing.assert_array_equal(g["keypoints3d"], r["keypoints3d"])
            np.testing.assert_array_equal(g["scores3d"], r["scores3d"])
            np.testing.assert_allclose(g["descriptors3d"], r["descriptors3d"],
                                       rtol=0, atol=1e-6)
        else:
            assert got_files[rel] == ref_files[rel], rel


def _perturbed_model(tmp_path):
    """tests/test_aux.py::test_global_ba_refines_model's model, 30 points
    seen by 6 cameras with the stored poses perturbed, here with 0.5 px
    of noise, so that the final cost stands above fp32's floor."""
    rng = np.random.default_rng(0)
    pts3d, K, poses, uvs, perms = make_scene(rng, n_points=30, n_cams=6,
                                             noise_px=0.5)
    cameras, images, points = {}, {}, {}
    for i, pose in enumerate(poses):
        cameras[i + 1] = colmap_io.Camera(
            i + 1, "PINHOLE", 512, 512,
            np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]))
        R_p = geo.rodrigues(rng.normal(size=3) * 0.005) @ pose[:3, :3]
        t_p = pose[:3, 3] + rng.normal(size=3) * 0.002
        images[i + 1] = colmap_io.Image(
            i + 1, geo.rotmat2qvec(R_p), t_p, i + 1, f"img{i}.png",
            uvs[i].astype(np.float64), np.full(len(uvs[i]), -1, np.int64))
    inv_perms = [np.argsort(p) for p in perms]
    for pi in range(len(pts3d)):
        pt2d = np.array([inv_perms[c][pi] for c in range(len(poses))],
                        np.int32)
        points[pi + 1] = colmap_io.Point3D(
            pi + 1, pts3d[pi], np.zeros(3, np.uint8), 0.0,
            np.arange(1, len(poses) + 1, dtype=np.int32), pt2d)
        for c in range(len(poses)):
            images[c + 1].point3D_ids[pt2d[c]] = pi + 1
    model_dir = str(tmp_path / "model")
    colmap_io.write_model(cameras, images, points, model_dir)
    return model_dir, K


def _residuals(model_dir, K):
    _, images, points = jcolmap.read_model(model_dir)
    res = []
    for pid in sorted(points):
        pt = points[pid]
        for iid, ki in zip(pt.image_ids, pt.point2D_idxs):
            im = images[int(iid)]
            cam = geo.qvec2rotmat(im.qvec) @ pt.xyz + im.tvec
            res.append((K @ cam)[:2] / cam[2] - im.xys[int(ki)])
    return np.array(res)


@pytest.mark.parametrize("kw", [{}, {"refine_points": False},
                                {"refine_extrinsics": False}],
                         ids=["full", "extrinsics_only", "points_only"])
def test_bundle_adjuster_matches_jax(tmp_path, kw):
    model_dir, K = _perturbed_model(tmp_path)
    ref = jba.run_bundle_adjuster(model_dir, str(tmp_path / "j"),
                                  iterations=10, **kw)
    got = tba.run_bundle_adjuster(model_dir, str(tmp_path / "t"),
                                  iterations=10, device="cpu", **kw)
    assert got["final_cost"] < got["initial_cost"]
    np.testing.assert_allclose(got["initial_cost"], ref["initial_cost"],
                               rtol=1e-6)
    np.testing.assert_allclose(got["final_cost"], ref["final_cost"],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(_residuals(str(tmp_path / "t"), K),
                               _residuals(str(tmp_path / "j"), K), atol=5e-3)
    if not kw:
        assert np.median(np.linalg.norm(
            _residuals(str(tmp_path / "t"), K), axis=1)) < 1.0


def test_bundle_adjuster_subsamples_and_defaults_to_the_card(tmp_path):
    model_dir, K = _perturbed_model(tmp_path)
    ref = jba.run_bundle_adjuster(model_dir, str(tmp_path / "j"),
                                  iterations=4, max_obs=100)
    got = tba.run_bundle_adjuster(model_dir, str(tmp_path / "t"),
                                  iterations=4, max_obs=100, device="cpu")
    np.testing.assert_allclose(got["initial_cost"], ref["initial_cost"],
                               rtol=1e-6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tba.run_bundle_adjuster(model_dir, str(tmp_path / "c"))


# ---------------------------------------------------------------------------
# The run entry against the root run.py
# ---------------------------------------------------------------------------

HW = 128


def build_capture(tmp_path, rng, n_frames=6, hw=64):
    """tests/test_run_cli.py's capture: textured frames shifting across a
    ring of poses, intrinsics and poses per frame, and a 3D box."""
    obj = tmp_path / "scan" / "0001-toy-box"
    seq = obj / "toy-1"
    for d in ("color", "intrin_ba", "poses_ba"):
        (seq / d).mkdir(parents=True)
    K = np.array([[80.0 * hw / 64, 0, hw / 2], [0, 80.0 * hw / 64, hw / 2],
                  [0, 0, 1]])
    np.savetxt(str(obj / "box3d_corners.txt"), np.array([
        [-1, -1, -1], [-1, 1, -1], [1, 1, -1], [1, -1, -1],
        [-1, -1, 1], [-1, 1, 1], [1, 1, 1], [1, -1, 1]]) * 0.2)
    tex = cv2.resize(rng.uniform(0, 255, (16, 16)).astype(np.uint8),
                     (hw, hw), interpolation=cv2.INTER_CUBIC)
    for i in range(n_frames):
        cv2.imwrite(str(seq / "color" / f"{i}.png"),
                    np.roll(tex, i * 3, axis=1))
        np.savetxt(str(seq / "intrin_ba" / f"{i}.txt"), K)
        pose = np.eye(4)
        pose[:3, :3] = geo.rodrigues([0.3 + 0.1 * i, 0.05 * i, 0.0])
        pose[:3, 3] = [0.01 * i, 0.0, 0.5]
        np.savetxt(str(seq / "poses_ba" / f"{i}.txt"), pose)
    return obj


def _sfm_config(tmp, out):
    with open(tmp / "list.txt", "w") as f:
        f.write("0001-toy-box toy-1\n")
    return {
        "type": "sfm", "redo": False, "device": "cpu",
        "scan_data_dir": str(tmp / "scan"),
        "dataset": {"max_num_kp3d": 100, "data_list": str(tmp / "list.txt"),
                    "outputs_dir": str(tmp / out) + "/{}"},
        "network": {"detection": "superpoint", "matching": "superglue",
                    "detection_model_path": str(tmp / "sp.pth"),
                    "matching_model_path": str(tmp / "sg.pth")},
        "sfm": {"down_ratio": 2, "covis_num": 4, "rotation_thresh": 50},
    }


def _config(d, cls):
    return cls({k: _config(v, cls) if isinstance(v, dict) else v
                for k, v in d.items()})


@pytest.fixture(scope="module")
def run_outputs(tmp_path_factory):
    """The root run.py and the port's entry, type sfm, on one capture."""
    import run as root_run
    from onepose_tpu.config import Config as JConfig
    from onepose_tpu.models import convert as jconvert
    from onepose_tpu.utils import model_io as jmodel_io
    from onepose_tpu_torch import run as trun
    from test_torch_superglue import _reference_state_dict as sg_state_dict

    tmp = tmp_path_factory.mktemp("run")
    rng = np.random.default_rng(0)
    build_capture(tmp, rng, hw=HW)
    sp = convert.init_superpoint_params(rng)
    torch.save({f"{n}.{k}": torch.from_numpy(np.array(
        p["w"].transpose(3, 2, 0, 1) if k == "weight" else p["b"]))
        for n, p in sp.items() for k in ("weight", "bias")}, tmp / "sp.pth")
    # SuperGlue planted on the capture's descriptors: matching is their
    # self-similarity, so the shifted frames match
    frames = np.stack([load_gray(str(p)) for p in sorted(
        (tmp / "scan" / "0001-toy-box" / "toy-1" / "color").glob("*.png"))])
    conf = dict(CONFS["superpoint"]["conf"])
    conf.pop("descriptor_dim")
    det = tsp.extract(convert.superpoint_from_jax(sp),
                      torch.from_numpy(frames[..., None]), conf)
    sg = convert.plant_superglue(convert.init_superglue_params(
        rng, {"num_gnn_layers": 2}), det, 0.0)
    torch.save(sg_state_dict(sg), tmp / "sg.pth")

    with pytest.MonkeyPatch.context() as mp:
        # both extractors read the frames at their size, not 512x512
        for confs in (CONFS, jextract.CONFS):
            mp.setitem(confs["superpoint"], "preprocessing", {
                "grayscale": True, "resize_h": HW, "resize_w": HW})
        # the JAX loader assumes the reference's depth (18 layers, a
        # 5-conv keypoint encoder); the JAX stem runs the plain math
        mp.setattr(jmodel_io, "load_superglue_params", lambda p: (
            jconvert.superglue_from_state_dict(jconvert.load_state_dict(p),
                                               num_gnn_layers=2,
                                               num_kenc_convs=4)))
        mp.setitem(jsp.DEFAULT_CONFIG, "stem", "direct")
        root_run.sfm(_config(_sfm_config(tmp, "jax"), JConfig))
        trun.sfm(_config(_sfm_config(tmp, "port"), Config))
    return tmp


def _by_position(kpts):
    """Row order of keypoints [N, 2] sorted by position (y, then x)."""
    return np.lexsort((kpts[:, 0], kpts[:, 1]))


def test_run_sfm_entry_matches_the_root_script(run_outputs):
    """Keypoints are compared by position: scores within rounding of each
    other may take each other's slots (the JAX package sorts by score),
    so each image's rows are put in position order first, and so are the
    matches, which index them."""
    tmp = run_outputs
    sub = osp.join("0001-toy-box", "outputs_superpoint_superglue")
    ref = _files(str(tmp / "jax" / sub))
    got = _files(str(tmp / "port" / sub))
    assert got.keys() == ref.keys()
    for rel in ("pairs-covis4.txt", "sfm_empty/images.bin",
                "sfm_empty/cameras.bin"):
        assert got[rel] == ref[rel], rel
    feats = [h5py.File(str(tmp / s / sub / "feats-superpoint.h5"), "r")
             for s in ("port", "jax")]
    names = []
    feats[1].visit(lambda n: names.append(n[:-len("/keypoints")])
                   if n.endswith("/keypoints") else None)
    assert len(names) == 3                         # frames 0, 2, 4
    order = {}
    for n in names:
        kp = [f[n]["keypoints"][()] for f in feats]
        order[n] = [_by_position(k) for k in kp]
        np.testing.assert_array_equal(*(k[o] for k, o in zip(kp, order[n])))
        for k in ("descriptors", "scores"):
            g, r = (f[n][k][()][..., o] for f, o in zip(feats, order[n]))
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-5, err_msg=k)
    matches = [h5py.File(str(tmp / s / sub / "matches-superglue.h5"), "r")
               for s in ("port", "jax")]
    pairs = [line.split() for line in open(str(
        tmp / "jax" / sub / "pairs-covis4.txt")).read().splitlines()]
    assert sorted(matches[0]) == sorted(matches[1]) and len(matches[1])
    n_matches = 0
    for a, b in pairs:
        key = "_".join((a.replace("/", "-"), b.replace("/", "-")))
        if key not in matches[1]:
            continue
        a, b = a.lstrip("/"), b.lstrip("/")
        mapped = []
        for i, m in enumerate(matches):
            m0 = m[key]["matches0"][()][order[a][i]]
            rank = np.argsort(order[b][i])
            mapped.append(np.where(m0 >= 0, rank[np.maximum(m0, 0)], -1))
        np.testing.assert_array_equal(*mapped, err_msg=key)
        n_matches += int((mapped[1] >= 0).sum())
    models = [reader(str(tmp / s / sub / "sfm_ws" / "model"))
              for s, reader in (("port", colmap_io.read_model),
                                ("jax", jcolmap.read_model))]
    xyz = [np.stack([p.xyz for p in m[2].values()]) for m in models]
    assert len(xyz[0]) == len(xyz[1]) >= 100
    # each point of one model within 1e-4 m of one of the other's: the
    # frames' shifts do not follow the capture's poses, so some points
    # are far and ill-conditioned (1.5e-5 m apart at most, measured)
    for a, b in (xyz, xyz[::-1]):
        d = np.sqrt(((a[:, None] - b[None]) ** 2).sum(-1)).min(axis=1)
        assert d.max() < 1e-4, d.max()
    assert n_matches >= 100


def test_run_merge_anno_entry_matches_the_root_script(run_outputs):
    import run as root_run
    from onepose_tpu.config import Config as JConfig
    from onepose_tpu_torch import run as trun

    tmp = run_outputs
    with open(tmp / "names.txt", "w") as f:
        f.write("0001-toy-box\nmissing-object\n")
    for name, mod, cls in (("jax", root_run, JConfig), ("port", trun, Config)):
        mod.merge_anno(_config({
            "type": "merge_anno", "split": "train",
            "network": {"detection": "superpoint", "matching": "superglue"},
            "datamodule": {"data_dir": str(tmp / name),
                           "out_path": str(tmp / f"{name}_train.json")},
            "train": {"names_file": str(tmp / "names.txt")}}, cls))
    ref = json.load(open(tmp / "jax_train.json"))
    got = json.load(open(tmp / "port_train.json"))
    assert got == json.loads(json.dumps(ref).replace(
        str(tmp / "jax"), str(tmp / "port")))
