"""The port's known-pose triangulation (sfm/triangulate.py) against the
JAX package's, fp32, on the CPU, and its robustness sweep.

The scene is tests/test_sfm.py's: 40 points in a 20 cm box, 10 cameras on
a ring looking at it, 0.3 px noise, every pair matched with 3 outlier
matches (copied here, not imported from the JAX package's test).
Tolerances: the verified match sets, the two-view geometry and the
tracks exactly equal (host code, and a Sampson gate that no match sits
on); triangulated points in equal number, with equal tracks, within
1e-5 m (the DLT's 4x4 systems summed in another order before eigh).

The sweep is tests/test_sfm_stress.py's noise and outlier cells (700
points seen from 48 cameras along contiguous arcs, covis-10 pairs,
``utils/synthetic.ring_features``), the port held to the same bounds.
The reference-scale run (4,000 points, 180 cameras, 4096-budget
keypoints; chip_smoke.py phase 11b on the card) is marked slow: it takes
about 35 s on the CPU.
"""
import h5py
import numpy as np
import pytest

from onepose_tpu.sfm import triangulate as jtri
from onepose_tpu.utils import colmap_io as jcolmap
from onepose_tpu_torch.sfm import postprocess
from onepose_tpu_torch.sfm import triangulate as ttri
from onepose_tpu_torch.sfm.match import names_to_pair
from onepose_tpu_torch.utils import colmap_io
from onepose_tpu_torch.utils import geometry as geo
from onepose_tpu_torch.utils.synthetic import ring_features, ring_pose

XYZ_TOL = 1e-5


def make_scene(rng, n_points=40, n_cams=10, noise_px=0.3):
    """3D points in a 20 cm box, cameras on a ring looking at the origin."""
    pts3d = rng.uniform(-0.1, 0.1, (n_points, 3))
    K = np.array([[500.0, 0, 256], [0, 500.0, 256], [0, 0, 1]])
    poses = [ring_pose(2 * np.pi * i / n_cams, 0.3) for i in range(n_cams)]
    uvs, perms = [], []
    for pose in poses:
        uv = geo.project_points(pts3d, K, pose)
        uv = uv + rng.normal(size=uv.shape) * noise_px
        perm = rng.permutation(n_points)
        uvs.append(uv[perm].astype(np.float32))
        perms.append(perm)
    return pts3d, K, poses, uvs, perms


def write_fixture_h5(tmp_path, rng, pts3d, K, poses, uvs, perms,
                     outlier_matches=3, names=None):
    """Features and pairwise matches in the pipeline's HDF5 layout, with a
    descriptor per 3D point and a few outlier matches a pair."""
    n_cams, n_points, dim = len(poses), len(pts3d), 32
    point_desc = rng.normal(size=(n_points, dim)).astype(np.float32)
    point_desc /= np.linalg.norm(point_desc, axis=1, keepdims=True)
    names = names or [f"/data/seq/color/{i}.png" for i in range(n_cams)]
    feature_path = str(tmp_path / "feats.h5")
    with h5py.File(feature_path, "w") as f:
        for ci, name in enumerate(names):
            g = f.create_group(name)
            g.create_dataset("keypoints", data=uvs[ci])
            g.create_dataset("descriptors", data=point_desc[perms[ci]].T)
            g.create_dataset("scores",
                             data=np.full(n_points, 0.5, np.float32))
            g.create_dataset("image_size", data=np.array([512, 512]))
    pair_list = []
    match_path = str(tmp_path / "matches.h5")
    with h5py.File(match_path, "w") as f:
        for i in range(n_cams):
            for j in range(i + 1, n_cams):
                pair_list.append((names[i], names[j]))
                matches0 = np.argsort(perms[j])[perms[i]].astype(np.int64)
                for _ in range(outlier_matches):
                    matches0[rng.integers(n_points)] = rng.integers(n_points)
                g = f.create_group(names_to_pair(names[i], names[j]))
                g.create_dataset("matches0", data=matches0)
                g.create_dataset("matching_scores0",
                                 data=np.full(n_points, 0.9, np.float32))
    return (names, feature_path, match_path, pair_list, {n: K for n in names},
            dict(zip(names, poses)), {n: (512, 512) for n in names})


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tri")
    rng = np.random.default_rng(0)
    return tmp, write_fixture_h5(tmp, rng, *make_scene(rng))


def test_verification_and_tracks_match_jax(scene):
    _, (names, feat, match, pairs, Ks, poses, _) = scene
    ref = jtri.verify_matches(feat, match, pairs, Ks, poses)
    got = ttri.verify_matches(feat, match, pairs, Ks, poses, device="cpu")
    assert got[0].keys() == ref[0].keys()
    for n in names:
        np.testing.assert_array_equal(got[0][n], ref[0][n])
    assert [v[:2] for v in got[1]] == [v[:2] for v in ref[1]]
    assert len(ref[1]) == 45
    for g, r in zip(got[1], ref[1]):
        np.testing.assert_array_equal(g[2], r[2])
    assert got[2].keys() == ref[2].keys()
    for key in ref[2]:
        for f in ("matches", "F", "E", "H", "qvec", "tvec"):
            np.testing.assert_array_equal(got[2][key][f], ref[2][key][f])
    # the gate drops outliers: fewer than the 40 matches a pair
    assert sum(len(v[2]) for v in ref[1]) < 45 * 40

    num_kpts = {n: len(got[0][n]) for n in names}
    assert (ttri.build_tracks(num_kpts, got[1])
            == jtri.build_tracks(num_kpts, ref[1]))


def test_sampson_gate_matches_jax():
    rng = np.random.default_rng(1)
    F = rng.normal(size=(3, 3))
    uv0 = rng.uniform(0, 512, (50, 2)).astype(np.float32)
    uv1 = rng.uniform(0, 512, (50, 2)).astype(np.float32)
    d_ref = np.asarray(jtri.sampson_distance(
        np.asarray(F, np.float32), uv0, uv1))
    import torch

    d_got = ttri.sampson_distance(torch.tensor(F, dtype=torch.float32),
                                  torch.from_numpy(uv0),
                                  torch.from_numpy(uv1)).numpy()
    np.testing.assert_allclose(d_got, d_ref, rtol=1e-5)
    # many pairs of unequal lengths in one padded call
    oks = ttri.verify_pairs([F, F.T], [uv0, uv0[:20]], [uv1, uv1[:20]],
                            threshold=float(np.median(d_ref)), device="cpu")
    assert [len(o) for o in oks] == [50, 20]
    np.testing.assert_array_equal(oks[0], jtri.verify_pair(
        F, uv0, uv1, float(np.median(d_ref))))


def test_dlt_matches_jax():
    """One batch of tracks through both DLTs: the points within 1e-5 m,
    errors and depths at the used observations within 1e-4 px / m."""
    import torch

    rng = np.random.default_rng(2)
    pts3d, K, poses, _, _ = make_scene(rng, n_points=30, n_cams=8)
    T, M = len(pts3d), 8
    Ps = np.stack([K @ p for p in poses]).astype(np.float32)
    uvs = np.stack([geo.project_points(pts3d, K, p) for p in poses], 1)
    uvs = (uvs + rng.normal(size=uvs.shape) * 0.3).astype(np.float32)
    mask = rng.random((T, M)) < 0.7
    mask[:, :2] = True
    xyz_r, err_r, z_r = (np.asarray(x) for x in jtri._triangulate_batch_host(
        uvs, np.broadcast_to(Ps, (T, M, 3, 4)), mask))
    uvs_t = torch.from_numpy(uvs)
    Ps_t = torch.from_numpy(Ps).expand(T, M, 3, 4)
    r0, r1 = ttri._dlt_rows(uvs_t, Ps_t)
    xyz, err, z = ttri._solve_and_reproject(
        ttri._normal_systems(r0, r1, torch.from_numpy(mask).float()[:, None]),
        uvs_t, Ps_t)
    np.testing.assert_allclose(xyz[:, 0].numpy(), xyz_r, rtol=0, atol=XYZ_TOL)
    np.testing.assert_allclose(err[:, 0].numpy()[mask], err_r[mask], atol=1e-3)
    np.testing.assert_allclose(z[:, 0].numpy()[mask], z_r[mask], atol=1e-5)
    assert np.median(np.linalg.norm(xyz_r - pts3d, axis=1)) < 2e-3


def _model(model_dir):
    cams, images, points = colmap_io.read_model(model_dir)
    return cams, images, points


def test_triangulate_from_h5_matches_jax(scene):
    tmp, (names, feat, match, pairs, Ks, poses, sizes) = scene
    ref_stats = jtri.triangulate_from_h5(feat, match, pairs, Ks, poses, sizes,
                                         str(tmp / "j" / "model"),
                                         verbose=False)
    got_stats = ttri.triangulate_from_h5(feat, match, pairs, Ks, poses, sizes,
                                         str(tmp / "t" / "model"),
                                         verbose=False, device="cpu")
    assert got_stats["num_sparse_points"] == ref_stats["num_sparse_points"]
    assert got_stats["num_sparse_points"] >= 35
    assert got_stats["num_observations"] == ref_stats["num_observations"]
    np.testing.assert_allclose(got_stats["mean_reproj_error"],
                               ref_stats["mean_reproj_error"], rtol=1e-4)
    _, g_img, g_pts = _model(str(tmp / "t" / "model"))
    _, r_img, r_pts = jcolmap.read_model(str(tmp / "j" / "model"))
    assert g_pts.keys() == r_pts.keys()
    for pid in r_pts:
        np.testing.assert_allclose(g_pts[pid].xyz, r_pts[pid].xyz, rtol=0,
                                   atol=XYZ_TOL)
        np.testing.assert_array_equal(g_pts[pid].image_ids,
                                      r_pts[pid].image_ids)
        np.testing.assert_array_equal(g_pts[pid].point2D_idxs,
                                      r_pts[pid].point2D_idxs)
    for iid in r_img:
        np.testing.assert_array_equal(g_img[iid].point3D_ids,
                                      r_img[iid].point3D_ids)
        np.testing.assert_array_equal(g_img[iid].qvec, r_img[iid].qvec)
    assert (open(tmp / "t" / "model.ply").read().count("\n")
            == open(tmp / "j" / "model.ply").read().count("\n"))


def test_triangulate_defaults_to_the_card(scene):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tmp, (_, feat, match, pairs, Ks, poses, sizes) = scene
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttri.triangulate_from_h5(feat, match, pairs, Ks, poses, sizes,
                                 str(tmp / "c" / "model"))


# ---------------------------------------------------------------------------
# Robustness sweep (tests/test_sfm_stress.py's cells)
# ---------------------------------------------------------------------------

N_POINTS, N_CAMS, CAP = 700, 48, 500


def nearest(a, b):
    """Distance from each row of ``a`` to its nearest row of ``b``."""
    return np.sqrt(((a[:, None] - b[None]) ** 2).sum(-1).min(axis=1))


# (noise px, outlier share, recall, precision, reproj bound, length share)
# — tests/test_sfm_stress.py's bounds, cell by cell
SWEEP = [
    (0.5, 0.05, 0.93, 0.93, 0.9, 0.75),
    (1.0, 0.05, 0.93, 0.93, 1.5, 0.75),
    (2.0, 0.05, 0.93, 0.5, 2.7, 0.4),
    (0.5, 0.1, 0.97, 0.90, 1.0, None),
    (0.5, 0.2, 0.97, 0.90, 1.0, None),
    (0.5, 0.3, 0.97, 0.90, 1.0, None),
]


@pytest.mark.parametrize("noise_px,outlier_frac,recall,precision,reproj,"
                         "length", SWEEP,
                         ids=[f"noise{c[0]}-outliers{c[1]}" for c in SWEEP])
def test_triangulation_sweep(tmp_path, noise_px, outlier_frac, recall,
                             precision, reproj, length):
    w = ring_features(str(tmp_path), np.random.default_rng(0), N_POINTS,
                      N_CAMS, noise_px, outlier_frac, arc=(0.15, 0.85))
    stats = ttri.triangulate_from_h5(
        w["feature_path"], w["match_path"], w["pair_list"], w["Ks"],
        w["poses"], w["sizes"], str(tmp_path / "model"), verbose=False,
        device="cpu")
    _, _, points3D = colmap_io.read_model(str(tmp_path / "model"))
    got = np.stack([p.xyz for p in points3D.values()])
    lengths = np.array([len(p.point2D_idxs) for p in points3D.values()])
    radius = max(3e-3, 2.5e-3 * noise_px)
    eligible = w["gt_tracks"] >= 3
    got_recall = float((nearest(w["pts3d"], got)[eligible] < radius).mean())
    got_precision = float((nearest(got, w["pts3d"]) < radius).mean())
    tkl = postprocess.select_track_length(points3D, CAP)
    kept = int((lengths >= tkl).sum())
    m = {"recall": got_recall, "precision": got_precision, "kept": kept,
         "stats": stats}
    assert got_recall >= recall, m
    assert got_precision >= precision, m
    assert stats["mean_reproj_error"] < reproj, m
    if length is not None:
        assert lengths.mean() >= length * w["gt_tracks"][eligible].mean(), m
    assert CAP // 3 <= kept <= CAP, m


@pytest.mark.slow
def test_reference_scale(tmp_path):
    """tests/test_sfm.py::test_sfm_reference_scale_protocol on the port:
    180 cameras, 4,000 points, keypoints within the 4096 budget, covis-10
    pairs; the cloud within 2 mm median, postprocess at most 2,500
    points."""
    w = ring_features(str(tmp_path), np.random.default_rng(11))
    stats = ttri.triangulate_from_h5(
        w["feature_path"], w["match_path"], w["pair_list"], w["Ks"],
        w["poses"], w["sizes"], str(tmp_path / "sfm_ws" / "model"),
        verbose=False, device="cpu")
    assert stats["num_sparse_points"] >= 2500, stats
    _, _, points3D = colmap_io.read_model(str(tmp_path / "sfm_ws" / "model"))
    got = np.stack([p.xyz for p in points3D.values()])
    assert np.median(nearest(got, w["pts3d"])) < 2e-3
    pp = postprocess.postprocess(
        str(tmp_path / "sfm_ws" / "model"), w["feature_path"], w["names"],
        str(tmp_path / "anno"), max_num_points=2500)
    assert pp["num_points"] <= 2500
