"""The port's detector path (ops/similarity.py, detector.py and the
detector entry) against the JAX package, fp32, on the CPU.

``ransac_similarity`` gets each view's JAX draws injected
(``jax.random.uniform`` of the view's key, as the JAX detector's ``vmap``
splits them). ``detect_bbox`` runs on a small planted scene: random
SuperPoint weights with zero biases, three random DB views, and a query
frame that is one view pasted into a black frame at an offset that is a
multiple of 8, so that its SuperPoint features are the view's own.
SuperGlue's weights make the keypoint encoder and every GNN delta zero
(or small) and the final projection a scaled identity less the DB's mean
descriptor, so that matching is descriptor self-similarity and the box
comes back near the pasted rectangle. The JAX side runs with
``stem="direct"``.

Tolerances: similarity A within 1e-5 and t within 1e-5 relative (t is a
difference of means of coordinates up to 400 px, which fp32 sums in
another order resolve to a few 1e-5), inlier sets identical; boxes and
inlier counts identical; the log assignments within GATE_REL (5e-5) of
their scale and matches0 equal except in the near-ties that their difference explains
(``superglue.match_gate``); crops and intrinsics equal (the same cv2 calls
on the same inputs)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from onepose_tpu import detector as jdet
from onepose_tpu.models import superglue as jsg
from onepose_tpu.models import superpoint as jsp
from onepose_tpu.ops import similarity as jsim
from onepose_tpu_torch import detector as tdet
from onepose_tpu_torch.models import convert
from onepose_tpu_torch.models import superglue as tsg
from onepose_tpu_torch.ops import similarity as tsim
from test_detector import make_pairs
from test_torch_superglue import jax_matches_and_log_assignment

SG_LAYERS = 4
DB_HW, FRAME_HW, OFFSET = (96, 128), (176, 224), (40, 48)   # offset (x, y)
K = np.array([[200.0, 0, 112], [0, 200.0, 88], [0, 0, 1]])


# ---------------------------------------------------------------------------
# ransac_similarity
# ---------------------------------------------------------------------------

def _jax_fit(keys, src, dst, mask, **kw):
    return [jsim.ransac_similarity(k, jnp.asarray(s), jnp.asarray(d),
                                   jnp.asarray(m), **kw)
            for k, s, d, m in zip(keys, src, dst, mask)]


def _assert_fits_equal(got, refs):
    for v, ref in enumerate(refs):
        np.testing.assert_allclose(got.A[v].numpy(), np.asarray(ref.A),
                                   atol=1e-5)
        np.testing.assert_allclose(got.t[v].numpy(), np.asarray(ref.t),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got.inliers[v].numpy(),
                                      np.asarray(ref.inliers))
        assert int(got.num_inliers[v]) == int(ref.num_inliers)
        assert bool(got.success[v]) == bool(ref.success)


def test_ransac_similarity_matches_jax_view_for_view():
    """Three views at once (the JAX detector's vmap as a batch dim): an
    exact one, one with 40% outliers, one with 30 valid slots of 100."""
    rng = np.random.default_rng(0)
    cases = [make_pairs(rng, noise=0.0),
             make_pairs(rng, noise=0.5, outlier_frac=0.4, theta=-0.7),
             make_pairs(rng, noise=1.0, outlier_frac=0.3, n_valid=30)]
    src, dst, mask = (np.stack([c[i] for c in cases]) for i in range(3))
    keys = jax.random.split(jax.random.PRNGKey(1), 3)
    noise = torch.from_numpy(np.stack(
        [np.asarray(jax.random.uniform(k, (256, 100))) for k in keys]))
    got = tsim.ransac_similarity(torch.from_numpy(src), torch.from_numpy(dst),
                                 torch.from_numpy(mask), noise=noise)
    _assert_fits_equal(got, _jax_fit(keys, src, dst, mask))
    for v, (_, _, _, A_gt, t_gt) in enumerate(cases[:2]):
        np.testing.assert_allclose(got.A[v].numpy(), A_gt, atol=0.02)
        np.testing.assert_allclose(got.t[v].numpy(), t_gt, atol=3.0)


def test_ransac_similarity_collapse_guard():
    """tests/test_detector.py's IRLS collapse case: 3 exact inliers among
    wild outliers at a tight threshold. The result is the winner's model,
    in both packages alike; a degenerate view beside it (one valid slot)
    fails without disturbing it."""
    rng = np.random.default_rng(7)
    A_gt = 1.2 * np.array([[np.cos(0.3), -np.sin(0.3)],
                           [np.sin(0.3), np.cos(0.3)]], np.float32)
    t_gt = np.array([15.0, -5.0], np.float32)
    src = rng.uniform(0, 400, (2, 32, 2)).astype(np.float32)
    dst = rng.uniform(2000, 4000, (2, 32, 2)).astype(np.float32)
    dst[0, :3] = src[0, :3] @ A_gt.T + t_gt
    mask = np.ones((2, 32), bool)
    mask[1, 1:] = False
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    noise = torch.from_numpy(np.stack(
        [np.asarray(jax.random.uniform(k, (4096, 32))) for k in keys]))
    got = tsim.ransac_similarity(
        torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(mask),
        threshold=0.5, num_hypotheses=4096, noise=noise)
    _assert_fits_equal(got, _jax_fit(keys, src, dst, mask, threshold=0.5,
                                     num_hypotheses=4096))
    assert got.success.tolist() == [True, False]
    assert int(got.num_inliers[0]) >= 3 and int(got.num_inliers[1]) == 0
    np.testing.assert_allclose(got.A[0].numpy(), A_gt, atol=1e-2)
    np.testing.assert_allclose(got.t[0].numpy(), t_gt, atol=1.0)


def test_ransac_similarity_generator_draws():
    rng = np.random.default_rng(2)
    src, dst, mask, A_gt, t_gt = make_pairs(rng, noise=0.5, outlier_frac=0.4)
    args = [torch.from_numpy(x)[None] for x in (src, dst, mask)]
    a, b = (tsim.ransac_similarity(*args,
                                   generator=torch.Generator().manual_seed(4))
            for _ in range(2))
    torch.testing.assert_close(a.A, b.A, rtol=0, atol=0)
    np.testing.assert_allclose(a.A[0].numpy(), A_gt, atol=0.02)
    assert int(a.num_inliers[0]) >= 50


# ---------------------------------------------------------------------------
# The detector on a planted scene
# ---------------------------------------------------------------------------

def _scene(seed=0, views=3, pasted=1):
    rng = np.random.default_rng(seed)
    db = [rng.uniform(0, 1, DB_HW).astype(np.float32) for _ in range(views)]
    frame = np.zeros(FRAME_HW, np.float32)
    (ox, oy), (h, w) = OFFSET, DB_HW
    frame[oy:oy + h, ox:ox + w] = db[pasted]
    return db, frame, np.array([ox, oy, ox + w, oy + h])


def _planted_sg_params(sp_params, db, delta, seed=5, config=None):
    """SuperGlue weights (JAX layout) planted on the DB views' descriptors
    by ``convert.plant_superglue``: every delta scaled by ``delta``,
    the final projection s·(x - mu)."""
    params = jax.tree.map(np.array, jsg.init_params(
        jax.random.PRNGKey(seed), config or {"num_gnn_layers": SG_LAYERS}))
    probe = tdet.LocalFeatureObjectDetector(
        convert.superpoint_from_jax(sp_params),
        convert.superglue_from_jax(params), db, max_keypoints=64,
        device="cpu")
    return convert.plant_superglue(params, probe.db_det, delta)


@pytest.fixture(scope="module")
def sp_params():
    return jax.tree.map(np.asarray, jsp.init_params(jax.random.PRNGKey(2)))


def _detectors(sp_params, sg_params, db):
    jax_det = jdet.LocalFeatureObjectDetector(
        sp_params, sg_params, db, sp_config={"stem": "direct"},
        max_keypoints=64)
    port = tdet.LocalFeatureObjectDetector(
        convert.superpoint_from_jax(sp_params),
        convert.superglue_from_jax(sg_params), db, max_keypoints=64,
        device="cpu")
    return jax_det, port


def _view_noise(key, views, k=64):
    return torch.from_numpy(np.stack(
        [np.asarray(jax.random.uniform(sub, (256, k)))
         for sub in jax.random.split(key, views)]))


@pytest.mark.parametrize("delta", [0.0, 0.05])
def test_detect_bbox_matches_jax_on_planted_scene(sp_params, delta):
    db, frame, rect = _scene()
    sg_params = _planted_sg_params(sp_params, db, delta)
    jax_det, port = _detectors(sp_params, sg_params, db)
    key = jax.random.PRNGKey(11)
    ref_box, ref_inl = jax_det.detect_bbox(frame, key)
    box, inl = port.detect_bbox(frame, noise=_view_noise(key, len(db)))
    np.testing.assert_array_equal(box, ref_box)
    assert inl == ref_inl >= 20
    # 64 keypoints in a 96x128 view: the 6 px threshold admits some
    # mismatches between neighbours, which pull the fit by a few pixels
    assert np.abs(box - rect).max() <= 8, (box, rect)

    # matches per view, the forward detect_bbox runs, under the near-tie
    # gate (64 keypoints 3 px apart share descriptor cells, so some
    # mutual decisions are near-ties)
    q_det = port.extract(torch.from_numpy(frame)[None, :, :, None])
    data = port.match_data(q_det, frame.shape)
    got = tsg.forward(port.sg_model, data, port.sg_config)
    Z = tsg.log_assignment(port.sg_model, data, port.sg_config)
    jq = jsp.extract(sp_params, jnp.asarray(frame)[None, :, :, None],
                     jax_det.sp_config)
    v, k = len(db), 64
    jdata = {
        "keypoints0": jax_det.db_det.keypoints,
        "scores0": jax_det.db_det.scores,
        "descriptors0": jax_det.db_det.descriptors,
        "mask0": jax_det.db_det.mask,
        "keypoints1": jnp.broadcast_to(jq.keypoints, (v, k, 2)),
        "scores1": jnp.broadcast_to(jq.scores, (v, k)),
        "descriptors1": jnp.broadcast_to(jq.descriptors, (v, k, 256)),
        "mask1": jnp.broadcast_to(jq.mask, (v, k)),
        "shape0": DB_HW, "shape1": FRAME_HW}
    ref_m0, ref_Z = jax_matches_and_log_assignment(sg_params, jdata,
                                                   jax_det.sg_config)
    gate = tsg.match_gate(got.matches0, Z, ref_m0, ref_Z,
                          port.sg_config["match_threshold"])
    assert gate.ok and gate.diff <= 4, gate


def test_detect_falls_back_to_the_whole_frame(sp_params):
    """Under 6 inliers the box is the whole frame, as in the JAX package
    (random SuperGlue weights leave every score far below 0.2)."""
    db, frame, _ = _scene()
    sg_params = jax.tree.map(np.asarray, jsg.init_params(
        jax.random.PRNGKey(5), {"num_gnn_layers": SG_LAYERS}))
    jax_det, port = _detectors(sp_params, sg_params, db)
    key = jax.random.PRNGKey(12)
    ref = jax_det.detect_bbox(frame, key)
    got = port.detect_bbox(frame, noise=_view_noise(key, len(db)))
    assert got[1] == ref[1] == 0
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[0], [0, 0, FRAME_HW[1], FRAME_HW[0]])


def test_detect_and_previous_pose_detect_match_jax(sp_params):
    """The host half: crop and intrinsics after detection and after the
    projection of a 3D box with a previous pose."""
    pytest.importorskip("cv2")
    db, frame, _ = _scene()
    jax_det, port = _detectors(sp_params,
                               _planted_sg_params(sp_params, db, 0.0), db)
    key = jax.random.PRNGKey(13)
    ref = jax_det.detect(frame, K, key=key)
    got = port.detect(frame, K, noise=_view_noise(key, len(db)))
    for name in ("bbox", "crop", "K_crop"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(ref, name))
    assert got.inliers == ref.inliers and got.crop.shape == (512, 512)

    corners = np.array([[x, y, z] for x in (-0.05, 0.05)
                        for y in (-0.04, 0.04) for z in (-0.03, 0.03)])
    pose = np.concatenate([np.eye(3), [[0.01], [-0.02], [0.6]]], 1)
    ref = jax_det.previous_pose_detect(frame, K, pose, corners, 256)
    got = port.previous_pose_detect(frame, K, pose, corners, 256)
    for name in ("bbox", "crop", "K_crop"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(ref, name))
    assert got.inliers == -1


def test_crop_img_by_bbox_equal():
    pytest.importorskip("cv2")
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (480, 640)).astype(np.float32)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    for bbox in ([100, 60, 420, 380], [-20, 10, 300, 500], [5, 7, 64, 40]):
        for k in (K, None):
            crop, K_crop = tdet.crop_img_by_bbox(img, bbox, k, 128)
            ref_crop, ref_K = jdet.crop_img_by_bbox(img, bbox, k, 128)
            np.testing.assert_array_equal(crop, ref_crop)
            if k is None:
                assert K_crop is None and ref_K is None
            else:
                np.testing.assert_array_equal(K_crop, ref_K)


def test_detector_defaults_to_the_card(sp_params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    db, _, _ = _scene()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdet.LocalFeatureObjectDetector(
            convert.superpoint_from_jax(sp_params),
            convert.superglue_from_jax(jax.tree.map(
                np.asarray, jsg.init_params(jax.random.PRNGKey(0)))), db)


def _config(cls, d):
    return cls({k: _config(cls, v) if isinstance(v, dict) else v
                for k, v in d.items()})


def test_detector_entry_matches_the_root_script(sp_params, tmp_path):
    """``python -m onepose_tpu_torch.feature_matching_object_detector``'s
    ``detection`` against the root script's on a tiny layout (an SfM model
    naming three DB views, two full frames, reference-layout .pth
    weights): the same color_det/ crops and intrin_det/ intrinsics. The
    SuperGlue checkpoint has the reference's depth (18 layers, a 5-conv
    keypoint encoder), which the JAX package's loader assumes."""
    cv2 = pytest.importorskip("cv2")
    from onepose_tpu.config import Config as JConfig
    from onepose_tpu.utils import colmap_io as jcolmap
    from onepose_tpu_torch import feature_matching_object_detector as tfm
    from onepose_tpu_torch.config import Config as TConfig
    from test_torch_superglue import _reference_state_dict
    import feature_matching_object_detector as jfm

    db, frame, _ = _scene()
    db = [np.round(v * 255) / 255 for v in db]   # what a PNG round trip keeps
    frame = np.round(frame * 255) / 255
    paths = []
    for i, view in enumerate(db):
        paths.append(str(tmp_path / f"db{i}.png"))
        cv2.imwrite(paths[-1], (view * 255).round().astype(np.uint8))
    model = tmp_path / "sfm" / "obj" / "outputs_superpoint_superglue" / \
        "sfm_ws" / "model"
    jcolmap.write_model(
        {1: jcolmap.Camera(1, "PINHOLE", 128, 96, np.ones(4))},
        {i + 1: jcolmap.Image(i + 1, np.zeros(4), np.zeros(3), 1, p,
                              np.zeros((0, 2)), np.zeros(0, np.int64))
         for i, p in enumerate(paths)}, {}, str(model))
    seq = tmp_path / "data" / "obj" / "seq-1"
    (seq / "color_full").mkdir(parents=True)
    (seq / "intrinsics.txt").write_text(
        "fx: 200.0\nfy: 200.0\ncx: 112.0\ncy: 88.0\n")
    for i, f in enumerate((frame, np.roll(frame, 16, axis=1))):
        cv2.imwrite(str(seq / "color_full" / f"{i}.png"),
                    (f * 255).round().astype(np.uint8))

    sg_params = _planted_sg_params(
        sp_params, db, 0.0, config={"keypoint_encoder": (32, 64, 128, 256,
                                                         256)})
    torch.save(_reference_state_dict(sg_params), tmp_path / "sg.pth")
    torch.save({f"{n}.{k}": torch.from_numpy(np.array(
        p["w"].transpose(3, 2, 0, 1) if k == "weight" else p["b"]))
        for n, p in sp_params.items() for k in ("weight", "bias")},
        tmp_path / "sp.pth")
    (tmp_path / "data.txt").write_text("obj seq-1\n")
    (tmp_path / "sfm.txt").write_text("obj\n")
    cfg = {"type": "detection", "n_ref_view": 3, "max_keypoints": 64,
           "device": "cpu",
           "network": {"detection": "superpoint", "matching": "superglue"},
           "model": {"extractor_model_path": str(tmp_path / "sp.pth"),
                     "matching_model_path": str(tmp_path / "sg.pth")},
           "input": {"data_list": str(tmp_path / "data.txt"),
                     "sfm_list": str(tmp_path / "sfm.txt")},
           "scan_data_dir": str(tmp_path / "data"),
           "sfm_model_dir": str(tmp_path / "sfm")}
    outputs = {}
    for name, run, cls in (("port", tfm.detection, TConfig),
                           ("jax", jfm.detection, JConfig)):
        run(_config(cls, cfg))
        outputs[name] = {
            p.name: (cv2.imread(str(p), cv2.IMREAD_GRAYSCALE)
                     if p.suffix == ".png" else np.loadtxt(p))
            for d in ("color_det", "intrin_det")
            for p in sorted((seq / d).iterdir())}
        for d in ("color_det", "intrin_det"):
            for p in (seq / d).iterdir():
                p.unlink()
    assert sorted(outputs["port"]) == ["0.png", "0.txt", "1.png", "1.txt"]
    for k, v in outputs["jax"].items():
        np.testing.assert_array_equal(outputs["port"][k], v, err_msg=k)
    assert outputs["port"]["0.png"].shape == (512, 512)
    # frame 0 was found (a 128-px-wide box: fx 200 → about 800), not the
    # whole-frame fallback (fx 200 · 512 / 224)
    assert outputs["port"]["0.txt"][0, 0] > 700
