"""The port's demo (onepose_tpu_torch/inference_demo.py) on the CPU.

1. The CLI's ``inference_core`` on a tiny world written directly (not
   through SfM): a capture of a textured plane (``plane_sequence``) with
   ``color_full`` frames, intrinsics and a 3D box; an SfM directory with
   the anno files and a COLMAP model naming three reference views;
   reference-layout .pth checkpoints of random weights at reduced depth
   (GATsSPG 1 block, SuperGlue 2 layers). The DB's points matched in frame
   0's crop are planted on the plane. It runs without tracking and with
   it and writes ``poses.json``, the rendered frames and the video; it
   runs against the root ``inference_demo.py`` on the same world, fed its
   RANSAC noise; bf16 raises.
2. The tracked path in memory, the CPU rehearsal of chip_smoke.py phase
   10b at a small size: plane frames through ``PosePipeline`` at batch 1
   and ``apply_tracking`` (``pose_frame``), the DB's points planted on the
   plane for frame 0's matches. Frame 0 is a PnP pose within 0.5 cm /
   0.5 deg of the truth (phase 8's bound) and seeds the keyframe; every
   later frame is tracked from LK flow. Their accuracy is not held here:
   random SuperPoint weights put most keypoints on the same pixels in
   every frame (chip_smoke.py phase 10b records the share), so the
   association step ties the planted points to keypoints that do not
   follow the plane. The tracker's accuracy is held with true keypoints
   in tests/test_torch_tracker.py.

Random GATsSPG weights score every 2D-3D pair far below the matcher's 0.2
threshold, so the CLI runs set it to 0 on both sides
(``no_match_threshold``).
"""
import json
import os.path as osp

import jax
import numpy as np
import pytest
import torch

from onepose_tpu.models import gats_spg as jgats
from onepose_tpu.utils import colmap_io as jcolmap
from onepose_tpu_torch import inference_demo, pipeline
from onepose_tpu_torch.config import Config
from onepose_tpu_torch.detector import LocalFeatureObjectDetector
from onepose_tpu_torch.models import convert, gats_spg as tgats
from onepose_tpu_torch.sfm.extract import CONFS, load_gray
from onepose_tpu_torch.utils import model_io
from onepose_tpu_torch.ops import epnp
from onepose_tpu_torch.tracker import BATracker, TrackNoise, draw_track_noise
from onepose_tpu_torch.datasets import anno
from onepose_tpu_torch.utils import geometry as geo
from onepose_tpu_torch.utils.synthetic import plane_sequence, plant_on_plane
from test_torch_detector import _view_noise
from test_torch_epnp import _jax_noise, _stack_noise
from test_torch_gats_spg import _reference_state_dict as gats_state_dict
from test_torch_superglue import _reference_state_dict as sg_state_dict

cv2 = pytest.importorskip("cv2")
N_FRAMES = 4
K_FULL = np.array([[200.0, 0, 80], [0, 200.0, 60], [0, 0, 1]])


def _config(d, cls=Config):
    return cls({k: _config(v, cls) if isinstance(v, dict) else v
                for k, v in d.items()})


def _no_match_threshold(mp):
    """Random GATsSPG weights score every 2D-3D pair far below the 0.2
    threshold, so both packages' matchers take every mutual best pair
    (chip_smoke.py's phases 8 and 10b do the same)."""
    mp.setitem(jgats.DEFAULT_CONFIG, "match_threshold", 0.0)
    mp.setitem(tgats.DEFAULT_CONFIG, "match_threshold", 0.0)


@pytest.fixture
def no_match_threshold(monkeypatch):
    _no_match_threshold(monkeypatch)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The capture is a textured plane (``plane_sequence``) seen by a
    moving camera, its 160x120 frames written as PNGs. The DB's points
    matched in frame 0's crop are planted on the plane under frame 0's
    pose, so frame 0 is a PnP pose and seeds the tracker's keyframe."""
    tmp = tmp_path_factory.mktemp("demo_world")
    rng = np.random.default_rng(0)
    obj = tmp / "data" / "0001-toy-box"
    seq = obj / "toy-1"
    (seq / "color_full").mkdir(parents=True)
    (seq / "intrinsics.txt").write_text(
        "fx: 200.0\nfy: 200.0\ncx: 80.0\ncy: 60.0\n")
    _, _, frames = plane_sequence(rng, N_FRAMES, hw=160, focal=200.0,
                                  n_points=8, slots=8, desc_dim=8,
                                  rot_step=(0.00375, 0.005625, 0.001875),
                                  trans_step=(0.00075, -0.000375))
    # the box: points on the plane seen at frame 0 at half-pixel corners
    # 0.5 px inside the frame, and 10 um above them, so that the crops
    # around its projection stay close to frame 0's crop (the whole
    # frame) and LK flow carries from crop to crop; half pixels keep the
    # crop's floor and ceil away from ties
    R, t = frames[0]["pose"][:, :3], frames[0]["pose"][:, 3]
    corners = np.array([[u, v, 1.0] for u in (0.5, 159.5)
                        for v in (0.5, 119.5)])
    dirs = corners @ np.linalg.inv(K_FULL).T @ R
    base = -R.T @ t - (-R.T @ t)[2] / dirs[:, 2:] * dirs
    np.savetxt(str(obj / "box3d_corners.txt"),
               np.concatenate([base, base + [0, 0, 1e-5]]))
    for i, fr in enumerate(frames):
        cv2.imwrite(str(seq / "color_full" / f"{i}.png"),
                    (fr["image"][20:140] * 255).round().astype(np.uint8))

    sfm = tmp / "sfm_model" / "0001-toy-box" / "outputs_superpoint_superglue"
    (sfm / "anno").mkdir(parents=True)
    n_pts = 40
    idxs = rng.integers(2, 6, n_pts)
    xyz = rng.uniform(-0.1, 0.1, (n_pts, 3))
    np.savez(str(sfm / "anno" / "anno_3d_average.npz"), keypoints3d=xyz,
             descriptors3d=rng.normal(size=(256, n_pts)).astype(np.float32),
             scores3d=rng.uniform(0, 1, (n_pts, 1)).astype(np.float32))
    # the DB's points are the collect file's (as the reference loads them)
    clt = {"descriptors3d": rng.normal(size=(256, int(idxs.sum()))).astype(
               np.float32),
           "scores3d": rng.uniform(0, 1, (int(idxs.sum()), 1)).astype(
               np.float32)}
    np.savez(str(sfm / "anno" / "anno_3d_collect.npz"), keypoints3d=xyz,
             **clt)
    np.save(str(sfm / "anno" / "idxs.npy"), idxs)
    views = []
    for i in range(3):
        views.append(str(tmp / f"view{i}.png"))
        cv2.imwrite(views[-1], rng.integers(0, 256, (96, 128), np.uint8))
    jcolmap.write_model(
        {1: jcolmap.Camera(1, "PINHOLE", 128, 96, np.ones(4))},
        {i + 1: jcolmap.Image(i + 1, np.zeros(4), np.zeros(3), 1, p,
                              np.zeros((0, 2)), np.zeros(0, np.int64))
         for i, p in enumerate(views)}, {}, str(sfm / "sfm_ws" / "model"))

    sp = convert.init_superpoint_params(rng)
    torch.save({f"{n}.{k}": torch.from_numpy(np.array(
        p["w"].transpose(3, 2, 0, 1) if k == "weight" else p["b"]))
        for n, p in sp.items() for k in ("weight", "bias")},
        tmp / "sp.pth")
    torch.save(gats_state_dict(convert.init_gats_spg_params(
        rng, {"num_blocks": 1})), tmp / "gats.ckpt")
    torch.save(sg_state_dict(convert.init_superglue_params(
        rng, {"num_gnn_layers": 2})), tmp / "sg.pth")

    # frame 0 as the demo sees it: the detector's crop (the whole frame:
    # random SuperGlue weights find no box) through the pipeline
    cfg = _cli_config(tmp)
    with pytest.MonkeyPatch.context() as mp:
        _no_match_threshold(mp)
        det = LocalFeatureObjectDetector(
            model_io.load_superpoint(str(tmp / "sp.pth")),
            model_io.load_superglue(str(tmp / "sg.pth")),
            [load_gray(p) for p in views], max_keypoints=64, device="cpu")
        res = det.detect(load_gray(str(seq / "color_full" / "0.png")),
                         K_FULL)
        sp_conf = dict(CONFS["superpoint"]["conf"], max_keypoints=64)
        db = anno.load_object_db(*(str(sfm / "anno" / n) for n in (
            "anno_3d_average.npz", "anno_3d_collect.npz", "idxs.npy")),
            num_leaf=cfg.num_leaf, shape3d=cfg.shape3d)
        out = pipeline.PosePipeline(
            model_io.load_superpoint(str(tmp / "sp.pth")),
            model_io.load_gats_spg(str(tmp / "gats.ckpt")), db,
            sp_config=sp_conf, device="cpu")(
                res.crop[None, :, :, None], res.K_crop[None])
    m0 = out.matches0[0].numpy()
    assert (m0 < n_pts).all() and (m0 >= 0).sum() >= 8
    np.savez(str(sfm / "anno" / "anno_3d_collect.npz"), **clt,
             keypoints3d=plant_on_plane(
                 db, m0, out.keypoints2d[0].numpy(), res.K_crop,
                 frames[0]["pose"]).keypoints3d[:n_pts])
    return tmp


def _cli_config(tmp, **extra):
    return _config(_cli_dict(tmp, **extra))


def _cli_dict(tmp, **extra):
    return {
        "type": "inference_demo", "num_leaf": 2, "n_ref_view": 3,
        "max_keypoints": 64, "shape3d": 64, "use_tracking": False,
        "device": "cpu", "data_root": str(tmp / "data" / "0001-toy-box"),
        "data_seq": "toy-1",
        "model": {"onepose_model_path": str(tmp / "gats.ckpt"),
                  "extractor_model_path": str(tmp / "sp.pth"),
                  "matching_model_path": str(tmp / "sg.pth")},
        "network": {"detection": "superpoint", "matching": "superglue"},
        "sfm_model_dir": str(tmp / "sfm_model"),
        "pnp": {"reproj_threshold": 5.0, "num_hypotheses": 32,
                "refine_iters": 2},
        "output": {"demo_dir": str(tmp / "demo_out")},
        **extra}


@pytest.mark.parametrize("use_tracking", [False, True])
def test_demo_cli(world, no_match_threshold, use_tracking):
    out = world / f"demo_{int(use_tracking)}"
    log = inference_demo.inference_core(_cli_config(
        world, use_tracking=use_tracking, output={"demo_dir": str(out)}))
    with open(out / "poses.json") as f:
        assert json.load(f) == log
    assert [e["frame"] for e in log] == [f"{i}.png" for i in range(N_FRAMES)]
    assert log[0]["source"] == "pnp" and log[0]["inliers"] >= 8
    for e in log[1:]:
        assert e["source"].startswith("track:") if use_tracking else (
            e["source"] == "pnp")
    for e in log:
        assert e["pose"] is None or np.isfinite(e["pose"]).all()
    rendered = sorted(p.name for p in (out / "frames").iterdir())
    assert rendered == [f"{i}.png" for i in range(N_FRAMES)]
    assert cv2.imread(str(out / "frames" / "0.png")).shape == (120, 160, 3)
    assert osp.getsize(out / "demo_video.mp4") > 0


def _jax_demo(world, cfg, monkeypatch):
    """The root script's ``inference_core`` on the world, fp32, its random
    keys recorded: (pose log, the pipeline's key a frame, the tracker's
    key and info of each tracked frame)."""
    from onepose_tpu import pipeline as jpipe, tracker as jtr
    from onepose_tpu.config import Config as JConfig
    from onepose_tpu.models import convert as jconvert
    from onepose_tpu.utils import model_io as jmodel_io
    import inference_demo as root_demo

    # the JAX loaders assume the reference's depths (4 blocks; 18 layers
    # and a 5-conv keypoint encoder)
    monkeypatch.setattr(jmodel_io, "load_gats_params", lambda p: (
        jconvert.gats_spg_from_state_dict(jconvert.load_state_dict(
            p, strip_prefixes=("matcher.",)), num_blocks=1)))
    monkeypatch.setattr(jmodel_io, "load_superglue_params", lambda p: (
        jconvert.superglue_from_state_dict(jconvert.load_state_dict(p),
                                           num_gnn_layers=2,
                                           num_kenc_convs=4)))
    pipe_keys, track_keys = [], {}
    pipe_call = jpipe.PosePipeline.__call__

    def pipe_and_record(self, images, Ks, keys=None):
        pipe_keys.append(keys[0])
        return pipe_call(self, images, Ks, keys)

    def key_of_frame(tracker):
        track_keys[len(pipe_keys) - 1] = jax.random.split(tracker.key)[1]

    monkeypatch.setattr(jpipe.PosePipeline, "__call__", pipe_and_record)
    infos = _record_track_infos(monkeypatch, jtr.BATracker, key_of_frame)
    root_demo.inference_core(_config(cfg, JConfig))
    with open(osp.join(cfg["output"]["demo_dir"], "poses.json")) as f:
        return json.load(f), pipe_keys, track_keys, infos


def _record_track_infos(monkeypatch, cls, before=None):
    """``cls.track`` patched to keep each call's info (without the port's
    step outputs), calling ``before(tracker)`` first when given."""
    infos, track = [], cls.track

    def track_and_record(self, *args, **kwargs):
        if before is not None:
            before(self)
        pose, info = track(self, *args, **kwargs)
        infos.append({k: v for k, v in info.items() if k != "step"})
        return pose, info

    monkeypatch.setattr(cls, "track", track_and_record)
    return infos


def _jax_track_noise(key, slots):
    """JAX's _track_step draws for ``key`` (flow PnP, association PnP at
    the tracker's 256 hypotheses), as the port's TrackNoise."""
    return TrackNoise(*(
        epnp.RansacNoise(*(torch.tensor(x)[None]
                           for x in _jax_noise(k, slots, 256)))
        for k in jax.random.split(key)))


def test_demo_matches_the_root_script(world, no_match_threshold,
                                      monkeypatch):
    """The port's demo against the root ``inference_demo.py`` with
    tracking, both fp32, the port fed the JAX run's RANSAC noise (the
    detector's, the pipeline's, the tracker's) from the same key splits.
    Frame 0 finds no box (random SuperGlue weights) and is a PnP pose on
    the planted DB (22 inliers); frame 1 crops around the box at frame 0's
    pose and finds 8 inliers, so frame 2 crops around it at frame 1's PnP
    pose (not its tracked pose); frame 2 finds 4, so frame 3 runs full
    detection again; frames 1-3 are tracked (flow, motion, motion).

    Per frame the sources and PnP inliers are equal, and so are the
    tracker's infos (mode, inlier counts, tracked points). The logged
    poses agree within 1e-5 per entry: measured 1.5e-8 on frame 0 (PnP)
    and 1.0e-7, 2.3e-7, 1.5e-6 on frames 1-3 (fp32 rounding: the same
    hypotheses and winners, the window BA's sums in another order). The
    camera moves slowly (about 0.4 deg a frame): random SuperPoint
    keypoints stay near their pixels, so frames 1 and 2 keep enough of
    frame 0's planted matches for a PnP consensus; faster, their RANSAC
    picks among random correspondences, whose near-equal scores flip
    between the two packages' roundings."""
    cfg = _cli_dict(world, use_tracking=True, stem_dtype="float32",
                    compute_dtype="float32")
    cfg["output"]["demo_dir"] = str(world / "demo_jax")
    ref, pipe_keys, track_keys, ref_infos = _jax_demo(world, cfg,
                                                      monkeypatch)

    detect = _view_noise(jax.random.PRNGKey(0), 3)   # detect()'s key=None
    noises = [inference_demo.DemoNoise(
        _stack_noise([_jax_noise(k, 64, 32)]),
        _jax_track_noise(track_keys[fi], 64) if fi in track_keys else None,
        detect) for fi, k in enumerate(pipe_keys)]
    cfg["output"]["demo_dir"] = str(world / "demo_port")
    infos = _record_track_infos(monkeypatch, BATracker)
    got = inference_demo.inference_core(_config(cfg), noises)

    assert [e["source"] for e in ref] == [
        "pnp", "track:flow", "track:motion", "track:motion"]
    assert [e["inliers"] for e in ref] == [22, 8, 4, 0]
    assert sorted(track_keys) == [1, 2, 3]
    assert infos == ref_infos
    for g, r in zip(got, ref):
        assert (g["frame"], g["source"], g["inliers"]) == (
            r["frame"], r["source"], r["inliers"])
        np.testing.assert_allclose(g["pose"], r["pose"], atol=1e-5,
                                   err_msg=g["frame"])


def test_demo_cli_refuses_bf16(world):
    """The demo computes SuperPoint in bf16 by default now; what it refuses
    is a dtype the port does not have."""
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        inference_demo.inference_core(_cli_config(
            world, stem_dtype="float16"))


def test_demo_defaults_to_the_card(world):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = _cli_config(world)
    del cfg["device"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference_demo.inference_core(cfg)


def test_tracked_path_in_memory():
    """Phase 10b's path at 128 px: PnP on frame 0 against the planted DB,
    then tracking from frame 0's keyframe."""
    rng = np.random.default_rng(1)
    kmat, _, frames = plane_sequence(rng, N_FRAMES, hw=128, focal=115.0,
                                     n_points=8, slots=8, desc_dim=8,
                                     rot_step=(0.01, 0.015, 0.005),
                                     trans_step=(0.002, -0.001))
    sp_model, gats_model = (
        convert.superpoint_from_jax(convert.init_superpoint_params(rng)),
        convert.gats_spg_from_jax(convert.init_gats_spg_params(
            rng, {"num_blocks": 1})))
    kw = dict(sp_config={"max_keypoints": 128},
              gats_config={"num_blocks": 1, "match_threshold": 0.0},
              num_hypotheses=64, refine_iters=5, device="cpu")
    idxs = rng.integers(2, 6, 120)
    db = anno.build_object_db(
        avg_keypoints3d=rng.uniform(-0.1, 0.1, (120, 3)).astype(np.float32),
        avg_descriptors3d=rng.normal(size=(256, 120)).astype(np.float32),
        avg_scores3d=rng.uniform(0, 1, (120, 1)).astype(np.float32),
        clt_descriptors=rng.normal(size=(256, int(idxs.sum()))).astype(
            np.float32),
        clt_scores=rng.uniform(0, 1, (int(idxs.sum()), 1)).astype(np.float32),
        idxs=idxs, num_leaf=2, shape3d=128)
    K32 = kmat.astype(np.float32)
    img0 = frames[0]["image"][None, :, :, None]
    probe = pipeline.PosePipeline(sp_model, gats_model, db, **kw)(
        img0, K32[None], generator=torch.Generator().manual_seed(0))
    m0 = probe.matches0[0].numpy()
    db = plant_on_plane(db, m0, probe.keypoints2d[0].numpy(), kmat,
                        frames[0]["pose"])
    pipe = pipeline.PosePipeline(sp_model, gats_model, db, **kw)
    tracker = BATracker(win_size=6, pnp_hypotheses=64, ba_iterations=6,
                        device="cpu")
    gen = torch.Generator().manual_seed(2)
    out = []
    for fi, fr in enumerate(frames):
        noise = inference_demo.DemoNoise(
            epnp.draw_noise(1, 128, 64, 64, gen),
            draw_track_noise(128, 128, 64, gen))
        out.append(inference_demo.pose_frame(
            pipe, tracker, db.keypoints3d, fr["image"], K32, fi,
            noise=noise))
    r_err, t_err = geo.query_pose_error(out[0].pose, frames[0]["pose"])
    assert out[0].success and out[0].inliers >= 20
    assert r_err < 0.5 and t_err < 0.5, (r_err, t_err)
    assert [o.source for o in out] == ["pnp"] + ["track:flow"] * (
        N_FRAMES - 1)
    assert all(np.isfinite(o.pose).all() for o in out)
    assert len(tracker.frames) == N_FRAMES
