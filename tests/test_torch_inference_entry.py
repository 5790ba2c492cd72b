"""The port's eval entry (onepose_tpu_torch/inference.py) against the root
``inference.py`` on one tiny world, both in fp32, on the CPU.

The world is a textured plane (``plane_sequence``) filmed by a slowly
moving camera, four 128x128 frames written as PNGs with their
intrinsics and ground-truth poses; the object DB's points matched in
frame 0 are planted on the plane under frame 0's pose, so frame 0 is a
true PnP pose and the next frames, which keep most of frame 0's
keypoints, follow it. Both entries run ``inference_core`` with the same
weights (GATsSPG at 1 block, numpy-initialised and carried across by
``models/convert.py``) and a match threshold of 0 (random weights score
every pair far below 0.2). The port is fed the root script's RANSAC
noise, drawn from its key splits (a key a batch, one a frame).

Per frame the success flags are equal and the poses agree within 1e-5
per entry (fp32 rounding of the same hypotheses); cmd1/3/5 and the
written report are equal.
"""
import os.path as osp

import jax
import numpy as np
import pytest

from onepose_tpu import evaluators as jeval, pipeline as jpipe
from onepose_tpu.config import Config as JConfig
from onepose_tpu.models import gats_spg as jgats
from onepose_tpu_torch import evaluators as teval, inference, pipeline
from onepose_tpu_torch.config import Config
from onepose_tpu_torch.datasets import anno
from onepose_tpu_torch.models import convert, gats_spg as tgats
from onepose_tpu_torch.sfm.extract import CONFS, load_gray
from onepose_tpu_torch.utils.synthetic import plane_sequence, plant_on_plane
from test_torch_epnp import _jax_noise, _stack_noise

cv2 = pytest.importorskip("cv2")
N_FRAMES, HW, FOCAL, KPTS = 4, 128, 115.0, 64
PNP = {"reproj_threshold": 5.0, "num_hypotheses": 32, "refine_iters": 2}
POSE_TOL = 1e-5


def _config(d, cls):
    return cls({k: _config(v, cls) if isinstance(v, dict) else v
                for k, v in d.items()})


def _cfg(tmp, cls, **extra):
    return _config({
        "network": {"detection": "superpoint", "matching": "superglue"},
        "num_leaf": 2, "shape3d": 64, "max_keypoints": KPTS,
        "object_detect_mode": "GT_box", "batch_size": 2, "pnp": PNP,
        "stem_dtype": "float32", "compute_dtype": "float32",
        "output": {"eval_dir": str(tmp / "eval" / cls.__module__)},
        **extra}, cls)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval_world")
    rng = np.random.default_rng(0)
    obj = tmp / "data" / "0001-plane-box"
    seq = obj / "plane-1"
    for d in ("color", "intrin_ba", "poses_ba"):
        (seq / d).mkdir(parents=True)
    K, _, frames = plane_sequence(rng, N_FRAMES, hw=HW, focal=FOCAL,
                                  n_points=8, slots=8, desc_dim=8,
                                  rot_step=(0.00375, 0.005625, 0.001875),
                                  trans_step=(0.00075, -0.000375))
    for i, fr in enumerate(frames):
        cv2.imwrite(str(seq / "color" / f"{i}.png"),
                    (fr["image"] * 255).round().astype(np.uint8))
        np.savetxt(str(seq / "intrin_ba" / f"{i}.txt"), K)
        np.savetxt(str(seq / "poses_ba" / f"{i}.txt"),
                   np.vstack([fr["pose"], [0, 0, 0, 1]]))

    sp = convert.init_superpoint_params(rng)
    gats = convert.init_gats_spg_params(rng, {"num_blocks": 1})
    n_pts = 40
    idxs = rng.integers(2, 6, n_pts)
    db_files = dict(
        avg_keypoints3d=rng.uniform(-0.1, 0.1, (n_pts, 3)).astype(np.float32),
        avg_descriptors3d=rng.normal(size=(256, n_pts)).astype(np.float32),
        avg_scores3d=rng.uniform(0, 1, (n_pts, 1)).astype(np.float32),
        clt_descriptors=rng.normal(size=(256, int(idxs.sum()))).astype(
            np.float32),
        clt_scores=rng.uniform(0, 1, (int(idxs.sum()), 1)).astype(
            np.float32), idxs=idxs)
    cfg = _cfg(tmp, Config)
    db = anno.build_object_db(**db_files, num_leaf=cfg.num_leaf,
                              shape3d=cfg.shape3d)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tgats.DEFAULT_CONFIG, "match_threshold", 0.0)
        out = pipeline.PosePipeline(
            convert.superpoint_from_jax(sp), convert.gats_spg_from_jax(gats),
            db, sp_config=dict(CONFS["superpoint"]["conf"],
                               max_keypoints=KPTS), device="cpu")(
            load_gray(str(seq / "color" / "0.png"))[None, :, :, None],
            K[None].astype(np.float32))
    m0 = out.matches0[0].numpy()
    assert (m0 < n_pts).all() and (m0 >= 0).sum() >= 8
    planted = plant_on_plane(db, m0, out.keypoints2d[0].numpy(), K,
                             frames[0]["pose"]).keypoints3d[:n_pts]

    anno_dir = (tmp / "sfm_model" / "0001-plane-box"
                / "outputs_superpoint_superglue" / "anno")
    anno_dir.mkdir(parents=True)
    np.savez(str(anno_dir / "anno_3d_average.npz"), keypoints3d=planted,
             descriptors3d=db_files["avg_descriptors3d"],
             scores3d=db_files["avg_scores3d"])
    np.savez(str(anno_dir / "anno_3d_collect.npz"), keypoints3d=planted,
             descriptors3d=db_files["clt_descriptors"],
             scores3d=db_files["clt_scores"])
    np.save(str(anno_dir / "idxs.npy"), idxs)
    return tmp, sp, gats


def _record_evaluations(monkeypatch, cls):
    """``cls.evaluate`` patched to keep each frame's (pose or None, gt)."""
    seen, evaluate = [], cls.evaluate

    def evaluate_and_record(self, pose_pred, pose_gt):
        seen.append((pose_pred, pose_gt))
        return evaluate(self, pose_pred, pose_gt)

    monkeypatch.setattr(cls, "evaluate", evaluate_and_record)
    return seen


def _args(tmp):
    data_root = str(tmp / "data" / "0001-plane-box")
    return (data_root, osp.join(data_root, "plane-1"),
            str(tmp / "sfm_model" / "0001-plane-box"))


def test_eval_entry_matches_the_root_script(world, monkeypatch):
    import inference as root_inference

    tmp, sp, gats = world
    monkeypatch.setitem(jgats.DEFAULT_CONFIG, "match_threshold", 0.0)
    monkeypatch.setitem(tgats.DEFAULT_CONFIG, "match_threshold", 0.0)
    batch_keys, call = [], jpipe.PosePipeline.__call__

    def call_and_record(self, images, Ks, keys=None):
        batch_keys.append(keys)
        return call(self, images, Ks, keys)

    monkeypatch.setattr(jpipe.PosePipeline, "__call__", call_and_record)
    ref_frames = _record_evaluations(monkeypatch, jeval.Evaluator)
    ref = root_inference.inference_core(
        _cfg(tmp, JConfig), *_args(tmp), jax.tree.map(np.asarray, sp),
        jax.tree.map(np.asarray, gats))

    noises = [_stack_noise([_jax_noise(k, KPTS, PNP["num_hypotheses"])
                            for k in keys]) for keys in batch_keys]
    got_frames = _record_evaluations(monkeypatch, teval.Evaluator)
    got = inference.inference_core(
        _cfg(tmp, Config, device="cpu"), *_args(tmp),
        convert.superpoint_from_jax(sp), convert.gats_spg_from_jax(gats),
        noises=noises)

    assert len(batch_keys) == N_FRAMES // 2
    assert len(got_frames) == len(ref_frames) == N_FRAMES
    assert ref_frames[0][0] is not None        # frame 0: the planted pose
    for i, ((g, g_gt), (r, r_gt)) in enumerate(zip(got_frames, ref_frames)):
        np.testing.assert_array_equal(g_gt, r_gt)
        assert (g is None) == (r is None), i
        if r is not None:
            np.testing.assert_allclose(g, r, rtol=0, atol=POSE_TOL,
                                       err_msg=f"frame {i}")
    assert got == ref
    reports = [open(osp.join(str(tmp / "eval" / m), "0001-plane-boxplane-1"
                             ".txt")).read() for m in (Config.__module__,
                                                       JConfig.__module__)]
    assert reports[0] == reports[1]


def test_eval_entry_draws_noise_from_its_generator_without_it(world):
    """Without injected noise the entry seeds its own generator: two runs
    give the same cmd1/3/5."""
    tmp, sp, gats = world
    runs = [inference.inference_core(
        _cfg(tmp, Config, device="cpu"), *_args(tmp),
        convert.superpoint_from_jax(sp), convert.gats_spg_from_jax(gats))
        for _ in range(2)]
    assert runs[0] == runs[1] and set(runs[0]) == {"cmd1", "cmd3", "cmd5"}
