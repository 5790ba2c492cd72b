"""Demo video inference with the PyTorch port: full frames → detection →
pose → optional BA tracking → rendered 3D box.

Counterpart of the repository's ``inference_demo.py``. Frame 0, and every
frame after the PnP pose had fewer than 8 inliers, finds the object with
the feature-matching detector; the other frames crop around the 3D box
projected with the previous pose. Each 512x512 crop runs through
``PosePipeline`` at batch 1 (SuperPoint → GATsSPG → RANSAC-PnP); with
``use_tracking`` a keyframe BA tracker refines the trajectory. Every frame
is rendered with its estimated box, the poses go to ``poses.json`` and the
frames to ``demo_video.mp4``.

    python -m onepose_tpu_torch.inference_demo +experiment=test_demo \\
        data_root=<capture_root> data_seq=<seq>

The config key ``device`` names the torch device (default ``cuda``; there
is no quiet CPU fallback). SuperPoint defaults as in the root entry: a
bf16 direct stem and a bf16 encoder (``superpoint.entry_preset``);
``stem_dtype=float32`` selects the fp32 encoder and the stem kernel.
``detector_matcher=loftr`` detects with LoFTR (``model.loftr_model_path``)
in place of SuperGlue (``feature_matching_object_detector.make_detector``).
:func:`demo_frames` takes frames held in memory; the CLI reads the
sequence's PNGs.
"""
from __future__ import annotations

import glob
import json
import os.path as osp
import sys
from typing import Iterable, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from onepose_tpu_torch.ops import epnp
from onepose_tpu_torch.tracker import TrackNoise

MIN_INLIERS = 8        # below this the next frame runs full detection


class DemoNoise(NamedTuple):
    """Injected RANSAC noise of one frame: the pipeline's PnP (batch 1);
    when tracking, the tracker's (``tracker.TrackNoise``); when the frame
    runs full detection, the detector's similarity RANSAC
    ([n_views, 256, max_keypoints]; with LoFTR [n_views, 256, view
    cells])."""
    pose: epnp.RansacNoise
    track: Optional[TrackNoise] = None
    detect: Optional[torch.Tensor] = None


class DemoFrame(NamedTuple):
    source: str                    # "pnp" or "track:<mode>"
    inliers: int                   # PnP inliers of the crop
    success: bool                  # PnP succeeded
    pnp_pose: Optional[np.ndarray]   # [3, 4] PnP pose, None on failure
    pose: Optional[np.ndarray]       # [3, 4] final pose (tracked or PnP)


def apply_tracking(tracker, db_keypoints3d, crop, K_crop, out, fi, pose,
                   noise=None):
    """Per-frame BA-tracking control flow; returns ``(pose_final,
    source)``. The first frame seeds a keyframe and keeps the PnP pose;
    every later frame is tracked, and keyframes are refreshed every
    ``frame_interval`` frames, gated on pose jumps. Where the tracker
    fails, the PnP pose stands.

    ``out`` is a batch-1 :class:`onepose_tpu_torch.pipeline.PoseOutput`;
    ``noise`` the tracker's injected ``TrackNoise``, if any."""
    kpts = out.keypoints2d[0].cpu().numpy()
    descs = out.descriptors2d[0].cpu().numpy()
    kmask = out.kpt_mask[0].cpu().numpy()
    m0 = out.matches0[0].cpu().numpy()
    matched = np.where((m0 >= 0) & kmask)[0]

    def _add_kf():
        if pose is None or len(matched) < 8:
            return False
        return tracker.add_keyframe(
            crop, kpts, descs, kmask, pose, K_crop,
            mkpts3d=db_keypoints3d[m0[matched]], kpt_indices=matched)

    if not tracker.frames:
        _add_kf()
        return pose, "pnp"
    tracked, tinfo = tracker.track(crop, kpts, descs, kmask, K_crop,
                                   noise=noise)
    if fi % tracker.frame_interval == 0:
        _add_kf()
    if tracked is None:
        return pose, "pnp"
    return tracked, f"track:{tinfo['mode']}"


def pose_frame(pipe, tracker, db_keypoints3d, crop, K_crop, fi,
               generator: Optional[torch.Generator] = None,
               noise: Optional[DemoNoise] = None) -> DemoFrame:
    """One crop through ``pipe`` at batch 1, then the tracker when there
    is one. RANSAC's noise is ``noise`` when given, else drawn from
    ``generator`` (the pipeline's) and the tracker's own generator."""
    out = pipe(np.asarray(crop, np.float32)[None, :, :, None],
               np.asarray(K_crop, np.float32)[None], generator=generator,
               noise=None if noise is None else noise.pose)
    success = bool(out.success[0])
    n_inliers = int(out.num_inliers[0])
    pose = out.poses[0].cpu().numpy() if success else None
    pose_final, source = pose, "pnp"
    if tracker is not None:
        pose_final, source = apply_tracking(
            tracker, db_keypoints3d, crop, K_crop, out, fi, pose,
            None if noise is None else noise.track)
    return DemoFrame(source, n_inliers, success, pose, pose_final)


def demo_frames(frames: Iterable[np.ndarray], detector, pipe, tracker,
                K_full, box3d, db_keypoints3d,
                generator: Optional[torch.Generator] = None,
                noises: Optional[Iterable[DemoNoise]] = None
                ) -> Iterator[Tuple[object, DemoFrame]]:
    """Full grayscale frames ([H, W] float in [0, 1]) → per frame the
    detector's result (crop, K_crop, bbox) and the :class:`DemoFrame`.
    ``noises``, when given, holds every frame's :class:`DemoNoise`."""
    pose_prev = None
    noises = iter(noises) if noises is not None else None
    for fi, full in enumerate(frames):
        noise = next(noises) if noises is not None else None
        if pose_prev is None:
            res = detector.detect(full, K_full, noise=(
                None if noise is None else noise.detect))
        else:
            res = detector.previous_pose_detect(full, K_full, pose_prev,
                                                box3d)
        fr = pose_frame(pipe, tracker, db_keypoints3d, res.crop, res.K_crop,
                        fi, generator, noise)
        # weak PnP consensus: full detection on the next frame
        pose_prev = (fr.pnp_pose if fr.success and fr.inliers >= MIN_INLIERS
                     else None)
        yield res, fr


def inference_core(cfg, noises: Optional[Iterable[DemoNoise]] = None):
    """The demo over the configured sequence; returns the pose log that
    it writes to ``poses.json``. ``noises``, when given, holds every
    frame's injected :class:`DemoNoise` (else RANSAC draws from a
    generator seeded 12345, and the tracker's own)."""
    import cv2

    from onepose_tpu_torch import pipeline
    from onepose_tpu_torch.feature_matching_object_detector import (
        load_matcher, make_detector, sample_ref_views)
    from onepose_tpu_torch.inference import object_db
    from onepose_tpu_torch.models import superpoint
    from onepose_tpu_torch.sfm.extract import CONFS, load_gray
    from onepose_tpu_torch.tracker import BATracker
    from onepose_tpu_torch.utils import (geometry as geo, model_io,
                                         path_utils, vis_utils)

    gats_model = model_io.load_gats_spg(cfg.model.onepose_model_path)
    sp_model = model_io.load_superpoint(cfg.model.extractor_model_path)
    sg_model, loftr_model = load_matcher(cfg)

    data_root = cfg.data_root
    seq_dir = osp.join(data_root, cfg.data_seq)
    obj_name = data_root.rstrip("/").split("/")[-1]
    sfm_model_dir = osp.join(cfg.sfm_model_dir, obj_name)

    anno_dir = path_utils.get_anno_dir(
        sfm_model_dir, cfg.network.detection, cfg.network.matching)
    db = object_db(anno_dir, cfg.num_leaf, cfg.shape3d)
    box3d = np.loadtxt(path_utils.get_3d_box_path(data_root))
    K_full, _ = geo.get_K(path_utils.get_intrin_full_path(seq_dir))

    # the extract conf (nms_radius 3), as the reference's demo uses
    sp_conf = dict(CONFS[cfg.network.detection]["conf"])
    sp_conf["max_keypoints"] = cfg.max_keypoints
    sp_conf.update(superpoint.entry_preset(cfg))
    device = torch.device(cfg.get("device", "cuda"))
    pipe = pipeline.PosePipeline(
        sp_model, gats_model, db, sp_config=sp_conf,
        reproj_threshold=cfg.pnp.reproj_threshold,
        num_hypotheses=cfg.pnp.num_hypotheses,
        refine_iters=cfg.pnp.refine_iters, device=device)

    db_paths = sample_ref_views(
        sfm_model_dir, cfg.network.detection, cfg.network.matching,
        cfg.n_ref_view)
    det = make_detector(cfg, [load_gray(p) for p in db_paths], sp_model,
                        sg_model, loftr_model)
    tracker = BATracker(device=device) if cfg.use_tracking else None

    paths = sorted(
        glob.glob(osp.join(seq_dir, "color_full", "*.png")),
        key=lambda p: int(osp.splitext(osp.basename(p))[0]))
    generator = torch.Generator(device=device).manual_seed(12345)
    frame_dir = osp.join(cfg.output.demo_dir, "frames")
    pose_log = []
    results = demo_frames((load_gray(p) for p in paths), det, pipe, tracker,
                          K_full, box3d, np.asarray(db.keypoints3d),
                          generator, noises)
    for fi, (p, (_, fr)) in enumerate(zip(paths, results)):
        pose_log.append({
            "frame": osp.basename(p), "source": fr.source,
            "inliers": fr.inliers,
            "pose": None if fr.pose is None else fr.pose.tolist()})
        vis_utils.save_demo_image(
            fr.pose, K_full, cv2.imread(p), box3d,
            draw_box=fr.pose is not None,
            save_path=osp.join(frame_dir, osp.basename(p)))
        if fi % 20 == 0:
            print(f"[demo] frame {fi}/{len(paths)} inliers={fr.inliers} "
                  f"success={fr.success} source={fr.source}")

    with open(osp.join(cfg.output.demo_dir, "poses.json"), "w") as f:
        json.dump(pose_log, f)
    video = vis_utils.make_video(
        frame_dir, osp.join(cfg.output.demo_dir, "demo_video.mp4"))
    print(f"[demo] wrote {video}")
    return pose_log


def main(argv=None):
    from onepose_tpu_torch.config import load_config

    cfg = load_config(sys.argv[1:] if argv is None else argv)
    {"inference_demo": inference_core}[cfg.type](cfg)


if __name__ == "__main__":
    main()
