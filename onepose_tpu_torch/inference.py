"""Eval inference with the PyTorch port: frame→pose over test sequences,
with cmd1/3/5 metrics.

Counterpart of the repository's ``inference.py``. Per (object, sequence)
it loads the 3D descriptor DB and the models, runs every frame through
``PosePipeline`` in batches, evaluates against the ground-truth poses and
writes a report per sequence. The host-side pieces (config, DB loading,
image loading, prefetch, evaluation, paths, scene export) are the port's
own copies of the JAX package's host-only modules.

    python -m onepose_tpu_torch.inference +experiment=test_sample

The config key ``device`` names the torch device (default ``cuda``; there
is no quiet CPU fallback). SuperPoint defaults as in the root entry: a
bf16 direct stem and a bf16 encoder (``superpoint.entry_preset``);
``stem_dtype=float32`` selects the fp32 encoder and the stem kernel, and
``compute_dtype`` or ``stem`` may be set alone.

``n_devices=N`` runs every batch data-parallel over N ranks, one card
each (``parallel/launch.py::run_local``; N must divide ``batch_size``, as
in the root entry): each rank stages and runs its rows, the outputs are
all-gathered, and rank 0 evaluates every frame and writes the reports.
A loader thread reads the frames, and a staging thread uploads each
batch ahead of its step (``runtime/loader.py``), as the root entry's
loader starts each upload ahead.
"""
from __future__ import annotations

import glob
import os.path as osp
import sys
from typing import Iterable, Optional

import numpy as np
import torch

MAX_IN_FLIGHT = 4


def _read_list(path):
    with open(path, "r") as f:
        return [line.strip() for line in f if line.strip()]


def object_db(anno_dir: str, num_leaf: int, shape3d: int):
    """The object's DB from its anno files, padded to ``shape3d`` points,
    or, for an object of more points, to the next multiple of 8 above its
    count: the reference matches against all of an object's points, and
    the match kernel takes any N2. (The JAX package's entries refuse such
    an object: ``build_object_db`` raises.)"""
    from onepose_tpu_torch.datasets import anno

    idxs = osp.join(anno_dir, "idxs.npy")
    return anno.load_object_db(
        osp.join(anno_dir, "anno_3d_average.npz"),
        osp.join(anno_dir, "anno_3d_collect.npz"), idxs, num_leaf=num_leaf,
        shape3d=shape3d if len(np.load(idxs)) <= shape3d else None)


def inference_core(cfg, data_root, seq_dir, sfm_model_dir, sp_model,
                   gats_model, noises: Optional[Iterable] = None):
    """Every frame of ``seq_dir`` through ``PosePipeline`` in batches of
    ``cfg.batch_size``, evaluated against the ground truth → cmd1/3/5.
    ``noises``, when given, holds each batch's injected RANSAC noise
    (``epnp.RansacNoise``); else RANSAC draws from a generator seeded
    12345. ``cfg.n_devices`` above 1 spawns that many ranks unless this
    process is already one of a world; the result is rank 0's (None on the
    other ranks of a world)."""
    from onepose_tpu_torch.parallel import collectives as comm, launch

    n_dev = int(cfg.get("n_devices", 1) or 1)
    if n_dev > 1 and cfg.batch_size % n_dev:
        raise ValueError(f"batch_size {cfg.batch_size} not divisible by "
                         f"n_devices {n_dev}")
    if n_dev > 1 and comm.get_world_size() == 1:
        return launch.run_local(
            inference_core, n_dev, cfg, data_root, seq_dir, sfm_model_dir,
            sp_model, gats_model, None if noises is None else list(noises),
            device=torch.device(cfg.get("device", "cuda")).type)[0]
    return _core(cfg, seq_dir, sfm_model_dir, sp_model, gats_model, noises)


def _core(cfg, seq_dir, sfm_model_dir, sp_model, gats_model, noises):
    from onepose_tpu_torch import pipeline
    from onepose_tpu_torch.evaluators import Evaluator, record_eval_result
    from onepose_tpu_torch.models import superpoint
    from onepose_tpu_torch.parallel import collectives as comm
    from onepose_tpu_torch.parallel import mesh as pmesh
    from onepose_tpu_torch.runtime.loader import (DeviceStager,
                                                  PrefetchLoader, stage_ahead)
    from onepose_tpu_torch.sfm.extract import CONFS, load_gray
    from onepose_tpu_torch.utils import path_utils

    world = comm.get_world_size()
    mesh = pmesh.make_mesh(world) if world > 1 else None
    main = comm.is_main_process()
    anno_dir = path_utils.get_anno_dir(
        sfm_model_dir, cfg.network.detection, cfg.network.matching)
    db = object_db(anno_dir, cfg.num_leaf, cfg.shape3d)

    color_dir = ("color" if cfg.object_detect_mode == "GT_box"
                 else "color_det")
    img_lists = sorted(
        glob.glob(osp.join(seq_dir, color_dir, "*.png")),
        key=lambda p: int(osp.splitext(osp.basename(p))[0]))
    if not img_lists:
        if main:
            print(f"[inference] no frames in {seq_dir}/{color_dir}")
        return None

    # the extract conf (nms_radius 3), as the JAX entry and the reference
    # use, not the model's defaults; the static keypoint budget from cfg
    sp_conf = dict(CONFS[cfg.network.detection]["conf"])
    sp_conf["max_keypoints"] = cfg.max_keypoints
    sp_conf.update(superpoint.entry_preset(cfg))
    device = torch.device(cfg.get("device", "cuda"))
    pipe = pipeline.PosePipeline(
        sp_model, gats_model, db, sp_config=sp_conf,
        reproj_threshold=cfg.pnp.reproj_threshold,
        num_hypotheses=cfg.pnp.num_hypotheses,
        refine_iters=cfg.pnp.refine_iters, device=device, mesh=mesh)

    evaluator = Evaluator()
    bs = cfg.batch_size
    rows = pmesh.data_rows(mesh, bs)
    generator = torch.Generator(device=device).manual_seed(12345)
    noises = iter(noises) if noises is not None else None
    scene_poses = [] if cfg.get("save_wis3d", False) else None
    loader = PrefetchLoader(img_lists, lambda p: load_gray(p)[..., None],
                            batch_size=bs, depth=2)
    stager = DeviceStager(device)

    def stage(item):
        """On the staging thread: the batch's intrinsics and ground truth,
        then the upload of this rank's rows."""
        images, chunk, n_real = item
        Ks, gt_poses = [], []
        for p in chunk:
            Ks.append(np.loadtxt(path_utils.get_intrin_path_by_color(
                p, cfg.object_detect_mode)))
            gt_poses.append(np.loadtxt(path_utils.get_gt_pose_path_by_color(
                p, cfg.object_detect_mode)))
        while len(Ks) < bs:
            Ks.append(Ks[-1])
        Ks = np.stack(Ks).astype(np.float32)
        return stager({"images": images[rows], "Ks": Ks[rows]}), gt_poses, \
            n_real

    # keep a bounded window of batches in flight, draining the oldest
    pending = []

    def drain(item):
        out, gts, n = item
        poses = out.poses.cpu().numpy()
        success = out.success.cpu().numpy()
        for bi in range(n):
            evaluator.evaluate(poses[bi] if success[bi] else None, gts[bi])
            if scene_poses is not None and success[bi]:
                scene_poses.append(poses[bi])

    for staged, gt_poses, n_real in stage_ahead(iter(loader), stage):
        batch = staged.wait()
        out = pipe.run_rows(
            batch["images"], batch["Ks"], generator=generator,
            noise=next(noises) if noises is not None else None)
        if not main:   # rank 0 evaluates the whole batch
            continue
        pending.append((out, gt_poses, n_real))
        if len(pending) > MAX_IN_FLIGHT:
            drain(pending.pop(0))
    if not main:
        return None
    for item in pending:
        drain(item)

    eval_result = evaluator.summarize()
    obj_name = sfm_model_dir.rstrip("/").split("/")[-1]
    seq_name = seq_dir.rstrip("/").split("/")[-1]
    if scene_poses is not None:
        from onepose_tpu_torch.utils import vis_utils

        vis_dir = cfg.get_path("output.vis_dir") or cfg.output.eval_dir
        valid3d = np.asarray(db.mask3d, bool)
        vis_utils.export_scene_html(
            osp.join(vis_dir, f"{obj_name}_{seq_name}.html"),
            points3d=np.asarray(db.keypoints3d)[valid3d],
            poses=scene_poses, name=f"{obj_name}/{seq_name}")
    record_eval_result(cfg.output.eval_dir, obj_name, seq_name, eval_result)
    return eval_result


def inference(cfg):
    """Every listed (object, sequence); ``n_devices`` above 1 spawns that
    many ranks once for all of them, and the results are rank 0's."""
    from onepose_tpu_torch.parallel import collectives as comm, launch

    n_dev = int(cfg.get("n_devices", 1) or 1)
    if n_dev > 1 and cfg.batch_size % n_dev:
        raise ValueError(f"batch_size {cfg.batch_size} not divisible by "
                         f"n_devices {n_dev}")
    if n_dev > 1 and comm.get_world_size() == 1:
        return launch.run_local(
            _inference, n_dev, cfg,
            device=torch.device(cfg.get("device", "cuda")).type)[0]
    return _inference(cfg)


def _inference(cfg):
    from onepose_tpu_torch.parallel import collectives as comm
    from onepose_tpu_torch.utils import model_io

    log = print if comm.is_main_process() else (lambda *a: None)
    gats_model = model_io.load_gats_spg(cfg.model.onepose_model_path)
    sp_model = model_io.load_superpoint(cfg.model.extractor_model_path)

    results = {}
    for entry, sfm_name in zip(_read_list(cfg.input.data_list),
                               _read_list(cfg.input.sfm_list)):
        obj_dir, *seqs = entry.split(" ")
        data_root = osp.join(cfg.scan_data_dir, obj_dir)
        sfm_model_dir = osp.join(cfg.sfm_model_dir, sfm_name)
        for seq in seqs:
            seq_dir = osp.join(data_root, seq)
            log(f"[inference] eval {seq_dir}")
            res = inference_core(cfg, data_root, seq_dir, sfm_model_dir,
                                 sp_model, gats_model)
            if res is not None:
                results[f"{obj_dir}/{seq}"] = res
    if results:
        agg = {k: float(np.mean([r[k] for r in results.values()]))
               for k in next(iter(results.values()))}
        log(f"[inference] aggregate over {len(results)} seqs: {agg}")
    return results


def main():
    from onepose_tpu_torch.config import load_config

    cfg = load_config(sys.argv[1:])
    {"inference": inference}[cfg.type](cfg)


if __name__ == "__main__":
    main()
