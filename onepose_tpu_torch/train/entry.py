"""Train the GATsSPG matcher with the PyTorch port (the entry behind
``python -m onepose_tpu_torch.train``).

Counterpart of the repository's ``train.py`` (the reference's ``train.py``
and Lightning module): Adam with a multi-step LR, focal loss, gradient
clipping and accumulation (``train/trainer.py``), per-epoch validation
with pose metrics through ``PosePipeline`` (so the stem and match kernels
run on this entry's path), epoch checkpoints as torch files that
``utils/model_io.load_gats_spg`` reads, and resumption from the latest.

    python -m onepose_tpu_torch.train +experiment=train_GATsSPG
    python -m onepose_tpu_torch.train -m +experiment=train_GATsSPG \\
        model.lr=1e-3,5e-4 optimized_metric=train_loss

The config key ``device`` names the torch device (default ``cuda``; there
is no quiet CPU fallback: without a card it raises); ``device=cpu`` trains
on the CPU. One device only: ``parallel.n_devices`` above 1 raises.
"""
from __future__ import annotations

import functools
import os
import os.path as osp
import re
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

HOST_KEYS = ("descriptors2d_query", "descriptors3d_db", "descriptors2d_db",
             "conf_gt")


def _gats_config(cfg) -> dict:
    return {k: cfg.model[k] for k in (
        "descriptor_dim", "scale_factor", "match_threshold", "include_self",
        "additional", "with_linear_transform")}


def _device(cfg) -> torch.device:
    n_devices = cfg.get_path("parallel.n_devices")
    if n_devices is not None and int(n_devices) > 1:
        raise NotImplementedError(
            f"parallel.n_devices={n_devices}: the port trains on one device "
            "(multi-GPU training is ROADMAP Queue 1 item 4)")
    device = torch.device(cfg.get("device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: no CUDA device; pass device=cpu to train "
                           "on the CPU")
    return device


def train(cfg, model=None,
          leaf_uniform: Optional[Callable[[np.ndarray], np.ndarray]] = None):
    """Run training; returns (final ``TrainState``, callback_metrics).

    callback_metrics holds the last logged value of every metric
    (train_loss and the validation pose metrics), the role of Lightning's
    ``trainer.callback_metrics``. ``model`` is the matcher to start from
    (else one made from ``cfg.seed``); ``leaf_uniform`` maps a batch's leaf
    seeds to its [B, num_leaf, shape3d] uniforms (default
    ``trainer.leaf_uniforms``; the tests inject the JAX package's draws).
    """
    from onepose_tpu_torch.datasets.gats_dataset import GATsSPGDataset
    from onepose_tpu_torch.ops.precision import pin_fp32
    from onepose_tpu_torch.runtime.loader import DeviceStager, stage_ahead
    from onepose_tpu_torch.train import trainer
    from onepose_tpu_torch.train.logging import MetricLogger
    from onepose_tpu_torch.utils import model_io

    device = _device(cfg)
    pin_fp32()
    gats_cfg = _gats_config(cfg)
    dm = cfg.datamodule
    train_ds = GATsSPGDataset(
        dm.train_anno_file, num_leaf=dm.num_leaf, split="train",
        shape2d=dm.shape2d, shape3d=dm.shape3d, pad_val=dm.assign_pad_val,
        seed=cfg.seed)
    steps_per_epoch = max(len(train_ds) // dm.batch_size, 1)
    # milestones in micro-steps: with accumulation k the applied LR halves
    # k times later than the epochs say, as in the JAX package
    milestones = [m * steps_per_epoch for m in cfg.model.milestones]
    tx = trainer.make_optimizer(
        base_lr=float(cfg.model.lr),
        weight_decay=float(cfg.model.weight_decay),
        milestones_steps=milestones, gamma=cfg.model.gamma,
        grad_clip=cfg.trainer.gradient_clip_val,
        accumulate_steps=cfg.trainer.accumulate_grad_batches)
    state = trainer.init_train_state(tx, gats_cfg, model=model,
                                     seed=cfg.seed, device=device)

    start_epoch = 0
    latest = (model_io.latest_checkpoint(cfg.checkpoint.dirpath)
              if cfg.get("resume", True) else None)
    if latest is not None:
        model_io.load_train_state(latest, state)
        start_epoch = int(re.search(r"epoch=(\d+)",
                                    osp.basename(latest)).group(1)) + 1
        print(f"[train] resumed from {latest} (epoch {start_epoch})")

    os.makedirs(cfg.checkpoint.dirpath, exist_ok=True)
    logger = MetricLogger(
        cfg.logging.log_dir, wandb_project=cfg.logging.get("wandb_project"),
        wandb_config={"model": dict(cfg.model), "datamodule": dict(dm)})
    # the logged LR counts micro-steps, as the JAX entry logs it
    lr_sched = trainer.multistep_schedule(float(cfg.model.lr), milestones,
                                          cfg.model.gamma)
    watcher = None
    if cfg.logging.get("watch_model"):
        from onepose_tpu_torch.train.callbacks import ModelWatcher

        watcher = ModelWatcher(
            logger, log_freq=int(cfg.logging.get("watch_log_freq", 100)))

    # Device-resident input path (default): all objects' observation
    # descriptors upload once; a step ships the leaf uniforms (or indices),
    # the query descriptors and the sparse GT pairs, and the leaf gather
    # and dense conf_gt are made on the device.
    device_resident = bool(dm.get("device_resident", True))
    device_leaves = bool(dm.get("device_leaf_sampling", True))
    if device_resident:
        db_np, obj_index = train_ds.device_db()
        db_keys = ["clt_stack", "avg_stack"]
        if device_leaves:
            db_keys += ["count_stack", "offset_stack"]
        db = {k: torch.as_tensor(db_np[k], device=device) for k in db_keys}
        step_fn = trainer.make_gather_train_step(
            gats_cfg, db, dm.shape2d, dm.shape3d, dm.assign_pad_val,
            num_leaf=int(dm.num_leaf))
        print(f"[train] device-resident DB: "
              f"{db_np['clt_stack'].nbytes / 1e6:.0f} MB, "
              f"{len(obj_index)} objects")
    else:
        step_fn = trainer.make_train_step(gats_cfg)
    uniforms = leaf_uniform or functools.partial(
        trainer.leaf_uniforms, num_leaf=int(dm.num_leaf), shape3d=dm.shape3d)
    stager = DeviceStager(device)

    def stage(batch):
        """On the staging thread: seeds → uniforms, then the upload."""
        if "leaf_seed" in batch:
            batch = dict(batch)
            batch["leaf_uniform"] = uniforms(batch.pop("leaf_seed"))
        elif not device_resident:
            batch = {k: batch[k] for k in HOST_KEYS}
        return stager(batch)

    global_step = state.step
    callback_metrics = {}
    for epoch in range(start_epoch, cfg.trainer.max_epochs):
        t0 = time.time()
        losses = []
        if device_resident:
            batch_iter = train_ds.light_batches(
                obj_index, db_np["t_max"], dm.batch_size, shuffle=True,
                seed=cfg.seed + epoch, on_device_leaves=device_leaves)
        else:
            batch_iter = train_ds.batches(dm.batch_size, shuffle=True,
                                          seed=cfg.seed + epoch)
        for staged in stage_ahead(batch_iter, stage):
            state, loss = step_fn(state, staged.wait())
            global_step += 1
            if watcher is not None:
                watcher.step(global_step, state.model)
            if global_step % cfg.trainer.log_every_n_steps == 0:
                loss_val = float(loss)
                losses.append(loss_val)
                logger.log(global_step, {
                    "epoch": epoch, "train_loss": loss_val,
                    "lr": float(lr_sched(global_step))})
        epoch_loss = float(np.mean(losses)) if losses else float("nan")
        callback_metrics["train_loss"] = epoch_loss
        print(f"[train] epoch {epoch}: loss={epoch_loss:.4f} "
              f"({time.time() - t0:.1f}s, {global_step} steps)")

        ckpt_path = osp.join(cfg.checkpoint.dirpath, f"epoch={epoch}.ckpt")
        model_io.save_train_state(state, ckpt_path)
        logger.log_checkpoint(ckpt_path)
        model_io.save_gats_spg(state.model,
                               osp.join(cfg.checkpoint.dirpath, "last.ckpt"))

        val_metrics = validate(cfg, state.model, gats_cfg, epoch=epoch)
        if val_metrics:
            callback_metrics.update(val_metrics)
            logger.log(global_step, {"epoch": epoch, **val_metrics})
    logger.close()
    return state, callback_metrics


def validate(cfg, model, gats_cfg, epoch=0, n_plots=10, val_batch=8):
    """Validation with live SuperPoint extraction and PnP through
    ``PosePipeline`` (the reference's validation_step), f1 / precision /
    recall heatmaps of the matches, and reprojection match figures every
    ``len / n_plots`` items.

    Items are grouped by object, so each object's 3D DB is built once,
    and frames run in batches of ``val_batch`` (the last padded)."""
    from onepose_tpu_torch import pipeline
    from onepose_tpu_torch.datasets.anno import ObjectDB
    from onepose_tpu_torch.datasets.gats_dataset import GATsSPGDataset
    from onepose_tpu_torch.train.callbacks import (
        MATCH_CLASS_NAMES, ClassificationHeatmaps,
        match_classification_labels)
    from onepose_tpu_torch.utils import geometry as geo, model_io, vis_utils

    if not osp.exists(cfg.datamodule.val_anno_file):
        print("[val] no val annotations; skipping")
        return None
    try:
        sp_model = model_io.load_superpoint(cfg.model.spp_model_path)
    except FileNotFoundError:
        print("[val] no SuperPoint weights; skipping")
        return None
    device = _device(cfg)

    val_ds = GATsSPGDataset(
        cfg.datamodule.val_anno_file, num_leaf=cfg.datamodule.num_leaf,
        split="val", shape2d=cfg.datamodule.shape2d,
        shape3d=cfg.datamodule.shape3d, load_pose_gt=True, seed=cfg.seed)
    plot_interval = max(len(val_ds) // n_plots, 1)
    plot_dir = osp.join(cfg.logging.log_dir, "val_plots")

    # group items by object DB (the avg-anno path identifies the object)
    groups = {}
    for i, ann in enumerate(val_ds.items):
        groups.setdefault(ann["avg_anno3d_file"], []).append(i)

    heatmaps = ClassificationHeatmaps(MATCH_CLASS_NAMES)
    R_errs = np.full(len(val_ds), np.inf)
    t_errs = np.full(len(val_ds), np.inf)
    generator = torch.Generator(device=device).manual_seed(0)
    t0 = time.time()
    for anno_file in sorted(groups):
        idx_list = groups[anno_file]
        rng = np.random.default_rng(cfg.seed)
        kpts3d, avg_desc, leaf_desc, num3d = val_ds._read_anno3d(
            val_ds.items[idx_list[0]], rng)
        valid3d = np.arange(len(kpts3d)) < num3d
        db = ObjectDB(
            keypoints3d=kpts3d, descriptors3d=avg_desc,
            scores3d=np.zeros(len(kpts3d), np.float32),
            descriptors2d_db=leaf_desc,
            scores2d_db=np.zeros(len(leaf_desc), np.float32),
            mask3d=valid3d, num_leaf=cfg.datamodule.num_leaf,
            num_points=num3d)
        pipe = pipeline.PosePipeline(
            sp_model, model, db, gats_config=gats_cfg,
            sp_config={"max_keypoints": 1024}, device=device)

        for start in range(0, len(idx_list), val_batch):
            chunk = idx_list[start:start + val_batch]
            items = [val_ds.get_query(int(i)) for i in chunk]
            pad = val_batch - len(chunk)
            images = np.stack([it["image"] for it in items]
                              + [items[-1]["image"]] * pad)[..., None]
            Ks = np.stack([it["query_intrinsic"] for it in items]
                          + [items[-1]["query_intrinsic"]] * pad)
            out = pipe(images, Ks, generator=generator)
            succ = out.success.cpu().numpy()
            poses = out.poses.cpu().numpy()
            matches0 = out.matches0.cpu().numpy()
            kpt_mask = out.kpt_mask.cpu().numpy()
            keypoints = out.keypoints2d.cpu().numpy()
            for j, gi in enumerate(chunk):
                K, pose_gt = (items[j]["query_intrinsic"],
                              items[j]["query_pose_gt"])
                if succ[j]:
                    R_errs[gi], t_errs[gi] = geo.query_pose_error(
                        poses[j], pose_gt)
                # f1/confusion labels against the GT-pose reprojection
                gt_proj = geo.project_points(kpts3d, K, pose_gt)
                heatmaps.update(*match_classification_labels(
                    matches0[j], kpt_mask[j], keypoints[j], gt_proj,
                    valid3d))
                if gi % plot_interval == 0:
                    # matched 2D keypoints vs GT-reprojected 3D matches
                    valid = (matches0[j] >= 0) & kpt_mask[j]
                    if valid.sum() >= 1:
                        reproj = geo.project_points(
                            kpts3d[matches0[j][valid]], K, pose_gt)
                        vis_utils.draw_matches(
                            items[j]["image"], keypoints[j][valid],
                            items[j]["image"], reproj,
                            save_path=osp.join(
                                plot_dir, f"epoch{epoch}_item{gi}.png"))
    metrics = geo.aggregate_metrics(
        {"R_errs": list(R_errs), "t_errs": list(t_errs)})
    metrics.update(heatmaps.emit(epoch=epoch, plot_dir=plot_dir))
    print(f"[val] {metrics} ({time.time() - t0:.1f}s, "
          f"{len(val_ds)} items, {len(groups)} objects)")
    return metrics


def run_one(overrides):
    """One train run; returns the optimized metric (or None): the config's
    ``optimized_metric`` names a callback metric whose final value is
    returned (the reference's optuna return)."""
    from onepose_tpu_torch.config import load_config

    cfg = load_config(overrides)
    _, metrics = {"train": train}[cfg.type](cfg)
    name = cfg.get("optimized_metric")
    if name:
        if name not in metrics:
            raise KeyError(
                f"optimized_metric {name!r} not in callback metrics "
                f"{sorted(metrics)}")
        return metrics[name]
    return None


def main():
    """CLI. ``-m`` / ``--multirun`` sweeps comma-valued overrides (hydra's
    basic sweeper): each ``key=a,b,c`` becomes a sweep axis; runs the
    cartesian product and reports each run's and the best
    ``optimized_metric``."""
    args = sys.argv[1:]
    multirun = False
    if args and args[0] in ("-m", "--multirun"):
        multirun = True
        args = args[1:]

    if not multirun:
        metric = run_one(args)
        if metric is not None:
            print(f"[train] optimized_metric: {metric}")
        return metric

    from onepose_tpu_torch.config import expand_multirun

    combos = expand_multirun(args)
    results = []
    for i, combo in enumerate(combos):
        print(f"[multirun] job {i}/{len(combos)}: {' '.join(combo)}")
        results.append((combo, run_one(combo)))
    scored = [(c, m) for c, m in results if m is not None]
    for combo, metric in scored:
        print(f"[multirun] {' '.join(combo)} -> {metric}")
    if scored:
        # direction: optimize_direction=minimize override (losses), else max
        minimize = any(a.split("=", 1) == ["optimize_direction", "minimize"]
                       for a in args)
        pick = min if minimize else max
        best = pick(scored, key=lambda cm: cm[1])
        print(f"[multirun] best: {' '.join(best[0])} -> {best[1]}")
        return best[1]
    return None


if __name__ == "__main__":
    main()
