"""SfM and preprocessing entry of the port, in the place of the
repository's ``run.py``: dispatches on ``cfg.type``.

    python -m onepose_tpu_torch.run +preprocess=sfm_spp_spg_demo
    python -m onepose_tpu_torch.run +preprocess=merge_anno split=train

``sfm`` builds each listed object's DB (``sfm/runner.py::run_sfm``) on
the device the config key ``device`` names (default ``cuda``; there is no
quiet CPU fallback), with SuperPoint and SuperGlue loaded from the
reference checkpoints the config names; ``n_devices=N`` spawns N ranks,
one card each, that extract and match data-parallel
(``parallel/launch.py::run_local``). ``merge_anno`` merges the objects'
annotation files into one training index.
"""
from __future__ import annotations

import os.path as osp
import sys


def _read_list(path):
    with open(path, "r") as f:
        return [line.strip() for line in f if line.strip()]


def sfm(cfg):
    import torch

    from onepose_tpu_torch.parallel import collectives as comm, launch

    n_dev = int(cfg.get("n_devices", 1) or 1)
    if n_dev > 1 and comm.get_world_size() == 1:
        launch.run_local(_sfm, n_dev, cfg,
                         device=torch.device(cfg.get("device", "cuda")).type)
    else:
        _sfm(cfg)


def _sfm(cfg):
    """``sfm`` on one rank of a world of one or more."""
    from onepose_tpu_torch.parallel import collectives as comm
    from onepose_tpu_torch.parallel import mesh as pmesh
    from onepose_tpu_torch.sfm import runner
    from onepose_tpu_torch.utils import model_io

    world = comm.get_world_size()
    mesh = pmesh.make_mesh(world) if world > 1 else None
    log = print if comm.is_main_process() else (lambda *a: None)
    sp_model = model_io.load_superpoint(cfg.network.detection_model_path)
    sg_model = model_io.load_superglue(cfg.network.matching_model_path)
    device = cfg.get("device", "cuda")

    for entry in _read_list(cfg.dataset.data_list):
        obj_dir, *seqs = entry.split(" ")
        root_dir = osp.join(cfg.scan_data_dir, obj_dir)
        data_dirs = [osp.join(root_dir, s) for s in seqs]
        log(f"[sfm] processing {root_dir}")

        img_lists = runner.gather_img_lists(
            data_dirs, down_ratio=cfg.sfm.down_ratio)
        if not img_lists:
            log(f"[sfm] no images in {root_dir}")
            continue
        Ks, poses, sizes = runner.load_sequence_calib(img_lists)

        obj_name = obj_dir.split("/")[-1]
        outputs_dir = osp.join(
            cfg.dataset.outputs_dir.format(obj_name),
            f"outputs_{cfg.network.detection}_{cfg.network.matching}")
        box_path = osp.join(root_dir, "box3d_corners.txt")
        stats = runner.run_sfm(
            img_lists, outputs_dir, sp_model, sg_model, Ks, poses, sizes,
            box_path=box_path if osp.exists(box_path) else None,
            covis_num=cfg.sfm.covis_num,
            max_num_points=cfg.dataset.max_num_kp3d, redo=cfg.redo,
            device=device, mesh=mesh)
        log(f"[sfm] {obj_name}: {stats}")


def merge_anno(cfg):
    from onepose_tpu_torch.datasets.merge import merge_anno as merge

    names_file = (cfg.train.names_file if cfg.split == "train"
                  else cfg.val.names_file)
    merge(cfg.datamodule.data_dir, _read_list(names_file),
          cfg.datamodule.out_path, detection=cfg.network.detection,
          matching=cfg.network.matching)


def main():
    from onepose_tpu_torch.config import load_config

    cfg = load_config(sys.argv[1:])
    {"sfm": sfm, "merge_anno": merge_anno}[cfg.type](cfg)


if __name__ == "__main__":
    main()
