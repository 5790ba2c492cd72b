"""SfM orchestration for the port, the ``run.py sfm`` path: extract →
covisible pairs → match → verify → database → triangulate → postprocess,
with file-granular resumability (outputs that exist are reused unless
``redo``).

Port of ``onepose_tpu/sfm/runner.py``; the device stages run on the card
unless the caller names another device. With ``mesh=`` extraction and
matching run data-parallel over the mesh's ranks; the host stages run on
rank 0 while the others wait, and the outputs directory must be one that
every rank sees.
"""
from __future__ import annotations

import glob
import os
import os.path as osp
from typing import Dict, Optional, Sequence

import numpy as np

from onepose_tpu_torch import runtime
from onepose_tpu_torch.sfm import extract, match, pairs as pairs_mod, \
    postprocess, triangulate
from onepose_tpu_torch.utils import path_utils


def sfm_outputs_layout(outputs_dir: str, covis_num: int = 10):
    return {
        "feature_out": osp.join(outputs_dir, "feats-superpoint.h5"),
        "covis_pairs_out": osp.join(
            outputs_dir, f"pairs-covis{covis_num}.txt"),
        "matches_out": osp.join(outputs_dir, "matches-superglue.h5"),
        "empty_dir": osp.join(outputs_dir, "sfm_empty"),
        "deep_sfm_dir": osp.join(outputs_dir, "sfm_ws"),
        "model_dir": osp.join(outputs_dir, "sfm_ws", "model"),
        "anno_dir": osp.join(outputs_dir, "anno"),
    }


def gather_img_lists(data_dirs: Sequence[str], down_ratio: int = 5):
    """Glob color/*.png under each sequence dir, downsampled by index
    (reference run.py:91-101)."""
    img_lists = []
    for seq_dir in data_dirs:
        imgs = glob.glob(osp.join(seq_dir, "color", "*.png"))
        down = [
            p for p in imgs
            if int(osp.splitext(osp.basename(p))[0]) % down_ratio == 0
        ]
        img_lists += down
    return sorted(img_lists)


def load_sequence_calib(img_lists: Sequence[str]):
    """Per-image K / pose / size from the dataset layout."""
    import cv2

    Ks: Dict[str, np.ndarray] = {}
    poses: Dict[str, np.ndarray] = {}
    sizes: Dict[str, tuple] = {}
    for p in img_lists:
        K_path = path_utils.get_intrin_path_by_color(p)
        Ks[p] = np.loadtxt(K_path)
        poses[p] = np.loadtxt(path_utils.get_gt_pose_path_by_color(p))
        img = cv2.imread(p, cv2.IMREAD_GRAYSCALE)
        sizes[p] = (img.shape[1], img.shape[0])
    return Ks, poses, sizes


def run_sfm(img_lists: Sequence[str], outputs_dir: str, sp_model,
            sg_model, Ks: Dict[str, np.ndarray],
            poses: Dict[str, np.ndarray], sizes: Dict[str, tuple],
            box_path: Optional[str] = None, covis_num: int = 10,
            max_num_points: int = 2500, redo: bool = False,
            images: Optional[Dict[str, np.ndarray]] = None,
            device="cuda", mesh=None, mark=None) -> dict:
    """End-to-end SfM for one object on ``device``, with ``sp_model`` (a
    ``SuperPoint``) and ``sg_model`` (a ``SuperGlue``). Ks/poses/sizes are
    keyed by image path; ``images`` optionally supplies in-memory
    grayscale arrays. An output file that exists is reused unless
    ``redo``. ``mesh``: extraction and matching split over its data axis
    (collective: every rank calls this); the stats on rank 0, None on the
    others. ``mark``, when given, is called with each stage's name as it
    ends."""
    import torch

    from onepose_tpu_torch.parallel import collectives as comm

    device = runtime.resolve_device(device, "run_sfm")
    mark = mark or (lambda name: None)
    main = comm.is_main_process()
    if main:
        os.makedirs(outputs_dir, exist_ok=True)
    lay = sfm_outputs_layout(outputs_dir, covis_num)

    def todo(path) -> bool:
        """Rank 0's decision to (re)make ``path``, for every rank."""
        flag = torch.tensor([redo or not osp.exists(path)])
        return bool(comm.broadcast(flag.to(comm.comm_device()), 0))

    if todo(lay["feature_out"]):
        extract.extract_to_h5(sp_model, img_lists, lay["feature_out"],
                              images=images, device=device, mesh=mesh)
    mark("extract")

    if main and (redo or not osp.exists(lay["covis_pairs_out"])):
        Rs = np.stack([np.asarray(poses[p])[:3, :3] for p in img_lists])
        ts = np.stack([np.asarray(poses[p])[:3, 3] for p in img_lists])
        pair_list = pairs_mod.covis_pairs(
            img_lists, num_matched=covis_num, poses=(Rs, ts))
        pairs_mod.write_pairs(pair_list, lay["covis_pairs_out"])
    comm.synchronize()
    pair_list = pairs_mod.read_pairs(lay["covis_pairs_out"])
    mark("pairs")

    if todo(lay["matches_out"]):
        match.match_pairs_to_h5(
            sg_model, pair_list, lay["feature_out"], lay["matches_out"],
            device=device, mesh=mesh)
    mark("match")
    if not main:   # the host stages run on rank 0
        comm.synchronize()
        return None
    stats = _host_stages(img_lists, lay, pair_list, Ks, poses, sizes,
                         box_path, max_num_points, redo, device, mark)
    comm.synchronize()
    return stats


def _host_stages(img_lists, lay, pair_list, Ks, poses, sizes, box_path,
                 max_num_points, redo, device, mark) -> dict:
    """The stages after matching: the empty model, verification, the
    database, triangulation and postprocess."""
    # posed-but-pointless model (reference generate_empty.py artifact)
    if redo or not osp.exists(lay["empty_dir"]):
        from onepose_tpu_torch.utils import colmap_io

        cameras, images_m = triangulate.build_empty_model(
            img_lists, Ks, poses, sizes)
        colmap_io.write_model(cameras, images_m, {}, lay["empty_dir"])

    # One epipolar-verification pass shared by the database export and the
    # triangulation stage.
    verification = triangulate.verify_matches(
        lay["feature_out"], lay["matches_out"], pair_list, Ks, poses,
        device=device)
    mark("verify")

    # COLMAP-consumable database (interchange only; not on the compute
    # path) with verified two_view_geometries rows (F/E/relative pose).
    db_path = osp.join(lay["deep_sfm_dir"], "database.db")
    if redo or not osp.exists(db_path):
        from onepose_tpu_torch.utils.colmap_db import export_database

        os.makedirs(lay["deep_sfm_dir"], exist_ok=True)
        # a redo starts a new database: the export inserts rows by id
        # and refuses ids that exist
        if osp.exists(db_path):
            os.remove(db_path)
        export_database(lay["feature_out"], lay["matches_out"], pair_list,
                        Ks, sizes, verification[2], db_path)

    stats = triangulate.triangulate_from_h5(
        lay["feature_out"], lay["matches_out"], pair_list, Ks, poses,
        sizes, lay["model_dir"], verification=verification, device=device)
    mark("triangulate")

    pp_stats = postprocess.postprocess(
        lay["model_dir"], lay["feature_out"], img_lists, lay["anno_dir"],
        box_path=box_path, max_num_points=max_num_points)
    mark("postprocess")
    return {**stats, **pp_stats}
