"""Global bundle adjustment over a triangulated model, on one device.

Port of ``onepose_tpu/sfm/global_ba.py`` (in the reference's place of
``colmap bundle_adjuster``): the model's cameras and points go through
``ops/lm.py::solve_ba``, the damped Schur-complement LM, for a fixed
number of iterations with the intrinsics fixed. Observations beyond
``max_obs`` are subsampled evenly, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from onepose_tpu_torch import runtime
from onepose_tpu_torch.ops import lm
from onepose_tpu_torch.utils import colmap_io
from onepose_tpu_torch.utils.geometry import qvec2rotmat, rotmat2qvec


def run_bundle_adjuster(model_dir: str, output_dir: Optional[str] = None,
                        iterations: int = 20,
                        refine_extrinsics: bool = True,
                        refine_points: bool = True,
                        max_obs: int = 65536, device="cuda") -> dict:
    """Load a COLMAP-format model, bundle-adjust it on ``device``, write
    it back (to ``output_dir`` when given) → initial and final cost."""
    from onepose_tpu_torch.ops.precision import pin_fp32

    device = runtime.resolve_device(device, "run_bundle_adjuster")
    pin_fp32()
    cameras, images, points3D = colmap_io.read_model(model_dir)
    if not points3D:
        return {"final_cost": 0.0, "initial_cost": 0.0}

    image_ids = sorted(images.keys())
    cam_slot = {iid: i for i, iid in enumerate(image_ids)}
    point_ids = sorted(points3D.keys())
    pt_slot = {pid: i for i, pid in enumerate(point_ids)}

    poses, Kparams = [], {}
    for iid in image_ids:
        im = images[iid]
        poses.append(np.concatenate(
            [qvec2rotmat(im.qvec), np.asarray(im.tvec)[:, None]], axis=1))
        cam = cameras[im.camera_id]
        if cam.model == "PINHOLE":
            fx, fy, cx, cy = cam.params
        elif cam.model == "SIMPLE_PINHOLE":
            fx = fy = cam.params[0]
            cx, cy = cam.params[1:3]
        else:
            raise NotImplementedError(cam.model)
        Kparams[iid] = [fx, fy, cx, cy]

    obs_cam, obs_pt, obs_uv, obs_K = [], [], [], []
    for pid in point_ids:
        pt = points3D[pid]
        for iid, ki in zip(pt.image_ids, pt.point2D_idxs):
            obs_cam.append(cam_slot[int(iid)])
            obs_pt.append(pt_slot[pid])
            obs_uv.append(images[int(iid)].xys[int(ki)])
            obs_K.append(Kparams[int(iid)])
    O = len(obs_cam)
    keep = (np.linspace(0, O - 1, max_obs).astype(int)
            if O > max_obs else np.arange(O))

    def put(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    problem = lm.BAProblem(
        cameras=lm.pose_to_camera(put(np.stack(poses))),
        points=put(np.stack([points3D[p].xyz for p in point_ids])),
        cam_idx=put(np.asarray(obs_cam)[keep], torch.long),
        pt_idx=put(np.asarray(obs_pt)[keep], torch.long),
        uv=put(np.asarray(obs_uv)[keep]),
        K=put(np.asarray(obs_K)[keep]),
        mask=torch.ones(len(keep), dtype=torch.bool, device=device))

    res = lm.solve_ba(problem, iterations=iterations,
                      fix_cameras=not refine_extrinsics,
                      fix_points=not refine_points)

    poses_new = lm.camera_to_pose(res.cameras).cpu().numpy()
    pts_new = res.points.cpu().numpy()
    for i, iid in enumerate(image_ids):
        images[iid].qvec = rotmat2qvec(poses_new[i, :, :3])
        images[iid].tvec = poses_new[i, :, 3].astype(np.float64)
    for pid in point_ids:
        points3D[pid].xyz = pts_new[pt_slot[pid]].astype(np.float64)

    colmap_io.write_model(cameras, images, points3D,
                          output_dir or model_dir)
    return {"initial_cost": float(res.initial_cost),
            "final_cost": float(res.final_cost)}
