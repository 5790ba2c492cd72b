"""Synthetic scenes with known poses, for running and checking the port
without a dataset, in numpy and torch (cv2 only to write a video): a
textured plane filmed by a moving camera, in the role of
``scripts/bench_tracker.py::make_sequence``, or from an arc of a ring
(SfM's capture), or as a raw OnePose Cap capture (the demo chain's
input); the planting of an object DB's points on that plane; SfM's
feature and match files at a known cloud seen from a ring; object DBs
of random features and the intrinsics the scenes share; and the
entries' three checkpoint files.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.nn.functional as F

from onepose_tpu_torch.datasets import anno
from onepose_tpu_torch.utils import geometry as geo


def pinhole(hw, focal=460.0):
    """The synthetic worlds' intrinsics: ``focal`` px, the principal point
    at the centre of an hw x hw image. → [3, 3] float64."""
    return np.array([[focal, 0, hw / 2], [0, focal, hw / 2], [0, 0, 1]])


def random_db(rng, points, shape3d, leaf, obs=(2, 10)):
    """An object DB of random features from ``rng``: ``points`` 3D points
    in a 0.2 m cube, each seen obs[0] to obs[1] - 1 times, in a DB of
    ``shape3d`` slots and ``leaf`` leaves a point."""
    idxs = rng.integers(obs[0], obs[1], points)
    total = int(idxs.sum())
    return anno.build_object_db(
        avg_keypoints3d=rng.uniform(-0.1, 0.1, (points, 3)).astype(np.float32),
        avg_descriptors3d=rng.normal(size=(256, points)).astype(np.float32),
        avg_scores3d=rng.uniform(0, 1, (points, 1)).astype(np.float32),
        clt_descriptors=rng.normal(size=(256, total)).astype(np.float32),
        clt_scores=rng.uniform(0, 1, (total, 1)).astype(np.float32),
        idxs=idxs, num_leaf=leaf, shape3d=shape3d)


def plane_sequence(rng, n_frames, hw=512, focal=460.0, n_points=400,
                   slots=1024, desc_dim=256, rot0=0.25,
                   rot_step=(0.02, 0.03, 0.01),
                   trans_step=(0.004, -0.002)):
    """A textured plane (z = 0 in the object frame, 0.4 m square) under a
    moving camera 0.5 m away, with known poses: a 80x80 random texture
    upsampled bicubically to 640x640, each frame the exact homography warp
    of it (``grid_sample``, bilinear, black outside).
    Keypoints are ``n_points`` projected plane points (0.3 px noise) with
    stable descriptors (noise 0.02), padded with masked slots to
    ``slots``. → (K [3, 3], pts3d [n_points, 3], frames: dicts of image
    [hw, hw] float32 in [0, 1], pose [3, 4], keypoints [slots, 2],
    descriptors [slots, desc_dim], mask [slots])."""
    K = pinhole(hw, focal)
    render = plane_renderer(rng, K, hw)
    pts3d = np.concatenate([rng.uniform(-0.15, 0.15, (n_points, 2)),
                            np.zeros((n_points, 1))], axis=1)
    descs = rng.normal(size=(n_points, desc_dim)).astype(np.float32)

    frames = []
    for i in range(n_frames):
        R = geo.rodrigues([rot0 + rot_step[0] * i, rot_step[1] * i,
                           rot_step[2] * i])
        t = np.array([trans_step[0] * i, trans_step[1] * i, 0.5])
        pose = np.concatenate([R, t[:, None]], axis=1)
        img = render(pose)
        uv = geo.project_points(pts3d, K, pose)
        kp = np.zeros((slots, 2), np.float32)
        ds = np.zeros((slots, desc_dim), np.float32)
        mask = np.zeros(slots, bool)
        kp[:n_points] = uv + rng.normal(size=uv.shape) * 0.3
        ds[:n_points] = descs + 0.02 * rng.normal(size=descs.shape)
        mask[:n_points] = True
        frames.append({"image": img,
                       "pose": pose, "keypoints": kp, "descriptors": ds,
                       "mask": mask})
    return K, pts3d, frames


def plane_renderer(rng, K, hw):
    """A textured plane (z = 0 in the object frame, 0.4 m square centred
    on the origin: a 80x80 random texture upsampled bicubically to
    640x640) and its renderer: pose [3, 4] → the exact homography warp of
    the texture into a [hw, hw] float32 image in [0, 1] (``grid_sample``,
    bilinear, black outside)."""
    tex_res = 640
    cells = torch.from_numpy(rng.uniform(0, 1, (1, 1, 80, 80)))
    tex = F.interpolate(cells, size=(tex_res, tex_res), mode="bicubic",
                        align_corners=False).clamp(0, 1)
    scale = tex_res / 0.4                       # texture px a metre
    T_plane = np.array([[scale, 0, 0.2 * scale], [0, scale, 0.2 * scale],
                        [0, 0, 1]])
    ys, xs = np.mgrid[0:hw, 0:hw].astype(np.float64)
    pix = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3)

    def render(pose):
        R, t = pose[:, :3], pose[:, 3]
        H = K @ np.stack([R[:, 0], R[:, 1], t], axis=1) @ np.linalg.inv(
            T_plane)                            # texture px → image px
        src = pix @ np.linalg.inv(H).T
        src = src[:, :2] / src[:, 2:3]
        grid = torch.from_numpy((2 * src + 1) / tex_res - 1).reshape(
            1, hw, hw, 2)
        return F.grid_sample(tex, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=False)[0, 0].numpy().astype(
                                 np.float32)

    return render


def ring_views(rng, n_views, hw=512, focal=460.0, arc_deg=120.0,
               dist=0.5, elevation_deg=10.0):
    """SfM's capture: the textured plane of :func:`plane_renderer` seen
    from ``n_views`` known poses along an arc of ``arc_deg`` of a ring
    around it (``dist`` from its centre, ``elevation_deg`` above its
    horizontal axis, looking at the centre, the plane's y axis up).
    → (K [3, 3], poses [n_views, 3, 4] world→camera, images
    [n_views, hw, hw] float32 in [0, 1])."""
    K = pinhole(hw, focal)
    render = plane_renderer(rng, K, hw)
    poses = arc_poses(n_views, arc_deg, dist, elevation_deg)
    return K, poses, np.stack([render(pose) for pose in poses])


def arc_poses(n_views, arc_deg, dist, elevation_deg, az0_deg=0.0):
    """[n_views, 3, 4] world→camera poses along an arc of ``arc_deg``
    centred on azimuth ``az0_deg`` of a ring around the plane z = 0
    (:func:`ring_views`' geometry)."""
    el = np.deg2rad(elevation_deg)
    poses = []
    for az in np.deg2rad(az0_deg + np.linspace(-arc_deg / 2, arc_deg / 2,
                                               n_views)):
        c = dist * np.array([np.sin(az) * np.cos(el), np.sin(el),
                             np.cos(az) * np.cos(el)])
        z = -c / np.linalg.norm(c)
        x = np.cross(z, [0.0, 1.0, 0.0])
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        poses.append(np.concatenate([R, (-R @ c)[:, None]], axis=1))
    return np.stack(poses)


def raw_capture(obj_dir, obj_name, rng, n_annotate=40, n_test=8, hw=512,
                focal=460.0):
    """A OnePose Cap capture of the textured plane (0.4 m square, its box
    0.02 m deep at the ARKit world's origin) under ``obj_dir``:
    ``<obj_name>-annotate`` (``n_annotate`` views along a 60 degree arc)
    and ``<obj_name>-test`` (``n_test`` views along a 30 degree arc
    between them), each with Frames.m4v (8-bit gray as BGR, mp4v, through
    cv2), Frames.txt and ARposes.txt, and Box.txt in the annotate one.
    ARposes hold the camera in the world with ARKit's axis flip, as
    ``parse_scanned_data`` reads them. → {sequence: (poses [n, 3, 4],
    frames [n, hw, hw] float32)}, the frames before encoding."""
    import cv2

    K = pinhole(hw, focal)
    render = plane_renderer(rng, K, hw)
    out = {}
    for seq, poses in ((f"{obj_name}-annotate", arc_poses(
            n_annotate, 60.0, 0.5, 10.0)), (f"{obj_name}-test", arc_poses(
                n_test, 30.0, 0.5, 20.0, az0_deg=5.0))):
        d = os.path.join(obj_dir, seq)
        os.makedirs(d, exist_ok=True)
        frames = np.stack([render(pose) for pose in poses])
        with open(os.path.join(d, "Frames.txt"), "w") as f:
            for i in range(len(poses)):
                f.write(f"{i / 30},{i},{focal},{focal},{hw / 2},{hw / 2}\n")
        lines = ["# ts,px,py,pz,qw,qx,qy,qz"]
        for i, pose in enumerate(poses):
            T_oc = np.vstack([pose, [0, 0, 0, 1]])
            T_cw = np.linalg.inv(T_oc)
            q = geo.rotmat2qvec(T_cw[:3, :3] @ np.diag([1.0, -1.0, -1.0]))
            lines.append(f"{i / 30}," + ",".join(
                str(v) for v in (*T_cw[:3, 3], *q)))
        with open(os.path.join(d, "ARposes.txt"), "w") as f:
            f.write("\n".join(lines))
        if seq.endswith("-annotate"):
            with open(os.path.join(d, "Box.txt"), "w") as f:
                f.write("# px,py,pz,ex,ey,ez,qw,qx,qy,qz\n"
                        "0,0,0,0.4,0.4,0.02,1,0,0,0\n")
        writer = cv2.VideoWriter(os.path.join(d, "Frames.m4v"),
                                 cv2.VideoWriter_fourcc(*"mp4v"), 30,
                                 (hw, hw))
        for img in frames:
            gray = np.round(img * 255).astype(np.uint8)
            writer.write(cv2.cvtColor(gray, cv2.COLOR_GRAY2BGR))
        writer.release()
        out[seq] = (poses, frames)
    return out


def write_checkpoints(data_dir, sp_model, sg_params, gats_model):
    """The three weights the entries load, in the reference's files under
    ``data_dir/models``: SuperPoint's ``superpoint_v1.pth``, SuperGlue's
    ``superglue_outdoor.pth`` (from JAX-layout ``sg_params``) and
    GATsSPG's ``GATsSPG.ckpt``."""
    from onepose_tpu_torch.models import convert
    from onepose_tpu_torch.utils import model_io

    models = os.path.join(data_dir, "models")
    for sub in ("extractors/SuperPoint", "matchers/SuperGlue",
                "checkpoints/onepose"):
        os.makedirs(os.path.join(models, sub), exist_ok=True)
    torch.save(sp_model.state_dict(), os.path.join(
        models, "extractors", "SuperPoint", "superpoint_v1.pth"))
    torch.save(convert.superglue_to_state_dict(sg_params), os.path.join(
        models, "matchers", "SuperGlue", "superglue_outdoor.pth"))
    model_io.save_gats_spg(gats_model, os.path.join(
        models, "checkpoints", "onepose", "GATsSPG.ckpt"))


def plant_on_plane(db, matches0, keypoints2d, kmat, pose):
    """A copy of ``db`` whose 3D points matched by one frame's keypoints
    are those keypoints' rays intersected with the plane z = 0 under the
    frame's pose (``plane_sequence``'s object). Matching reads descriptors
    only, so the frame's matches stay and are now consistent with the
    pose, and LK flow from the frame is consistent with them later."""
    kpts3d = db.keypoints3d.copy()
    R, t = pose[:, :3], pose[:, 3]
    center = -R.T @ t
    m0 = np.asarray(matches0)
    rays = np.concatenate([np.asarray(keypoints2d, np.float64),
                           np.ones((len(m0), 1))], 1) @ np.linalg.inv(kmat).T
    dirs = rays @ R                                   # R^T ray, row-wise
    for k in np.flatnonzero(m0 >= 0):
        kpts3d[m0[k]] = center - center[2] / dirs[k, 2] * dirs[k]
    return dataclasses.replace(db, keypoints3d=kpts3d.astype(np.float32))


def ring_pose(theta, height, radius=0.6):
    """World→camera pose of a camera ``radius`` from the z axis at angle
    ``theta`` and ``height``, looking at the origin, z up."""
    center = np.array([radius * np.cos(theta), radius * np.sin(theta),
                       height])
    z = -center / np.linalg.norm(center)
    x = np.cross(z, [0.0, 0.0, 1.0])
    x /= np.linalg.norm(x)
    R = np.stack([x, np.cross(z, x), z])
    return np.concatenate([R, (-R @ center)[:, None]], axis=1)


def ring_features(out_dir, rng, n_points=4000, n_cams=180, noise_px=0.3,
                  outlier_frac=0.0, arc=(1 / 8, 0.9)):
    """SfM's features and matches at a known cloud, without images: the
    annotate-sweep model of the JAX package's SfM tests. ``n_points`` in
    a 20 cm box, ``n_cams`` on a ring 0.6 m out with a height wobble, each
    point seen along a contiguous arc of the ring (a share of it between
    ``arc``), its projections with ``noise_px`` of noise as each image's
    keypoints (and one descriptor a point), covis-10 pairs from the
    poses, each pair's true matches with ``outlier_frac`` of them sent to
    random wrong targets. The files go to ``out_dir`` (``feats.h5``,
    ``matches.h5``) under image paths in ``out_dir/seq/color``. → dict of
    the cloud, the paths, the pair list, Ks, poses, sizes, the image
    names and each point's true observation count."""
    from onepose_tpu_torch.utils import hdf5

    from onepose_tpu_torch.sfm import pairs as pairs_mod
    from onepose_tpu_torch.sfm.match import names_to_pair

    pts3d = rng.uniform(-0.1, 0.1, (n_points, 3))
    K = np.array([[500.0, 0, 256], [0, 500.0, 256], [0, 0, 1]])
    poses = [ring_pose(2 * np.pi * i / n_cams,
                       0.3 + 0.05 * np.sin(3 * 2 * np.pi * i / n_cams))
             for i in range(n_cams)]
    centers = rng.integers(0, n_cams, n_points)
    widths = rng.integers(max(int(n_cams * arc[0]), 3),
                          max(int(n_cams * arc[1]), 4), n_points)
    cam_idx = np.arange(n_cams)
    ang_dist = np.minimum((cam_idx[:, None] - centers[None, :]) % n_cams,
                          (centers[None, :] - cam_idx[:, None]) % n_cams)
    visible = ang_dist <= widths[None, :] // 2

    names = [os.path.join(out_dir, "seq", "color", f"{i}.png")
             for i in range(n_cams)]
    point_desc = rng.normal(size=(n_points, 32)).astype(np.float32)
    point_desc /= np.linalg.norm(point_desc, axis=1, keepdims=True)
    feature_path = os.path.join(out_dir, "feats.h5")
    kpt_of = []
    with hdf5.File(feature_path, "w") as f:
        for ci in range(n_cams):
            ids = np.where(visible[ci])[0]
            uv = geo.project_points(pts3d[ids], K, poses[ci])
            uv = uv + rng.normal(size=uv.shape) * noise_px
            kpt_of.append(ids)
            g = f.create_group(names[ci])
            g.create_dataset("keypoints", data=uv.astype(np.float32))
            g.create_dataset("descriptors", data=point_desc[ids].T)
            g.create_dataset("scores",
                             data=np.full(len(ids), 0.5, np.float32))
            g.create_dataset("image_size", data=np.array([512, 512]))

    Rs = np.stack([p[:, :3] for p in poses])
    ts = np.stack([p[:, 3] for p in poses])
    pair_list = pairs_mod.covis_pairs(names, num_matched=10, poses=(Rs, ts))
    match_path = os.path.join(out_dir, "matches.h5")
    index = {n: i for i, n in enumerate(names)}
    with hdf5.File(match_path, "w") as f:
        seen = set()
        for na, nb in pair_list:
            kp = names_to_pair(na, nb)
            if kp in seen:
                continue
            seen.add(kp)
            ids_a, ids_b = kpt_of[index[na]], kpt_of[index[nb]]
            pos_b = np.full(n_points, -1, np.int64)
            pos_b[ids_b] = np.arange(len(ids_b))
            matches0 = pos_b[ids_a]
            valid_rows = np.where(matches0 >= 0)[0]
            n_bad = int(len(valid_rows) * outlier_frac)
            if n_bad:
                bad_rows = rng.choice(valid_rows, n_bad, replace=False)
                matches0[bad_rows] = rng.integers(0, len(ids_b), n_bad)
            g = f.create_group(kp)
            g.create_dataset("matches0", data=matches0)
            g.create_dataset("matching_scores0",
                             data=np.full(len(ids_a), 0.9, np.float32))
    return {"pts3d": pts3d, "feature_path": feature_path,
            "match_path": match_path, "pair_list": pair_list,
            "Ks": {n: K for n in names}, "poses": dict(zip(names, poses)),
            "sizes": {n: (512, 512) for n in names}, "names": names,
            "gt_tracks": visible.sum(axis=0)}
