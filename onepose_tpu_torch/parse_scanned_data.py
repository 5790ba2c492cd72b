#!/usr/bin/env python
"""Parse OnePose Cap (ARKit) captures into the dataset layout: the port's
ingest entry, its own copy of the repository's ``parse_scanned_data.py``.

'-annotate' sequences get per-frame object poses (T_oc = T_wc @ T_ow with
the ARKit gravity flip), the annotated 3D box corners, 512x512 object
crops with updated intrinsics and crop-to-full transforms; '-test'
sequences get their full frames and averaged intrinsics. numpy, and cv2
where frames are decoded.

    python -m onepose_tpu_torch.parse_scanned_data --scanned_object_path <capture_root>
"""
import argparse
import os
import os.path as osp

import numpy as np

from onepose_tpu_torch.utils import geometry as geo


def compose_T(position, rot_mat):
    T = np.eye(4)
    T[:3, :3] = rot_mat
    T[:3, 3] = position
    return T


def get_bbox3d(box_path):
    """Box.txt line 2: 'x,y,z,ex,ey,ez,qw,qx,qy,qz' → 8 corner coords in the
    object frame (axis-aligned, centered)."""
    with open(box_path, "r") as f:
        lines = f.readlines()
    data = [float(e) for e in lines[1].strip().split(",")]
    ex, ey, ez = data[3:6]
    bbox = np.array([
        [-ex, -ey, -ez], [ex, -ey, -ez], [ex, -ey, ez], [-ex, -ey, ez],
        [-ex, ey, -ez], [ex, ey, -ez], [ex, ey, ez], [-ex, ey, ez],
    ]) * 0.5
    bbox_homo = np.concatenate([bbox, np.ones((8, 1))], axis=1)
    return bbox, bbox_homo


def parse_box_T_ow(box_path):
    with open(box_path, "r") as f:
        lines = f.readlines()
    data = [float(e) for e in lines[1].strip().split(",")]
    return compose_T(data[:3], geo.qvec2rotmat(data[6:10]))


def average_intrinsics(frames_txt, out_path):
    with open(frames_txt, "r") as f:
        lines = [ln.strip() for ln in f
                 if ln.strip() and not ln.startswith("#")]
    data = np.array([[float(e) for e in ln.split(",")] for ln in lines])
    fx, fy, cx, cy = np.average(data, axis=0)[2:6]
    with open(out_path, "w") as f:
        f.write(f"fx: {fx}\nfy: {fy}\ncx: {cx}\ncy: {cy}")
    return fx, fy, cx, cy


def reproj_homo(K_homo, pose, pts_homo):
    """K_homo [3,4] @ pose [4,4] @ pts [4,n] → [n,2] pixels."""
    p = K_homo @ pose @ pts_homo
    return (p[:2] / p[2:]).T


ARKIT_FLIP = np.diag([1.0, -1.0, -1.0])


def parse_poses(pose_file, box_path, K_homo, bbox_homo, out_pose_dir,
                reproj_box_dir, downsample_rate=1):
    """ARposes.txt lines: 'ts, px, py, pz, qw, qx, qy, qz' (camera in
    world). Object pose per frame: T_oc = inv(T_cw) @ T_ow with the ARKit
    gravity-frame flip applied to the camera rotation."""
    T_ow = parse_box_T_ow(box_path)
    with open(pose_file, "r") as f:
        lines = [ln.strip() for ln in f.readlines()]
    index = 0
    kept = 0
    for line in lines:
        if not line or line[0] == "#":
            continue
        if index % downsample_rate == 0:
            data = [float(e) for e in line.split(",")]
            position = data[1:4]
            rot = geo.qvec2rotmat(data[4:8]) @ ARKIT_FLIP
            T_cw = compose_T(position, rot)
            T_oc = np.linalg.inv(T_cw) @ T_ow

            box2d = reproj_homo(K_homo, T_oc, bbox_homo.T)
            x0, y0 = box2d.min(0)
            x1, y1 = box2d.max(0)
            if x0 < -1000 or y0 < -1000 or x1 > 3000 or y1 > 3000:
                index += 1
                continue
            np.savetxt(osp.join(out_pose_dir, f"{index}.txt"), T_oc)
            np.savetxt(osp.join(reproj_box_dir, f"{index}.txt"), box2d)
            kept += 1
        index += 1
    return kept


def parse_video_crops(data_dir, downsample_rate=1, hw=512):
    """Decode Frames.m4v; per frame with a reproj box: two-stage crop to
    hw x hw, save color/, color_full/, intrin/, M/ (crop→full transform),
    bbox/ (box reprojected into the crop)."""
    import cv2

    K, K_homo = geo.get_K(osp.join(data_dir, "intrinsics.txt"))
    bbox, bbox_homo = get_bbox3d(osp.join(data_dir, "Box.txt"))

    cap = cv2.VideoCapture(osp.join(data_dir, "Frames.m4v"))
    index = 0
    while True:
        ret, image = cap.read()
        if not ret:
            break
        if index % downsample_rate == 0:
            rb_path = osp.join(data_dir, "reproj_box", f"{index}.txt")
            if osp.isfile(rb_path):
                reproj_box = np.loadtxt(rb_path).astype(int)
                x0, y0 = reproj_box.min(0)
                x1, y1 = reproj_box.max(0)
                box = np.array([x0, y0, x1, y1])

                resize_shape = np.array([y1 - y0, x1 - x0])
                K_crop, _ = geo.get_K_crop_resize(box, K, resize_shape)
                crop, trans1 = geo.get_image_crop_resize(
                    image, box, resize_shape)

                box_new = np.array([0, 0, x1 - x0, y1 - y0])
                resize_shape = np.array([hw, hw])
                K_crop, K_crop_homo = geo.get_K_crop_resize(
                    box_new, K_crop, resize_shape)
                crop, trans2 = geo.get_image_crop_resize(
                    crop, box_new, resize_shape)

                trans_full_to_crop = trans2 @ trans1
                np.savetxt(osp.join(data_dir, "M", f"{index}.txt"),
                           np.linalg.inv(trans_full_to_crop))

                pose = np.loadtxt(
                    osp.join(data_dir, "poses", f"{index}.txt"))
                box_crop = reproj_homo(K_crop_homo, pose, bbox_homo.T)
                np.savetxt(
                    osp.join(data_dir, "bbox", f"{index}.txt"),
                    np.array([*box_crop.min(0), *box_crop.max(0)]))

                cv2.imwrite(
                    osp.join(data_dir, "color", f"{index}.png"), crop)
                cv2.imwrite(
                    osp.join(data_dir, "color_full", f"{index}.png"),
                    image)
                np.savetxt(
                    osp.join(data_dir, "intrin", f"{index}.txt"), K_crop)
        index += 1
    cap.release()


def data_process_anno(data_dir, downsample_rate=1, hw=512):
    for d in ("color", "color_full", "poses", "reproj_box", "bbox",
              "intrin", "M"):
        os.makedirs(osp.join(data_dir, d), exist_ok=True)

    fx, fy, cx, cy = average_intrinsics(
        osp.join(data_dir, "Frames.txt"),
        osp.join(data_dir, "intrinsics.txt"))
    K_homo = np.array([[fx, 0, cx, 0], [0, fy, cy, 0], [0, 0, 1, 0]])

    bbox, bbox_homo = get_bbox3d(osp.join(data_dir, "Box.txt"))
    np.savetxt(osp.join(osp.dirname(data_dir), "box3d_corners.txt"), bbox)

    parse_poses(
        osp.join(data_dir, "ARposes.txt"), osp.join(data_dir, "Box.txt"),
        K_homo, bbox_homo, osp.join(data_dir, "poses"),
        osp.join(data_dir, "reproj_box"), downsample_rate)
    parse_video_crops(data_dir, downsample_rate, hw)

    # the un-BA'd capture doubles as the *_ba data (reference :243-249)
    for src, dst in (("intrin", "intrin_ba"), ("poses", "poses_ba")):
        link = osp.join(data_dir, dst)
        if osp.islink(link) or osp.exists(link):
            if osp.islink(link):
                os.remove(link)
        os.symlink(osp.join(data_dir, src), link)


def data_process_test(data_dir, downsample_rate=1):
    import cv2

    os.makedirs(osp.join(data_dir, "color_full"), exist_ok=True)
    average_intrinsics(
        osp.join(data_dir, "Frames.txt"),
        osp.join(data_dir, "intrinsics.txt"))
    cap = cv2.VideoCapture(osp.join(data_dir, "Frames.m4v"))
    index = 0
    while True:
        ret, image = cap.read()
        if not ret:
            break
        if index % downsample_rate == 0:
            cv2.imwrite(
                osp.join(data_dir, "color_full", f"{index}.png"), image)
        index += 1
    cap.release()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scanned_object_path", type=str, required=True)
    args = ap.parse_args(argv)
    data_dir = args.scanned_object_path
    assert osp.exists(data_dir), f"{data_dir} does not exist"

    for seq_dir in os.listdir(data_dir):
        if "-annotate" in seq_dir:
            print(f"=> Processing annotate sequence: {seq_dir}")
            data_process_anno(osp.join(data_dir, seq_dir))
        elif "-test" in seq_dir:
            print(f"=> Processing test sequence: {seq_dir}")
            data_process_test(osp.join(data_dir, seq_dir))


if __name__ == "__main__":
    main()
