"""COLMAP binary model IO (cameras.bin / images.bin / points3D.bin).

The port's own copy of the readers and writers of
``onepose_tpu/utils/colmap_io.py``, which implements the public COLMAP
binary format: the detector samples its reference views from a model, and
SfM writes one (and an ASCII PLY of its points).

Format (little-endian):
- cameras.bin:  u64 n; per camera: i32 camera_id, i32 model_id, u64 width,
  u64 height, f64 params[num_params(model)]
- images.bin:   u64 n; per image: i32 image_id, f64 qvec[4], f64 tvec[3],
  i32 camera_id, name chars until \\x00, u64 n_pts2d; per point2D:
  f64 x, f64 y, i64 point3D_id (-1 = none)
- points3D.bin: u64 n; per point: i64 point3D_id, f64 xyz[3], u8 rgb[3],
  f64 error, u64 track_len; per track element: i32 image_id, i32 point2D_idx
"""
from __future__ import annotations

import os.path as osp
import struct
from dataclasses import dataclass
from typing import Dict

import numpy as np

# model_id → (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class Image:
    id: int
    qvec: np.ndarray          # (w, x, y, z)
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray           # [N, 2]
    point3D_ids: np.ndarray   # [N] int64, -1 = unobserved


@dataclass
class Point3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray     # [T] int32
    point2D_idxs: np.ndarray  # [T] int32


def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack("<" + fmt, f.read(size))


def read_cameras_binary(path: str) -> Dict[int, Camera]:
    cameras = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            cam_id, model_id = _read(f, "ii")
            width, height = _read(f, "QQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, "d" * n_params))
            cameras[cam_id] = Camera(cam_id, name, width, height, params)
    return cameras


def read_images_binary(path: str) -> Dict[int, Image]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            (image_id,) = _read(f, "i")
            qvec = np.array(_read(f, "dddd"))
            tvec = np.array(_read(f, "ddd"))
            (camera_id,) = _read(f, "i")
            name_bytes = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name_bytes += c
            (n_pts,) = _read(f, "Q")
            if n_pts:
                data = np.frombuffer(
                    f.read(24 * n_pts),
                    dtype=np.dtype([("x", "<f8"), ("y", "<f8"),
                                    ("id", "<i8")]))
                xys = np.stack([data["x"], data["y"]], axis=1)
                p3d = data["id"].astype(np.int64)
            else:
                xys = np.zeros((0, 2))
                p3d = np.zeros(0, np.int64)
            images[image_id] = Image(
                image_id, qvec, tvec, camera_id,
                name_bytes.decode("utf-8"), xys, p3d)
    return images


def read_points3d_binary(path: str) -> Dict[int, Point3D]:
    points = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            (pid,) = _read(f, "q")
            xyz = np.array(_read(f, "ddd"))
            rgb = np.array(_read(f, "BBB"), np.uint8)
            (error,) = _read(f, "d")
            (track_len,) = _read(f, "Q")
            track = np.frombuffer(
                f.read(8 * track_len),
                dtype=np.dtype([("image_id", "<i4"), ("pt2d", "<i4")]))
            points[pid] = Point3D(
                pid, xyz, rgb, error,
                track["image_id"].astype(np.int32).copy(),
                track["pt2d"].astype(np.int32).copy())
    return points


def read_model(model_dir: str):
    """(cameras, images, points3D) of the binary model in ``model_dir``."""
    return (read_cameras_binary(osp.join(model_dir, "cameras.bin")),
            read_images_binary(osp.join(model_dir, "images.bin")),
            read_points3d_binary(osp.join(model_dir, "points3D.bin")))


# ---------------------------------------------------------------------------
# Writers
# ---------------------------------------------------------------------------

def write_cameras_binary(cameras: Dict[int, Camera], path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            model_id = CAMERA_MODEL_IDS[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, model_id,
                                cam.width, cam.height))
            f.write(struct.pack("<" + "d" * len(cam.params),
                                *np.asarray(cam.params, np.float64)))


def write_images_binary(images: Dict[int, Image], path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<dddd", *np.asarray(im.qvec, np.float64)))
            f.write(struct.pack("<ddd", *np.asarray(im.tvec, np.float64)))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            n_pts = len(im.xys)
            f.write(struct.pack("<Q", n_pts))
            if n_pts:
                rec = np.empty(
                    n_pts, dtype=np.dtype([("x", "<f8"), ("y", "<f8"),
                                           ("id", "<i8")]))
                rec["x"] = im.xys[:, 0]
                rec["y"] = im.xys[:, 1]
                rec["id"] = im.point3D_ids
                f.write(rec.tobytes())


def write_points3d_binary(points: Dict[int, Point3D], path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for pt in points.values():
            f.write(struct.pack("<q", pt.id))
            f.write(struct.pack("<ddd", *np.asarray(pt.xyz, np.float64)))
            f.write(struct.pack("<BBB", *np.asarray(pt.rgb, np.uint8)))
            f.write(struct.pack("<d", float(pt.error)))
            track_len = len(pt.image_ids)
            f.write(struct.pack("<Q", track_len))
            rec = np.empty(
                track_len, dtype=np.dtype([("image_id", "<i4"),
                                           ("pt2d", "<i4")]))
            rec["image_id"] = pt.image_ids
            rec["pt2d"] = pt.point2D_idxs
            f.write(rec.tobytes())


def write_model(cameras, images, points3D, model_dir: str):
    import os

    os.makedirs(model_dir, exist_ok=True)
    write_cameras_binary(cameras, osp.join(model_dir, "cameras.bin"))
    write_images_binary(images, osp.join(model_dir, "images.bin"))
    write_points3d_binary(points3D, osp.join(model_dir, "points3D.bin"))


def write_points_ply(points: Dict[int, Point3D], path: str):
    """ASCII PLY export (replaces `colmap model_converter --output_type PLY`)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\n"
                "property uchar blue\nend_header\n")
        for pt in points.values():
            x, y, z = pt.xyz
            r, g, b = pt.rgb
            f.write(f"{x} {y} {z} {int(r)} {int(g)} {int(b)}\n")
