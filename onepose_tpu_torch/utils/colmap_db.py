"""COLMAP sqlite database export, for the port's SfM.

The port's own copy of ``onepose_tpu/utils/colmap_db.py``. The SfM
workspace holds a ``database.db`` in COLMAP's public schema so that COLMAP
tooling can read it (GUI inspection, re-running its mapper); triangulation
itself does not read it. stdlib sqlite3.
"""
from __future__ import annotations

import sqlite3
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

MAX_IMAGE_ID = 2 ** 31 - 1

_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL,
    width INTEGER NOT NULL,
    height INTEGER NOT NULL,
    params BLOB,
    prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE,
    camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL,
    CONSTRAINT image_id_check CHECK(image_id >= 0 and image_id < 2147483647),
    FOREIGN KEY(camera_id) REFERENCES cameras(camera_id));
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL,
    F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB);
"""

CAMERA_MODEL_IDS = {"SIMPLE_PINHOLE": 0, "PINHOLE": 1}


def pair_id_of(image_id1: int, image_id2: int) -> int:
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return image_id1 * MAX_IMAGE_ID + image_id2


def _blob(arr, dtype) -> bytes:
    return np.ascontiguousarray(np.asarray(arr), dtype).tobytes()


class ColmapDatabase:
    def __init__(self, path: str):
        self.conn = sqlite3.connect(path)
        self.conn.executescript(_SCHEMA)

    def add_camera(self, model: str, width: int, height: int, params,
                   camera_id: Optional[int] = None,
                   prior_focal_length: bool = True) -> int:
        cur = self.conn.execute(
            "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
            (camera_id, CAMERA_MODEL_IDS[model], width, height,
             _blob(params, np.float64), int(prior_focal_length)))
        return cur.lastrowid

    def add_image(self, name: str, camera_id: int,
                  image_id: Optional[int] = None,
                  prior_q=(1, 0, 0, 0), prior_t=(0, 0, 0)) -> int:
        cur = self.conn.execute(
            "INSERT INTO images VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_id, name, camera_id, *prior_q, *prior_t))
        return cur.lastrowid

    def add_keypoints(self, image_id: int, keypoints: np.ndarray):
        """keypoints [N, 2] (x, y); stored with COLMAP's +0.5 pixel-center
        convention (the reference applies the same shift at import,
        triangulation.py:65-66)."""
        kpts = np.asarray(keypoints, np.float32) + 0.5
        self.conn.execute(
            "INSERT INTO keypoints VALUES (?, ?, ?, ?)",
            (image_id, kpts.shape[0], 2, _blob(kpts, np.float32)))

    def add_matches(self, image_id1: int, image_id2: int,
                    matches: np.ndarray):
        """matches [M, 2] index pairs (kpt in image1, kpt in image2)."""
        m = np.asarray(matches, np.uint32)
        if image_id1 > image_id2:
            m = m[:, ::-1]
        self.conn.execute(
            "INSERT INTO matches VALUES (?, ?, ?, ?)",
            (pair_id_of(image_id1, image_id2), m.shape[0], 2,
             _blob(m, np.uint32)))

    def add_two_view_geometry(self, image_id1: int, image_id2: int,
                              matches: np.ndarray,
                              F=None, E=None, H=None,
                              qvec=None, tvec=None, config: int = 2):
        """config follows COLMAP's TwoViewGeometry enum: 2 = UNCALIBRATED
        (F only), 3 = CALIBRATED (E from known intrinsics) — the pipeline's
        known-pose verification writes config=3 rows."""
        m = np.asarray(matches, np.uint32)
        if image_id1 > image_id2:
            m = m[:, ::-1]
        eye = np.eye(3)
        self.conn.execute(
            "INSERT INTO two_view_geometries VALUES "
            "(?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (pair_id_of(image_id1, image_id2), m.shape[0], 2,
             _blob(m, np.uint32), config,
             _blob(F if F is not None else eye, np.float64),
             _blob(E if E is not None else eye, np.float64),
             _blob(H if H is not None else eye, np.float64),
             _blob(qvec if qvec is not None else [1, 0, 0, 0], np.float64),
             _blob(tvec if tvec is not None else [0, 0, 0], np.float64)))

    def commit(self):
        self.conn.commit()

    def close(self):
        self.conn.commit()
        self.conn.close()


def export_database(feature_path: str, match_path: str,
                    pairs: Sequence[Tuple[str, str]],
                    Ks: Dict[str, np.ndarray],
                    sizes: Dict[str, Tuple[int, int]],
                    verified: Optional[Dict[Tuple[str, str], np.ndarray]],
                    db_path: str) -> Dict[str, int]:
    """Build a COLMAP database from the pipeline's feature/match artifacts.

    verified: optional {(name0, name1): value} to populate
    two_view_geometries (the matches table always gets the raw matches).
    Each value is either an [M, 2] array of epipolar-verified index pairs,
    or a dict {"matches", "F", "E", "H", "qvec", "tvec"} as produced by
    ``sfm.triangulate.verify_matches`` — the latter writes full
    calibrated-geometry rows (config=3) matching the reference's import
    (the reference's src/sfm/triangulation.py:73-114). Returns
    {image name: image_id}.
    """
    from onepose_tpu_torch.utils import hdf5

    img_names = list(dict.fromkeys([n for p in pairs for n in p]))
    db = ColmapDatabase(db_path)
    name_to_id = {}
    with hdf5.File(feature_path, "r") as ff:
        for i, name in enumerate(img_names):
            K = np.asarray(Ks[name], np.float64)
            w, h = sizes[name]
            cam_id = db.add_camera(
                "PINHOLE", int(w), int(h),
                [K[0, 0], K[1, 1], K[0, 2], K[1, 2]], camera_id=i + 1)
            img_id = db.add_image(name, cam_id, image_id=i + 1)
            name_to_id[name] = img_id
            db.add_keypoints(img_id, ff[name]["keypoints"][()])

    from onepose_tpu_torch.sfm.match import names_to_pair

    seen = set()
    with hdf5.File(match_path, "r") as mf:
        for name0, name1 in pairs:
            if (name0, name1) in seen or (name1, name0) in seen:
                continue
            seen.add((name0, name1))
            key = names_to_pair(name0, name1)
            if key not in mf:
                continue
            matches0 = mf[key]["matches0"][()]
            valid = matches0 > -1
            idx = np.stack(
                [np.where(valid)[0], matches0[valid]], axis=1)
            db.add_matches(name_to_id[name0], name_to_id[name1], idx)
            if verified is not None and (name0, name1) in verified:
                v = verified[(name0, name1)]
                if isinstance(v, dict):
                    db.add_two_view_geometry(
                        name_to_id[name0], name_to_id[name1], v["matches"],
                        F=v.get("F"), E=v.get("E"), H=v.get("H"),
                        qvec=v.get("qvec"), tvec=v.get("tvec"), config=3)
                else:
                    db.add_two_view_geometry(
                        name_to_id[name0], name_to_id[name1], v)
    db.close()
    return name_to_id
