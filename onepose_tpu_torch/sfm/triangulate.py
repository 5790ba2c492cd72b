"""Known-pose multi-view triangulation, on one device.

Port of ``onepose_tpu/sfm/triangulate.py`` (in the reference's place of
COLMAP's ``matches_importer`` verification and ``point_triangulator``):
1. geometric verification: every match of every pair held to the known
   poses' epipolar geometry (Sampson distance below 4 px), all the pairs
   of a run in one padded batched call on the device, in fp32;
2. tracks: the conflict-aware union-find over the verified
   correspondences (``runtime/native.py``, on the host);
3. robust multi-view DLT per track: two-observation hypotheses drawn on
   the host (``np.random.default_rng(0)``), each scored by its
   reprojection inliers, the best hypothesis's inliers triangulated
   again; the 4x4 normal systems of every hypothesis, and then of every
   track, go through batched ``torch.linalg.eigh`` calls of up to 16,384
   systems (each checks its errors, so a call waits on the card once; a
   reference-scale run makes a few dozen, not one a track). The
   projections are
   gathered on the device from a table of each image's ``P``. Per-image
   conflicts and the minimum triangulation angle are numpy on the host,
   as in the JAX package; leftovers of a track go another round;
4. a COLMAP-format model (points3D.bin and point3D_ids in images.bin).

The eigenvector's sign cancels in ``X / X[3]``. A near-degenerate system
can give another null vector on the card (cuSOLVER) than on the CPU
(LAPACK), so card and CPU are held to each other by point position and
inlier counts, not by bits.
"""
from __future__ import annotations

import os.path as osp
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from onepose_tpu_torch import runtime
from onepose_tpu_torch.utils import colmap_io
from onepose_tpu_torch.utils.geometry import rotmat2qvec

MAX_REPROJ_ERROR = 4.0     # px (COLMAP Mapper.filter_max_reproj_error)
MIN_TRI_ANGLE_DEG = 1.5    # COLMAP Mapper.filter_min_tri_angle
EPIPOLAR_THRESHOLD = 4.0   # px Sampson gate for verification
MAX_TRACK_LEN = 32         # minimum observation-budget bucket (doubles up)
MAX_TRACK_OBS_CAP = 1024   # absolute per-track observation budget
EIGH_BATCH = 1 << 14       # systems a batched eigh call


# ---------------------------------------------------------------------------
# Empty model construction (reference generate_empty.py equivalent)
# ---------------------------------------------------------------------------

def build_empty_model(img_lists: Sequence[str],
                      Ks: Dict[str, np.ndarray],
                      poses: Dict[str, np.ndarray],
                      sizes: Dict[str, Tuple[int, int]]):
    """PINHOLE camera + posed image (no points) per frame.

    Ks: per-path 3x3; poses: per-path 3x4/4x4 world→camera; sizes: per-path
    (width, height). Returns (cameras, images) dicts of colmap_io types.
    """
    cameras, images = {}, {}
    for i, path in enumerate(img_lists):
        K = np.asarray(Ks[path], np.float64)
        w, h = sizes[path]
        cameras[i + 1] = colmap_io.Camera(
            i + 1, "PINHOLE", int(w), int(h),
            np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]))
        pose = np.asarray(poses[path], np.float64)
        R, t = pose[:3, :3], pose[:3, 3]
        images[i + 1] = colmap_io.Image(
            i + 1, rotmat2qvec(R), t.copy(), i + 1, path,
            np.zeros((0, 2)), np.zeros(0, np.int64))
    return cameras, images


# ---------------------------------------------------------------------------
# Geometric verification (on the device, every pair in one call)
# ---------------------------------------------------------------------------

def fundamental_from_poses(K0, R0, t0, K1, R1, t1):
    """F mapping homogeneous points in image0 to epipolar lines in image1."""
    R_rel = R1 @ R0.T
    t_rel = t1 - R_rel @ t0
    tx = np.array([
        [0, -t_rel[2], t_rel[1]],
        [t_rel[2], 0, -t_rel[0]],
        [-t_rel[1], t_rel[0], 0],
    ])
    E = tx @ R_rel
    return np.linalg.inv(K1).T @ E @ np.linalg.inv(K0)


def sampson_distance(F: torch.Tensor, uv0: torch.Tensor,
                     uv1: torch.Tensor) -> torch.Tensor:
    """First-order epipolar distance in pixels, batched: F [..., 3, 3],
    uv0 / uv1 [..., N, 2] → [..., N]."""
    ones = torch.ones_like(uv0[..., :1])
    x0 = torch.cat([uv0, ones], dim=-1)
    x1 = torch.cat([uv1, ones], dim=-1)
    Fx0 = x0 @ F.transpose(-1, -2)      # [..., N, 3] epipolar lines in image1
    Ftx1 = x1 @ F                       # [..., N, 3]
    num = torch.sum(x1 * Fx0, dim=-1) ** 2
    den = Fx0[..., 0] ** 2 + Fx0[..., 1] ** 2 + Ftx1[..., 0] ** 2 \
        + Ftx1[..., 1] ** 2 + 1e-12
    return torch.sqrt(num / den)


def verify_pairs(Fs: Sequence[np.ndarray], uv0s: Sequence[np.ndarray],
                 uv1s: Sequence[np.ndarray], threshold=EPIPOLAR_THRESHOLD,
                 device="cuda") -> List[np.ndarray]:
    """The Sampson gate of many pairs in one padded fp32 call on
    ``device``: per pair, a bool [M_i] of the matches within
    ``threshold`` px of their epipolar lines."""
    if not Fs:
        return []
    n, m = len(Fs), max(len(u) for u in uv0s)
    uv = np.zeros((2, n, m, 2), np.float32)
    for i, (a, b) in enumerate(zip(uv0s, uv1s)):
        uv[0, i, :len(a)] = a
        uv[1, i, :len(b)] = b
    uv = torch.from_numpy(uv).to(device)
    F = torch.from_numpy(np.stack(Fs).astype(np.float32)).to(device)
    ok = (sampson_distance(F, uv[0], uv[1]) < threshold).cpu().numpy()
    return [ok[i, :len(u)] for i, u in enumerate(uv0s)]


def verify_matches(feature_path: str, match_path: str,
                   pairs: Sequence[Tuple[str, str]],
                   Ks: Dict[str, np.ndarray],
                   poses: Dict[str, np.ndarray],
                   epipolar_threshold: float = EPIPOLAR_THRESHOLD,
                   device="cuda"):
    """Known-pose epipolar (Sampson) verification of every match pair.

    Returns (feats_uv, verified, geoms):
    - feats_uv: {name: [N, 2] keypoints}
    - verified: [(name0, name1, idx_pairs [M, 2])] surviving matches
    - geoms: {(name0, name1): {"matches", "F", "E", "H", "qvec", "tvec"}}
      per-pair two-view geometry from the known poses (E = [t]x R_rel,
      F = K1^-T E K0^-1, relative pose as qvec/tvec), the rows the
      reference imports into COLMAP's two_view_geometries table.
    """
    from onepose_tpu_torch.utils import hdf5

    from onepose_tpu_torch.sfm.match import names_to_pair

    device = runtime.resolve_device(device, "verify_matches")
    img_lists = list(dict.fromkeys([p for pair in pairs for p in pair]))
    feats_uv: Dict[str, np.ndarray] = {}
    with hdf5.File(feature_path, "r") as ff:
        for name in img_lists:
            feats_uv[name] = ff[name]["keypoints"][()].astype(np.float32)

    cands = []
    seen = set()
    with hdf5.File(match_path, "r") as mf:
        for name0, name1 in pairs:
            key = (name0, name1)
            if key in seen or (name1, name0) in seen:
                continue
            seen.add(key)
            pair_name = names_to_pair(name0, name1)
            if pair_name not in mf:
                continue
            matches0 = mf[pair_name]["matches0"][()]
            valid = matches0 > -1
            if valid.sum() == 0:
                continue
            idx0 = np.where(valid)[0]
            idx1 = matches0[valid]
            pose0 = np.asarray(poses[name0], np.float64)
            pose1 = np.asarray(poses[name1], np.float64)
            R_rel = pose1[:3, :3] @ pose0[:3, :3].T
            t_rel = pose1[:3, 3] - R_rel @ pose0[:3, 3]
            tx = np.array([
                [0, -t_rel[2], t_rel[1]],
                [t_rel[2], 0, -t_rel[0]],
                [-t_rel[1], t_rel[0], 0],
            ])
            E = tx @ R_rel
            F = (np.linalg.inv(np.asarray(Ks[name1])).T @ E
                 @ np.linalg.inv(np.asarray(Ks[name0])))
            cands.append((name0, name1, idx0, idx1, F, E, R_rel, t_rel))

    oks = verify_pairs([c[4] for c in cands],
                       [feats_uv[c[0]][c[2]] for c in cands],
                       [feats_uv[c[1]][c[3]] for c in cands],
                       epipolar_threshold, device)
    verified = []
    geoms: Dict[Tuple[str, str], dict] = {}
    for (name0, name1, idx0, idx1, F, E, R_rel, t_rel), ok in zip(cands, oks):
        if ok.sum() == 0:
            continue
        idx = np.stack([idx0[ok], idx1[ok]], axis=1)
        verified.append((name0, name1, idx))
        geoms[(name0, name1)] = {
            "matches": idx, "F": F, "E": E, "H": np.eye(3),
            "qvec": rotmat2qvec(R_rel), "tvec": t_rel,
        }
    return feats_uv, verified, geoms


# ---------------------------------------------------------------------------
# Track building (union-find)
# ---------------------------------------------------------------------------

def build_tracks(num_kpts: Dict[str, int],
                 verified_matches: List[Tuple[str, str, np.ndarray]]):
    """verified_matches: list of (name0, name1, idx_pairs [M, 2]).

    Connected components over the match graph via the native
    conflict-aware union-find (runtime/track_builder.cpp;
    Python fallback inside). Returns tracks = list of
    [(name, kpt_idx), ...] with >= 2 observations.

    Image conflicts (two keypoints of one image in a track — the
    signature of an outlier link) are handled at the UNION level: a merge
    that would put two keypoints of the same image into one component is
    refused, reproducing COLMAP's track-merging rule. Plain transitive
    union-find percolates into giant mixed components once surviving
    outlier links exceed ~n_points/2 (measured: recall 0.22 at 30%
    outlier matches vs 0.97 clean — the JAX package's tests/test_sfm_stress.py), and the
    downstream per-track consensus splitting can only unpick one physical
    point per round. Residual conflicts inside a refused-but-small mixed
    track are still pruned by the robust triangulation stage.
    """
    from onepose_tpu_torch.runtime.native import uf_components_imgsafe

    names = list(num_kpts.keys())
    offsets = {}
    total = 0
    node_img = np.empty(0, np.int32)
    img_of = []
    for ii, n in enumerate(names):
        offsets[n] = total
        total += num_kpts[n]
        img_of.append(np.full(num_kpts[n], ii, np.int32))
    node_img = (np.concatenate(img_of) if img_of
                else np.zeros(0, np.int32))

    edge_arrays = [
        pairs_idx.astype(np.int64)
        + np.array([offsets[name0], offsets[name1]], np.int64)
        for name0, name1, pairs_idx in verified_matches
    ]
    edges = (np.concatenate(edge_arrays) if edge_arrays
             else np.zeros((0, 2), np.int64))
    roots = uf_components_imgsafe(total, edges, node_img)

    # group nodes by root (vectorized)
    order = np.argsort(roots, kind="stable")
    sorted_roots = roots[order]
    boundaries = np.flatnonzero(
        np.diff(sorted_roots, prepend=sorted_roots[0] - 1 if total else 0))

    rev = []
    for n in names:
        rev.extend([(n, i) for i in range(num_kpts[n])])

    tracks = []
    starts = list(boundaries) + [total]
    for si in range(len(starts) - 1):
        members = order[starts[si]:starts[si + 1]]
        if len(members) < 2:
            continue
        tracks.append([rev[m] for m in members])
    return tracks


# ---------------------------------------------------------------------------
# Multi-view DLT (on the device, batched over tracks and hypotheses)
# ---------------------------------------------------------------------------

def _dlt_rows(uvs: torch.Tensor, Ps: torch.Tensor):
    """The DLT's two rows of each observation, normalised for
    conditioning: u * P[2] - P[0] and v * P[2] - P[1]. uvs [..., M, 2],
    Ps [..., M, 3, 4] → two [..., M, 4]."""
    r0 = uvs[..., 0:1] * Ps[..., 2, :] - Ps[..., 0, :]
    r1 = uvs[..., 1:2] * Ps[..., 2, :] - Ps[..., 1, :]
    r0 = r0 / (torch.linalg.vector_norm(r0, dim=-1, keepdim=True) + 1e-12)
    r1 = r1 / (torch.linalg.vector_norm(r1, dim=-1, keepdim=True) + 1e-12)
    return r0, r1


def null_vectors(AtA: torch.Tensor) -> torch.Tensor:
    """The eigenvector of the smallest eigenvalue of each symmetric 4x4
    system AtA [..., 4, 4] → [..., 4]: batched ``eigh`` calls of at most
    EIGH_BATCH systems (cuSOLVER's batched eigh refuses larger batches on
    the card, scripts/torch_eigh_batch_limit.py)."""
    flat = AtA.reshape(-1, 4, 4)
    vecs = [torch.linalg.eigh(flat[i:i + EIGH_BATCH])[1][..., 0]
            for i in range(0, flat.shape[0], EIGH_BATCH)]
    return torch.cat(vecs).reshape(*AtA.shape[:-2], 4)


def _solve_and_reproject(AtA: torch.Tensor, uvs: torch.Tensor,
                         Ps: torch.Tensor):
    """The null vector of each system AtA [T, H, 4, 4], dehomogenised →
    xyz [T, H, 3], and its pixel reprojection error and depth at every
    observation of its track (uvs [T, M, 2], Ps [T, M, 3, 4]) → err, z
    [T, H, M]. The error at padded slots is meaningless; callers mask."""
    X = null_vectors(AtA)                                   # [T, H, 4]
    w = X[..., 3:4]
    X = X / torch.where(w.abs() < 1e-12, 1e-12, w)
    xyz = X[..., :3]
    proj = torch.einsum("tmij,thj->thmi", Ps,
                        torch.cat([xyz, torch.ones_like(w)], dim=-1))
    z = proj[..., 2]
    uv_proj = proj[..., :2] / torch.where(z.abs() < 1e-12, 1e-12, z)[..., None]
    err = torch.linalg.vector_norm(uv_proj - uvs[:, None], dim=-1)
    return xyz, err, z


def _normal_systems(r0, r1, weights):
    """sum_m w (r0 r0^T + r1 r1^T) for weights [T, H, M] of 0 and 1 →
    [T, H, 4, 4]: A^T A of the weighted rows."""
    return (torch.einsum("thm,tmi,tmj->thij", weights, r0, r0)
            + torch.einsum("thm,tmi,tmj->thij", weights, r1, r1))


def triangulate_tracks(tracks, feats_uv: Dict[str, np.ndarray],
                       Ks: Dict[str, np.ndarray],
                       poses: Dict[str, np.ndarray],
                       max_reproj: float = MAX_REPROJ_ERROR,
                       min_tri_angle_deg: float = MIN_TRI_ANGLE_DEG,
                       max_rounds: int = 3, device="cuda"):
    """Robustly triangulate every track, iteratively: each round extracts
    each track's consensus point (RANSAC over observation pairs), and the
    leftover observations — which may belong to a *different* physical point
    that an outlier link merged into the same component — form the next
    round's tracks.

    Returns (xyz [T,3], per-track list of kept (name, kpt_idx), errors).
    """
    all_xyz, all_tracks, all_err = [], [], []
    current = tracks
    for _ in range(max_rounds):
        if not current:
            break
        xyz, kept, err, leftover = _triangulate_tracks_once(
            current, feats_uv, Ks, poses, max_reproj, min_tri_angle_deg,
            device)
        all_xyz.append(xyz)
        all_tracks.extend(kept)
        all_err.append(err)
        current = leftover
    if not all_tracks:
        return np.zeros((0, 3)), [], np.zeros(0)
    return (np.concatenate(all_xyz), all_tracks, np.concatenate(all_err))


def _triangulate_tracks_once(tracks, feats_uv, Ks, poses,
                             max_reproj, min_tri_angle_deg, device):
    if not tracks:
        return np.zeros((0, 3)), [], np.zeros(0), []

    T = len(tracks)
    # Observation budget: the longest track bucketed up to a power of two
    # (the JAX package's compile buckets; the padded batch's shape). A
    # fixed small cap silently truncated long tracks at reference scale
    # (a 180-image annotate sweep produces tracks of length 150+), which
    # distorted the track-length histogram filter_tkl depends on and
    # dropped observations from feature aggregation.
    longest = max(len(t) for t in tracks)
    M = MAX_TRACK_LEN
    while M < longest and M < MAX_TRACK_OBS_CAP:
        M *= 2
    uvs = np.zeros((T, M, 2), np.float32)
    mask = np.zeros((T, M), bool)
    centers = np.zeros((T, M, 3), np.float32)

    P_of, C_of = [], {}
    name_id = {}
    for name in feats_uv:
        pose = np.asarray(poses[name], np.float64)
        R, t = pose[:3, :3], pose[:3, 3]
        P_of.append((np.asarray(Ks[name]) @
                     np.concatenate([R, t[:, None]], axis=1)
                     ).astype(np.float32))
        C_of[name] = (-R.T @ t).astype(np.float32)
        name_id[name] = len(name_id)
    # padded slots gather a harmless dummy P, the table's last row
    dummy = np.zeros((3, 4), np.float32)
    dummy[2, 3] = 1.0
    P_table = np.stack(P_of + [dummy])

    img_ids = np.full((T, M), -1, np.int64)
    for ti, obs in enumerate(tracks):
        for mi, (name, ki) in enumerate(obs[:M]):
            uvs[ti, mi] = feats_uv[name][ki]
            centers[ti, mi] = C_of[name]
            mask[ti, mi] = True
            img_ids[ti, mi] = name_id[name]

    # Robust per-track triangulation: outlier links in the match graph can
    # merge two physical points into one track, where a global DLT lands
    # between them and every observation fails the reprojection gate. So:
    # RANSAC over two-observation hypotheses → consensus inlier set →
    # retriangulate the inliers.
    n_obs = mask.sum(axis=1)
    n_hyp = 8
    rng = np.random.default_rng(0)
    # Vectorized two-distinct-sample per (track, hypothesis): draw a in
    # [0, c), b in [0, c-1) and bump b past a (every track has >= 2 obs).
    c = n_obs[:, None]  # [T, 1]
    a = (rng.random((T, n_hyp)) * c).astype(np.int64)
    b = (rng.random((T, n_hyp)) * (c - 1)).astype(np.int64)
    b += b >= a
    hyp_mask = np.zeros((T, n_hyp, M), bool)
    t_idx = np.arange(T)[:, None]
    h_idx = np.arange(n_hyp)[None, :]
    hyp_mask[t_idx, h_idx, a] = True
    hyp_mask[t_idx, h_idx, b] = True

    # on the device: the projections gathered from the table, the rows
    # once, every hypothesis's system in one eigh, scored; then the best
    # hypothesis's inliers triangulated again in one more
    uvs_d = torch.from_numpy(uvs).to(device)
    Ps_d = torch.from_numpy(P_table).to(device)[
        torch.from_numpy(np.where(img_ids < 0, len(P_of), img_ids)).to(device)]
    mask_d = torch.from_numpy(mask).to(device)
    r0, r1 = _dlt_rows(uvs_d, Ps_d)
    hyp_w = torch.from_numpy(hyp_mask).to(device).float()
    _, err_h, z_h = _solve_and_reproject(
        _normal_systems(r0, r1, hyp_w), uvs_d, Ps_d)
    # score each hypothesis: inliers among the track's observations
    inl_h = (err_h < max_reproj) & (z_h > 0) & mask_d[:, None, :]
    best_h = inl_h.sum(dim=2).argmax(dim=1)
    good_obs_d = inl_h[torch.arange(T, device=device), best_h]
    xyz2, err2, z2 = _solve_and_reproject(
        _normal_systems(r0, r1, good_obs_d.float()[:, None]), uvs_d, Ps_d)
    good_obs, xyz2, err2, z2 = (x.cpu().numpy() for x in (
        good_obs_d, xyz2[:, 0], err2[:, 0], z2[:, 0]))
    enough = good_obs.sum(axis=1) >= 2
    good2 = good_obs & (err2 < max_reproj) & (z2 > 0)

    # resolve per-image conflicts (two keypoints of one image in a track):
    # keep the lower-error observation. Vectorized: group the flat (track,
    # image) pairs with a stable lexsort keyed by error and keep each
    # group's first element. Invalid slots group under image id -1 and are
    # already ~good2, so the final AND leaves them untouched.
    t_rep = np.repeat(np.arange(T), M)
    img_flat = np.where(good2, img_ids, -1).ravel()
    err_flat = np.where(good2, err2, np.inf).ravel()
    order = np.lexsort((err_flat, img_flat, t_rep))
    st, si = t_rep[order], img_flat[order]
    first = np.ones(T * M, bool)
    first[1:] = (st[1:] != st[:-1]) | (si[1:] != si[:-1])
    keeper = np.zeros(T * M, bool)
    keeper[order] = first
    good2 &= keeper.reshape(T, M)

    # triangulation angle: max pairwise angle between viewing rays.
    # Chunked over tracks — the full [T, M, M] pairwise matrix is ~1 GB at
    # reference scale (T=4000, M=256); 512-track chunks keep it exact at
    # ~130 MB peak.
    rays = xyz2[:, None, :] - centers          # [T, M, 3]
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True) + 1e-12
    max_angle = np.empty(T)
    chunk = max(1, (1 << 25) // max(M * M, 1))  # ~128 MB fp32 per chunk
    for s in range(0, T, chunk):
        e = min(s + chunk, T)
        cosang = np.einsum("tmi,tni->tmn", rays[s:e], rays[s:e])
        pair_ok = good2[s:e, :, None] & good2[s:e, None, :]
        cosang = np.where(pair_ok, cosang, 1.0)
        max_angle[s:e] = np.rad2deg(np.arccos(np.clip(
            cosang.min(axis=(1, 2)), -1.0, 1.0)))

    keep = enough & (good2.sum(axis=1) >= 2) & \
        (max_angle >= min_tri_angle_deg)

    kept_tracks = []
    kept_xyz = []
    kept_err = []
    leftover_tracks = []
    for ti in range(T):
        n_track = min(len(tracks[ti]), M)
        if keep[ti]:
            obs = [tracks[ti][mi] for mi in range(n_track)
                   if good2[ti, mi]]
            kept_tracks.append(obs)
            kept_xyz.append(xyz2[ti])
            kept_err.append(err2[ti][good2[ti]].mean())
            leftover = [tracks[ti][mi] for mi in range(n_track)
                        if not good2[ti, mi]]
        else:
            leftover = list(tracks[ti][:n_track])
        if len(leftover) >= 2 and len(leftover) < n_track:
            # genuinely shrunk: worth another extraction round (an equal
            # leftover means this track failed outright — retrying loops)
            leftover_tracks.append(leftover)
    if not kept_xyz:
        return np.zeros((0, 3)), [], np.zeros(0), leftover_tracks
    return (np.stack(kept_xyz), kept_tracks, np.asarray(kept_err),
            leftover_tracks)


# ---------------------------------------------------------------------------
# Orchestration
# ---------------------------------------------------------------------------

def triangulate_from_h5(feature_path: str, match_path: str,
                        pairs: Sequence[Tuple[str, str]],
                        Ks: Dict[str, np.ndarray],
                        poses: Dict[str, np.ndarray],
                        sizes: Dict[str, Tuple[int, int]],
                        model_out_dir: str,
                        epipolar_threshold: float = EPIPOLAR_THRESHOLD,
                        verification=None,
                        verbose: bool = True, device="cuda") -> dict:
    """Full pipeline from feature/match HDF5 files to a COLMAP-format model
    directory. Returns model_analyzer-style stats.

    verification: optional precomputed ``verify_matches`` result
    (feats_uv, verified, geoms) — e.g. shared with the database export —
    to avoid verifying twice."""
    img_lists = list(dict.fromkeys(
        [p for pair in pairs for p in pair]))

    # 1. epipolar verification per pair
    if verification is None:
        verification = verify_matches(
            feature_path, match_path, pairs, Ks, poses,
            epipolar_threshold, device)
    feats_uv, verified, _ = verification

    # 2. tracks
    num_kpts = {n: feats_uv[n].shape[0] for n in img_lists}
    tracks = build_tracks(num_kpts, verified)

    # 3. triangulate
    xyz, kept_tracks, errors = triangulate_tracks(
        tracks, feats_uv, Ks, poses, device=runtime.resolve_device(
            device, "triangulate_from_h5"))

    # 4. write COLMAP model
    cameras, images = build_empty_model(img_lists, Ks, poses, sizes)
    name_to_id = {im.name: iid for iid, im in images.items()}
    # attach keypoints to images
    p3d_ids = {n: np.full(num_kpts[n], -1, np.int64) for n in img_lists}
    points3D = {}
    for pi, (pt, obs, err) in enumerate(
            zip(xyz, kept_tracks, errors), start=1):
        image_ids = []
        pt2d_idxs = []
        for name, ki in obs:
            image_ids.append(name_to_id[name])
            pt2d_idxs.append(ki)
            p3d_ids[name][ki] = pi
        points3D[pi] = colmap_io.Point3D(
            pi, np.asarray(pt, np.float64),
            np.array([128, 128, 128], np.uint8), float(err),
            np.asarray(image_ids, np.int32),
            np.asarray(pt2d_idxs, np.int32))
    for iid, im in images.items():
        im.xys = feats_uv[im.name].astype(np.float64)
        im.point3D_ids = p3d_ids[im.name]

    colmap_io.write_model(cameras, images, points3D, model_out_dir)
    colmap_io.write_points_ply(
        points3D, osp.join(osp.dirname(model_out_dir) or ".", "model.ply"))

    n_obs = int(sum(len(t) for t in kept_tracks))
    stats = {
        "num_reg_images": len(images),
        "num_sparse_points": len(points3D),
        "num_observations": n_obs,
        "mean_track_length": n_obs / max(len(points3D), 1),
        "mean_reproj_error": float(np.mean(errors)) if len(errors) else 0.0,
    }
    if verbose:
        print(f"[triangulate] {stats}")
    return stats
