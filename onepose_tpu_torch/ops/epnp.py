"""Batched LO-RANSAC PnP in true fp32, on tensors.

Port of ``onepose_tpu/ops/epnp.py::ransac_pnp`` and every solver it
reaches. Each function takes arbitrary leading batch dimensions (``...``)
where the JAX code used ``vmap``: ``ransac_pnp`` itself runs a batch of
frames [B, N] at once, its hypotheses as [B, H, ...].

The small-matrix solvers are the analytic ones of the JAX package (block
Schur inverse, closed-form 3x3 eigensystem, subspace iteration, Newton
polar iteration, Durand–Kerner quartic roots), not ``torch.linalg``, so
the port computes what the reference computes. Every matmul here must run
in full fp32: ``onepose_tpu_torch.ops.precision.pin_fp32`` keeps TF32 off.

Random draws: hypothesis sampling is a Gumbel-style top-k over uniform
noise (``_sample_hypothesis_indices``). ``ransac_pnp`` takes that noise
injected (:class:`RansacNoise`) so that tests can feed it JAX's draws,
or draws it from a ``torch.Generator`` on the device.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from onepose_tpu_torch.ops import lie
from onepose_tpu_torch.utils.profiling import span


class PnPResult(NamedTuple):
    pose: torch.Tensor         # [B, 3, 4] world→camera
    inliers: torch.Tensor      # [B, N] bool
    num_inliers: torch.Tensor  # [B] int32
    success: torch.Tensor      # [B] bool


class RansacNoise(NamedTuple):
    """Uniform [0, 1) noise of the four sampling draws of one
    :func:`ransac_pnp` call: ``k3`` [B, H/2, N] (P3P), ``k4`` [B, H/4, N]
    (planar), ``k6`` [B, H - H/2 - H/4, N] (P6P) and ``lo``
    [B, lo_hypotheses, N] (the LO round, drawn from the best candidate's
    inliers)."""
    k3: torch.Tensor
    k4: torch.Tensor
    k6: torch.Tensor
    lo: torch.Tensor


def draw_noise(batch: int, n: int, num_hypotheses: int = 512,
               lo_hypotheses: int = 64,
               generator: Optional[torch.Generator] = None,
               device=None) -> RansacNoise:
    """Draw the noise of :class:`RansacNoise` from ``generator``."""
    n3 = num_hypotheses // 2
    n4 = num_hypotheses // 4
    sizes = (n3, n4, num_hypotheses - n3 - n4, lo_hypotheses)
    return RansacNoise(*(torch.rand((batch, h, n), generator=generator,
                                    device=device) for h in sizes))


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _norm(x: torch.Tensor, dim=-1, keepdim: bool = False) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=dim, keepdim=keepdim)


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3] by cofactors."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2]
                            - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2]
                              - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1]
                              - M[..., 1, 1] * M[..., 2, 0]))


# ---------------------------------------------------------------------------
# Small linear algebra
# ---------------------------------------------------------------------------

def _inv3(M: torch.Tensor) -> torch.Tensor:
    """Analytic 3x3 inverse (adjugate / det) of [..., 3, 3]."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    Dd = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    Hh = b * g - a * h
    Ii = a * e - b * d
    det = a * A + b * Dd + c * G
    det = torch.where(det.abs() < 1e-20,
                      torch.where(det < 0, -1e-20, 1e-20), det)
    adj = torch.stack([torch.stack([A, B, C], -1),
                       torch.stack([Dd, E, F], -1),
                       torch.stack([G, Hh, Ii], -1)], -2)
    return adj / det[..., None, None]


def _inv_psd(A: torch.Tensor) -> torch.Tensor:
    """Analytic inverse of well-shifted symmetric PD [..., D, D] matrices by
    nested 2x2 block Schur complements down to 3x3 adjugates. D must be
    divisible by 3. Unpivoted, so only for shifted PD systems."""
    D = A.shape[-1]
    if D % 3 != 0:
        raise ValueError(f"_inv_psd requires D divisible by 3, got {D}")
    if D == 3:
        return _inv3(A)
    m = 3 * ((D // 3) // 2)
    P, Q = A[..., :m, :m], A[..., :m, m:]
    S = A[..., m:, m:]
    Pi = _inv_psd(P)
    PiQ = Pi @ Q
    Si = _inv_psd(S - Q.transpose(-1, -2) @ PiQ)
    TL = Pi + PiQ @ Si @ PiQ.transpose(-1, -2)
    TR = -PiQ @ Si
    return torch.cat([torch.cat([TL, TR], -1),
                      torch.cat([TR.transpose(-1, -2), Si], -1)], -2)


def _trace(A: torch.Tensor) -> torch.Tensor:
    return A.diagonal(dim1=-2, dim2=-1).sum(-1)


def smallest_eigvec(A: torch.Tensor, iters: int = 8,
                    shift: float = 1e-6) -> torch.Tensor:
    """Eigenvector of symmetric PSD [..., D, D] with the smallest
    eigenvalue: inverse power iteration, its ``iters`` steps collapsed into
    ceil(log2 iters) Frobenius-normalized squarings of the shifted inverse.
    (The JAX version's optional Rayleigh-quotient steps are off on every
    path that reaches it and are not ported.)"""
    D = A.shape[-1]
    scale = _trace(A) / D + 1e-12
    Ainv = _inv_psd(A + (shift * scale)[..., None, None] * _eye(D, A))
    n_sq = max(int(np.ceil(np.log2(max(iters, 1)))), 0)

    def fro_normalize(M):
        n = _norm(M, dim=(-2, -1))
        return M / torch.clamp(n, min=1e-30)[..., None, None]

    B = fro_normalize(Ainv)
    for _ in range(n_sq):
        B = fro_normalize(B @ B)
    v0 = torch.full((D, 1), 1.0 / math.sqrt(D), dtype=A.dtype,
                    device=A.device)
    v = (B @ v0)[..., 0]
    return v / torch.clamp(_norm(v, keepdim=True), min=1e-20)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def _dot(a: torch.Tensor, b: torch.Tensor, keepdim: bool = False):
    return torch.sum(a * b, dim=-1, keepdim=keepdim)


def _eigh3_sym(A: torch.Tensor):
    """Closed-form eigendecomposition of symmetric [..., 3, 3].

    Returns (eigvals [..., 3] ascending, eigvecs [..., 3, 3] as columns),
    the ``eigh`` convention, from the trigonometric solution of the
    characteristic polynomial. For a repeated eigenvalue the pair's
    directions are arbitrary but the basis stays orthonormal."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    eye = _eye(3, A)
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))
    Bm = (A - q[..., None, None] * eye) / p[..., None, None]
    r = torch.clamp(_det3(Bm) / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    vals = torch.stack([e_lo, e_mid, e_hi], -1)

    def null_dir(lam, fallback):
        # null direction of (A - lam I): the largest cross product of two
        # of its rows (exact for a simple eigenvalue)
        M = A - lam[..., None, None] * eye
        cands = torch.stack([_cross(M[..., 0, :], M[..., 1, :]),
                             _cross(M[..., 0, :], M[..., 2, :]),
                             _cross(M[..., 1, :], M[..., 2, :])], -2)
        norms = _norm(cands)
        pick = norms.argmax(-1)
        v = torch.gather(cands, -2,
                         pick[..., None, None].expand(*pick.shape, 1, 3))
        v = v[..., 0, :]
        v = torch.where(norms.amax(-1, keepdim=True) > 1e-24, v, fallback)
        return v / torch.clamp(_norm(v, keepdim=True), min=1e-30)

    v_hi = null_dir(e_hi, eye[0])
    v_lo = null_dir(e_lo, eye[1])
    # Trust whichever end of the spectrum is more isolated and
    # orthogonalize the other against it (see the JAX version for why).
    lo_isolated = ((e_mid - e_lo) >= (e_hi - e_mid))[..., None]
    v_t = torch.where(lo_isolated, v_lo, v_hi)
    v_o = torch.where(lo_isolated, v_hi, v_lo)
    v_o = v_o - _dot(v_o, v_t, keepdim=True) * v_t
    n_o = _norm(v_o, keepdim=True)
    alt = _cross(v_t, eye[v_t.abs().argmin(-1)])
    alt = alt / torch.clamp(_norm(alt, keepdim=True), min=1e-30)
    v_o = torch.where(n_o > 1e-12, v_o / torch.clamp(n_o, min=1e-30), alt)
    v_lo = torch.where(lo_isolated, v_t, v_o)
    v_hi = torch.where(lo_isolated, v_o, v_t)
    v_mid = _cross(v_hi, v_lo)
    return vals, torch.stack([v_lo, v_mid, v_hi], -1)


# Fixed well-spread [12, 3] start block for the EPnP null-space subspace
# iteration; the same block as the JAX package's.
_SUBSPACE_V0 = np.linalg.qr(
    np.random.default_rng(7).normal(size=(12, 3)))[0].astype(np.float32)


def smallest_eigvecs3_12(A: torch.Tensor, iters: int = 4,
                         shift: float = 1e-6) -> torch.Tensor:
    """The three eigenvectors of symmetric PSD [..., 12, 12] with the
    smallest eigenvalues, as columns [..., 12, 3] in ascending order:
    inverse subspace iteration with Gram-Schmidt, then a closed-form 3x3
    Rayleigh-Ritz rotation."""
    D = A.shape[-1]
    scale = _trace(A) / D + 1e-12
    Ainv = _inv_psd(A + (shift * scale)[..., None, None] * _eye(D, A))

    def orthonormalize(V):
        c0, c1, c2 = V[..., 0], V[..., 1], V[..., 2]
        q0 = c0 / torch.clamp(_norm(c0, keepdim=True), min=1e-30)
        v1 = c1 - _dot(q0, c1, keepdim=True) * q0
        q1 = v1 / torch.clamp(_norm(v1, keepdim=True), min=1e-30)
        v2 = (c2 - _dot(q0, c2, keepdim=True) * q0
              - _dot(q1, c2, keepdim=True) * q1)
        q2 = v2 / torch.clamp(_norm(v2, keepdim=True), min=1e-30)
        return torch.stack([q0, q1, q2], -1)

    V = torch.as_tensor(_SUBSPACE_V0, dtype=A.dtype, device=A.device)
    for _ in range(iters):
        V = orthonormalize(Ainv @ V)
    T = V.transpose(-1, -2) @ A @ V
    _, W = _eigh3_sym(0.5 * (T + T.transpose(-1, -2)))
    return V @ W


def closest_rotation(M: torch.Tensor, iters: int = 6):
    """Nearest proper rotation to [..., 3, 3] by scaled Newton polar
    iteration X ← (μX + (μX)^-T)/2, with a det-sign flip. Returns (R, lam),
    M ≈ lam R, lam carrying the det sign."""
    sign = torch.where(_det3(M) < 0, -1.0, 1.0)[..., None, None]
    X0 = M * sign
    nrm = torch.sqrt(torch.sum(X0 * X0, dim=(-2, -1)) / 3.0) + 1e-12
    X = X0 / nrm[..., None, None]
    R = X
    for _ in range(iters):
        mu = torch.clamp(_det3(R).abs() ** (-1.0 / 3.0), 1e-4, 1e4)
        Xs = mu[..., None, None] * R
        R = 0.5 * (Xs + _inv3(Xs).transpose(-1, -2))
    lam_pos = _trace(R.transpose(-1, -2) @ X0) / 3.0
    return R, sign[..., 0, 0] * lam_pos


# ---------------------------------------------------------------------------
# EPnP core (weighted, static shapes)
# ---------------------------------------------------------------------------

def _control_points(pts3d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted centroid + principal-axis control points.
    pts3d [..., N, 3], w [..., N] → [..., 4, 3]."""
    wsum = torch.sum(w, -1) + 1e-12
    c0 = torch.sum(pts3d * w[..., None], -2) / wsum[..., None]
    centered = (pts3d - c0[..., None, :]) * torch.sqrt(w)[..., None]
    cov = centered.transpose(-1, -2) @ centered / wsum[..., None, None]
    eigval, eigvec = _eigh3_sym(cov)
    scales = torch.sqrt(torch.clamp(eigval, min=1e-10))
    ctrl = c0[..., None, :] + eigvec.transpose(-1, -2) * scales[..., None]
    return torch.cat([c0[..., None, :], ctrl], -2)


def _barycentric(pts3d: torch.Tensor, ctrl: torch.Tensor) -> torch.Tensor:
    """Barycentric coordinates [..., N, 4] of pts3d w.r.t. 4 control
    points."""
    B = (ctrl[..., 1:, :] - ctrl[..., :1, :]).transpose(-1, -2)  # [..., 3, 3]
    rhs = (pts3d - ctrl[..., :1, :]).transpose(-1, -2)           # [..., 3, N]
    Bt = B.transpose(-1, -2)
    BtB = Bt @ B + 1e-10 * _eye(3, pts3d)
    a123 = (_inv3(BtB) @ (Bt @ rhs)).transpose(-1, -2)           # [..., N, 3]
    a0 = 1.0 - torch.sum(a123, -1, keepdim=True)
    return torch.cat([a0, a123], -1)


def _build_MtM(alphas: torch.Tensor, uv_norm: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """Weighted 12x12 normal matrix of the EPnP design matrix in normalized
    camera coordinates. Row pair of point i, control point j:
    alpha_ij [1, 0, -u_i] and alpha_ij [0, 1, -v_i]."""
    u = uv_norm[..., 0]
    v = uv_norm[..., 1]
    zeros = torch.zeros_like(u)
    ones = torch.ones_like(u)
    row_u = torch.stack([ones, zeros, -u], -1)
    row_v = torch.stack([zeros, ones, -v], -1)
    M = (torch.stack([row_u, row_v], -2)[..., :, None, :]
         * alphas[..., None, :, None])                      # [..., N, 2, 4, 3]
    M = M.reshape(*M.shape[:-3], 2, 12)
    return torch.einsum("...nri,...nrj,...n->...ij", M, M, w)


_TRIU_I = [0, 0, 0, 1, 1, 2]
_TRIU_J = [1, 2, 3, 2, 3, 3]


def _solve_beta1(v: torch.Tensor, ctrl_w: torch.Tensor) -> torch.Tensor:
    """Scale one null-space vector [..., 12] so inter-control-point
    distances match the world's → camera control points [..., 4, 3]."""
    cc = v.reshape(*v.shape[:-1], 4, 3)
    d_cam = _norm(cc[..., _TRIU_I, :] - cc[..., _TRIU_J, :])
    d_world = _norm(ctrl_w[..., _TRIU_I, :] - ctrl_w[..., _TRIU_J, :])
    beta = (torch.sum(d_cam * d_world, -1)
            / (torch.sum(d_cam * d_cam, -1) + 1e-12))
    return beta[..., None, None] * cc


def _procrustes(ctrl_w: torch.Tensor, ctrl_c: torch.Tensor,
                alphas: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted Kabsch world→camera transform from control-point
    correspondences over all points → [..., 3, 4]."""
    pts_c = alphas @ ctrl_c
    pts_w = alphas @ ctrl_w
    wsum = torch.sum(w, -1) + 1e-12
    mean_z = torch.sum(pts_c[..., 2] * w, -1) / wsum
    pts_c = pts_c * torch.where(mean_z < 0, -1.0, 1.0)[..., None, None]
    mu_w = torch.sum(pts_w * w[..., None], -2) / wsum[..., None]
    mu_c = torch.sum(pts_c * w[..., None], -2) / wsum[..., None]
    cov = (((pts_c - mu_c[..., None, :]) * w[..., None]).transpose(-1, -2)
           @ (pts_w - mu_w[..., None, :]))
    R, _ = closest_rotation(cov)
    t = mu_c - (R @ mu_w[..., None])[..., 0]
    return torch.cat([R, t[..., None]], -1)


def epnp(pts3d: torch.Tensor, uv_norm: torch.Tensor,
         weights: torch.Tensor) -> torch.Tensor:
    """Weighted EPnP in normalized camera coordinates.

    pts3d [..., N, 3], uv_norm [..., N, 2], weights [..., N] >= 0 → pose
    [..., 3, 4]. The three smallest null-space vectors are beta-case-1
    candidates; the lowest weighted reprojection cost wins."""
    ctrl_w = _control_points(pts3d, weights)
    alphas = _barycentric(pts3d, ctrl_w)
    null3 = smallest_eigvecs3_12(_build_MtM(alphas, uv_norm, weights))
    # the three candidates along a new dim, before each problem's N dim
    vs = null3.transpose(-1, -2)                             # [..., 3, 12]
    ctrl_c = _solve_beta1(vs, ctrl_w[..., None, :, :])
    poses = _procrustes(ctrl_w[..., None, :, :], ctrl_c,
                        alphas[..., None, :, :], weights[..., None, :])
    proj = lie.project(poses, _eye(3, pts3d), pts3d[..., None, :, :])
    err = torch.sum((proj - uv_norm[..., None, :, :]) ** 2, -1)
    costs = (torch.sum(err * weights[..., None, :], -1)
             / (torch.sum(weights, -1, keepdim=True) + 1e-12))
    return _take(poses, costs.argmin(-1, keepdim=True))[..., 0, :, :]


def _take(stack: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """stack [..., H, 3, 4], idx [..., K] → [..., K, 3, 4]."""
    g = idx[..., None, None].expand(*idx.shape, *stack.shape[-2:])
    return torch.gather(stack, -3, g)


def _pick_by_cost(pose_a, cost_a, pose_b, cost_b):
    return torch.where((cost_a <= cost_b)[..., None, None], pose_a, pose_b)


def _sign_cost(pose, pts3d, uv_norm, weights):
    """Weighted reprojection cost plus a 1e6 penalty per point behind the
    camera."""
    cam = lie.transform(pose, pts3d)
    z = cam[..., 2]
    proj = cam[..., :2] / torch.clamp(z.abs(), min=1e-6)[..., None]
    err = torch.sum((proj - uv_norm) ** 2, -1)
    return (torch.sum(err * weights, -1)
            + 1e6 * torch.sum((z <= 0).to(weights.dtype) * weights, -1))


def planar_pnp(pts3d: torch.Tensor, uv_norm: torch.Tensor,
               weights: torch.Tensor) -> torch.Tensor:
    """Homography-based pose for (near-)planar point sets: fit the plane,
    estimate the plane→image homography by DLT and decompose
    H = [r1 r2 t] with a polar orthonormalization. [..., N, *] → [..., 3, 4]."""
    wsum = torch.sum(weights, -1) + 1e-12
    c = torch.sum(pts3d * weights[..., None], -2) / wsum[..., None]
    centered = (pts3d - c[..., None, :]) * torch.sqrt(weights)[..., None]
    cov = centered.transpose(-1, -2) @ centered / wsum[..., None, None]
    normal = _eigh3_sym(cov)[1][..., 0]
    e_seed = _eye(3, pts3d)[normal.abs().argmin(-1)]
    e1 = e_seed - _dot(e_seed, normal, keepdim=True) * normal
    e1 = e1 / torch.clamp(_norm(e1, keepdim=True), min=1e-12)
    e2 = _cross(normal, e1)
    basis = torch.stack([e1, e2, normal], -1)              # columns

    p2 = (pts3d - c[..., None, :]) @ basis[..., :2]       # [..., N, 2]
    P = torch.cat([p2, torch.ones_like(p2[..., :1])], -1)
    zeros = torch.zeros_like(P)
    u = uv_norm[..., 0:1]
    v = uv_norm[..., 1:2]
    A = torch.cat([torch.cat([P, zeros, -u * P], -1),
                   torch.cat([zeros, P, -v * P], -1)], -2)
    w2 = torch.cat([weights, weights], -1)
    AtA = torch.einsum("...ni,...nj,...n->...ij", A, A, w2)
    H = smallest_eigvec(AtA).reshape(*AtA.shape[:-2], 3, 3)

    def extract(sign):
        Hs = sign * H
        h1, h2, h3 = Hs[..., 0], Hs[..., 1], Hs[..., 2]
        lam = (0.5 * (_norm(h1) + _norm(h2)) + 1e-12)[..., None]
        Rp_raw = torch.stack([h1 / lam, h2 / lam,
                              _cross(h1, h2) / (lam * lam)], -1)
        Rp, _ = closest_rotation(Rp_raw)
        t_p = h3 / lam
        R_final = Rp @ basis.transpose(-1, -2)
        t_final = t_p - (R_final @ c[..., None])[..., 0]
        pose = torch.cat([R_final, t_final[..., None]], -1)
        return pose, _sign_cost(pose, pts3d, uv_norm, weights)

    return _pick_by_cost(*extract(1.0), *extract(-1.0))


def p6p_dlt(pts3d: torch.Tensor, uv_norm: torch.Tensor,
            weights: torch.Tensor) -> torch.Tensor:
    """DLT for the full projection matrix from >= 6 correspondences in
    normalized camera coordinates, then rotation extraction.
    [..., N, *] → [..., 3, 4]."""
    X = torch.cat([pts3d, torch.ones_like(pts3d[..., :1])], -1)
    zeros = torch.zeros_like(X)
    u = uv_norm[..., 0:1]
    v = uv_norm[..., 1:2]
    A = torch.cat([torch.cat([X, zeros, -u * X], -1),
                   torch.cat([zeros, X, -v * X], -1)], -2)   # [..., 2N, 12]
    w2 = torch.cat([weights, weights], -1)
    AtA = torch.einsum("...ni,...nj,...n->...ij", A, A, w2)
    P = smallest_eigvec(AtA).reshape(*AtA.shape[:-2], 3, 4)

    def extract(sign):
        Ps = sign * P
        R, lam = closest_rotation(Ps[..., :3])
        lam = torch.where(lam.abs() < 1e-12, 1e-12, lam)
        pose = torch.cat([R, (Ps[..., 3] / lam[..., None])[..., None]], -1)
        return pose, _sign_cost(pose, pts3d, uv_norm, weights)

    return _pick_by_cost(*extract(1.0), *extract(-1.0))


_Z0 = torch.tensor((0.4 + 0.9j) ** np.arange(1, 5), dtype=torch.complex64)


def _quartic_roots(coeffs: torch.Tensor, iters: int = 30) -> torch.Tensor:
    """All four complex roots of quartics [..., 5] (descending powers) by
    fixed-iteration Durand–Kerner in complex64 → [..., 4]."""
    lead = coeffs[..., :1]
    lead = torch.where(lead.abs() < 1e-20, 1e-20, lead)
    c = (coeffs / lead).to(torch.complex64)
    c1, c2, c3, c4 = (c[..., i:i + 1] for i in range(1, 5))
    eye = torch.eye(4, dtype=torch.complex64, device=coeffs.device)
    tiny = torch.tensor(1e-12, dtype=torch.complex64, device=coeffs.device)
    z = _Z0.to(coeffs.device).expand(*coeffs.shape[:-1], 4)
    for _ in range(iters):
        pz = (((z + c1) * z + c2) * z + c3) * z + c4
        denom = torch.prod(z[..., :, None] - z[..., None, :] + eye, -1)
        denom = torch.where(denom.abs() < 1e-12, tiny, denom)
        step = pz / denom
        # clip wild steps (fp32 overflow guard); converged roots stay put
        mag = step.abs()
        step = torch.where(mag > 10.0, step * (10.0 / mag), step)
        z = z - step
    return z


# Vandermonde inverse for degree-4 coefficient extraction from values at
# v ∈ {-2,-1,0,1,2} (rows: coefficient of v^4..v^0).
_V5_INV = np.linalg.inv(
    np.vander(np.array([-2.0, -1.0, 0.0, 1.0, 2.0]), 5)).astype(np.float32)


def p3p(pts3d: torch.Tensor, uv_norm: torch.Tensor) -> torch.Tensor:
    """Grunert P3P: up to 4 poses from 3 correspondences.

    pts3d [..., 3, 3], uv_norm [..., 3, 2] → poses [..., 4, 3, 4];
    infeasible roots give a far-away pose that scores no inliers. The
    quartic in v = s3/s1 is recovered from its residual at 5 abscissae
    through a fixed Vandermonde inverse; roots by Durand–Kerner."""
    dt, dev = pts3d.dtype, pts3d.device
    f = torch.cat([uv_norm, torch.ones_like(uv_norm[..., :1])], -1)
    f = f / _norm(f, keepdim=True)                          # bearings
    P1, P2, P3 = pts3d[..., 0, :], pts3d[..., 1, :], pts3d[..., 2, :]
    a2 = torch.sum((P2 - P3) ** 2, -1)
    b2 = torch.sum((P1 - P3) ** 2, -1)
    c2 = torch.sum((P1 - P2) ** 2, -1)
    b2 = torch.where(b2 < 1e-12, 1e-12, b2)
    cos_a = _dot(f[..., 1, :], f[..., 2, :])
    cos_b = _dot(f[..., 0, :], f[..., 2, :])
    cos_g = _dot(f[..., 0, :], f[..., 1, :])

    ac_b = ((a2 - c2) / b2)[..., None]
    c_b = (c2 / b2)[..., None]
    cb, cg, ca = cos_b[..., None], cos_g[..., None], cos_a[..., None]
    vs = torch.tensor([-2.0, -1.0, 0.0, 1.0, 2.0], dtype=dt, device=dev)
    q = 1.0 + vs * vs - 2.0 * vs * cb
    N = ac_b * q + 1.0 - vs * vs
    D = 2.0 * (cg - vs * ca)
    R = N * N - 2.0 * N * D * cg + D * D * (1.0 - c_b * q)
    coeffs = R @ torch.as_tensor(_V5_INV, device=dev).T      # v^4 .. v^0
    scale = coeffs.abs().amax(-1, keepdim=True) + 1e-20
    z = _quartic_roots(coeffs / scale)                       # [..., 4]

    # every root as its own problem: broadcast the per-sample values
    v = z.real
    ok = (z.imag.abs() < 1e-3 * (1.0 + v.abs())) & (v > 0)
    qv = 1.0 + v * v - 2.0 * v * cb
    qv = torch.where(qv < 1e-12, 1e-12, qv)
    Dv = 2.0 * (cg - v * ca)
    Dv = torch.where(Dv.abs() < 1e-9, torch.where(Dv < 0, -1e-9, 1e-9), Dv)
    u = (ac_b * qv + 1.0 - v * v) / Dv
    s1 = torch.sqrt(b2[..., None] / qv)
    s = torch.stack([s1, u * s1, v * s1], -1)                # [..., 4, 3]
    ok = ok & torch.all(s > 0, -1)
    Xc = s[..., None] * f[..., None, :, :]                   # [..., 4, 3, 3]

    def frame(X):
        e1 = X[..., 1, :] - X[..., 0, :]
        e1 = e1 / (_norm(e1, keepdim=True) + 1e-12)
        n = _cross(e1, X[..., 2, :] - X[..., 0, :])
        n = n / (_norm(n, keepdim=True) + 1e-12)
        return torch.stack([e1, n, _cross(e1, n)], -1)

    Rm = frame(Xc) @ frame(pts3d)[..., None, :, :].transpose(-1, -2)
    t = Xc[..., 0, :] - (Rm @ P1[..., None, :, None])[..., 0]
    pose = torch.cat([Rm, t[..., None]], -1)
    bad = torch.zeros(3, 4, dtype=dt, device=dev)
    bad[:, :3] = torch.eye(3, dtype=dt, device=dev)
    bad[2, 3] = 1e9
    return torch.where(ok[..., None, None], pose, bad)


# ---------------------------------------------------------------------------
# Gauss–Newton SE(3) polish
# ---------------------------------------------------------------------------

def gauss_newton_refine(pose: torch.Tensor, pts3d: torch.Tensor,
                        uv_norm: torch.Tensor, weights: torch.Tensor,
                        iters: int = 5, damping: float = 1e-6) -> torch.Tensor:
    """Fixed-iteration damped Gauss–Newton on the reprojection objective in
    normalized coordinates, left-multiplied SE(3) increments.
    [..., 3, 4] → [..., 3, 4]."""
    sw = torch.sqrt(weights)
    eye3 = _eye(3, pose)
    eye6 = _eye(6, pose)
    for _ in range(iters):
        cam = lie.transform(pose, pts3d)                     # [..., N, 3]
        z_r = torch.clamp(cam[..., 2:3], min=1e-6)
        r = (cam[..., :2] / z_r - uv_norm) * sw[..., None]   # [..., N, 2]
        x, y = cam[..., 0], cam[..., 1]
        iz = 1.0 / torch.clamp(cam[..., 2], min=1e-6)
        iz2 = iz * iz
        zero = torch.zeros_like(iz)
        J_proj = torch.stack([
            torch.stack([iz, zero, -x * iz2], -1),
            torch.stack([zero, iz, -y * iz2], -1)], -2)       # [..., N, 2, 3]
        J_cam = torch.cat([-lie.hat(cam), eye3.expand(*cam.shape, 3)],
                          -1)                                 # [..., N, 3, 6]
        J = (J_proj @ J_cam) * sw[..., None, None]           # [..., N, 2, 6]
        J = J.reshape(*J.shape[:-3], -1, 6)
        r = r.reshape(*r.shape[:-2], -1, 1)
        Jt = J.transpose(-1, -2)
        H = Jt @ J + damping * eye6
        delta = -(_inv_psd(H) @ (Jt @ r))[..., 0]
        dR = lie.so3_exp(delta[..., :3])
        R_new = dR @ pose[..., :3]
        t_new = (dR @ pose[..., 3:])[..., 0] + delta[..., 3:]
        pose = torch.cat([R_new, t_new[..., None]], -1)
    return pose


# ---------------------------------------------------------------------------
# RANSAC
# ---------------------------------------------------------------------------

def _sample_hypothesis_indices(noise: torch.Tensor, mask: torch.Tensor,
                               sample_size: int) -> torch.Tensor:
    """[B, H, S] index subsets of valid slots from noise [B, H, N]: the
    top-S noise values among valid slots, the lower index winning ties
    (as ``jax.lax.top_k`` does)."""
    scored = torch.where(mask[:, None, :], noise, -1.0)
    return _top_k_indices(scored, sample_size)


def _top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest along the last dim, ties to the lower
    index: a stable descending sort (``torch.topk`` promises no tie
    order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)[1][..., :k]


def _gather_points(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, *], idx [B, H, S] → [B, H, S, *]."""
    b = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[b, idx]


# the stages ``ransac_pnp(profile_prefix=...)`` can stop after, in order
PROFILE_PREFIXES = ("solve", "score", "lo", "refit", "full")


def ransac_pnp(pts2d: torch.Tensor, pts3d: torch.Tensor, mask: torch.Tensor,
               K: torch.Tensor, reproj_threshold: float = 5.0,
               num_hypotheses: int = 512, sample_size: int = 6,
               refine_iters: int = 5, lo_hypotheses: int = 64,
               lo_iters: int = 2, noise: Optional[RansacNoise] = None,
               generator: Optional[torch.Generator] = None,
               profile_prefix: Optional[str] = None) -> PnPResult:
    """LO-RANSAC PnP for a batch of frames.

    pts2d [B, N, 2] pixels; pts3d [B, N, 3]; mask [B, N] valid
    correspondences; K [B, 3, 3]. An inlier reprojects within
    ``reproj_threshold`` pixels. Round 1 splits the hypotheses over P3P
    (half), planar homography (a quarter) and P6P DLT (the rest), scored by
    MSAC; round 2 (LO) fits P6P to ``lo_hypotheses`` 8-point samples of the
    best candidate's inliers; every candidate then runs ``lo_iters``
    refit steps (EPnP or planar, one GN step, kept if MSAC does not drop)
    and the winner gets a ``refine_iters`` GN polish.

    ``noise`` injects the sampling noise; without it the noise is drawn
    from ``generator`` on the points' device.

    ``profile_prefix`` (measurement only; None or "full" runs the whole
    solve) stops after a named stage of :data:`PROFILE_PREFIXES` and
    returns the best pose so far: "solve" the first round-1 hypothesis,
    "score" the top-ranked one, "lo" the last candidate (the LO winner,
    or the 4th ranked without an LO round), "refit" the refit winner
    before the polish; with the inliers and count of that pose, ungated,
    and ``success`` True. ``chip_smoke.py`` times the cumulative prefixes.
    No product path sets it.

    A call is the span ``pnp``; its children, in order, are the stages of
    :data:`PROFILE_PREFIXES` (``pnp.solve``, ``pnp.score``, ``pnp.lo``,
    ``pnp.refit``) and ``pnp.polish``, the winner's Gauss-Newton polish
    and final score.
    """
    if profile_prefix not in PROFILE_PREFIXES + (None,):
        raise ValueError(f"profile_prefix {profile_prefix!r} is not one "
                         f"of {PROFILE_PREFIXES}")
    with span("pnp"):
        with span("pnp.solve"):
            B, n = mask.shape
            f32 = torch.float32
            pts2d = pts2d.to(f32)
            pts3d = pts3d.to(f32)
            K = K.to(f32)
            if noise is None:
                noise = draw_noise(B, n, num_hypotheses, lo_hypotheses,
                                   generator, pts3d.device)
            maskf = mask.to(f32)
            n_valid = mask.sum(-1)

            fx, fy = K[:, 0, 0], K[:, 1, 1]
            cx, cy = K[:, 0, 2], K[:, 1, 2]
            uv_norm = torch.stack(
                [(pts2d[..., 0] - cx[:, None]) / fx[:, None],
                 (pts2d[..., 1] - cy[:, None]) / fy[:, None]], -1)
            thr2 = reproj_threshold * reproj_threshold

            def score(pose):
                """pose [B, C, 3, 4] → (good [B, C, N], count [B, C],
                msac [B, C])."""
                cam = lie.transform(pose, pts3d[:, None])
                z = cam[..., 2]
                proj = cam[..., :2] / torch.clamp(z.abs(),
                                                  min=1e-6)[..., None]
                err2 = (((proj[..., 0] - uv_norm[:, None, :, 0])
                         * fx[:, None, None]) ** 2
                        + ((proj[..., 1] - uv_norm[:, None, :, 1])
                           * fy[:, None, None]) ** 2)
                good = (err2 < thr2) & (z > 0) & mask[:, None]
                msac = torch.sum(torch.where(good, 1.0 - err2 / thr2, 0.0),
                                 -1)
                return good, good.sum(-1), msac

            def msac_for(pose):
                return score(pose)[2]

            # all hypotheses at once: one homogeneous [N, 4] x [4, H] product
            # per camera coordinate (the JAX package's score_many form)
            pts_h = torch.cat([pts3d, torch.ones_like(pts3d[..., :1])], -1)

            def score_many(poses):
                """poses [B, H, 3, 4] → msac [B, H]."""
                X, Y, Z = (pts_h @ poses[:, :, r].transpose(-1, -2)
                           for r in range(3))
                az = torch.clamp(Z.abs(), min=1e-6)
                ex = (X / az - uv_norm[..., 0:1]) * fx[:, None, None]
                ey = (Y / az - uv_norm[..., 1:2]) * fy[:, None, None]
                err2 = ex * ex + ey * ey
                good = (err2 < thr2) & (Z > 0) & mask[..., None]
                return torch.sum(torch.where(good, 1.0 - err2 / thr2, 0.0),
                                 1)

            # --- round 1: minimal hypotheses from three solver families ---
            idx3 = _sample_hypothesis_indices(noise.k3, mask, 3)
            idx4 = _sample_hypothesis_indices(noise.k4, mask, 4)
            idx6 = _sample_hypothesis_indices(noise.k6, mask, sample_size)
            poses_p3p = p3p(_gather_points(pts3d, idx3),
                            _gather_points(uv_norm, idx3))
            poses_p3p = poses_p3p.reshape(B, -1, 3, 4)
            poses_pl = planar_pnp(_gather_points(pts3d, idx4),
                                  _gather_points(uv_norm, idx4),
                                  _gather_points(maskf, idx4))
            poses_p6 = p6p_dlt(_gather_points(pts3d, idx6),
                               _gather_points(uv_norm, idx6),
                               _gather_points(maskf, idx6))
            poses = torch.cat([poses_p3p, poses_pl, poses_p6], 1)

            def prefix_result(pose):
                good, count, _ = score(pose[:, None])
                return PnPResult(pose, good[:, 0],
                                 count[:, 0].to(torch.int32),
                                 torch.ones(B, dtype=torch.bool,
                                            device=pose.device))

            if profile_prefix == "solve":
                return prefix_result(poses[:, 0])

        with span("pnp.score"):
            # [B, 4, 3, 4]
            cands = _take(poses, _top_k_indices(score_many(poses), 4))

            if profile_prefix == "score":
                return prefix_result(cands[:, 0])

        with span("pnp.lo"):
            # --- round 2 (LO): non-minimal resampling from the consensus
            # set ---
            if lo_hypotheses > 0:
                lo_inl = score(cands[:, :1])[0][:, 0]
                idx_lo = _sample_hypothesis_indices(noise.lo, lo_inl, 8)
                poses_lo = p6p_dlt(_gather_points(pts3d, idx_lo),
                                   _gather_points(uv_norm, idx_lo),
                                   _gather_points(maskf, idx_lo))
                best_lo = _take(poses_lo, score_many(poses_lo).argmax(
                    -1, keepdim=True))
                cands = torch.cat([cands, best_lo], 1)

            if profile_prefix == "lo":
                return prefix_result(cands[:, -1])

        with span("pnp.refit"):
            # --- iterated refit chains on every candidate + one GN step
            # each ---
            C = cands.shape[1]
            p3 = pts3d[:, None].expand(B, C, n, 3)
            uvc = uv_norm[:, None].expand(B, C, n, 2)
            pose = cands
            for _ in range(max(lo_iters, 1)):
                w = score(pose)[0].to(f32)
                pose_g = epnp(p3, uvc, w + 1e-9)
                pose_p = planar_pnp(p3, uvc, w + 1e-9)
                pose_r = torch.where(
                    (msac_for(pose_g) >= msac_for(pose_p))[..., None, None],
                    pose_g, pose_p)
                pose_r = gauss_newton_refine(pose_r, p3, uvc, w,
                                             iters=min(1, refine_iters))
                better = msac_for(pose_r) >= msac_for(pose)
                pose = torch.where(better[..., None, None], pose_r, pose)
            pose_best = _take(pose,
                              score_many(pose).argmax(-1, keepdim=True))

            if profile_prefix == "refit":
                return prefix_result(pose_best[:, 0])

        with span("pnp.polish"):
            # full-strength GN polish on the winner's inlier set, kept only
            # if it does not lose consensus
            if refine_iters > 0:
                inl_b = score(pose_best)[0].to(f32)
                pose_pol = gauss_newton_refine(pose_best, pts3d[:, None],
                                               uv_norm[:, None], inl_b,
                                               iters=refine_iters)
                keep = msac_for(pose_pol) >= msac_for(pose_best)
                pose_best = torch.where(keep[..., None, None], pose_pol,
                                        pose_best)

            inliers, count, _ = score(pose_best)
            inliers, count = inliers[:, 0], count[:, 0]
            pose_best = pose_best[:, 0]
            min_inl = min(sample_size, 4)
            success = (n_valid >= min_inl) & (count >= min_inl)
            eye34 = torch.eye(3, 4, dtype=f32, device=pose_best.device)
            pose_final = torch.where(success[:, None, None], pose_best, eye34)
            return PnPResult(pose_final, inliers & success[:, None],
                             torch.where(success, count, 0).to(torch.int32),
                             success)
