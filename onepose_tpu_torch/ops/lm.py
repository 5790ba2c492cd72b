"""Levenberg–Marquardt bundle adjustment, on tensors.

Port of ``onepose_tpu/ops/lm.py``: cameras [C, 6] (angle-axis,
translation), points [P, 3], observations padded to a fixed budget with a
validity mask; analytic Jacobians; the normal equations reduced by the
Schur complement on the cameras (per-point 3x3 blocks inverted, the
camera system dense 6C x 6C); a fixed number of damped LM iterations
with gain-ratio damping, the step chosen on the device (no host sync).
``fix_cameras`` / ``fix_points`` cover point-only refinement and
extrinsics-only BA.

Translations from the JAX version:
- ``segment_sum`` → :func:`segment_sum`: the observations are sorted
  by segment once a solve (a stable sort, :func:`segment_matrix`), and
  each solve's sums gather the rows in that order and reduce each
  segment's run with ``torch.segment_reduce``, whose kernels add a
  segment's rows in a fixed order, in fp64, rounded to fp32 once (a
  sequential fp32 sum over a camera's thousands of observations would
  round more than the blocked sums of a matrix product). Time and memory
  are linear in the observations. ``index_add_`` and ``index_put_`` with ``accumulate`` add
  with atomics (``index_add_`` on a card, ``index_put_`` on the CPU), so
  their bits change from run to run; these sums' do not, so a run can be
  held bit for bit against another on the same device. The card's
  summation order is not the CPU's, so card vs CPU is a tolerance;
- the Schur complement's per-point camera blocks ``Wp`` [P, C*6, 3] are
  one such sum keyed by ``point * C + camera``, not a dense scatter of
  every observation over every camera;
- ``lax.scan`` → a Python loop over ``iterations``;
- ``jnp.linalg.inv`` of the [P, 3, 3] blocks → ``torch.linalg.inv_ex``
  (LU, as JAX's; no error check, so no sync);
- ``cho_factor`` → ``torch.linalg.cholesky_ex``. JAX's factor is NaN on a
  matrix that is not positive definite, so the step's cost is NaN and the
  step is rejected; ``cholesky_ex`` reports it in ``info`` and leaves a
  partial factor whose solve is finite garbage, so :func:`solve_ba`
  rejects the step where ``info != 0``.
Every product here must run in full fp32 (``ops.precision.pin_fp32``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from onepose_tpu_torch.ops import lie


class BAProblem(NamedTuple):
    """cameras: [C, 6] (w, t); points: [P, 3]; observations:
    cam_idx [O], pt_idx [O], uv [O, 2] pixels, K [O, 4] (fx, fy, cx, cy),
    mask [O]."""

    cameras: torch.Tensor
    points: torch.Tensor
    cam_idx: torch.Tensor
    pt_idx: torch.Tensor
    uv: torch.Tensor
    K: torch.Tensor
    mask: torch.Tensor


class BAResult(NamedTuple):
    cameras: torch.Tensor
    points: torch.Tensor
    initial_cost: torch.Tensor
    final_cost: torch.Tensor


class Segments(NamedTuple):
    """The sparse form of the 0/1 segment matrix [n, O] whose entry
    (s, o) is 1 where ``ids[o] == s``: ``order`` [O] the observations
    sorted by segment (stable, so each segment keeps its observations in
    their order) and ``lengths`` [n] the size of each segment."""

    order: torch.Tensor
    lengths: torch.Tensor

    def to(self, device) -> "Segments":
        return Segments(self.order.to(device), self.lengths.to(device))


def segment_matrix(ids: torch.Tensor, n: int) -> Segments:
    """The observations ``ids`` [O] (each in [0, n)) grouped by segment."""
    ids = ids.long()
    return Segments(torch.sort(ids, stable=True).indices,
                    torch.bincount(ids, minlength=n))


def segment_sum(data: torch.Tensor, seg: Segments) -> torch.Tensor:
    """Sums of the rows of ``data`` [O, ...] by segment → [n, ...], each
    segment's rows added in a fixed order in fp64 and rounded once
    (empty segments are 0)."""
    rows = data.reshape(data.shape[0], -1)[seg.order].double()
    out = torch.segment_reduce(rows, "sum", lengths=seg.lengths, axis=0,
                               unsafe=True)
    return out.to(data.dtype).reshape(seg.lengths.shape[0], *data.shape[1:])


def _cam_point(cameras, points, cam_idx, pt_idx):
    cam = cameras[cam_idx]               # [O, 6]
    R = lie.so3_exp(cam[:, :3])          # [O, 3, 3]
    p = (R @ points[pt_idx][:, :, None])[:, :, 0] + cam[:, 3:6]
    return R, p


def project_obs(cameras, points, cam_idx, pt_idx, K):
    """Per-observation projection → [O, 2] pixels and depths [O]."""
    _, p = _cam_point(cameras, points, cam_idx, pt_idx)
    z = p[:, 2]
    zs = torch.where(z.abs() < 1e-8, 1e-8, z)
    u = K[:, 0] * (p[:, 0] / zs) + K[:, 2]
    v = K[:, 1] * (p[:, 1] / zs) + K[:, 3]
    return torch.stack([u, v], dim=1), z


def residuals(cameras, points, cam_idx, pt_idx, uv, K, mask):
    pred, _ = project_obs(cameras, points, cam_idx, pt_idx, K)
    return (pred - uv) * mask[:, None]


def _obs_jacobians(cameras, points, cam_idx, pt_idx, K, mask):
    """Analytic per-observation Jacobians → (Jc [O, 2, 6], Jp [O, 2, 3],
    predicted pixels [O, 2]). The camera increment is left-multiplicative:
    R ← exp(dw) R, t ← exp(dw) t + dt."""
    R, p = _cam_point(cameras, points, cam_idx, pt_idx)
    z = torch.where(p[:, 2].abs() < 1e-8, 1e-8, p[:, 2])
    iz = 1.0 / z
    iz2 = iz * iz
    fx, fy = K[:, 0], K[:, 1]

    zero = torch.zeros_like(iz)
    J_proj = torch.stack([                      # d(uv)/d(p): [O, 2, 3]
        torch.stack([fx * iz, zero, -fx * p[:, 0] * iz2], dim=-1),
        torch.stack([zero, fy * iz, -fy * p[:, 1] * iz2], dim=-1),
    ], dim=1)
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(p.shape[0], 3, 3)
    J_cam = torch.cat([-lie.hat(p), eye], dim=-1)   # d(p)/d(cam): [O, 3, 6]
    Jc = J_proj @ J_cam
    Jp = J_proj @ R                                 # d(p)/d(X) = R

    pred = torch.stack([fx * p[:, 0] * iz + K[:, 2],
                        fy * p[:, 1] * iz + K[:, 3]], dim=1)
    m = mask[:, None, None]
    return Jc * m, Jp * m, pred


def _precond_solve(A: torch.Tensor, b: torch.Tensor):
    """Jacobi-preconditioned Cholesky solve with one step of iterative
    refinement → (x, ok). ``ok`` is False where A is not positive definite
    (the factorization failed); x is then meaningless."""
    d = torch.rsqrt(torch.clamp(torch.diagonal(A), min=1e-12))
    A_s = A * d[:, None] * d[None, :]
    b_s = (b * d)[:, None]
    L, info = torch.linalg.cholesky_ex(A_s)
    y = torch.cholesky_solve(b_s, L)
    y = y + torch.cholesky_solve(b_s - A_s @ y, L)
    return y[:, 0] * d, info == 0


def _to_dense_cams(Hcc: torch.Tensor, lam_eye6: torch.Tensor):
    """[C, 6, 6] block-diagonal → dense [C*6, C*6] with damping."""
    H = Hcc + lam_eye6[None] + 1e-8 * torch.eye(
        6, dtype=Hcc.dtype, device=Hcc.device)[None]
    return torch.block_diag(*H.unbind(0))


def _apply_update(cams, pts, dc, dp, fix_cameras, fix_points,
                  fix_first_camera):
    if fix_first_camera and not fix_cameras:
        dc = torch.cat([torch.zeros_like(dc[:1]), dc[1:]])
    if fix_cameras:
        cams_new = cams
    else:
        dR = lie.so3_exp(dc[:, :3])
        w_new = lie.so3_log(dR @ lie.so3_exp(cams[:, :3]))
        t_new = (dR @ cams[:, 3:6, None])[:, :, 0] + dc[:, 3:6]
        cams_new = torch.cat([w_new, t_new], dim=1)
    pts_new = pts if fix_points else pts + dp
    return cams_new, pts_new


def solve_ba(problem: BAProblem, iterations: int = 10,
             init_lambda: float = 1e-3, fix_cameras: bool = False,
             fix_points: bool = False,
             fix_first_camera: bool = True) -> BAResult:
    """Damped LM with the Schur complement. All shapes static."""
    C = problem.cameras.shape[0]
    P = problem.points.shape[0]
    cam_idx, pt_idx = problem.cam_idx.long(), problem.pt_idx.long()
    uv, K = problem.uv, problem.K
    mask = problem.mask.float()
    dev = uv.device
    eye3 = torch.eye(3, device=dev)
    eye6 = torch.eye(6, device=dev)
    seg_cam = segment_matrix(cam_idx, C)
    seg_pt = None if fix_points else segment_matrix(pt_idx, P)
    # each point's blocks, camera by camera: the segment of (point, camera)
    seg_pt_cam = (None if fix_points or fix_cameras
                  else segment_matrix(pt_idx * C + cam_idx, P * C))

    def cost(cams, pts):
        r = residuals(cams, pts, cam_idx, pt_idx, uv, K, mask)
        return torch.sum(r * r)

    def lm_step(cams, pts, lam):
        """→ (cameras, points, solve_ok) of one damped step."""
        Jc, Jp, pred = _obs_jacobians(cams, pts, cam_idx, pt_idx, K, mask)
        r = (pred - uv) * mask[:, None]                     # [O, 2]
        Jct = Jc.transpose(1, 2)
        Jpt = Jp.transpose(1, 2)

        lam_eye6 = lam * eye6
        if fix_points or not fix_cameras:
            Hcc = segment_sum(Jct @ Jc, seg_cam)         # [C, 6, 6]
            gc = segment_sum((Jct @ r[:, :, None])[:, :, 0], seg_cam)
        if fix_points:                  # the camera-only system
            dc, ok = _precond_solve(_to_dense_cams(Hcc, lam_eye6),
                                    gc.reshape(C * 6))
            cams_new, pts_new = _apply_update(
                cams, pts, -dc.reshape(C, 6), torch.zeros_like(pts),
                fix_cameras, fix_points, fix_first_camera)
            return cams_new, pts_new, ok

        Hpp = segment_sum(Jpt @ Jp, seg_pt)              # [P, 3, 3]
        gp = segment_sum((Jpt @ r[:, :, None])[:, :, 0], seg_pt)
        Hpp_inv = torch.linalg.inv_ex(Hpp + lam * eye3 + 1e-8 * eye3)[0]
        if fix_cameras:                 # points only: no linear solve
            dp = -(Hpp_inv @ gp[:, :, None])[:, :, 0]
            cams_new, pts_new = _apply_update(
                cams, pts, torch.zeros_like(cams), dp, fix_cameras,
                fix_points, fix_first_camera)
            return cams_new, pts_new, torch.ones((), dtype=torch.bool,
                                                 device=dev)

        if fix_first_camera:
            # the gauge fixed inside the system: a huge prior on camera 0
            gauge = 1e6 * Hcc.abs().amax()
            Hcc = torch.cat([Hcc[:1] + gauge * eye6, Hcc[1:]])

        # Schur complement on the cameras, with each point's camera blocks
        # laid out densely: Wp [P, C*6, 3]
        Wp = segment_sum(Jct @ Jp, seg_pt_cam).reshape(P, C * 6, 3)
        WpHi = Wp @ Hpp_inv                                 # [P, C6, 3]
        S = _to_dense_cams(Hcc, lam_eye6) - torch.einsum(
            "pax,pbx->ab", WpHi, Wp)
        gp_tilde = (Hpp_inv @ gp[:, :, None])[:, :, 0]      # [P, 3]
        g_schur = gc.reshape(C * 6) - torch.einsum(
            "pax,px->a", Wp, gp_tilde)

        dc, ok = _precond_solve(S, g_schur)
        dc = -dc
        # back-substitute the points: dp = -Hpp^-1 (gp + Hpc dc)
        Hpc_dc = torch.einsum("pax,a->px", Wp, dc)
        dp = -(Hpp_inv @ (gp + Hpc_dc)[:, :, None])[:, :, 0]
        cams_new, pts_new = _apply_update(
            cams, pts, dc.reshape(C, 6), dp, fix_cameras, fix_points,
            fix_first_camera)
        return cams_new, pts_new, ok

    cams, pts = problem.cameras, problem.points
    lam = torch.full((), init_lambda, device=dev)
    c_init = cost(cams, pts)
    for _ in range(iterations):
        c0 = cost(cams, pts)
        cams_new, pts_new, ok = lm_step(cams, pts, lam)
        improved = ok & (cost(cams_new, pts_new) < c0)
        cams = torch.where(improved, cams_new, cams)
        pts = torch.where(improved, pts_new, pts)
        lam = torch.where(improved, torch.clamp(lam * 0.5, min=1e-8),
                          torch.clamp(lam * 4.0, max=1e6))
    return BAResult(cams, pts, c_init, cost(cams, pts))


def pose_to_camera(pose: torch.Tensor) -> torch.Tensor:
    """[..., 3, 4] or [..., 4, 4] world→camera pose → [..., 6]
    (angle-axis, t)."""
    return torch.cat([lie.so3_log(pose[..., :3, :3]), pose[..., :3, 3]], -1)


def camera_to_pose(cam: torch.Tensor) -> torch.Tensor:
    """[..., 6] → [..., 3, 4]."""
    return torch.cat([lie.so3_exp(cam[..., :3]), cam[..., 3:6, None]], -1)
