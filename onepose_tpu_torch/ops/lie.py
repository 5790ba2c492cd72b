"""SO(3)/SE(3) utilities on tensors, batched over leading dimensions.

Port of ``onepose_tpu/ops/lie.py``: closed-form Rodrigues map and its
inverse, rigid transforms and pinhole projection.
"""
from __future__ import annotations

import torch


def hat(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] → [..., 3, 3] skew-symmetric matrices."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([zeros, -wz, wy], dim=-1),
        torch.stack([wz, zeros, -wx], dim=-1),
        torch.stack([-wy, wx, zeros], dim=-1),
    ], dim=-2)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula with a Taylor fallback near zero.
    [..., 3] → [..., 3, 3]."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + 1e-32)
    K = hat(w)
    KK = K @ K
    small = theta < 1e-5
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * K + b[..., None, None] * KK


# so3_log's switch to the symmetric part: theta above 171.9 degrees. In
# fp32 the skew part's round trip is within 2e-6 up to 165 degrees and
# 1.2e-5 at 172; the symmetric part's is within 6e-7 at every angle
NEAR_PI_COS = -0.99


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] → [..., 3] axis-angle.

    Away from theta = pi: ``theta / (2 sin theta)`` times the skew part,
    the JAX package's formula. Towards pi that divides by a vanishing
    sine, and the JAX package's ``so3_log`` loses the axis there; above
    171.9 degrees (cos theta < ``NEAR_PI_COS``) the port takes the axis
    from the symmetric part instead, ``(S - cos theta I) / (1 - cos
    theta) = a a^T``, the column of its largest diagonal entry
    normalised, signed by the skew part, and theta from ``atan2(sin,
    cos)``, which keeps its precision at pi."""
    trace = R.diagonal(dim1=-2, dim2=-1).sum(-1)
    cos_raw = (trace - 1.0) / 2.0
    cos_theta = torch.clamp(cos_raw, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w_hat = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], dim=-1)
    small = theta < 1e-5
    scale = torch.where(
        small, 0.5 + theta * theta / 12.0,
        theta / (2.0 * torch.sin(torch.where(small, 1.0, theta))))
    w = scale[..., None] * w_hat

    near = cos_raw < NEAR_PI_COS
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    aat = ((R + R.transpose(-1, -2)) / 2.0 - cos_theta[..., None, None]
           * eye) / (1.0 - cos_theta)[..., None, None]
    col = aat.diagonal(dim1=-2, dim2=-1).argmax(-1)
    a = torch.take_along_dim(aat, col[..., None, None], dim=-1)[..., 0]
    a = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True).clamp(
        min=1e-30)
    a = torch.where((a * w_hat).sum(-1, keepdim=True) < 0, -a, a)
    theta_pi = torch.atan2(
        torch.linalg.vector_norm(w_hat, dim=-1) / 2.0, cos_raw)
    return torch.where(near[..., None], theta_pi[..., None] * a, w)


def transform(pose: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply [..., 3, 4] pose to [..., N, 3] points → camera-frame points."""
    R = pose[..., :3, :3]
    t = pose[..., :3, 3]
    return pts @ R.transpose(-1, -2) + t[..., None, :]


def project(pose: torch.Tensor, K: torch.Tensor, pts: torch.Tensor,
            eps: float = 1e-9) -> torch.Tensor:
    """Project [..., N, 3] object points to pixels with [..., 3, 4] pose and
    [..., 3, 3] intrinsics → [..., N, 2]."""
    uv = transform(pose, pts) @ K.transpose(-1, -2)
    z = uv[..., 2:3]
    z = torch.where(z.abs() < eps, torch.where(z < 0, -eps, eps), z)
    return uv[..., :2] / z
