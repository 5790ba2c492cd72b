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


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] → [..., 3] axis-angle. Stable away from theta = pi."""
    trace = R.diagonal(dim1=-2, dim2=-1).sum(-1)
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
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
    return scale[..., None] * w_hat


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
