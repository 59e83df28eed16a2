"""SO(3) helpers on tensors (counterpart of regen3d_tpu/transforms/rotations.py).

Rotation matrices act on ROW vectors from the right (``x_rot = x @ R``).
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector: hat(v) @ x = v × x."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def so3_exp(log_rot: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) → rotation matrix (..., 3, 3), Rodrigues with the
    eps inside the sqrt so gradients are finite at the identity."""
    theta2 = torch.sum(log_rot * log_rot, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    sin_over = torch.sin(theta) / theta
    one_minus_cos_over = (1.0 - torch.cos(theta)) / (theta * theta)
    K = _hat(log_rot)
    KK = K @ K
    eye = torch.eye(3, dtype=log_rot.dtype, device=log_rot.device).expand(K.shape)
    return (eye + sin_over[..., None, None] * K
            + one_minus_cos_over[..., None, None] * KK)


def yaw_rotation(yaw: torch.Tensor) -> torch.Tensor:
    """Rotation about +Y: [[c, 0, s], [0, 1, 0], [-s, 0, c]]."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    rows = [[c, zero, s], [zero, one, zero], [-s, zero, c]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) wxyz → rotation matrix (..., 3, 3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) → axis-angle (..., 3), angle ≤ π: the
    antisymmetric part with a Taylor-safe scale θ / max(2 sin θ, eps), and
    for θ > 3 the axis from the diagonal (R_ii = cos θ + a_i²(1 − cos θ))
    with the antisymmetric part's signs."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_theta)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    scale = theta / torch.clamp(2.0 * torch.sin(theta), min=_EPS)
    v_std = w * scale[..., None]
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    denom = torch.clamp(1.0 - cos_theta, min=_EPS)[..., None]
    axis_abs = torch.sqrt(torch.clamp((diag - cos_theta[..., None]) / denom,
                                      0.0, 1.0))
    sign = torch.where(w >= 0, 1.0, -1.0)
    v_pi = theta[..., None] * axis_abs * sign
    return torch.where((theta > 3.0)[..., None], v_pi, v_std)


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) → unit quaternion (..., 4) wxyz, with
    w ≥ 0: Shepperd's four candidates without branches, the one with the
    largest pivot taken (the first among ties, as ``jnp.argmax``), eps
    inside each root."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=0.0) + _EPS)

    qw0 = safe_sqrt(1.0 + tr) / 2.0
    q0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0)], -1)
    qx1 = safe_sqrt(1.0 + m00 - m11 - m22) / 2.0
    q1 = torch.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
                      (m02 + m20) / (4 * qx1)], -1)
    qy2 = safe_sqrt(1.0 - m00 + m11 - m22) / 2.0
    q2 = torch.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
                      (m12 + m21) / (4 * qy2)], -1)
    qz3 = safe_sqrt(1.0 - m00 - m11 + m22) / 2.0
    q3 = torch.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
                      (m12 + m21) / (4 * qz3), qz3], -1)
    pivots = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22,
                          m22 - m00 - m11], -1)
    best = torch.argmax(pivots, dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)            # (..., 4, 4)
    q = torch.take_along_dim(qs, best[..., None, None], dim=-2)[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)
