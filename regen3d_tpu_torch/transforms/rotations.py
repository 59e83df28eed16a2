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
