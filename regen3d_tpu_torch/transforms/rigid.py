"""Rigid / similarity transforms (counterpart of
regen3d_tpu/transforms/rigid.py).

Convention: row vectors, ``x' = x @ R * s + t`` — consistent with the camera
view transform in :mod:`regen3d_tpu_torch.camera`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class Transform3d(NamedTuple):
    """Similarity transform ``x' = (x @ R) * s + t`` (row-vector convention)."""

    R: torch.Tensor  # (3, 3)
    t: torch.Tensor  # (3,)
    s: torch.Tensor  # scalar

    @classmethod
    def identity(cls, dtype=torch.float32, device="cuda") -> "Transform3d":
        return cls(torch.eye(3, dtype=dtype, device=device),
                   torch.zeros(3, dtype=dtype, device=device),
                   torch.ones((), dtype=dtype, device=device))

    def apply(self, points: torch.Tensor) -> torch.Tensor:
        return (points @ self.R) * self.s + self.t

    def compose(self, other: "Transform3d") -> "Transform3d":
        """self then other: x @ (R1 s1) + t1 → @ (R2 s2) + t2."""
        return Transform3d(
            R=self.R @ other.R,
            t=(self.t @ other.R) * other.s + other.t,
            s=self.s * other.s,
        )

    def inverse(self) -> "Transform3d":
        R_inv = self.R.T
        s_inv = 1.0 / self.s
        return Transform3d(R=R_inv, t=-(self.t @ R_inv) * s_inv, s=s_inv)

    def as_matrix(self) -> torch.Tensor:
        """4x4 homogeneous matrix for row vectors: [x 1] @ M."""
        M = torch.eye(4, dtype=self.R.dtype, device=self.R.device)
        M[:3, :3] = self.R * self.s
        M[3, :3] = self.t
        return M


def kabsch(
    src: torch.Tensor,
    dst: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Optimal rotation+translation aligning src→dst: ``src @ R + t ≈ dst``.
    Weighted least squares, reflection-free."""
    R, t, _ = umeyama(src, dst, weights=weights, estimate_scale=False)
    return R, t


def umeyama(
    src: torch.Tensor,
    dst: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    estimate_scale: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Similarity solve: (R, t, s) minimising Σ w ‖(src @ R) s + t − dst‖²
    (Umeyama's closed form)."""
    if weights is None:
        weights = torch.ones(src.shape[0], dtype=src.dtype, device=src.device)
    w = weights / torch.clamp(weights.sum(), min=1e-12)
    mu_src = (src * w[:, None]).sum(0)
    mu_dst = (dst * w[:, None]).sum(0)
    src_c = src - mu_src
    dst_c = dst - mu_dst
    # cross-covariance for the row convention: R ≈ argmax tr(Rᵀ src_cᵀ W dst_c)
    H = (src_c * w[:, None]).T @ dst_c
    U, S, Vt = torch.linalg.svd(H)
    det = torch.linalg.det(U @ Vt)
    d = torch.ones(3, dtype=src.dtype, device=src.device)
    d[2] = torch.sign(det) + (det == 0).to(src.dtype)
    D = torch.diag(d)
    R = U @ D @ Vt
    var_src = (w * (src_c * src_c).sum(-1)).sum()
    if estimate_scale:
        s = (S * d).sum() / torch.clamp(var_src, min=1e-12)
    else:
        s = torch.ones((), dtype=src.dtype, device=src.device)
    t = mu_dst - (mu_src @ R) * s
    return R, t, s
