"""Y-up oriented bounding box via 2D PCA in the ground (XZ) plane
(counterpart of regen3d_tpu/ops/obb.py; reference:
pose_matching_planar.py:337-377, the coarse pose init).

The major footprint axis is the top eigenvector of a 2×2 covariance. Where
the two eigenvalues tie (a square or round footprint) any axis is a major
axis, and LAPACK and cuSOLVER may return different ones: the box, and with
it ``volume``, then differ between the two (ROADMAP Queue 3 r).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class OBB(NamedTuple):
    center: torch.Tensor        # (3,)
    axes: torch.Tensor          # (3, 3) rows = box axes in world
    half_extents: torch.Tensor  # (3,)

    @property
    def volume(self) -> torch.Tensor:
        return 8.0 * torch.prod(self.half_extents)

    def corners(self) -> torch.Tensor:
        """(8, 3) world-space box corners."""
        signs = torch.tensor(
            [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
            dtype=self.center.dtype, device=self.center.device)
        return self.center + (signs * self.half_extents) @ self.axes


def oriented_bounding_box_2d_up(
    points: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> OBB:
    """Fit a Y-up OBB: PCA of the XZ footprint gives the yaw, Y is vertical.
    Padded points are excluded through ``mask``."""
    if mask is None:
        w = torch.ones(points.shape[0], dtype=points.dtype, device=points.device)
    else:
        w = mask.to(points.dtype)
    wsum = torch.clamp_min(w.sum(), 1e-12)
    mu = (points * w[:, None]).sum(0) / wsum

    xz = (points - mu)[:, [0, 2]]               # (N, 2) footprint
    cov = (xz * w[:, None]).T @ xz / wsum       # (2, 2)
    _, vecs = torch.linalg.eigh(cov)            # ascending; columns are axes
    a = vecs[:, 1]                              # major footprint axis
    zero, one = torch.zeros_like(a[0]), torch.ones_like(a[0])
    # right-handed world axes: major in XZ, +Y up, minor = up × major
    ax_major = torch.stack([a[0], zero, a[1]])
    ax_up = torch.stack([zero, one, zero])
    ax_minor = torch.linalg.cross(ax_up, ax_major)
    axes = torch.stack([ax_major, ax_up, ax_minor], 0)

    local = (points - mu) @ axes.T              # (N, 3) in box frame
    big = torch.tensor(1e30, dtype=points.dtype, device=points.device)
    valid = w[:, None] > 0
    lo = torch.where(valid, local, big).min(0).values
    hi = torch.where(valid, local, -big).max(0).values
    center = mu + (0.5 * (lo + hi)) @ axes
    return OBB(center=center, axes=axes, half_extents=0.5 * (hi - lo))


def aabb(points: torch.Tensor, mask: Optional[torch.Tensor] = None,
         pad: float = 0.0):
    """Axis-aligned bounds (min, max) with symmetric padding (the background
    bbox hinge loss; reference pose_matching_planar.py:1490-1561)."""
    if mask is None:
        lo, hi = points.min(0).values, points.max(0).values
    else:
        big = torch.tensor(1e30, dtype=points.dtype, device=points.device)
        m = mask[:, None]
        lo = torch.where(m, points, big).min(0).values
        hi = torch.where(m, points, -big).max(0).values
    return lo - pad, hi + pad
