"""Plane fitting: total-least-squares SVD and batched RANSAC (counterpart of
regen3d_tpu/ops/plane.py; reference pose_matching_planar.py:402-474, the
floor snap of on-floor objects).

Every RANSAC hypothesis is scored in one (N, num_iters) pass, then the best
is refit by weighted SVD on its inliers. The JAX package draws its
(num_iters, 3) sample indices from ``jax.random``, which torch cannot
reproduce: :func:`fit_plane_ransac` takes a ``torch.Generator`` or the draw
itself. Ties in the inlier count go to the first hypothesis, as
``jnp.argmax`` and ``torch.argmax`` both give them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from regen3d_tpu_torch.ops import full_f32
from regen3d_tpu_torch.transforms.rigid import Transform3d


class Plane(NamedTuple):
    """n·x + d = 0 with ‖n‖ = 1."""

    normal: torch.Tensor    # (3,)
    offset: torch.Tensor    # scalar d
    centroid: torch.Tensor  # (3,) fit centroid (on the plane)

    def signed_distance(self, pts: torch.Tensor) -> torch.Tensor:
        return pts @ self.normal + self.offset

    def project(self, pts: torch.Tensor) -> torch.Tensor:
        return pts - self.signed_distance(pts)[..., None] * self.normal


def fit_plane_svd(
    points: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    up_hint: Optional[torch.Tensor] = None,
) -> Plane:
    """Total-least-squares plane through weighted points (smallest principal
    axis of the covariance). ``up_hint`` flips the normal into a half-space."""
    if weights is None:
        weights = torch.ones(points.shape[0], dtype=points.dtype,
                             device=points.device)
    w = weights / torch.clamp_min(weights.sum(), 1e-12)
    mu = (points * w[:, None]).sum(0)
    x = points - mu
    with full_f32():
        cov = (x * w[:, None]).T @ x
    _, vecs = torch.linalg.eigh(cov)
    n = vecs[:, 0]
    if up_hint is not None:
        n = n * torch.sign((n * up_hint).sum() + 1e-12)
    return Plane(normal=n, offset=-(n * mu).sum(), centroid=mu)


def fit_plane_ransac(
    points: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    num_iters: int = 2000,
    threshold: float = 0.05,
    up_hint: Optional[torch.Tensor] = None,
    idx: Optional[torch.Tensor] = None,
) -> Tuple[Plane, torch.Tensor]:
    """RANSAC plane + SVD refit on inliers → (plane, inlier mask).

    The (num_iters, 3) sample indices are ``idx`` where given, else drawn
    uniformly from ``generator`` (a generator on the points' device)."""
    n_pts = points.shape[0]
    if idx is None:
        idx = torch.randint(0, n_pts, (num_iters, 3), generator=generator,
                            device=points.device)
    tri = points[idx.long()]                            # (I, 3, 3)
    normals = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    norm = torch.linalg.norm(normals, dim=-1, keepdim=True)
    normals = normals / torch.clamp_min(norm, 1e-12)
    d = -(normals * tri[:, 0]).sum(-1)                  # (I,)
    # degenerate (collinear) samples score no inliers
    valid = norm[:, 0] > 1e-9
    with full_f32():
        dist = (points @ normals.T + d[None, :]).abs()  # (N, I)
        inliers = (dist < threshold).sum(0)
        inliers = torch.where(valid, inliers, torch.full_like(inliers, -1))
        best = torch.argmax(inliers)
        inlier_mask = (points @ normals[best] + d[best]).abs() < threshold
    plane = fit_plane_svd(points, weights=inlier_mask.to(points.dtype),
                          up_hint=up_hint)
    return plane, inlier_mask


def plane_transforms(plane: Plane, dtype=torch.float32
                     ) -> Tuple[Transform3d, Transform3d]:
    """(world→plane, plane→world) with the normal mapped to +Y and the origin
    at the fit centroid (reference: get_plane_transforms,
    pose_matching_planar.py:103-182)."""
    n = plane.normal.to(dtype)
    dev = n.device
    helper = (torch.tensor([1.0, 0.0, 0.0], dtype=dtype, device=dev)
              if bool(n[0].abs() < 0.9)
              else torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=dev))
    t1 = torch.linalg.cross(helper, n)
    t1 = t1 / torch.clamp_min(torch.linalg.norm(t1), 1e-12)
    t2 = torch.linalg.cross(n, t1)
    # row-vector convention: x_plane = (x_world − c) @ R, R's columns the axes
    R = torch.stack([t1, n, t2], dim=-1)
    c = plane.centroid.to(dtype)
    world_to_plane = Transform3d(R=R, t=-(c @ R),
                                 s=torch.ones((), dtype=dtype, device=dev))
    return world_to_plane, world_to_plane.inverse()
