"""Mesh surface sampling (counterpart of regen3d_tpu/ops/sampling.py; the
pytorch3d ``sample_points_from_meshes`` analog).

Used for GLB → point-cloud conversion (reference: global_utils.py:739-744,
100k samples at scene_optim.py:213-235) and metric evaluation.

The JAX package draws with ``jax.random`` (a Gumbel categorical over
log-areas and uniform barycentrics), a stream torch cannot reproduce. The
port splits the sampler into its draws and a deterministic
:func:`points_from_draws`:

* :func:`draw_samples` makes (S, 3) uniforms with a CPU ``torch.Generator``
  seeded by ``seed``; the card and the CPU therefore sample the same
  points (CUDA and CPU generators give different streams). Column 0 picks
  the face through the inverse CDF of the cumulative face areas (f64),
  columns 1-2 are the barycentric draws;
* :func:`points_from_draws` is the JAX function's arithmetic after its
  draws, so fed JAX's own face indices and uniforms it gives JAX's points.
"""

from __future__ import annotations

from typing import Tuple

import torch


def face_areas(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """(V, 3), (F, 3) int → (F,) triangle areas."""
    tri = verts[faces.long()]
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    return 0.5 * torch.linalg.norm(torch.cross(e1, e2, dim=-1), dim=-1)


def draw_samples(verts: torch.Tensor, faces: torch.Tensor, num_samples: int,
                 seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Area-weighted face indices (S,) int64 and barycentric uniforms (S, 2)
    on ``verts``' device, from CPU draws seeded by ``seed``."""
    u = torch.rand((num_samples, 3), generator=torch.Generator().manual_seed(
        int(seed)), dtype=torch.float64).to(verts.device)
    cdf = torch.cumsum(face_areas(verts, faces).double(), 0)
    fidx = torch.searchsorted(cdf, u[:, 0] * cdf[-1], right=True)
    return torch.clamp(fidx, max=faces.shape[0] - 1), u[:, 1:].float()


def points_from_draws(verts: torch.Tensor, faces: torch.Tensor,
                      face_idx: torch.Tensor, u: torch.Tensor,
                      return_normals: bool = False) -> Tuple[torch.Tensor, ...]:
    """Surface points from face indices (S,) and uniforms (S, 2), by the
    square-root trick for uniform barycentrics → (points (S, 3)[, face
    normals (S, 3)])."""
    tri = verts[faces[face_idx.long()].long()]            # (S, 3, 3)
    su = torch.sqrt(u[:, 0])
    w0 = 1.0 - su
    w1 = su * (1.0 - u[:, 1])
    w2 = su * u[:, 1]
    pts = (w0[:, None] * tri[:, 0] + w1[:, None] * tri[:, 1]
           + w2[:, None] * tri[:, 2])
    if not return_normals:
        return (pts,)
    n = torch.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], dim=-1)
    n = n / torch.clamp_min(torch.linalg.norm(n, dim=-1, keepdim=True), 1e-12)
    return pts, n


def sample_points_from_meshes(
    verts: torch.Tensor,
    faces: torch.Tensor,
    num_samples: int,
    seed: int,
    return_normals: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Uniform-over-surface samples: (points (S, 3)[, normals (S, 3)])."""
    fidx, u = draw_samples(verts, faces, num_samples, seed)
    return points_from_draws(verts, faces, fidx, u, return_normals)
