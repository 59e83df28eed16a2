"""Poisson surface reconstruction on a dense grid by FFT (counterpart of
regen3d_tpu/ops/poisson.py).

Replaces Open3D's octree screened-Poisson meshing used for the background
mesh (reference: mesh_pointclouds.py:461-552, depth=10 + density trim):

1. splat oriented normals and a unit density into a (R, R, R, 4) grid with
   trilinear weights;
2. solve ∇²χ = ∇·V for the indicator χ in the Fourier domain
   (``torch.fft``);
3. on the host, in numpy as in the JAX package: the iso level is the mean
   of χ at the samples' cells, cells without support are pushed outside
   the surface (the density trim), and marching tetrahedra extracts it.

The splat is deterministic: JAX's ``grid.at[z, y, x].add`` becomes a sort
of the 8·N corner contributions by cell and a segmented sum (differences of
an f64 running sum at the segment ends), not ``index_put_(accumulate=True)``,
whose CUDA atomics add in no fixed order.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

# the grid spans the points' extent padded by this share on each side
_PAD = 0.1
# a small Tikhonov term keeping the Fourier solve bounded at DC (the
# screened-Poisson analog)
_SCREEN = 1e-2


def _trilinear_scatter(r: int, idx: torch.Tensor, frac: torch.Tensor,
                       values: torch.Tensor) -> torch.Tensor:
    """Sum values (N, C) into a (R, R, R, C) z-major grid with trilinear
    weights, corners clipped to the grid."""
    keys, contrib = [], []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                w = ((1 - dx - frac[:, 0]).abs() * (1 - dy - frac[:, 1]).abs()
                     * (1 - dz - frac[:, 2]).abs())
                xi = torch.clamp(idx[:, 0] + dx, 0, r - 1)
                yi = torch.clamp(idx[:, 1] + dy, 0, r - 1)
                zi = torch.clamp(idx[:, 2] + dz, 0, r - 1)
                keys.append((zi * r + yi) * r + xi)
                contrib.append(w[:, None] * values)
    keys = torch.cat(keys)
    contrib = torch.cat(contrib)
    keys, order = torch.sort(keys, stable=True)
    run = torch.cumsum(contrib[order].double(), 0)
    cells, counts = torch.unique_consecutive(keys, return_counts=True)
    ends = torch.cumsum(counts, 0) - 1
    sums = run[ends]
    sums = sums - torch.cat([torch.zeros_like(sums[:1]), sums[:-1]])
    grid = torch.zeros(r * r * r, values.shape[1], dtype=values.dtype,
                       device=values.device)
    grid[cells] = sums.to(values.dtype)
    return grid.reshape(r, r, r, -1)


def poisson_indicator(
    points: torch.Tensor,
    normals: torch.Tensor,
    resolution: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Solve for the indicator field χ on a regular grid.

    Returns (chi (R,R,R) z-major, density (R,R,R), (origin, cell_size)).
    """
    r = resolution
    lo = points.min(0).values
    hi = points.max(0).values
    span = (hi - lo).max() * (1 + 2 * _PAD)
    origin = (lo + hi) / 2.0 - span / 2.0
    cell = span * (1.0 / (r - 1))  # XLA's rounding of span / (r − 1)

    coords = (points - origin) / cell
    idx = torch.floor(coords).to(torch.int64)
    frac = coords - idx
    vals = torch.cat([normals, torch.ones_like(normals[:, :1])], -1)
    field = _trilinear_scatter(r, idx, frac, vals)
    V = field[..., :3]
    density = field[..., 3]

    # divergence by central differences, grid units (axis 0 = z)
    div = ((torch.roll(V[..., 0], -1, 2) - torch.roll(V[..., 0], 1, 2))
           + (torch.roll(V[..., 1], -1, 1) - torch.roll(V[..., 1], 1, 1))
           + (torch.roll(V[..., 2], -1, 0) - torch.roll(V[..., 2], 1, 0))
           ) * 0.5

    # spectral Laplacian inverse: chi_hat = div_hat / (lap_eig - screen)
    k = torch.fft.fftfreq(r, dtype=torch.float32, device=points.device) \
        * (2 * math.pi)
    kz, ky, kx = k[:, None, None], k[None, :, None], k[None, None, :]
    lap = 2.0 * ((torch.cos(kx) - 1) + (torch.cos(ky) - 1)
                 + (torch.cos(kz) - 1))
    chi_hat = torch.fft.fftn(div) / (lap - _SCREEN)
    chi = torch.fft.ifftn(chi_hat).real
    return chi, density, (origin, cell)


@torch.no_grad()
def poisson_reconstruct(
    points: np.ndarray,
    normals: np.ndarray,
    resolution: int = 128,
    density_quantile: float = 0.0,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Point cloud + normals → triangle mesh (verts, faces); the field is
    solved on ``device``.

    density_quantile trims low-support surface area like the reference's
    Open3D density filter (mesh_pointclouds.py:527-537).
    """
    from regen3d_tpu_torch.ops.marching_cubes import marching_tetrahedra

    pts = torch.as_tensor(np.asarray(points, np.float32), device=device)
    nrm = torch.as_tensor(np.asarray(normals, np.float32), device=device)
    nrm = nrm / torch.clamp_min(torch.linalg.norm(nrm, dim=-1, keepdim=True),
                                1e-12)
    chi, density, (origin, cell) = poisson_indicator(pts, nrm, resolution)
    origin = origin.cpu().numpy()
    cell = float(cell)

    # iso level: mean chi at the input samples (their grid cells)
    r = resolution
    coords = np.clip(((points - origin) / cell).round().astype(int), 0, r - 1)
    chi_np = chi.cpu().numpy()
    iso = float(chi_np[coords[:, 2], coords[:, 1], coords[:, 0]].mean())

    vol = chi_np
    if density_quantile > 0:
        # Trim unsupported surface (the closure 'bubble' Poisson adds around
        # open scans): any cell without nearby samples is pushed to the
        # OUTSIDE value so marching only keeps supported area.
        dens = density.cpu().numpy()
        # dilate support by one cell so the surface band survives
        sup = dens > 0
        for ax in (0, 1, 2):
            sup = sup | np.roll(sup, 1, ax) | np.roll(sup, -1, ax)
        occ_vals = dens[dens > 0]
        thr = np.quantile(occ_vals, density_quantile) if len(occ_vals) else 0.0
        supported = sup & (np.maximum.reduce(
            [np.roll(dens, s, a) for a in (0, 1, 2) for s in (-1, 0, 1)]) >= thr)
        inside_is_high = (chi_np > iso).mean() < 0.5
        margin = 3.0 * (np.abs(chi_np - iso).mean() + 1e-9)
        outside_val = iso - margin if inside_is_high else iso + margin
        vol = np.where(supported, vol, outside_val)
    # inside = chi > iso for outward normals ⇒ extract at -chi with -iso to
    # keep the marching convention (inside = value < iso)
    verts, faces = marching_tetrahedra(-vol, -iso)
    verts = verts * cell + origin
    return verts.astype(np.float32), faces
