"""Host-side mesh cleanup + decimation (numpy).

Covers the reference's mesh hygiene: NaN-vertex repair + degenerate-face
removal (clean_mesh, diff_utils.py:334-404; clean_and_validate_trimesh,
2d_to_3d_models/run.py:24-64) and the FaceReducer/remesh decimation knobs
(config.yaml:172-173) via vertex-clustering decimation.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def clean_mesh(verts: np.ndarray, faces: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Drop non-finite vertices (remapping faces), degenerate and
    out-of-range faces, and unreferenced vertices."""
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int64)
    finite = np.all(np.isfinite(verts), axis=1)
    remap = np.full(len(verts), -1, np.int64)
    remap[finite] = np.arange(finite.sum())
    verts = verts[finite]
    faces = remap[faces]
    ok = np.all(faces >= 0, axis=1)
    f = faces[ok]
    ok2 = (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])
    f = f[ok2]
    # drop zero-area faces
    tri = verts[f]
    area2 = np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]),
                           axis=1)
    f = f[area2 > 1e-12]
    # drop unreferenced vertices
    used = np.zeros(len(verts), bool)
    used[f.reshape(-1)] = True
    remap2 = np.full(len(verts), -1, np.int64)
    remap2[used] = np.arange(used.sum())
    return verts[used], remap2[f].astype(np.int32)


def _hash_grid_keys(key3: np.ndarray) -> np.ndarray:
    """(N, 3) non-negative int grid coords → (N,) collision-free int64 keys.
    np.unique on the 1D hash is ~10× faster than np.unique(axis=0)'s
    structured sort — this sits on the per-object phase-3 host path."""
    span = int(key3.max()) + 1 if len(key3) else 1
    return (key3[:, 0] * span + key3[:, 1]) * span + key3[:, 2]


def weld_vertices(verts: np.ndarray, faces: np.ndarray, tol: float = 1e-6
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Merge vertices closer than tol (grid hash)."""
    key3 = np.round(verts / tol).astype(np.int64)
    key3 -= key3.min(0)
    _, first, inverse = np.unique(_hash_grid_keys(key3), return_index=True,
                                  return_inverse=True)
    return verts[first], inverse[faces].astype(np.int32)


def decimate_vertex_clustering(
    verts: np.ndarray, faces: np.ndarray, target_faces: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Decimate by snapping vertices to a uniform grid sized to hit roughly
    ``target_faces`` (bisection on cell size), then cleaning.

    A TPU-friendly stand-in for quadric decimation: O(V), deterministic,
    robust on the noisy marching-tetrahedra outputs it consumes.
    """
    if len(faces) <= target_faces:
        return verts.astype(np.float32), faces.astype(np.int32)
    lo_v = verts.min(0)
    extent = float(max(verts.max(0) - lo_v))
    # clustered face count ≈ 2 · surface_area / cell²: seed the bisection
    # bracket around that analytic cell estimate instead of
    # [extent/1024, extent] so few rounds reach the target
    tri = verts[faces]
    area = float(np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]),
        axis=1).sum()) * 0.5
    est = float(np.sqrt(2.0 * max(area, 1e-12) / target_faces))
    lo, hi = est / 8.0, min(est * 8.0, extent)
    best = None
    for _ in range(10):
        cell = (lo + hi) / 2.0
        key3 = np.floor((verts - lo_v) / max(cell, 1e-12)).astype(np.int64)
        uniq, inverse = np.unique(_hash_grid_keys(key3), return_inverse=True)
        # cluster centroid positions (bincount = fused one-pass add.at)
        cnt = np.bincount(inverse, minlength=len(uniq)).astype(np.float64)
        pos = np.stack([np.bincount(inverse, weights=verts[:, k],
                                    minlength=len(uniq)) for k in range(3)],
                       axis=1)
        pos = (pos / cnt[:, None]).astype(np.float32)
        f = inverse[faces]
        ok = (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])
        f = f[ok]
        if len(f) > target_faces:
            lo = cell
        else:
            best = (pos, f.astype(np.int32))
            hi = cell
    if best is None:
        # bracket never reached the target (analytic seed too fine for a
        # pathological shape): coarsest probe wins
        key3 = np.floor((verts - lo_v) / max(hi, 1e-12)).astype(np.int64)
        uniq, inverse = np.unique(_hash_grid_keys(key3), return_inverse=True)
        cnt = np.bincount(inverse, minlength=len(uniq)).astype(np.float64)
        pos = np.stack([np.bincount(inverse, weights=verts[:, k],
                                    minlength=len(uniq)) for k in range(3)],
                       axis=1)
        f = inverse[faces]
        ok = (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])
        best = ((pos / cnt[:, None]).astype(np.float32),
                f[ok].astype(np.int32))
    v, f = clean_mesh(*best)
    return v, f


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals."""
    tri = verts[faces]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n = np.zeros_like(verts)
    for k in range(3):
        np.add.at(n, faces[:, k], fn)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    return n / np.maximum(norm, 1e-12)


def fix_winding_outward(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Heuristic global winding fix: if most face normals point toward the
    centroid, flip all faces (trimesh fix_normals analog for closed-ish
    meshes)."""
    tri = verts[faces]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    to_center = tri.mean(1) - verts.mean(0)
    frac_out = ((fn * to_center).sum(1) > 0).mean()
    if frac_out < 0.5:
        return faces[:, [0, 2, 1]]
    return faces
