"""Iso-surface extraction: C++ marching tetrahedra through ctypes
(counterpart of regen3d_tpu/ops/marching_cubes.py).

``native/marching.cpp`` (a copy of the JAX package's) is built with ``g++``
into ``build/native/`` at the repository root at first use; the library's
name carries a hash of the source, so an edited source is rebuilt. A failed
build raises: the numpy version, about 100× slower, is kept only as the
plain version the tests compare against (:func:`marching_tetrahedra_plain`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "marching.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_LIB: Optional[ctypes.CDLL] = None


def lib_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libmarching-{digest}.so"


def load() -> ctypes.CDLL:
    """Build (once per source) and load the marching library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    so = lib_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
        out = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                              str(SOURCE), "-o", str(tmp)],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE}:\n{out.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.mt_extract.restype = ctypes.c_void_p
    lib.mt_extract.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_float]
    lib.mt_counts.restype = None
    lib.mt_counts.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                              ctypes.POINTER(ctypes.c_int64)]
    lib.mt_fetch.restype = None
    lib.mt_fetch.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                             ctypes.POINTER(ctypes.c_int32)]
    lib.mt_free.restype = None
    lib.mt_free.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def marching_tetrahedra(sdf: np.ndarray, iso: float = 0.0,
                        bounds: Optional[Tuple[float, float]] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the iso-surface of a dense SDF volume.

    Args:
      sdf: (nz, ny, nx) float volume, z-major (decode_grid layout).
      iso: iso value (inside = sdf < iso).
      bounds: optional (lo, hi) world extent of the grid on every axis: the
        vertices are rescaled from grid units as the JAX module does it, an
        f32 scale (hi − lo)/(n − 1) per axis, then ``verts * scale + lo``.

    Returns (verts (V, 3) float32 in xyz order, faces (T, 3) int32).
    """
    sdf = np.ascontiguousarray(sdf, dtype=np.float32)
    nz, ny, nx = sdf.shape
    lib = load()
    h = lib.mt_extract(sdf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                       nx, ny, nz, ctypes.c_float(iso))
    try:
        nv = ctypes.c_int64()
        nt = ctypes.c_int64()
        lib.mt_counts(h, ctypes.byref(nv), ctypes.byref(nt))
        verts = np.empty((nv.value, 3), np.float32)
        tris = np.empty((nt.value, 3), np.int32)
        if nv.value:
            lib.mt_fetch(h, verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                         tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    finally:
        lib.mt_free(h)
    if bounds is not None and len(verts):
        lo, hi = bounds
        scale = np.asarray([(hi - lo) / max(nx - 1, 1),
                            (hi - lo) / max(ny - 1, 1),
                            (hi - lo) / max(nz - 1, 1)], np.float32)
        verts = verts * scale + np.float32(lo)
    return verts, tris


# --- the plain version (same 6-tet decomposition, vectorized per tet type) --

_TETS = np.asarray([
    [[0, 0, 0], [1, 0, 0], [1, 1, 0], [1, 1, 1]],
    [[0, 0, 0], [1, 1, 0], [0, 1, 0], [1, 1, 1]],
    [[0, 0, 0], [0, 1, 0], [0, 1, 1], [1, 1, 1]],
    [[0, 0, 0], [0, 1, 1], [0, 0, 1], [1, 1, 1]],
    [[0, 0, 0], [0, 0, 1], [1, 0, 1], [1, 1, 1]],
    [[0, 0, 0], [1, 0, 1], [1, 0, 0], [1, 1, 1]],
], np.int64)

# case → triangles as corner-pair edges; winding fixed geometrically after
# interpolation (normals aligned inside→outside), matching the C++ path.
_CASES = {
    1: [[(0, 1), (0, 2), (0, 3)]],
    2: [[(1, 0), (1, 2), (1, 3)]],
    3: [[(0, 2), (0, 3), (1, 2)], [(1, 2), (0, 3), (1, 3)]],
    4: [[(2, 0), (2, 1), (2, 3)]],
    5: [[(0, 1), (0, 3), (2, 1)], [(2, 1), (0, 3), (2, 3)]],
    6: [[(1, 0), (1, 3), (2, 0)], [(2, 0), (1, 3), (2, 3)]],
    7: [[(3, 0), (3, 1), (3, 2)]],
    8: [[(3, 0), (3, 1), (3, 2)]],
    9: [[(0, 1), (0, 2), (3, 1)], [(3, 1), (0, 2), (3, 2)]],
    10: [[(1, 0), (1, 2), (3, 0)], [(3, 0), (1, 2), (3, 2)]],
    11: [[(2, 0), (2, 1), (2, 3)]],
    12: [[(2, 0), (2, 1), (3, 0)], [(3, 0), (2, 1), (3, 1)]],
    13: [[(1, 0), (1, 2), (1, 3)]],
    14: [[(0, 1), (0, 2), (0, 3)]],
}


def marching_tetrahedra_plain(sdf: np.ndarray, iso: float = 0.0
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """The numpy version of :func:`marching_tetrahedra` (the JAX module's
    fallback): the same surface, vertices welded to 1e-5 grid units."""
    sdf = np.ascontiguousarray(sdf, dtype=np.float32)
    nz, ny, nx = sdf.shape
    inside = sdf < iso
    any_in = np.zeros((nz - 1, ny - 1, nx - 1), bool)
    any_out = np.zeros_like(any_in)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                s = inside[dz:nz - 1 + dz, dy:ny - 1 + dy, dx:nx - 1 + dx]
                any_in |= s
                any_out |= ~s
    zz, yy, xx = np.nonzero(any_in & any_out)
    base = np.stack([xx, yy, zz], -1)  # (M, 3) xyz cube origins
    verts_list = []
    tris_list = []
    vcount = 0

    def sample(p):
        return sdf[p[:, 2], p[:, 1], p[:, 0]]

    for tet in _TETS:
        corners = base[:, None, :] + tet[None, :, :]  # (M, 4, 3)
        vals = np.stack([sample(corners[:, i]) for i in range(4)], -1)
        mask = ((vals < iso) * np.asarray([1, 2, 4, 8])).sum(-1)
        for case, tris in _CASES.items():
            sel = np.nonzero(mask == case)[0]
            if not len(sel):
                continue
            ins = [i for i in range(4) if case & (1 << i)]
            outs = [i for i in range(4) if not case & (1 << i)]
            dirv = (corners[sel][:, outs].mean(1)
                    - corners[sel][:, ins].mean(1)).astype(np.float32)
            for tri in tris:
                pts3 = []
                for (a, b) in tri:
                    pa = corners[sel, a].astype(np.float32)
                    pb = corners[sel, b].astype(np.float32)
                    va = vals[sel, a]
                    vb = vals[sel, b]
                    t = np.where(vb == va, 0.5, (iso - va) / np.where(
                        vb == va, 1.0, vb - va))
                    pts3.append(pa + np.clip(t, 0, 1)[:, None] * (pb - pa))
                n = np.cross(pts3[1] - pts3[0], pts3[2] - pts3[0])
                flip = (n * dirv).sum(-1) < 0
                p1 = np.where(flip[:, None], pts3[2], pts3[1])
                p2 = np.where(flip[:, None], pts3[1], pts3[2])
                ids = np.arange(vcount, vcount + 3 * len(sel)).reshape(3, -1)
                vcount += 3 * len(sel)
                verts_list += [pts3[0].astype(np.float32),
                               p1.astype(np.float32), p2.astype(np.float32)]
                tris_list.append(np.stack(ids, -1))
    if not verts_list:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    verts = np.concatenate(verts_list)
    tris = np.concatenate(tris_list).astype(np.int32)
    # weld duplicate vertices
    rounded = np.round(verts / 1e-5).astype(np.int64)
    _, uniq_idx, inverse = np.unique(rounded, axis=0, return_index=True,
                                     return_inverse=True)
    return (verts[uniq_idx],
            inverse.reshape(-1)[tris].astype(np.int32))
