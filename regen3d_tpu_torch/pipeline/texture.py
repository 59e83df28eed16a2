"""Texture baking: project view images onto a mesh with visibility
(counterpart of regen3d_tpu/pipeline/texture.py).

For each view the mesh is depth-rasterized for occlusion
(:func:`regen3d_tpu_torch.ops.rasterize.rasterize_hard_auto`: the dense
z-buffer, or the tile-binned one where the JAX package's dispatch rule
takes it, which gives the dense one's fragments bit for bit), every
surface point samples the view image where it is visible, and views blend
by facing weight (:func:`bake_point_colors`). On top of it:

* :func:`bake_vertex_colors`, the points being the mesh's vertices;
* :func:`bake_texture_atlas`, the texel-space atlas: every face gets a
  (T + 2)² cell of a square atlas, T² texels on its barycentric lattice,
  written as a PNG by the port's own encoder, and the mesh comes back with
  its corners unshared and per-corner UVs;
* :func:`orbit_views`, the camera ring of the multiview texture path.

The JAX package pads rows to 4096 for its compile cache; the port needs no
padding. The points are taken ``_QUERY_CHUNK`` at a time, so an atlas of
64 texels a face over a 50,000-face mesh (3.2 M points) does not hold a
view's per-point temporaries all at once.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from regen3d_tpu_torch.camera import Camera, lookat_camera
from regen3d_tpu_torch.ops.rasterize import rasterize_hard_auto
from regen3d_tpu_torch.utils.image import encode_png
from regen3d_tpu_torch.utils.meshproc import vertex_normals

# a point is visible where its depth is within this of the z-buffer's
# (relative and absolute); faces the dense rasterizer takes at a time;
# points a view samples at a time
_DEPTH_EPS = 5e-3
_FACE_CHUNK = 256
_QUERY_CHUNK = 1 << 20


def _accumulate_view(frag, pos, nrm, acc, wsum, img, cam: Camera):
    """One view's occlusion-tested, facing-weighted colour accumulation
    onto the points ``pos`` (in place), given the view's fragments."""
    h, w = img.shape[:2]
    uv, z = cam.project(pos)
    xi = torch.clamp(torch.round(uv[:, 0]).long(), 0, w - 1)
    yi = torch.clamp(torch.round(uv[:, 1]).long(), 0, h - 1)
    zbuf = frag.depth[0, yi, xi]
    visible = (z > 0) & (z <= zbuf * (1 + _DEPTH_EPS) + _DEPTH_EPS)
    inb = (uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0) & (uv[:, 1] < h)
    to_cam = cam.center - pos
    to_cam = to_cam / torch.clamp_min(
        torch.linalg.norm(to_cam, dim=-1, keepdim=True), 1e-9)
    facing = (nrm * to_cam).sum(-1).abs()
    wgt = torch.where(visible & inb, facing, torch.zeros_like(facing))[:, None]
    acc += wgt * img[yi, xi]
    wsum += wgt


@torch.no_grad()
def bake_point_colors(
    positions: np.ndarray,
    normals: np.ndarray,
    occluder: Tuple[np.ndarray, np.ndarray],
    views: Sequence[Tuple[Camera, np.ndarray]],
) -> Tuple[np.ndarray, np.ndarray]:
    """Blend view images onto surface points, on the views' cameras'
    device. positions, normals: (N, 3); occluder: the (verts, faces) mesh of
    the visibility test; views: [(camera, (H, W, 3) float image in
    [0, 1])]. Returns (colours (N, 3) in [0, 1], coverage (N,)): a point no
    view sees takes the mean colour of those seen."""
    dev = views[0][0].R.device
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt,
                                                    device=dev)
    v, f = t(occluder[0]), t(occluder[1], torch.int64)
    pos, nrm = t(positions), t(normals)
    acc = torch.zeros((len(pos), 3), dtype=torch.float32, device=dev)
    wsum = torch.zeros((len(pos), 1), dtype=torch.float32, device=dev)
    for cam, img in views:
        img = t(img)
        vs = cam.view_to_screen(cam.world_to_view(v))
        frag = rasterize_hard_auto(vs[None], f[None], tuple(img.shape[:2]),
                                   chunk=_FACE_CHUNK)
        for q0 in range(0, len(pos), _QUERY_CHUNK):
            sl = slice(q0, q0 + _QUERY_CHUNK)
            _accumulate_view(frag, pos[sl], nrm[sl], acc[sl], wsum[sl], img,
                             cam)
        del frag
    colors = (acc / torch.clamp_min(wsum, 1e-9)).cpu().numpy()
    coverage = wsum[:, 0].cpu().numpy()
    covered = coverage > 1e-6
    if covered.any():
        colors[~covered] = colors[covered].mean(0)
    return np.clip(colors, 0, 1), coverage


def bake_vertex_colors(
    verts: np.ndarray,
    faces: np.ndarray,
    views: Sequence[Tuple[Camera, np.ndarray]],
) -> np.ndarray:
    """Blend view images onto mesh vertices with occlusion + facing weights
    (:func:`bake_point_colors` at the vertices, with their area-weighted
    normals). A vertex no view sees takes the mean colour of those seen.

    Returns (V, 4) RGBA float vertex colours."""
    colors, _ = bake_point_colors(verts, vertex_normals(verts, faces),
                                  (verts, faces), views)
    return np.concatenate([colors, np.ones((len(colors), 1), np.float32)],
                          -1)


def bake_texture_atlas(
    verts: np.ndarray,
    faces: np.ndarray,
    views: Sequence[Tuple[Camera, np.ndarray]],
    texels_per_face: int = 8,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, bytes]:
    """Texel-space texture baking with a per-face grid atlas.

    Every face gets a (T + 2)² atlas cell (a 1-texel gutter) of a G × G
    grid, G = ⌈√F⌉; its T² texel centres lie on a barycentric lattice (the
    texels past the diagonal folded back onto the triangle), their colours
    from :func:`bake_point_colors` with the face's normal. Returns a new
    mesh with per-corner UVs (each face's corners unshared, the standard
    auto-atlas layout): (verts (3F, 3), faces (F, 3), uvs (3F, 2), the
    atlas as PNG bytes)."""
    F = len(faces)
    T = texels_per_face
    cell = T + 2
    G = int(np.ceil(np.sqrt(F)))
    atlas_px = G * cell

    tri = verts[faces]                                   # (F, 3, 3)
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    fn = fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-12)

    us = (np.arange(T) + 0.5) / T
    uu, vv = np.meshgrid(us, us)
    w1, w2 = uu.ravel(), vv.ravel()
    inside = w1 + w2 <= 1.0 + 1e-6
    w1f = np.where(inside, w1, 1.0 - w1)
    w2f = np.where(inside, w2, 1.0 - w2)
    bary = np.stack([1.0 - w1f - w2f, w1f, w2f], -1).astype(np.float32)

    positions = np.einsum("tk,fkd->ftd", bary, tri).reshape(-1, 3)
    normals = np.repeat(fn, T * T, axis=0)
    colors, _ = bake_point_colors(positions, normals, (verts, faces), views)

    cells = np.zeros((G * G, cell, cell, 3), np.float32)
    cells[:F, 1:1 + T, 1:1 + T] = colors.reshape(F, T, T, 3)
    atlas = (cells.reshape(G, G, cell, cell, 3).transpose(0, 2, 1, 3, 4)
             .reshape(atlas_px, atlas_px, 3))
    png = encode_png((np.clip(atlas, 0, 1) * 255).astype(np.uint8))

    new_verts = tri.reshape(-1, 3).astype(np.float32)
    new_faces = np.arange(3 * F, dtype=np.int32).reshape(F, 3)
    cy, cx = np.divmod(np.arange(F), G)
    x0 = (cx * cell + 1) / atlas_px
    y0 = (cy * cell + 1) / atlas_px
    side = T / atlas_px
    # corner order matches bary: w0 at (0, 0), w1 at (1, 0), w2 at (0, 1)
    uvs = np.zeros((F, 3, 2), np.float32)
    uvs[:, 0] = np.stack([x0, y0], -1)
    uvs[:, 1] = np.stack([x0 + side, y0], -1)
    uvs[:, 2] = np.stack([x0, y0 + side], -1)
    return new_verts, new_faces, uvs.reshape(-1, 2), png


def orbit_views(center: np.ndarray, radius: float, image: np.ndarray,
                n_views: int = 6, elevation: float = 0.3,
                focal_scale: float = 1.2, device="cuda"
                ) -> List[Tuple[Camera, np.ndarray]]:
    """A ring of ``n_views`` look-at cameras (on ``device``) around
    ``center`` at ``radius``, raised by ``elevation``·radius, focal
    ``focal_scale``·H, each paired with ``image``."""
    views = []
    h = image.shape[0]
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        eye = center + radius * np.asarray(
            [np.sin(ang), elevation, -np.cos(ang)], np.float32)
        cam = lookat_camera(eye, center, image.shape[:2],
                            focal_px=h * focal_scale, device=device)
        views.append((cam, image))
    return views
