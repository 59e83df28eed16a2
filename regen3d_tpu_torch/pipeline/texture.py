"""Vertex-colour baking: project view images onto a mesh with visibility
(counterpart of regen3d_tpu/pipeline/texture.py's ``bake_vertex_colors``,
with ``bake_point_colors`` folded in).

For each view the mesh is depth-rasterized (the plain
:func:`regen3d_tpu_torch.ops.rasterize.rasterize_hard`, every pixel against
every face in chunks) for occlusion, every vertex samples the view image
where it is visible, and views blend by facing weight. The JAX package pads
rows to 4096 for its compile cache; the port needs no padding.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from regen3d_tpu_torch.camera import Camera
from regen3d_tpu_torch.ops.rasterize import rasterize_hard
from regen3d_tpu_torch.utils.meshproc import vertex_normals


# a point is visible where its depth is within this of the z-buffer's
# (relative and absolute); faces the plain rasterizer takes at a time
_DEPTH_EPS = 5e-3
_FACE_CHUNK = 256


def _accumulate_view(v, f, nrm, acc, wsum, img, cam: Camera):
    """One view's occlusion-tested, facing-weighted colour accumulation
    onto the vertices ``v``."""
    h, w = img.shape[:2]
    vs = cam.view_to_screen(cam.world_to_view(v))
    frag = rasterize_hard(vs[None], f[None], (h, w), chunk=_FACE_CHUNK)
    uv, z = cam.project(v)
    xi = torch.clamp(torch.round(uv[:, 0]).long(), 0, w - 1)
    yi = torch.clamp(torch.round(uv[:, 1]).long(), 0, h - 1)
    zbuf = frag.depth[0, yi, xi]
    visible = (z > 0) & (z <= zbuf * (1 + _DEPTH_EPS) + _DEPTH_EPS)
    inb = (uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0) & (uv[:, 1] < h)
    to_cam = cam.center - v
    to_cam = to_cam / torch.clamp_min(
        torch.linalg.norm(to_cam, dim=-1, keepdim=True), 1e-9)
    facing = (nrm * to_cam).sum(-1).abs()
    wgt = torch.where(visible & inb, facing, torch.zeros_like(facing))[:, None]
    return acc + wgt * img[yi, xi], wsum + wgt


@torch.no_grad()
def bake_vertex_colors(
    verts: np.ndarray,
    faces: np.ndarray,
    views: Sequence[Tuple[Camera, np.ndarray]],
) -> np.ndarray:
    """Blend view images onto mesh vertices with occlusion + facing weights,
    on the views' cameras' device. A vertex no view sees takes the mean
    colour of those seen.

    Args:
      verts: (V, 3) world. faces: (F, 3). views: [(camera, (H, W, 3) float
        image in [0,1])].

    Returns (V, 4) RGBA float vertex colors.
    """
    dev = views[0][0].R.device
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt,
                                                    device=dev)
    v, f = t(verts), t(faces, torch.int64)
    nrm = t(vertex_normals(verts, faces))
    acc = torch.zeros((len(v), 3), dtype=torch.float32, device=dev)
    wsum = torch.zeros((len(v), 1), dtype=torch.float32, device=dev)
    for cam, img in views:
        acc, wsum = _accumulate_view(v, f, nrm, acc, wsum, t(img), cam)
    colors = (acc / torch.clamp_min(wsum, 1e-9)).cpu().numpy()
    covered = wsum[:, 0].cpu().numpy() > 1e-6
    if covered.any():
        colors[~covered] = colors[covered].mean(0)
    return np.concatenate([np.clip(colors, 0, 1),
                           np.ones((len(colors), 1), np.float32)], -1)
