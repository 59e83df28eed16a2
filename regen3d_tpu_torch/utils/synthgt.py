"""Analytic ground truth for synthetic rooms (counterpart of
regen3d_tpu/utils/synthgt.py).

A synthetic room's geometry is known in closed form: an oracle depth map
per frame. Triangulating that depth gives an independent ``GT_scene`` mesh
for phase 7's alignment and phase 9's metrics, as the reference evaluates
against an external GT scene (evaluation/run_eval.py:106-125), never
against its own output. numpy throughout, the JAX package's arithmetic;
the GLB goes through the port's ``utils/glb.save_glb``.
"""

from __future__ import annotations

import numpy as np

from regen3d_tpu_torch.utils.glb import MeshData, SceneData, save_glb


def triangulate_depth_frame(frame: dict, path: str,
                            max_depth_jump: float = 0.15,
                            mask: np.ndarray | None = None,
                            pose_world: bool = True) -> None:
    """Triangulate one oracle depth frame into a GT scene mesh GLB at
    ``path``.

    ``frame`` is a phase-4 frame dict: ``points`` (H·W, 3) camera-space
    back-projections in row-major pixel order, ``width`` and ``height``.
    Grid cells whose four corners' depths span ``max_depth_jump`` or more
    are dropped, so foreground objects grow no skirts to the background.

    ``mask`` (H, W bool) keeps only cells whose four corners are inside it:
    the pipeline's predicted scene cloud holds the objects only (the
    reference samples the combined object GLB, scene_optim.py), so the GT
    is masked to the objects too.

    ``pose_world`` maps the camera-frame points into the pipeline's pose
    world (raw → world is diag(s, −s, −s); the scale drops out after
    normalisation), so phase 7's ICP resolves the residual pose error and
    not a 180° flip it cannot recover from the identity."""
    h, w = frame["height"], frame["width"]
    pts = np.asarray(frame["points"], np.float32).reshape(h, w, 3)
    depth = pts[..., 2]
    idx = np.arange(h * w).reshape(h, w)
    a = idx[:-1, :-1].ravel()
    b = idx[1:, :-1].ravel()
    c = idx[1:, 1:].ravel()
    d = idx[:-1, 1:].ravel()
    z = np.stack([depth[:-1, :-1], depth[1:, :-1],
                  depth[1:, 1:], depth[:-1, 1:]], 0)
    keep = (z.max(0) - z.min(0)).ravel() < max_depth_jump
    if mask is not None:
        m = np.asarray(mask, bool)
        cell = (m[:-1, :-1] & m[1:, :-1] & m[1:, 1:] & m[:-1, 1:]).ravel()
        keep = keep & cell
    faces = np.concatenate([
        np.stack([a, b, c], -1)[keep],
        np.stack([a, c, d], -1)[keep]]).astype(np.int32)
    verts = pts.reshape(-1, 3)
    if pose_world:
        verts = verts * np.asarray([1.0, -1.0, -1.0], np.float32)
    save_glb(path, SceneData(meshes=[MeshData(
        name="gt_room", vertices=verts, faces=faces)]))
