"""Coordinate-convention converters (counterpart of
regen3d_tpu/transforms/conventions.py; numpy, and torch for the reorder).

Four conventions are in flight across the pipeline (SURVEY §7.3 item 5):

  * OpenCV / VGGT camera:   +X right, +Y down, +Z forward (into the scene)
  * COLMAP:                 same as OpenCV (world→cam extrinsic [R|t])
  * Blender world/camera:   +Z up world; camera looks down its local -Z, +Y up
  * "P3D" render frame:     +X left, +Y up, +Z forward; view transform acts on
                            ROW vectors: ``x_view = x_world @ R + T``

The artifact contract (camera.npz written by phase 4, consumed by phases
5/6/8 — reference: minimal_demo_vggt.py:160-255 and cam_utils.py:28-87)
stores ``R_fix @ [R|t]``: the OpenCV world→camera extrinsic with the camera
axes re-expressed through :data:`R_FIX_CV2BLENDER` — NOT a true Blender
matrix_world. The constant matrices below match the reference's ``R_fix``
(minimal_demo_vggt.py:165-173) and ``P2B``/``B2P`` (global_utils.py:819-844)
exactly, so reference-produced and repo-produced camera.npz /
scene_vggt.ply / points.ply artifact sets are interchangeable. Phase 4
writes them through :func:`opencv_extrinsic_to_blender_world` and
:func:`vggt_points_to_scene_ply`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# OpenCV/VGGT camera axes → Blender: the reference's exact R_fix
# (minimal_demo_vggt.py:165-173) — a +90° rotation about X taking
# (+X right, +Y down, +Z fwd) to Blender's Z-up layout.
R_FIX_CV2BLENDER = np.array(
    [[1.0, 0.0, 0.0],
     [0.0, 0.0, -1.0],
     [0.0, 1.0, 0.0]], dtype=np.float64)

# Constant basis-change matrices between Blender world and the P3D render
# frame (convention facts; reference: global_utils.py:819-844).
_B2P_R1 = np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0]], dtype=np.float64)
_B2P_R2 = np.array([[-1, 0, 0], [0, 1, 0], [0, 0, -1]], dtype=np.float64)
_B2P_T = np.array([[-1, 0, 0], [0, 0, -1], [0, 1, 0]], dtype=np.float64)
_P2B_R1 = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], dtype=np.float64)
_P2B_R2 = np.array([[-1, 0, 0], [0, 1, 0], [0, 0, -1]], dtype=np.float64)
_P2B_T = np.array([[-1, 0, 0], [0, 0, 1], [0, -1, 0]], dtype=np.float64)

# Net raw-VGGT-world → pose-fit-world linear map for the frame-0 (identity)
# camera: the composition of the reference's scene_vggt.ply point fix
# (minimal_demo_vggt.py:176-186: @R_fix.T, @B2P(ext).R.T, +T, Y-flip, ×scale)
# with phase 5's reload transform (pc_utils.py:25-37: B2P(I) + Y-flip)
# collapses to diag(1,−1,−1)·scale — exactly the reference's set_vggt_cloud
# matrix (mesh_pointclouds.py:27-81), i.e. the reference is self-consistent.
# Pinned by tests/test_reference_artifacts.py::TestRawToWorld (the JAX
# package) and tests/test_torch_geometry_ops.py (the port against it).
_RAW2WORLD = np.diag([1.0, -1.0, -1.0])


def blender_to_p3d(B: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """camera.npz 'extrinsic' 4x4 → (R, T) row-vector view transform.

    ``x_view = x_world @ R + T``. Mirrors reference ``B2P``
    (global_utils.py:835-844) so reference camera.npz files are
    interchangeable with ours.
    """
    B = np.asarray(B, dtype=np.float64)
    R = _B2P_R1 @ B[:3, :3] @ _B2P_R2
    T = _B2P_T @ B[:3, 3] @ R
    return R, T


def p3d_to_blender(R: np.ndarray, T: np.ndarray) -> np.ndarray:
    """Inverse of :func:`blender_to_p3d` (reference ``P2B``,
    global_utils.py:819-831). Returns the 4x4 'extrinsic' npz layout."""
    R = np.asarray(R, dtype=np.float64)
    T = np.asarray(T, dtype=np.float64)
    col3 = _P2B_T @ R @ T
    B3 = _P2B_R1 @ R @ _P2B_R2
    B = np.eye(4, dtype=np.float64)
    B[:3, :3] = B3
    B[:3, 3] = col3
    return B


def opencv_extrinsic_to_blender_world(E_cv: np.ndarray) -> np.ndarray:
    """COLMAP/OpenCV world→camera extrinsic [R|t] (3x4 or 4x4) → the 4x4
    'extrinsic' stored in camera.npz: ``R_fix @ R_cw`` and ``R_fix @ t_cw``,
    UNSCALED (the reference's layout, minimal_demo_vggt.py:160-186), i.e.
    the cam-from-world transform with rotated camera axes, not a true
    matrix_world."""
    E_cv = np.asarray(E_cv, dtype=np.float64)
    out = np.eye(4, dtype=np.float64)
    out[:3, :3] = R_FIX_CV2BLENDER @ E_cv[:3, :3]
    out[:3, 3] = R_FIX_CV2BLENDER @ E_cv[:3, 3]
    return out


def vggt_points_to_scene_ply(points: np.ndarray, ext_blender: np.ndarray,
                             scale: float) -> np.ndarray:
    """Raw VGGT-world points → the store frame of scene_vggt.ply, the
    reference's point fix (minimal_demo_vggt.py:176-186) operation for
    operation in f64: ``p @ R_fix.T`` → ``@ B2P(ext).R.T`` → ``+ B2P(ext).T``
    → Y-flip → ``× vggt_scene_scale``. Phase 5 undoes it through B2P(I) and
    the Y-flip (pc_utils.py:25-37), exactly when the frame-0 camera is the
    identity, which phase 4's rebase makes it."""
    R_p, T_p = blender_to_p3d(np.asarray(ext_blender, np.float64))
    q = (np.asarray(points, np.float64) @ R_FIX_CV2BLENDER.T) @ R_p.T + T_p
    q[:, 1] *= -1.0
    return q * float(scale)


def vggt_raw_to_world(points: np.ndarray, scale: float) -> np.ndarray:
    """Raw VGGT-world points (points.ply / points_emptyRoom.ply contract) →
    the pose-fit world used by phases 6/7: ``w = diag(s,−s,−s)·p``.

    Identical to the reference's set_vggt_cloud (mesh_pointclouds.py:27-81),
    and equal to the net of :func:`vggt_points_to_scene_ply` (frame-0
    identity camera) composed with phase 5's reload transform — the two
    routes into the pose world agree.
    """
    return np.asarray(points, np.float64) @ (_RAW2WORLD.T * float(scale))


def blender_points_reorder(points: torch.Tensor) -> torch.Tensor:
    """Make a P3D-frame point cloud 'Blender readable' for export:
    flip Z then swap Y/Z (reference: global_utils.py:686-688)."""
    p = points * torch.tensor([1.0, 1.0, -1.0], dtype=points.dtype,
                              device=points.device)
    return p[..., [0, 2, 1]]
