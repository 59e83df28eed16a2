"""Pixel-space perspective camera (counterpart of regen3d_tpu/camera.py).

View frame ("P3D"): +X left, +Y up, +Z forward, ``x_view = x_world @ R + T``.
Screen: origin top-left, +u right, +v down, in pixels, with the P3D-sign
pinhole ``u = cx − fx·x/z``, ``v = cy − fy·y/z``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from regen3d_tpu_torch.transforms.conventions import blender_to_p3d


@dataclasses.dataclass(frozen=True)
class Camera:
    R: torch.Tensor             # (3, 3) world→view rotation (row-vector conv.)
    T: torch.Tensor             # (3,)  world→view translation
    focal: torch.Tensor         # (2,) fx, fy in pixels
    principal: torch.Tensor     # (2,) cx, cy in pixels
    image_size: Tuple[int, int]  # (H, W) render target
    znear: float = 0.1
    zfar: float = 50.0

    def world_to_view(self, points: torch.Tensor) -> torch.Tensor:
        return points @ self.R + self.T

    def view_to_world(self, points: torch.Tensor) -> torch.Tensor:
        return (points - self.T) @ self.R.T

    @property
    def center(self) -> torch.Tensor:
        """Camera centre in world coordinates."""
        return -self.T @ self.R.T

    def project(self, points_world: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """World points (..., 3) → (screen uv (..., 2), depth (...,))."""
        s = self.view_to_screen(self.world_to_view(points_world))
        return s[..., :2], s[..., 2]

    def unproject(self, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        """Screen pixels (..., 2) + view-space depth (...,) → world (..., 3)."""
        x = (self.principal[0] - uv[..., 0]) * depth / self.focal[0]
        y = (self.principal[1] - uv[..., 1]) * depth / self.focal[1]
        return self.view_to_world(torch.stack([x, y, depth], dim=-1))

    def view_to_screen(self, points_view: torch.Tensor) -> torch.Tensor:
        """View-space (..., 3) → (u, v, z) screen coords with depth kept."""
        z = points_view[..., 2]
        z_safe = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
        u = self.principal[0] - self.focal[0] * points_view[..., 0] / z_safe
        v = self.principal[1] - self.focal[1] * points_view[..., 1] / z_safe
        return torch.stack([u, v, z], dim=-1)

    def pixel_rays_world(self, xx: torch.Tensor, yy: torch.Tensor
                         ) -> torch.Tensor:
        """Unit world-space directions (..., 3) of the rays through pixel
        positions (xx, yy): the inverse of the pinhole on the z = 1 view
        plane, rotated to the world (environment-map backgrounds)."""
        x = (self.principal[0] - xx) / self.focal[0]
        y = (self.principal[1] - yy) / self.focal[1]
        d = torch.stack([x, y, torch.ones_like(x)], dim=-1) @ self.R.T
        return d / torch.clamp_min(torch.linalg.norm(d, dim=-1, keepdim=True),
                                   1e-8)

    def rescaled(self, height: int, width: int) -> "Camera":
        """Camera for another render resolution: focal scales by the height
        ratio, the principal point recentres on the new image."""
        scale = height / self.image_size[0]
        return dataclasses.replace(
            self, focal=self.focal * scale,
            principal=torch.tensor([width / 2.0, height / 2.0],
                                   dtype=torch.float32,
                                   device=self.focal.device),
            image_size=(height, width))


def lookat_camera(eye, target, image_hw: Tuple[int, int], focal_px: float,
                  up=(0.0, 1.0, 0.0), znear: float = 0.1, zfar: float = 100.0,
                  device="cuda") -> Camera:
    """Camera at ``eye`` looking at ``target`` in f32: R's columns are the
    view axes in the world, −x, −y and f, where f is the unit forward
    direction, x = f × up normalised (or (1, 0, 0) where f is along ``up``)
    and y = f × x: the OpenCV frame with x and y negated, which is the P3D
    view frame the projection's signs assume. Principal point at the image
    centre."""
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    eye, target, up = f32(eye), f32(target), f32(up)
    f = target - eye
    f = f / torch.clamp_min(torch.linalg.norm(f), 1e-12)
    x_cam = torch.linalg.cross(f, up)
    x_norm = torch.linalg.norm(x_cam)
    x_cam = torch.where(x_norm > 1e-6,
                        x_cam / torch.clamp_min(x_norm, 1e-12),
                        f32([1.0, 0.0, 0.0]))
    y_cam = torch.linalg.cross(f, x_cam)
    R = torch.stack([-x_cam, -y_cam, f], -1)
    h, w = image_hw
    return Camera(R=R, T=-eye @ R, focal=f32([focal_px, focal_px]),
                  principal=f32([w / 2.0, h / 2.0]), image_size=(h, w),
                  znear=znear, zfar=zfar)


def camera_from_npz(
    npz_path: str,
    render_hw: Optional[Tuple[int, int]] = None,
    znear: float = 0.1,
    zfar: float = 50.0,
    device="cuda",
) -> Camera:
    """Load the camera.npz artifact (keys: extrinsic, focal, image_size,
    camera_angle_x) into a :class:`Camera`, optionally for another render
    resolution: B2P of the stored extrinsic, focal scaled by the height
    ratio, principal point at the image centre."""
    data = np.load(npz_path)
    R, T = blender_to_p3d(np.asarray(data["extrinsic"], dtype=np.float64))
    orig_w, orig_h = [int(x) for x in
                      np.asarray(data["image_size"]).reshape(-1)[:2]]
    if render_hw is None:
        render_hw = (orig_h, orig_w)
    h, w = render_hw
    f = float(data["focal"]) * (h / orig_h)
    f32 = lambda x: torch.tensor(np.asarray(x, np.float32), device=device)
    return Camera(R=f32(R), T=f32(T), focal=f32([f, f]),
                  principal=f32([w / 2.0, h / 2.0]), image_size=(h, w),
                  znear=znear, zfar=zfar)


def save_camera_npz(
    npz_path: str,
    extrinsic_blender: np.ndarray,
    focal_px: float,
    image_wh: Tuple[int, int],
) -> None:
    """Write the camera.npz artifact with the reference's keys and dtypes
    (minimal_demo_vggt.py:189-204)."""
    os.makedirs(os.path.dirname(os.path.abspath(npz_path)), exist_ok=True)
    width, height = image_wh
    camera_angle_x = float(2.0 * np.arctan(width / (2.0 * float(focal_px))))
    np.savez(
        npz_path,
        extrinsic=np.asarray(extrinsic_blender, dtype=np.float32),
        focal=np.float32(focal_px),
        image_size=np.array([width, height], dtype=np.int32),
        camera_angle_x=np.float32(camera_angle_x),
    )
