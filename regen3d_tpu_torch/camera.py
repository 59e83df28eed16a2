"""Pixel-space perspective camera (counterpart of regen3d_tpu/camera.py).

View frame ("P3D"): +X left, +Y up, +Z forward, ``x_view = x_world @ R + T``.
Screen: origin top-left, +u right, +v down, in pixels, with the P3D-sign
pinhole ``u = cx − fx·x/z``, ``v = cy − fy·y/z``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


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

    def view_to_screen(self, points_view: torch.Tensor) -> torch.Tensor:
        """View-space (..., 3) → (u, v, z) screen coords with depth kept."""
        z = points_view[..., 2]
        z_safe = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
        u = self.principal[0] - self.focal[0] * points_view[..., 0] / z_safe
        v = self.principal[1] - self.focal[1] * points_view[..., 1] / z_safe
        return torch.stack([u, v, z], dim=-1)

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
