"""COLMAP sparse-reconstruction text format IO (the phase-4 data contract;
counterpart of regen3d_tpu/utils/colmapio.py, byte for byte the same text).

The reference exports its VGGT reconstruction through pycolmap
(minimal_demo_vggt.py:457-508: `batch_np_matrix_to_pycolmap_wo_track` →
`reconstruction.write`). We keep the COLMAP *file format* as the contract
(SURVEY §2.10) and write/read it directly: cameras.txt, images.txt,
points3D.txt + image_list.txt.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np


@dataclass
class ColmapCamera:
    camera_id: int
    model: str               # e.g. SIMPLE_PINHOLE / PINHOLE
    width: int
    height: int
    params: np.ndarray       # SIMPLE_PINHOLE: [f, cx, cy]; PINHOLE: [fx, fy, cx, cy]


@dataclass
class ColmapImage:
    image_id: int
    qvec: np.ndarray         # (4,) wxyz — world→cam rotation
    tvec: np.ndarray         # (3,) world→cam translation
    camera_id: int
    name: str

    def cam_from_world(self) -> np.ndarray:
        """3x4 [R|t], OpenCV convention (x_cam = R·x_w + t, column vectors).
        R is computed in f32, as the JAX package computes it (x64 off)."""
        import torch

        from regen3d_tpu_torch.transforms.rotations import quat_to_matrix
        R = quat_to_matrix(torch.as_tensor(np.asarray(self.qvec),
                                           dtype=torch.float32)).numpy()
        return np.concatenate([R, self.tvec.reshape(3, 1)], axis=1)


@dataclass
class ColmapReconstruction:
    cameras: Dict[int, ColmapCamera] = field(default_factory=dict)
    images: Dict[int, ColmapImage] = field(default_factory=dict)
    points: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))
    colors: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.uint8))

    def write(self, out_dir: str) -> None:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "cameras.txt"), "w") as f:
            f.write("# Camera list: CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
            f.write(f"# Number of cameras: {len(self.cameras)}\n")
            for c in self.cameras.values():
                params = " ".join(f"{p:.10g}" for p in c.params)
                f.write(f"{c.camera_id} {c.model} {c.width} {c.height} {params}\n")
        with open(os.path.join(out_dir, "images.txt"), "w") as f:
            f.write("# Image list: IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, "
                    "CAMERA_ID, NAME\n#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
            for im in self.images.values():
                q = " ".join(f"{v:.10g}" for v in im.qvec)
                t = " ".join(f"{v:.10g}" for v in im.tvec)
                f.write(f"{im.image_id} {q} {t} {im.camera_id} {im.name}\n\n")
        with open(os.path.join(out_dir, "points3D.txt"), "w") as f:
            f.write("# 3D point list: POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                    "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
            for i, p in enumerate(self.points):
                c = self.colors[i] if i < len(self.colors) else (128, 128, 128)
                f.write(f"{i + 1} {p[0]:.8g} {p[1]:.8g} {p[2]:.8g} "
                        f"{int(c[0])} {int(c[1])} {int(c[2])} 0\n")

    @classmethod
    def read(cls, in_dir: str) -> "ColmapReconstruction":
        rec = cls()
        with open(os.path.join(in_dir, "cameras.txt")) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                parts = line.split()
                rec.cameras[int(parts[0])] = ColmapCamera(
                    camera_id=int(parts[0]), model=parts[1],
                    width=int(parts[2]), height=int(parts[3]),
                    params=np.asarray([float(x) for x in parts[4:]]))
        with open(os.path.join(in_dir, "images.txt")) as f:
            lines = [l for l in f if not l.startswith("#")]
        for i in range(0, len(lines), 2):
            parts = lines[i].split()
            if len(parts) < 10:
                continue
            rec.images[int(parts[0])] = ColmapImage(
                image_id=int(parts[0]),
                qvec=np.asarray([float(x) for x in parts[1:5]]),
                tvec=np.asarray([float(x) for x in parts[5:8]]),
                camera_id=int(parts[8]), name=parts[9])
        pts, cols = [], []
        p3d = os.path.join(in_dir, "points3D.txt")
        if os.path.exists(p3d):
            with open(p3d) as f:
                for line in f:
                    if line.startswith("#") or not line.strip():
                        continue
                    parts = line.split()
                    pts.append([float(x) for x in parts[1:4]])
                    cols.append([int(x) for x in parts[4:7]])
        rec.points = np.asarray(pts) if pts else np.zeros((0, 3))
        rec.colors = np.asarray(cols, np.uint8) if cols else np.zeros((0, 3), np.uint8)
        return rec


def focal_and_angle(width: int, fx: float, fy: float) -> Tuple[float, float]:
    """Mean pixel focal + horizontal camera angle (the camera.npz fields,
    reference: _intrinsics_for_image, minimal_demo_vggt.py:105-107)."""
    focal = float((fx + fy) / 2.0)
    return focal, float(2.0 * np.arctan(width / (2.0 * focal)))
