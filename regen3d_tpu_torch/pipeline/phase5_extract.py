"""Phase 5: per-object point clouds cut from the scene cloud (counterpart of
regen3d_tpu/pipeline/phase5_extract.py).

Per finding: a binary mask from the white-background PNG, eroded to cut
depth-edge noise; scene_vggt.ply re-based into the render world (B2P(I) +
Y-flip, pc_utils.py:11-40); every point projected through the camera once,
and each object keeps those landing on its mask; quantile / DBSCAN filters;
kNN-PCA normals; out go pointclouds/<stem>.ply,
pointclouds/normals/<stem>_normals.ply and masks/<stem>.png.

The JAX package pads each object's cloud to a power of two to bound its
compiled programs; the port runs each cloud at its own size.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List

import numpy as np
import torch

from regen3d_tpu_torch.artifacts import Artifacts
from regen3d_tpu_torch.camera import Camera, camera_from_npz
from regen3d_tpu_torch.config import Config
from regen3d_tpu_torch.ops import full_f32
from regen3d_tpu_torch.ops.filters import (
    dbscan_largest_cluster,
    estimate_normals,
    quantile_filter,
)
from regen3d_tpu_torch.pipeline.front3d import maybe_extract
from regen3d_tpu_torch.transforms.conventions import blender_to_p3d
from regen3d_tpu_torch.utils.image import erode_mask, mask_from_finding, save_image
from regen3d_tpu_torch.utils.ply import load_ply, save_ply

log = logging.getLogger(__name__)


def scene_cloud_to_world(points: np.ndarray) -> np.ndarray:
    """scene_vggt.ply → render-world frame: fixed B2P(I) rotation + Y-flip
    (reference: get_model_vggt_cloud, pc_utils.py:25-37)."""
    R, t = blender_to_p3d(np.eye(4))
    out = points @ R.T + t
    out[:, 1] *= -1
    return out


def project_and_mask(camera: Camera, points_world: torch.Tensor,
                     masks: torch.Tensor) -> torch.Tensor:
    """(K, N) bool: which points project onto each object's mask
    (masks (K, H, W) bool)."""
    uv, z = camera.project(points_world)
    h, w = masks.shape[1:]
    xi = torch.round(uv[:, 0]).long()
    yi = torch.round(uv[:, 1]).long()
    inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h) & (z > 0)
    hits = masks[:, yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
    return hits & inb[None, :]


def run(cfg: Config, device="cuda") -> Dict[str, int]:
    """Extract per-object clouds for every finding. Returns {stem: n_points}."""
    art = Artifacts(cfg)
    # 3D-FRONT mode derives camera.npz from the dataset's JSON
    maybe_extract(cfg)
    stems = art.list_findings(full_size=True)
    os.makedirs(art.masks_dir, exist_ok=True)
    os.makedirs(art.pointclouds_dir, exist_ok=True)
    os.makedirs(art.normals_dir, exist_ok=True)

    cloud = load_ply(art.scene_cloud_ply).vertices
    world = scene_cloud_to_world(cloud.astype(np.float64)).astype(np.float32)

    shrink_px = int(cfg.get("mask_shrink_pixels", 4))
    shrink_it = int(cfg.get("mask_shrink_iterations", 4))
    masks: List[np.ndarray] = []
    for stem in stems:
        m = mask_from_finding(os.path.join(art.findings_fullsize, f"{stem}.png"))
        m = erode_mask(m, shrink_px, shrink_it)
        save_image(os.path.join(art.masks_dir, f"{stem}.png"),
                   (m * 255).astype(np.uint8))
        masks.append(m)
    if not masks:
        log.warning("phase5: no findings to extract")
        return {}

    # masks are at the finding resolution: so is the camera
    cam = camera_from_npz(art.camera_npz, render_hw=masks[-1].shape,
                          device=device)
    use_quant = bool(cfg.get("filter_vggt_quantile", True))
    use_db = bool(cfg.get("filter_vggt_dbscan", False))
    q = float(cfg.get("quantile_value", 0.02))
    eps = float(cfg.get("dbscan_eps", 0.1))
    min_pts = int(cfg.get("dbscan_min_points", 10))

    counts: Dict[str, int] = {}
    with full_f32():
        world_t = torch.from_numpy(world).to(device)
        hits = project_and_mask(
            cam, world_t, torch.from_numpy(np.stack(masks)).to(device)).cpu().numpy()
        for k, stem in enumerate(stems):
            pts = world[hits[k]]
            if len(pts) < 8:
                log.warning("phase5: %s has %d points — skipped", stem, len(pts))
                counts[stem] = 0
                continue
            tp = torch.from_numpy(pts).to(device)
            keep = torch.ones(len(pts), dtype=torch.bool, device=device)
            if use_quant:
                keep &= quantile_filter(tp, q)
            if use_db:
                keep &= dbscan_largest_cluster(tp, eps, min_pts)
            pts = pts[keep.cpu().numpy()]
            if len(pts) < 8:
                counts[stem] = 0
                continue
            kk = 30 if len(pts) > 30 else len(pts) - 1
            normals = estimate_normals(torch.from_numpy(pts).to(device), k=kk,
                                       viewpoint=cam.center).cpu().numpy()
            save_ply(os.path.join(art.pointclouds_dir, f"{stem}.ply"), pts)
            save_ply(os.path.join(art.normals_dir, f"{stem}_normals.ply"), pts,
                     normals=normals)
            counts[stem] = len(pts)
            log.info("phase5: %s → %d points", stem, len(pts))
    return counts
