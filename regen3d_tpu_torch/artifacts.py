"""The filesystem data bus: typed registry of every artifact the phases exchange.

The reference's phases communicate exclusively through files under
``output/`` whose locations are scattered across config keys and hard-coded
join logic (reference: src/config.yaml:56-57,146-148,163,224-227,265,273,
344-357,369,397). Object identity travels in *filenames* of the form
``<label>__(cx, cy).png`` (reference: src/segmentation/segmentation.py:891,903,
matched downstream at src/scene_reconstruction/run.py:66-76).

This module centralizes that contract so every phase reads/writes the same
canonical paths, and provides the finding-name codec.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import List, Optional, Tuple

from regen3d_tpu_torch.config import Config

# --- finding-filename codec: "<label>__(cx, cy)" -----------------------------
_FINDING_RE = re.compile(r"^(?P<label>.+)__\((?P<cx>-?\d+),\s*(?P<cy>-?\d+)\)$")


def finding_stem(label: str, center_xy: Tuple[int, int]) -> str:
    """Encode an object identity: label + integer mask-centroid pixel coords."""
    cx, cy = int(center_xy[0]), int(center_xy[1])
    return f"{label}__({cx}, {cy})"


def parse_finding_stem(stem: str) -> Optional[Tuple[str, Tuple[int, int]]]:
    """Decode ``<label>__(cx, cy)``; returns None for non-conforming names."""
    m = _FINDING_RE.match(stem)
    if not m:
        return None
    return m.group("label"), (int(m.group("cx")), int(m.group("cy")))


@dataclass(frozen=True)
class Artifacts:
    """Canonical output/ layout (reference citations inline)."""

    cfg: Config

    # --- roots ---------------------------------------------------------------
    @property
    def output(self) -> str:
        return self.cfg.output_root

    @property
    def temp(self) -> str:
        return self.cfg.path("temp", "../tmp")

    # --- phase 1: segmentation (config.yaml:56-57) ----------------------------
    @property
    def findings(self) -> str:
        return self.cfg.path("output_seg", "../output/findings")

    @property
    def findings_fullsize(self) -> str:
        return os.path.join(self.findings, "fullSize")

    @property
    def findings_cropped(self) -> str:
        return os.path.join(self.findings, "cropped")

    @property
    def banana_root(self) -> str:
        return self.cfg.path("output_seg_banana", "../output/findings/banana")

    @property
    def banana_outline(self) -> str:
        return os.path.join(self.banana_root, "outline")

    @property
    def banana_bbox(self) -> str:
        return os.path.join(self.banana_root, "bbox")

    @property
    def banana_layouts(self) -> str:
        return os.path.join(self.banana_root, "segmentation_layouts")

    @property
    def depth_scene(self) -> str:
        return self.cfg.path("depth_scene", "../output/findings/depth.png")

    # --- phase 2: inpainting (config.yaml:146-148) -----------------------------
    @property
    def inpaint_dir(self) -> str:
        return self.cfg.path("output_inp_banana",
                             "../output/findings/banana/inpaint_nanoBanana")

    @property
    def prepped_dir(self) -> str:
        return self.cfg.path("prepped_for_hunyuan",
                             "../output/findings/banana/prepped")

    @property
    def empty_room(self) -> str:
        return os.path.join(self.inpaint_dir, "empty_room.png")

    # --- phase 3: 3D assets (config.yaml:163) ----------------------------------
    @property
    def assets_root(self) -> str:
        return self.cfg.path("output_folder_hy", "../output/3D/")

    def asset_glb(self, name: str) -> str:
        return os.path.join(self.assets_root, name, f"{name}.glb")

    def list_assets(self) -> List[str]:
        if not os.path.isdir(self.assets_root):
            return []
        names = []
        for d in sorted(os.listdir(self.assets_root)):
            if os.path.isfile(self.asset_glb(d)):
                names.append(d)
        return names

    # --- phase 4: camera + clouds (config.yaml:224-227) -------------------------
    @property
    def pre3d_dir(self) -> str:
        return self.cfg.path("tmp_dir", "../output/pre_3D")

    @property
    def camera_npz(self) -> str:
        return self.cfg.path("camera", "../output/pre_3D/camera.npz")

    @property
    def camera_empty_npz(self) -> str:
        return os.path.join(os.path.dirname(self.camera_npz), "camera_emptyRoom.npz")

    @property
    def scene_cloud_ply(self) -> str:
        return self.cfg.path("vggt_cloud", "../output/pre_3D/scene_vggt.ply")

    @property
    def colmap_sparse(self) -> str:
        return self.cfg.path("output_vggt", "../output/vggt/sparse")

    @property
    def points_ply(self) -> str:
        return os.path.join(self.colmap_sparse, "points.ply")

    @property
    def points_empty_ply(self) -> str:
        return os.path.join(self.colmap_sparse, "points_emptyRoom.ply")

    @property
    def image_list_txt(self) -> str:
        return os.path.join(self.colmap_sparse, "image_list.txt")

    # --- phase 5: per-object clouds (config.yaml:265,344,357) -------------------
    @property
    def masks_dir(self) -> str:
        return self.cfg.path("mask_folder", "../output/masks")

    @property
    def pointclouds_dir(self) -> str:
        return self.cfg.path("output_ply", "../output/pointclouds/")

    @property
    def normals_dir(self) -> str:
        return os.path.join(self.pointclouds_dir, "normals")

    @property
    def meshed_dir(self) -> str:
        return self.cfg.path("out_pc_meshed", "../output/pointclouds/meshed/")

    @property
    def ground_aligned_glb(self) -> str:
        return os.path.join(self.meshed_dir, "ground_aligned.glb")

    # --- phase 6: fitted objects (config.yaml:273) -------------------------------
    @property
    def glb_dir(self) -> str:
        return self.cfg.path("glb_output_folder", "../output/glb/")

    def fitted_glb(self, name: str) -> str:
        return os.path.join(self.glb_dir, f"{name}.glb")

    # --- phase 7: assembled scene (config.yaml:347) -------------------------------
    @property
    def combined_scene_glb(self) -> str:
        return self.cfg.path("glb_scene_path", "../output/glb/scene/combined_scene.glb")

    @property
    def combined_scene_bp_ply(self) -> str:
        return self.cfg.path("ply_scene_bp_path",
                             "../output/pointclouds/scene/combined_scene_bp.ply")

    @property
    def pred_points_ply(self) -> str:
        return self.cfg.path("ply_pred_points",
                             "../output/pointclouds/scene/pred_points.ply")

    @property
    def gt_points_ply(self) -> str:
        return self.cfg.path("ply_gt_points",
                             "../output/pointclouds/scene/gt_points.ply")

    # --- phase 8/9 (config.yaml:369,397) -------------------------------------------
    @property
    def rendering_dir(self) -> str:
        return self.cfg.path("output_render", "../output/rendering/")

    @property
    def predicted_image(self) -> str:
        return self.cfg.path("predicted_image",
                             "../output/rendering/render_cam1_white_bg.png")

    @property
    def eval_dir(self) -> str:
        return self.cfg.path("eval_output_dir", "../output/evaluation/")

    # --- helpers -----------------------------------------------------------------
    def list_findings(self, full_size: bool = True) -> List[str]:
        """Finding stems present on the bus, sorted (the object work-list)."""
        d = self.findings_fullsize if full_size else self.findings_cropped
        if not os.path.isdir(d):
            return []
        stems = []
        for f in sorted(os.listdir(d)):
            if f.lower().endswith(".png"):
                stems.append(os.path.splitext(f)[0])
        return stems

    def ensure_dirs(self, *paths: str) -> None:
        for p in paths:
            os.makedirs(p, exist_ok=True)


def clear_output_directory(path: str) -> None:
    """Delete all files under ``path`` (reference: global_utils.py:443-461)."""
    if not os.path.isdir(path):
        return
    for root, _dirs, files in os.walk(path):
        for f in files:
            try:
                os.remove(os.path.join(root, f))
            except OSError:
                pass
