"""MIDI-3D comparison baseline, the ``Use_MIDI: true`` workflow and ``-p 10``
(counterpart of regen3d_tpu/pipeline/baseline_midi.py).

Segmentation (phase 1's detector and SAM engine, or boxes from
``<input>.boxes.txt`` under ``seg_mode: box``), then every instance's crop
through the flow-matching generator at once with ``cross_instance`` on:
each DiT block is followed by a gated attention over the concatenated
tokens of all instances, so the scene's instances denoise jointly. Each
instance is also conditioned on its box by a parameter-free Fourier token.
The layout places each mesh on its mask's centroid ray at a depth that
makes it subtend its box. Out go ``combined_scene_midi.glb``
(``glb_scene_path_midi``) and ``segmentation.png`` under ``midi_output``.

The generator, the crops' resize and the DiT run on ``device`` (the
generator's when one is passed); segmentation overlay, layout and meshing
on the host. Without a generator the tiny random-init one is drawn from
the config's seed; its condition encoder runs the flash forward at D = 8.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional

import numpy as np
import torch

from regen3d_tpu_torch.config import Config
from regen3d_tpu_torch.models.layers import fourier_features, resize_bilinear
from regen3d_tpu_torch.pipeline.detection import BoundingBox, DetectionResult
from regen3d_tpu_torch.pipeline.phase1_segmentation import detect_and_segment
from regen3d_tpu_torch.pipeline.phase3_assets import (
    AssetGenerator,
    extract_and_clean,
)
from regen3d_tpu_torch.utils.glb import MeshData, SceneData, save_glb
from regen3d_tpu_torch.utils.image import load_image_rgb, save_image

log = logging.getLogger(__name__)


def _read_boxes(txt_path: str) -> List[List[int]]:
    """The box file: four whitespace-separated ints per line."""
    boxes = []
    with open(txt_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 4:
                boxes.append([int(p) for p in parts])
    return boxes


def box_detections(cfg: Config, h: int, w: int) -> List[DetectionResult]:
    """``seg_mode: box``: one detection per line of ``<input>.boxes.txt``,
    its mask the box."""
    box_txt = os.path.splitext(cfg.path("input_image"))[0] + ".boxes.txt"
    boxes = _read_boxes(box_txt) if os.path.exists(box_txt) else []
    dets = []
    for x0, y0, x1, y1 in boxes:
        m = np.zeros((h, w), bool)
        m[y0:y1, x0:x1] = True
        dets.append(DetectionResult(label="object", score=1.0,
                                    box=BoundingBox(x0, y0, x1, y1), mask=m))
    if not dets:
        log.warning("midi: box mode with no %s — falling back to label",
                    box_txt)
    return dets


def segmentation_overlay(image: np.ndarray, dets) -> np.ndarray:
    """Each mask blended half and half with a colour from
    ``default_rng(0)``."""
    vis = image.copy()
    rng = np.random.default_rng(0)
    for d in dets:
        col = rng.integers(64, 255, 3)
        vis[d.mask] = (0.5 * vis[d.mask] + 0.5 * col).astype(np.uint8)
    return vis


def instance_crops(image: np.ndarray, dets, size: int, device
                   ) -> torch.Tensor:
    """(B, size, size, 4) RGBA crops in [0, 1] on ``device``: each box's
    pixels with its mask as alpha, resized bilinearly (antialiased when it
    shrinks, as ``jax.image.resize``)."""
    crops = []
    for d in dets:
        x0, y0 = int(d.box.xmin), int(d.box.ymin)
        x1, y1 = int(np.ceil(d.box.xmax)), int(np.ceil(d.box.ymax))
        crop = image[max(y0, 0):y1, max(x0, 0):x1].astype(np.float32) / 255.0
        a = d.mask[max(y0, 0):y1, max(x0, 0):x1].astype(np.float32)
        rgba = np.concatenate([crop, a[..., None]], -1)
        crops.append(resize_bilinear(torch.from_numpy(rgba).to(device)[None],
                                     (size, size))[0])
    return torch.stack(crops)


def box_tokens(dets, h: int, w: int, cond_dim: int) -> np.ndarray:
    """(B, 1, cond_dim) f32: the Fourier features (8 frequencies) of each
    normalised box (cx, cy, bw, bh), cut or zero-padded to ``cond_dim``."""
    boxes_n = np.asarray(
        [[(d.box.xmin + d.box.xmax) / (2.0 * w),
          (d.box.ymin + d.box.ymax) / (2.0 * h),
          (d.box.xmax - d.box.xmin) / w,
          (d.box.ymax - d.box.ymin) / h] for d in dets], np.float32)
    ff = fourier_features(torch.from_numpy(boxes_n), 8).numpy()
    tok = np.zeros((len(dets), 1, cond_dim), np.float32)
    tok[:, 0, :min(ff.shape[-1], cond_dim)] = ff[:, :cond_dim]
    return tok


def layout_meshes(dets, vols: np.ndarray, h: int, w: int) -> List[MeshData]:
    """Each volume meshed (``extract_and_clean``) and placed on its box's
    centre ray at the depth where the unit object subtends the box (focal
    max(H, W)); instances without a level set are dropped."""
    focal = max(h, w) * 1.0
    meshes = []
    for i, d in enumerate(dets):
        verts, faces = extract_and_clean(vols[i], None)
        if len(faces) == 0:
            continue
        verts = verts - verts.mean(0)
        ext = float(np.abs(verts).max()) + 1e-6
        bw = d.box.xmax - d.box.xmin
        bh = d.box.ymax - d.box.ymin
        z = 2.0 * focal / max(float(max(bw, bh)), 1.0)
        cx = (d.box.xmin + d.box.xmax) / 2.0
        cy = (d.box.ymin + d.box.ymax) / 2.0
        pos = np.asarray([(cx - w / 2.0) / focal * z,
                          (cy - h / 2.0) / focal * z, z], np.float32)
        scale = z * max(bw, bh) / (2.0 * focal) / ext
        meshes.append(MeshData(name=f"{d.label}_{i}",
                               vertices=(verts * scale + pos).astype(np.float32),
                               faces=faces))
    return meshes


def run(cfg: Config, sam=None, detector=None,
        generator: Optional[AssetGenerator] = None,
        device="cuda") -> Optional[str]:
    """Image → segmentation → joint instance generation → scene GLB.
    Returns the GLB's path (``glb_scene_path_midi``), or None when nothing
    was detected or meshed."""
    out_glb = cfg.path("glb_scene_path_midi",
                       "../output/glb/scene/combined_scene_midi.glb")
    if bool(cfg.get("use_latest_glb", False)) and os.path.exists(out_glb):
        log.info("midi: use_latest_glb — reusing %s", out_glb)
        return out_glb
    if generator is not None:
        device = generator.device
    out_dir = cfg.path("midi_output", "../output/midi/")
    os.makedirs(out_dir, exist_ok=True)
    image = load_image_rgb(cfg.path("input_image"), max_side=None)
    h, w = image.shape[:2]

    seg_mode = str(cfg.get("seg_mode", "label"))
    dets = box_detections(cfg, h, w) if seg_mode == "box" else []
    if not dets:
        thr_cfg = Config({**cfg.values,
                          "threshold": float(cfg.get("detect_threshold",
                                                     0.2))},
                         cfg.base_dir)
        dets = detect_and_segment(thr_cfg, image, sam=sam, detector=detector,
                                  device=device)
    if not dets:
        log.warning("midi: no instances detected")
        return None
    save_image(os.path.join(out_dir, "segmentation.png"),
               segmentation_overlay(image, dets))

    seed = int(cfg.get("seed", 1234567))
    if generator is None:
        log.warning("midi: no checkpoint — random-init generator")
        generator = AssetGenerator.random_init(
            torch.Generator(device=device).manual_seed(seed), tiny=True,
            cross_instance=True, device=device)

    size = 64 if generator.dit_cfg.width < 512 else 512
    res = int(cfg.get("octree_resolution_hy", 256))
    if generator.dit_cfg.width < 512:
        res = min(res, 128)
    vols = generator.generate_sdf_batch(
        torch.Generator(device=device).manual_seed(seed),
        instance_crops(image, dets, size, device),
        int(cfg.get("num_inference_steps_midi", 50)),
        float(cfg.get("guidance_scale_midi", 7.0)), res, 2048,
        extra_cond_tokens=box_tokens(dets, h, w, generator.dit_cfg.cond_dim))

    meshes = layout_meshes(dets, vols, h, w)
    if not meshes:
        log.warning("midi: all instances produced empty level sets")
        return None
    os.makedirs(os.path.dirname(out_glb), exist_ok=True)
    save_glb(out_glb, SceneData(meshes=meshes))
    log.info("midi: %d instances → %s", len(meshes), out_glb)
    return out_glb
