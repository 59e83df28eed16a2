"""3D-FRONT camera extraction, the ``use_3d_front: true`` path (counterpart
of regen3d_tpu/pipeline/front3d.py).

Reads the camera saved beside a 3D-FRONT scene render,

  {"camera": {"pos": [x, y, z], "look_at"|"target": [x, y, z],
              "up": [x, y, z] (optional), "fov": degrees (horizontal)},
   "width": W, "height": H}

(or the same keys at the top level), and writes phase 4's camera.npz from
it. A small host computation: the look-at camera is built on the CPU.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Optional

import numpy as np

from regen3d_tpu_torch.artifacts import Artifacts
from regen3d_tpu_torch.camera import lookat_camera, save_camera_npz
from regen3d_tpu_torch.config import Config
from regen3d_tpu_torch.transforms.conventions import p3d_to_blender

log = logging.getLogger(__name__)


def extract_camera_from_json(json_path: str, npz_path: str,
                             default_wh=(1280, 960)) -> str:
    """The JSON's camera → camera.npz at ``npz_path`` (the look-at camera's
    extrinsic in Blender's convention, the focal from the horizontal field
    of view). Returns ``npz_path``."""
    with open(json_path) as f:
        meta = json.load(f)
    cam = meta.get("camera", meta)
    pos = np.asarray(cam["pos"], np.float64)
    target = np.asarray(cam.get("look_at", cam.get("target",
                                                   pos + [0, 0, 1])), np.float64)
    fov_deg = float(cam.get("fov", 70.0))
    width = int(meta.get("width", default_wh[0]))
    height = int(meta.get("height", default_wh[1]))
    up = np.asarray(cam.get("up", [0, 1, 0]), np.float64)

    focal = (width / 2.0) / np.tan(np.radians(fov_deg) / 2.0)
    c = lookat_camera(pos.astype(np.float32), target.astype(np.float32),
                      (height, width), focal_px=float(focal),
                      up=up.astype(np.float32), device="cpu")
    ext_blender = p3d_to_blender(c.R.numpy(), c.T.numpy())
    save_camera_npz(npz_path, ext_blender, float(focal), (width, height))
    log.info("front3d: camera from %s → %s (fov %.1f°, %dx%d)",
             json_path, npz_path, fov_deg, width, height)
    return npz_path


def maybe_extract(cfg: Config) -> Optional[str]:
    """With ``use_3d_front`` set, camera.npz from the scene JSON beside the
    input image (``<input>.json``); None when the flag is off or the JSON
    is missing (with a warning)."""
    if not bool(cfg.get("use_3d_front", False)):
        return None
    img = cfg.path("input_image")
    json_path = os.path.splitext(img)[0] + ".json"
    if not os.path.exists(json_path):
        log.warning("front3d: no %s — cannot extract camera", json_path)
        return None
    art = Artifacts(cfg)
    os.makedirs(os.path.dirname(art.camera_npz), exist_ok=True)
    return extract_camera_from_json(json_path, art.camera_npz)
