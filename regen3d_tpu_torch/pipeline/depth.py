"""Monocular depth for phase 1's ``depth.png`` (counterpart of
regen3d_tpu/pipeline/depth.py).

The reference's ``depth_from_image`` (global_utils.py:357-418) runs Marigold
(``depth_large_model: true``) or Depth-Anything-V2-Small. The port runs
:class:`~regen3d_tpu_torch.models.depth_anything.DepthAnything` when one is
passed, on the device it was built on, and otherwise the offline prior the
JAX package falls back to. Marigold waits for ROADMAP Queue 1 item 5. A
``depth_anything_checkpoint`` that exists loads the model
(``pipeline/depth_distill.load_depth_checkpoint``: the JAX package's orbax
directory or the port's, with its ``config.json``); a missing one falls
back to the prior as in the JAX package.
"""

from __future__ import annotations

import logging
import os
from typing import Mapping, Optional

import numpy as np
import torch

from regen3d_tpu_torch.artifacts import Artifacts
from regen3d_tpu_torch.models.layers import resize_bilinear
from regen3d_tpu_torch.utils.image import load_image_rgb, save_image

log = logging.getLogger(__name__)


@torch.no_grad()
def estimate_depth(image: np.ndarray, model=None) -> np.ndarray:
    """(H, W, 3) uint8 → (H, W) float32 relative depth in [0, 1].

    With a model (a ``DepthAnything``): the image in [0, 1] resized
    (``jax.image.resize``'s bilinear, antialiased when it shrinks) to the
    model's square input, its depth min-max normalised and resized back to
    (H, W). Without one:
    indoor scenes are roughly depth-increasing with image height (floor →
    wall), modulated by inverse luminance contrast."""
    if model is not None:
        dev = next(model.parameters()).device
        size = model.cfg.image_size
        img = torch.from_numpy(np.ascontiguousarray(image)).to(dev)
        img = resize_bilinear(img[None].float() / 255.0, (size, size))
        d = model(img)[0].float()
        d = (d - d.min()) / torch.clamp(d.max() - d.min(), min=1e-9)
        d = resize_bilinear(d[None, :, :, None], image.shape[:2])[0, ..., 0]
        return d.cpu().numpy()
    h, w = image.shape[:2]
    rows = np.linspace(1.0, 0.2, h)[:, None]
    lum = image.mean(-1) / 255.0
    d = 0.8 * rows + 0.2 * (1.0 - np.abs(lum - np.median(lum)))
    return ((d - d.min()) / max(d.max() - d.min(), 1e-9)).astype(np.float32)


def run(cfg: Mapping, model=None, device="cuda") -> Optional[str]:
    """Write ``Artifacts.depth_scene`` (``output/findings/depth.png``) for
    ``input_image``: ``estimate_depth`` × 255 as uint8, with ``model``, or
    else the model of ``depth_anything_checkpoint`` loaded on ``device``.
    Returns its path."""
    art = Artifacts(cfg)
    ckpt = str(cfg.get("depth_anything_checkpoint", "") or "")
    if model is None and ckpt and os.path.exists(ckpt):
        from regen3d_tpu_torch.pipeline.depth_distill import (
            load_depth_checkpoint,
        )
        model = load_depth_checkpoint(ckpt, device=device)
        log.info("depth: Depth-Anything checkpoint %s", ckpt)
    elif model is None and ckpt:
        log.warning("depth: depth_anything_checkpoint %s missing — the "
                    "offline prior", ckpt)
    img = load_image_rgb(cfg.path("input_image"), max_side=1280)
    depth = estimate_depth(img, model)
    out = art.depth_scene
    save_image(out, (depth * 255).astype(np.uint8))
    log.info("depth: wrote %s", out)
    return out
