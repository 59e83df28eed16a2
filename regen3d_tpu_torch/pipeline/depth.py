"""Monocular depth prior (counterpart of regen3d_tpu/pipeline/depth.py's
``estimate_depth``).

The reference's ``depth_from_image`` (global_utils.py:357-418) runs Marigold
or Depth-Anything-V2. The port has only the offline prior the JAX package
falls back to without checkpoints; a depth model waits for ROADMAP Queue 1
item 11.
"""

from __future__ import annotations

import numpy as np


def estimate_depth(image: np.ndarray, model=None, params=None) -> np.ndarray:
    """(H, W, 3) uint8 → (H, W) float relative depth in [0, 1]: indoor
    scenes are roughly depth-increasing with image height (floor → wall),
    modulated by inverse luminance contrast."""
    if model is not None:
        raise NotImplementedError(
            "estimate_depth with a depth model is not ported yet (ROADMAP "
            "Queue 1 item 11); the offline prior runs without one")
    h, w = image.shape[:2]
    rows = np.linspace(1.0, 0.2, h)[:, None]
    lum = image.mean(-1) / 255.0
    d = 0.8 * rows + 0.2 * (1.0 - np.abs(lum - np.median(lum)))
    return ((d - d.min()) / max(d.max() - d.min(), 1e-9)).astype(np.float32)
