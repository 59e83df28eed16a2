"""The saliency net's phase-1 wrapper (counterpart of the ``SaliencyModel``
of regen3d_tpu/pipeline/saliency_distill.py; its trainer and checkpoint
writer are ROADMAP Queue 1 item 8, its orbax loader item 1)."""

from __future__ import annotations

import numpy as np
import torch

from regen3d_tpu_torch.models.layers import resize_bilinear
from regen3d_tpu_torch.models.saliency import SaliencyTransformer


class SaliencyModel:
    """A :class:`~regen3d_tpu_torch.models.saliency.SaliencyTransformer`
    (holding its weights, on its device) that maps an RGB image of any
    size, uint8 or float, to an (H, W) f32 saliency map."""

    def __init__(self, model: SaliencyTransformer):
        self.model = model
        self.cfg = model.cfg

    @torch.no_grad()
    def saliency(self, image: np.ndarray) -> np.ndarray:
        """The image in [0, 1] (divided by 255 when its maximum passes
        1.5), resized as ``jax.image.resize`` does to the net's square
        input, its map resized back to (H, W)."""
        h, w = image.shape[:2]
        arr = np.asarray(image, np.float32)
        if arr.max() > 1.5:
            arr = arr / 255.0
        dev = self.model.saliency_token.device
        s = self.cfg.image_size
        small = resize_bilinear(torch.from_numpy(arr).to(dev)[None], (s, s))
        m = self.model(small)[0]
        return resize_bilinear(m[None, :, :, None].float(),
                               (h, w))[0, ..., 0].cpu().numpy()
