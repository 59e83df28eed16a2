"""The saliency net's phase-1 wrapper and its checkpoint (counterpart of
``SaliencyModel`` and ``save_saliency_checkpoint`` of
regen3d_tpu/pipeline/saliency_distill.py; the trainer is ROADMAP Queue 1
item 8). A checkpoint is a directory of either kind ``models/weights.py``
reads, with a ``config.json`` sidecar of the ``SaliencyConfig`` without its
dtype."""

from __future__ import annotations

import numpy as np
import torch

from regen3d_tpu_torch.models.from_jax import SALIENCY_CONV_TRANSPOSE
from regen3d_tpu_torch.models.layers import resize_bilinear
from regen3d_tpu_torch.models.saliency import SaliencyConfig, SaliencyTransformer
from regen3d_tpu_torch.models.weights import (
    load_model,
    read_config_json,
    save_model,
)


def save_saliency_checkpoint(path: str, net: SaliencyTransformer) -> None:
    """``net``'s weights as the port's checkpoint directory, with its
    config as the sidecar."""
    save_model(path, net, net.cfg, SALIENCY_CONV_TRANSPOSE)


class SaliencyModel:
    """A :class:`~regen3d_tpu_torch.models.saliency.SaliencyTransformer`
    (holding its weights, on its device) that maps an RGB image of any
    size, uint8 or float, to an (H, W) f32 saliency map."""

    def __init__(self, model: SaliencyTransformer):
        self.model = model
        self.cfg = model.cfg

    @classmethod
    def load(cls, path: str, device="cuda") -> "SaliencyModel":
        """The net of checkpoint directory ``path`` on ``device``, at the
        sidecar's config (its default dtype) or, without one,
        ``SaliencyConfig()``. A missing directory raises
        ``FileNotFoundError``."""
        d = read_config_json(path)
        cfg = SaliencyConfig(**d) if d is not None else SaliencyConfig()
        return cls(load_model(SaliencyTransformer(cfg, device=device), path,
                              SALIENCY_CONV_TRANSPOSE))

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
