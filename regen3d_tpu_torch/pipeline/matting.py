"""Phase 2's matting net at inference (counterpart of ``MattingModel`` and
``iou`` of regen3d_tpu/pipeline/matting.py; ``synth_matting_batch`` and the
trainer are ROADMAP Queue 1 item 8).

The net runs at ``eval_size``² on its device; the resizes on both sides are
Pillow's BILINEAR, bit for bit without PIL (``utils/image.resize_pil``), as
the JAX package computes them with Pillow. A checkpoint is a directory of
either kind ``models/weights.py`` reads, without a sidecar: ``base`` comes
from the caller (``matting_base`` in the config).
"""

from __future__ import annotations

import numpy as np
import torch

from regen3d_tpu_torch.models.unet import MattingUNet
from regen3d_tpu_torch.models.weights import load_model, save_model
from regen3d_tpu_torch.utils.image import resize_pil


class MattingModel:
    """A loaded :class:`~regen3d_tpu_torch.models.unet.MattingUNet` (on its
    device) and the resolution it runs at."""

    def __init__(self, model: MattingUNet, eval_size: int = 256):
        self.model = model
        self.eval_size = eval_size

    @classmethod
    def load(cls, path: str, base: int = 32, eval_size: int = 256,
             device="cuda") -> "MattingModel":
        """The net of checkpoint directory ``path`` at width ``base`` on
        ``device``. A missing directory raises ``FileNotFoundError``."""
        return cls(load_model(MattingUNet(base=base, device=device), path),
                   eval_size=eval_size)

    def save(self, path: str) -> None:
        save_model(path, self.model)

    @torch.no_grad()
    def alpha(self, img: np.ndarray) -> np.ndarray:
        """uint8/float (H, W, 3) → float32 alpha (H, W) in [0, 1], at the
        input resolution: the image as uint8 resized to eval_size² by
        BILINEAR, the net's alpha clipped and as uint8 resized back the
        same way, each step the JAX package's."""
        h, w = img.shape[:2]
        arr = np.asarray(img)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        s = self.eval_size
        small = resize_pil((arr * 255).astype(np.uint8), (s, s),
                           "bilinear").astype(np.float32) / 255.0
        dev = next(self.model.parameters()).device
        a = self.model(torch.from_numpy(small[None]).to(dev))
        a = a.float().cpu().numpy()[0, ..., 0]
        return resize_pil((np.clip(a, 0, 1) * 255).astype(np.uint8), (h, w),
                          "bilinear").astype(np.float32) / 255.0


def iou(pred: np.ndarray, gt: np.ndarray, thr: float = 0.5) -> float:
    p, g = pred > thr, gt > thr
    inter = np.logical_and(p, g).sum()
    union = np.logical_or(p, g).sum()
    return float(inter) / max(float(union), 1.0)
