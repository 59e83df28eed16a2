"""Phase 2's matting net: its synthetic training data, its trainer and its
inference wrapper (counterpart of regen3d_tpu/pipeline/matting.py).

The data are pure numpy, drawn from ``np.random.default_rng(seed)`` as in
the JAX package, so the batches are JAX's bit for bit. The trainer
(``distill_matting``) keeps the weights in f32 and computes in the net's
dtype (bf16 by default), as flax does, with optax's AdamW on a cosine
schedule (``parallel/train.OptaxAdamW``); the net's own init is drawn from
a ``torch.Generator``, so the trained weights are not JAX's, while one
step from the same weights and batch is.

The net runs at ``eval_size``² on its device; the resizes on both sides are
Pillow's BILINEAR, bit for bit without PIL (``utils/image.resize_pil``), as
the JAX package computes them with Pillow. A checkpoint is a directory of
either kind ``models/weights.py`` reads, without a sidecar: ``base`` comes
from the caller (``matting_base`` in the config).
"""

from __future__ import annotations

import logging
from typing import Tuple

import numpy as np
import torch

from regen3d_tpu_torch.models.unet import MattingUNet, init_flax_style_
from regen3d_tpu_torch.models.weights import load_model, save_model
from regen3d_tpu_torch.ops import clip
from regen3d_tpu_torch.parallel.batches import BatchStream
from regen3d_tpu_torch.parallel.train import (
    OptaxAdamW,
    cosine_decay_schedule,
    on_card,
    train_steps,
)
from regen3d_tpu_torch.utils.image import resize_pil

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# synthetic alpha-compositing data (the JAX package's, numpy)
# ---------------------------------------------------------------------------

def _smooth_field(rng: np.random.Generator, size: int, cells: int = 4,
                  lo: float = 0.0, hi: float = 1.0) -> np.ndarray:
    """Low-frequency random field in [lo, hi] via bilinear-upsampled noise."""
    coarse = rng.uniform(lo, hi, (cells, cells)).astype(np.float32)
    idx = np.linspace(0, cells - 1, size)
    x0 = np.clip(idx.astype(np.int32), 0, cells - 2)
    fx = idx - x0
    row = coarse[x0][:, x0] * (1 - fx)[None, :] + coarse[x0][:, x0 + 1] * fx[None, :]
    row2 = coarse[x0 + 1][:, x0] * (1 - fx)[None, :] + coarse[x0 + 1][:, x0 + 1] * fx[None, :]
    return row * (1 - fx)[:, None] + row2 * fx[:, None]


def _soft_blob(rng: np.random.Generator, size: int, n_lobes: int,
               scale: Tuple[float, float]) -> np.ndarray:
    """Union of gaussian lobes → soft [0,1] mask with a crisp-ish core."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    m = np.zeros((size, size), np.float32)
    for _ in range(n_lobes):
        cx, cy = rng.uniform(0.25, 0.75, 2)
        sx = rng.uniform(*scale)
        sy = rng.uniform(*scale)
        th = rng.uniform(0, np.pi)
        dx, dy = xx - cx, yy - cy
        u = dx * np.cos(th) + dy * np.sin(th)
        v = -dx * np.sin(th) + dy * np.cos(th)
        m = np.maximum(m, np.exp(-(u / sx) ** 2 - (v / sy) ** 2))
    return m


def synth_matting_batch(rng: np.random.Generator, batch: int, size: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(images (B,S,S,3) float in [0,1], alphas (B,S,S,1) float in [0,1]):
    a near-white background with a gentle gradient and noise; an object of
    soft lobes sharpened to an alpha with a thin soft edge, textured by a
    low-frequency colour field that may be near-white in places; a contact
    shadow that darkens the background and is not in the alpha."""
    imgs = np.zeros((batch, size, size, 3), np.float32)
    alphas = np.zeros((batch, size, size, 1), np.float32)
    for i in range(batch):
        bg_level = rng.uniform(0.97, 1.0)
        bg = bg_level - 0.02 * _smooth_field(rng, size, 3)
        bg = np.repeat(bg[..., None], 3, -1)
        bg += rng.normal(0, 0.006, bg.shape)
        blob = _soft_blob(rng, size, rng.integers(1, 4), (0.08, 0.28))
        alpha = np.clip((blob - 0.35) / 0.08, 0.0, 1.0)
        fg = np.stack([_smooth_field(rng, size, 4, 0.05, 1.0)
                       for _ in range(3)], -1)
        if rng.random() < 0.7:       # near-white object region
            white_patch = _soft_blob(rng, size, 1, (0.05, 0.15))[..., None]
            fg = fg * (1 - white_patch) + rng.uniform(0.96, 1.0) * white_patch
        if rng.random() < 0.8:       # contact shadow, not in the alpha
            sh = np.roll(blob, (rng.integers(2, size // 6),
                                rng.integers(-size // 8, size // 8)),
                         (0, 1))
            shade = 1.0 - rng.uniform(0.1, 0.35) * np.clip(sh, 0, 1)
            bg = bg * shade[..., None]
        a = alpha[..., None]
        imgs[i] = np.clip(bg * (1 - a) + fg * a, 0.0, 1.0)
        alphas[i] = a
    return imgs, alphas


def threshold_alpha(img: np.ndarray, thresh: float = 246 / 255.0
                    ) -> np.ndarray:
    """The phase-2 fallback matte: non-white-ish pixels are foreground
    (prepare_for_3d's ``arr >= 246`` rule), the baseline to beat."""
    return (~np.all(img >= thresh, axis=-1)).astype(np.float32)[..., None]


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def matting_loss(model: MattingUNet, imgs: torch.Tensor,
                 alphas: torch.Tensor) -> torch.Tensor:
    """BCE + L1 on the alpha, the prediction clipped to [1e-6, 1 − 1e-6]
    as ``jnp.clip`` clips (``ops.clip``)."""
    pred = clip(model(imgs).float(), 1e-6, 1 - 1e-6)
    bce = -(alphas * torch.log(pred)
            + (1 - alphas) * torch.log(1 - pred)).mean()
    return bce + torch.abs(pred - alphas).mean()


def distill_matting(steps: int = 600, batch: int = 16, size: int = 128,
                    base: int = 32, lr: float = 2e-3, seed: int = 0,
                    log_every: int = 100, device="cuda"
                    ) -> Tuple[MattingUNet, np.ndarray]:
    """Train MattingUNet on synthetic compositing → (net with f32 weights
    computing in bf16, the losses). adamw(cosine_decay_schedule(lr,
    steps), b1 0.9, b2 0.95, weight decay 1e-4); each step's batch is drawn
    on the host after the one batch the JAX trainer draws for its init (in
    a worker process on the card: ``BatchStream``)."""
    model = MattingUNet(base=base, device=device, param_dtype=torch.float32)
    init_flax_style_(model, torch.Generator(device).manual_seed(seed))
    opt = OptaxAdamW(model.parameters(), cosine_decay_schedule(lr, steps),
                     b1=0.9, b2=0.95, weight_decay=1e-4)

    with BatchStream(synth_matting_batch, seed, (1, size), (batch, size),
                     steps, on_card(device)) as sample:
        losses = train_steps("matting", steps, sample,
                             lambda i, a: matting_loss(model, i, a), opt,
                             device, log_every)
    return model, losses


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
