"""The saliency net's synthetic scenes, trainer, phase-1 wrapper and
checkpoint (counterpart of regen3d_tpu/pipeline/saliency_distill.py). A
checkpoint is a directory of either kind ``models/weights.py`` reads, with
a ``config.json`` sidecar of the ``SaliencyConfig`` without its dtype.

The scenes are numpy from ``np.random.default_rng(seed)`` but for the
background fields, which JAX upsamples with ``jax.image.resize``: the port
uses ``layers.resize_bilinear``, so the batches agree to f32 rounding. The
trainer keeps the weights in f32 and computes in ``cfg.dtype``; at
``small_config()`` every attention has heads of 24, which the flash
kernels take at width 32 (forward and backward).
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np
import torch

from regen3d_tpu_torch.models.from_jax import SALIENCY_CONV_TRANSPOSE
from regen3d_tpu_torch.models.layers import resize_bilinear
from regen3d_tpu_torch.models.saliency import (
    SaliencyConfig,
    SaliencyTransformer,
    init_flax_style_,
)
from regen3d_tpu_torch.models.weights import (
    load_model,
    read_config_json,
    save_model,
)
from regen3d_tpu_torch.ops import clip
from regen3d_tpu_torch.parallel.batches import BatchStream
from regen3d_tpu_torch.parallel.train import (
    OptaxAdamW,
    cosine_decay_schedule,
    on_card,
    train_steps,
)

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# synthetic salient-object scenes
# ---------------------------------------------------------------------------

def _field(rng, size, cells, lo=0.0, hi=1.0):
    coarse = rng.uniform(lo, hi, (cells, cells, 3)).astype(np.float32)
    up = resize_bilinear(torch.from_numpy(coarse)[None], (size, size))
    return up[0].numpy()


def _blob_mask(rng, size, cx, cy, scale):
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    m = np.zeros((size, size), np.float32)
    for _ in range(rng.integers(1, 4)):
        ox, oy = rng.uniform(-0.06, 0.06, 2)
        sx, sy = rng.uniform(scale * 0.6, scale, 2)
        th = rng.uniform(0, np.pi)
        dx, dy = xx - (cx + ox), yy - (cy + oy)
        u = dx * np.cos(th) + dy * np.sin(th)
        v = -dx * np.sin(th) + dy * np.cos(th)
        m = np.maximum(m, np.exp(-(u / sx) ** 2 - (v / sy) ** 2))
    return np.clip((m - 0.35) / 0.1, 0.0, 1.0)


def synth_saliency_batch(rng: np.random.Generator, batch: int, size: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """(images (B,S,S,3) in [0,1], saliency GT (B,S,S) in {0, 1}): a
    low-contrast background with clutter blobs of its own palette and one
    high-contrast multi-lobe object at a uniform position, coloured by the
    RGB cube's corner farthest from the background's mean."""
    imgs = np.zeros((batch, size, size, 3), np.float32)
    gts = np.zeros((batch, size, size), np.float32)
    for i in range(batch):
        bg = _field(rng, size, rng.integers(2, 5), 0.38, 0.62)
        for _ in range(rng.integers(2, 6)):
            cm = _blob_mask(rng, size, rng.uniform(0.1, 0.9),
                            rng.uniform(0.1, 0.9), 0.06)
            cc = np.clip(bg.mean((0, 1)) + rng.normal(0, 0.05, 3), 0, 1)
            bg = bg * (1 - cm[..., None]) + cc * cm[..., None]
        cx, cy = rng.uniform(0.15, 0.85, 2)
        om = _blob_mask(rng, size, cx, cy, rng.uniform(0.10, 0.22))
        base = bg.mean((0, 1))
        oc = np.clip(np.where(base < 0.5, 1.0, 0.0)
                     + rng.normal(0, 0.05, 3), 0, 1)
        tex = 0.85 + 0.3 * _field(rng, size, 4)[..., :3]
        img = bg * (1 - om[..., None]) + (oc * tex + (1 - tex) * 0.5) \
            * om[..., None]
        img = np.clip(img + rng.normal(0, 0.015, img.shape), 0, 1)
        imgs[i] = img
        gts[i] = (om > 0.5).astype(np.float32)
    return imgs, gts


def center_prior(size: int) -> np.ndarray:
    """The classic no-learning saliency baseline: a centred gaussian."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    return np.exp(-(((xx - 0.5) / 0.28) ** 2 + ((yy - 0.5) / 0.28) ** 2))


def mae(pred: np.ndarray, gt: np.ndarray) -> float:
    """Mean absolute error of the min-max normalised map, the saliency
    benchmark metric."""
    p = (pred - pred.min()) / max(pred.max() - pred.min(), 1e-9)
    return float(np.abs(p - gt).mean())


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def small_config(size: int = 96) -> SaliencyConfig:
    """The trainable dims of the same T2T arch (heads of 24 throughout)."""
    return SaliencyConfig(image_size=size, width=96, depth=3, num_heads=4)


def saliency_loss(model: SaliencyTransformer, imgs: torch.Tensor,
                  gts: torch.Tensor) -> torch.Tensor:
    """Class-balanced BCE (salient pixels weighted by 1 / their share,
    clipped to [1e-3, 0.5]) plus the soft Dice, the prediction clipped to
    [1e-6, 1 − 1e-6] as ``jnp.clip`` clips."""
    pred = clip(model(imgs).float(), 1e-6, 1 - 1e-6)
    pos = clip(gts.mean(), 1e-3, 0.5)
    w = gts / pos + (1 - gts) / (1 - pos)
    bce = -(w * (gts * torch.log(pred)
                 + (1 - gts) * torch.log(1 - pred))).mean() / 2
    inter = (pred * gts).sum((1, 2))
    dice = 1 - (2 * inter + 1) / (pred.sum((1, 2)) + gts.sum((1, 2)) + 1)
    return bce + dice.mean()


def distill_saliency(cfg: Optional[SaliencyConfig] = None, steps: int = 300,
                     batch: int = 8, lr: float = 1e-3, seed: int = 0,
                     log_every: int = 50, device="cuda"
                     ) -> Tuple[SaliencyTransformer, np.ndarray]:
    """Train the saliency net on synthetic scenes → (net with f32 weights
    computing in ``cfg.dtype``, the losses); adamw(cosine_decay_schedule(
    lr, steps), b1 0.9, b2 0.95, weight decay 1e-4)."""
    cfg = cfg or small_config()
    s = cfg.image_size
    model = SaliencyTransformer(cfg, device=device, param_dtype=torch.float32)
    init_flax_style_(model, torch.Generator(device).manual_seed(seed))
    opt = OptaxAdamW(model.parameters(), cosine_decay_schedule(lr, steps),
                     b1=0.9, b2=0.95, weight_decay=1e-4)

    # after the batch the JAX trainer draws for its init
    with BatchStream(synth_saliency_batch, seed, (1, s), (batch, s), steps,
                     on_card(device)) as sample:
        losses = train_steps("saliency", steps, sample,
                             lambda i, g: saliency_loss(model, i, g), opt,
                             device, log_every)
    return model, losses


# ---------------------------------------------------------------------------
# checkpoint + inference wrapper (the phase-1 consumer)
# ---------------------------------------------------------------------------


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
