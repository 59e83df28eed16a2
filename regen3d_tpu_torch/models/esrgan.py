"""RealESRGAN ×4 (RRDBNet), the Hunyuan3D-2.1 variant's texture upscaler
(counterpart of regen3d_tpu/models/esrgan.py): conv_first → num_block ×
RRDB → conv_body residual → two nearest-2× upsample convs → conv_hr →
conv_last, LeakyReLU 0.2, residual scaling 0.2; NHWC at the interface.

Precision: the net is f32 in the JAX package and here. On the card
cuDNN's convolutions take TF32 when ``torch.backends.cudnn.allow_tf32`` is
set, which PyTorch sets by default: the port's card computes each
convolution's products with 10-bit mantissas and f32 sums then. The module
sets no global flag; a caller that wants IEEE f32 products on the card
clears ``allow_tf32`` itself. Submodules carry the flax tree's names
(``body_{i}.rdb{j}.conv{k}``), so ``models/from_jax.py`` maps the JAX
package's parameters by name. Built on the card unless ``device`` is given.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from regen3d_tpu_torch.models.layers import Conv, init_flax_layers_


@dataclasses.dataclass(frozen=True)
class ESRGANConfig:
    num_feat: int = 64
    num_block: int = 23
    num_grow_ch: int = 32
    scale: int = 4                 # fixed ×4 (two ×2 stages)

    @classmethod
    def x4plus(cls) -> "ESRGANConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "ESRGANConfig":
        return cls(num_feat=16, num_block=2, num_grow_ch=8)


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def _conv(c_in, c_out, device):
    return Conv(c_in, c_out, 3, dtype=torch.float32, device=device)


class ResidualDenseBlock(nn.Module):
    def __init__(self, feat, grow, device="cuda"):
        super().__init__()
        for i in range(4):
            self.add_module(f"conv{i + 1}", _conv(feat + i * grow, grow,
                                                  device))
        self.conv5 = _conv(feat + 4 * grow, feat, device)

    def forward(self, x):
        xs = [x]
        for i in range(4):
            xs.append(_lrelu(getattr(self, f"conv{i + 1}")(torch.cat(xs, -1))))
        return x + 0.2 * self.conv5(torch.cat(xs, -1))


class RRDB(nn.Module):
    def __init__(self, feat, grow, device="cuda"):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(feat, grow, device)
        self.rdb2 = ResidualDenseBlock(feat, grow, device)
        self.rdb3 = ResidualDenseBlock(feat, grow, device)

    def forward(self, x):
        return x + 0.2 * self.rdb3(self.rdb2(self.rdb1(x)))


class RRDBNet(nn.Module):
    """(B, H, W, 3) in [0, 1] → (B, 4H, 4W, 3) f32."""

    def __init__(self, cfg: ESRGANConfig, device="cuda"):
        super().__init__()
        c = self.cfg = cfg
        self.conv_first = _conv(3, c.num_feat, device)
        for i in range(c.num_block):
            self.add_module(f"body_{i}", RRDB(c.num_feat, c.num_grow_ch,
                                              device))
        self.conv_body = _conv(c.num_feat, c.num_feat, device)
        self.conv_up1 = _conv(c.num_feat, c.num_feat, device)
        self.conv_up2 = _conv(c.num_feat, c.num_feat, device)
        self.conv_hr = _conv(c.num_feat, c.num_feat, device)
        self.conv_last = _conv(c.num_feat, 3, device)

    def forward(self, x):
        feat = self.conv_first(x.float())
        body = feat
        for i in range(self.cfg.num_block):
            body = getattr(self, f"body_{i}")(body)
        feat = feat + self.conv_body(body)
        for up in (self.conv_up1, self.conv_up2):
            feat = feat.repeat_interleave(2, 1).repeat_interleave(2, 2)
            feat = _lrelu(up(feat))
        return self.conv_last(_lrelu(self.conv_hr(feat)))


@torch.no_grad()
def upscale_x4(model: RRDBNet, img: np.ndarray, tile: Optional[int] = 256,
               overlap: int = 16) -> np.ndarray:
    """×4 upscale of an (H, W, 3) image in [0, 1] on ``model``'s device →
    (4H, 4W, 3) f32 in [0, 1]. Over ``tile`` pixels a side the image goes
    in tiles of ``tile − 2·overlap`` pixels, each run with ``overlap``
    pixels of context on every side the image has and cropped to its
    interior, as the JAX package tiles it."""
    dev = next(model.parameters()).device

    def fwd(a):
        return model(torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                                     device=dev)[None])[0].cpu().numpy()

    h, w = img.shape[:2]
    if tile is None or (h <= tile and w <= tile):
        return np.clip(fwd(img), 0.0, 1.0)
    s = model.cfg.scale
    out = np.zeros((h * s, w * s, 3), np.float32)
    step = tile - 2 * overlap
    for y0 in range(0, h, step):
        for x0 in range(0, w, step):
            ya, xa = max(y0 - overlap, 0), max(x0 - overlap, 0)
            yb = min(y0 + step + overlap, h)
            xb = min(x0 + step + overlap, w)
            patch = fwd(img[ya:yb, xa:xb])
            cy0, cx0 = (y0 - ya) * s, (x0 - xa) * s
            cy1 = cy0 + (min(y0 + step, h) - y0) * s
            cx1 = cx0 + (min(x0 + step, w) - x0) * s
            out[y0 * s:y0 * s + (cy1 - cy0),
                x0 * s:x0 * s + (cx1 - cx0)] = patch[cy0:cy1, cx0:cx1]
    return np.clip(out, 0.0, 1.0)


def init_flax_style_(model: nn.Module, generator: torch.Generator) -> None:
    """flax's default init: lecun-normal (truncated) kernels, zero biases."""
    init_flax_layers_(model, generator)
