"""Depth-Anything-V2-Small for phase 1's ``depth.png`` (counterpart of
regen3d_tpu/models/depth_anything.py, the reference's
``depth-anything/Depth-Anything-V2-Small-hf``): the DINOv2 ViT-S/14 trunk
(patch embed, cls token, learned position table resized to the grid, 12
pre-norm blocks with fused qkv and LayerScale, the final norm applied to
every tap) and the DPT head (per-tap 1×1 projections to (48, 96, 192,
384), the ×4 and ×2 transposed convolutions, identity and a stride-2 conv,
the 3×3 ``layer{i}_rn`` convs, four fusion blocks of two residual conv
units, the output convs around a resize to the input size).

At ``DepthAnythingConfig.small()`` (518², patch 14) the trunk runs 1,370
tokens in 6 heads of 64: the flash forward kernel at (1, 6, 1370, 1370,
64), taps after blocks (2, 5, 8, 11). Dtypes as in the JAX module: the
trunk and head in ``cfg.dtype`` (bf16 by default), the position table,
the cls token, the taps' LayerNorm and ``output_conv2b`` in f32; the
weights stored in ``param_dtype`` where given (f32 for training). Built on
the card unless ``device`` is given; names follow the flax tree.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from regen3d_tpu_torch.models.layers import (
    Conv,
    ConvTranspose,
    LayerNorm,
    PatchEmbed,
    ViTBlock,
    init_flax_layers_,
    resize_bilinear,
    store_params_,
)


@dataclasses.dataclass(frozen=True)
class DepthAnythingConfig:
    image_size: int = 518
    patch: int = 14
    width: int = 384               # ViT-S
    depth: int = 12
    num_heads: int = 6
    out_idx: Tuple[int, ...] = (2, 5, 8, 11)
    features: int = 64
    out_channels: Tuple[int, ...] = (48, 96, 192, 384)
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def small(cls) -> "DepthAnythingConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "DepthAnythingConfig":
        return cls(image_size=56, patch=14, width=32, depth=4, num_heads=2,
                   out_idx=(0, 1, 2, 3), features=8,
                   out_channels=(4, 8, 16, 32))


class ResidualConvUnit(nn.Module):
    def __init__(self, ch, dtype, device="cuda"):
        super().__init__()
        self.conv1 = Conv(ch, ch, 3, dtype=dtype, device=device)
        self.conv2 = Conv(ch, ch, 3, dtype=dtype, device=device)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusionBlock(nn.Module):
    """The skip through ``resConfUnit1`` added, ``resConfUnit2``, a
    bilinear resize (×2 unless ``out_hw``), the 1×1 ``out_conv``."""

    def __init__(self, ch, dtype, device="cuda", skip=True):
        super().__init__()
        if skip:    # refinenet4 has none
            self.resConfUnit1 = ResidualConvUnit(ch, dtype, device)
        self.resConfUnit2 = ResidualConvUnit(ch, dtype, device)
        self.out_conv = Conv(ch, ch, 1, dtype=dtype, device=device)

    def forward(self, x, skip=None, out_hw: Optional[Tuple[int, int]] = None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        out_hw = out_hw or (x.shape[1] * 2, x.shape[2] * 2)
        return self.out_conv(resize_bilinear(x, out_hw))


class DepthAnything(nn.Module):
    """(B, H, W, 3) in [0, 1] → relative depth (B, H, W) ≥ 0, f32."""

    def __init__(self, cfg: DepthAnythingConfig = DepthAnythingConfig(),
                 device="cuda", param_dtype=None):
        super().__init__()
        self.cfg = c = cfg
        kw = dict(dtype=c.dtype, device=device)
        side = c.image_size // c.patch
        self.patch_embed = PatchEmbed(c.patch, c.width, **kw)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.width,
                                                  device=device))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + side * side, c.width,
                                                  device=device))
        self.norm = LayerNorm(c.width, device=device)
        for i in range(c.depth):
            setattr(self, f"block{i}", ViTBlock(c.width, c.num_heads,
                                                layer_scale=True, **kw))
        oc, fe = c.out_channels, c.features
        for i in range(4):
            setattr(self, f"project{i}", Conv(c.width, oc[i], 1, **kw))
            setattr(self, f"layer{i + 1}_rn",
                    Conv(oc[i], fe, 3, bias=False, **kw))
            setattr(self, f"refinenet{i + 1}",
                    FeatureFusionBlock(fe, skip=i < 3, **kw))
        self.resize0 = ConvTranspose(oc[0], oc[0], 4, 4, **kw)
        self.resize1 = ConvTranspose(oc[1], oc[1], 2, 2, **kw)
        self.resize3 = Conv(oc[3], oc[3], 3, stride=2, **kw)
        self.output_conv1 = Conv(fe, fe // 2, 3, **kw)
        self.output_conv2a = Conv(fe // 2, 32, 3, **kw)
        self.output_conv2b = Conv(32, 1, 1, device=device)
        store_params_(self, param_dtype)

    def forward(self, img):
        c = self.cfg
        b, h, w = img.shape[:3]
        x, (gh, gw) = self.patch_embed(img.to(c.dtype))
        side = c.image_size // c.patch
        pos_patch = resize_bilinear(
            self.pos_embed[:, 1:].reshape(1, side, side, c.width), (gh, gw))
        x = x + pos_patch.reshape(1, gh * gw, c.width).to(c.dtype)
        cls = (self.cls_token + self.pos_embed[:, :1]).expand(b, 1, c.width)
        x = torch.cat([cls.to(c.dtype), x], 1)
        taps = []
        for i in range(c.depth):
            x = getattr(self, f"block{i}")(x)
            if i in c.out_idx:
                taps.append(self.norm(x)[:, 1:])

        outs = []
        for i, t in enumerate(taps):
            y = getattr(self, f"project{i}")(t.reshape(b, gh, gw, c.width))
            if i == 0:
                y = self.resize0(y)
            elif i == 1:
                y = self.resize1(y)
            elif i == 3:
                y = self.resize3(y)
            outs.append(getattr(self, f"layer{i + 1}_rn")(y))
        path = self.refinenet4(outs[3], out_hw=outs[2].shape[1:3])
        path = self.refinenet3(path, outs[2], out_hw=outs[1].shape[1:3])
        path = self.refinenet2(path, outs[1], out_hw=outs[0].shape[1:3])
        path = self.refinenet1(path, outs[0])
        y = resize_bilinear(self.output_conv1(path), (h, w))
        y = F.relu(self.output_conv2a(y))
        return F.relu(self.output_conv2b(y))[..., 0]


def init_flax_style_(model: DepthAnything, generator: torch.Generator) -> None:
    """Random init from ``generator`` with the JAX module's initializers:
    flax's layer defaults, LayerScale 1e-5, a zero cls token and the
    position table N(0, 0.02²)."""
    init_flax_layers_(model, generator)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, ViTBlock):
                mod.ls1.fill_(1e-5)
                mod.ls2.fill_(1e-5)
        model.cls_token.zero_()
        model.pos_embed.normal_(0.0, 0.02, generator=generator)
