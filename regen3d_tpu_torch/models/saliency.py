"""Saliency transformer for phase 1's ``saliency`` point strategy
(counterpart of regen3d_tpu/models/saliency.py, the VST role): a
tokens-to-token stem (two overlapping soft splits with token mixing, 16×
down), a transformer encoder with a saliency token, the token's
cross-attention into the patches, and a reverse-T2T decoder back to the
stride-4 grid, whose logits are resized to the input.

At ``SaliencyConfig()`` (224², width 384, depth 6, 6 heads of 64) the
stem's blocks and ``dec8`` are 2-head blocks of width 192, so the flash
forward kernel runs at head dim 96 over 3,136 tokens (stride 4) and 784
(stride 8); the encoder at 197 tokens and ``decode`` at 196 queries
against the saliency token alone (Sk = 1), both at head dim 64. Dtypes as
in the JAX module: everything in ``cfg.dtype`` (bf16 by default) but the
saliency token (stored f32), the final ``out`` Dense and the resize (f32).
The weights are stored in ``param_dtype`` where given (f32 for training).
Built on the card unless ``device`` is given; names follow the flax tree.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from regen3d_tpu_torch.models.layers import (
    Attention,
    Conv,
    ConvTranspose,
    Dense,
    LayerNorm,
    TransformerBlock,
    init_flax_layers_,
    posemb_sincos_2d,
    resize_bilinear,
    store_params_,
)


@dataclasses.dataclass(frozen=True)
class SaliencyConfig:
    image_size: int = 224
    width: int = 384
    depth: int = 6
    num_heads: int = 6
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def tiny(cls) -> "SaliencyConfig":
        return cls(image_size=64, width=64, depth=2, num_heads=4)


class T2TStem(nn.Module):
    """Two overlapping soft splits (7×7 stride 4, 3×3 stride 2), each
    followed by a 2-head block with mlp ratio 1, and a 3×3 stride-2
    projection to ``width``: → (stride-16 features, stride-8 skip,
    stride-4 skip)."""

    def __init__(self, width, dtype, in_ch=6, device="cuda"):
        super().__init__()
        half = width // 2
        kw = dict(dtype=dtype, device=device)
        self.dtype = dtype
        self.unfold1 = Conv(in_ch, half, 7, stride=4, **kw)
        self.t2t1 = TransformerBlock(half, 2, mlp_ratio=1.0, **kw)
        self.unfold2 = Conv(half, half, 3, stride=2, **kw)
        self.t2t2 = TransformerBlock(half, 2, mlp_ratio=1.0, **kw)
        self.proj = Conv(half, width, 3, stride=2, **kw)

    def forward(self, img):
        x = self.unfold1(img.to(self.dtype))
        b, h, w, c = x.shape
        s4 = self.t2t1(x.reshape(b, h * w, c)).reshape(b, h, w, c)
        x = self.unfold2(s4)
        b, h, w, c = x.shape
        s8 = self.t2t2(x.reshape(b, h * w, c)).reshape(b, h, w, c)
        return self.proj(s8), s8, s4


class SaliencyTransformer(nn.Module):
    """(B, H, W, 3) in [0, 1] → (B, H, W) saliency in [0, 1], f32."""

    def __init__(self, cfg: SaliencyConfig = SaliencyConfig(), device="cuda",
                 param_dtype=None):
        super().__init__()
        self.cfg = cfg
        c, half = cfg, cfg.width // 2
        kw = dict(dtype=c.dtype, device=device)
        self.stem = T2TStem(c.width, c.dtype, device=device)
        self.saliency_token = nn.Parameter(torch.zeros(1, c.width,
                                                       device=device))
        for i in range(c.depth):
            setattr(self, f"block{i}", TransformerBlock(c.width, c.num_heads,
                                                        **kw))
        self.dn = LayerNorm(c.width, **kw)
        self.decode = Attention(c.width, c.num_heads, **kw)
        self.up8 = ConvTranspose(c.width, half, 3, 2, **kw)
        self.skip8 = Dense(half, half, **kw)
        self.dec8 = TransformerBlock(half, 2, mlp_ratio=1.0, **kw)
        self.up4 = ConvTranspose(half, half, 3, 2, **kw)
        self.skip4 = Dense(half, half, **kw)
        self.out = Dense(half, 1, device=device)
        store_params_(self, param_dtype)

    def forward(self, img):
        c = self.cfg
        # the frame's mean-centred image beside the raw one: contrast with
        # the scene is a linear feature for the stem
        inp = torch.cat([img, img - img.mean(dim=(1, 2), keepdim=True)], -1)
        feat, s8, s4 = self.stem(inp)
        b, gh, gw, _ = feat.shape
        x = feat.reshape(b, gh * gw, c.width) + posemb_sincos_2d(
            gh, gw, c.width, device=feat.device)[None].to(c.dtype)
        tok = self.saliency_token[None].to(c.dtype).expand(b, 1, c.width)
        x = torch.cat([tok, x], 1)
        for i in range(c.depth):
            x = getattr(self, f"block{i}")(x)
        sal, patches = x[:, :1], x[:, 1:]
        att = self.decode(self.dn(patches), sal)
        d = (patches + att).reshape(b, gh, gw, c.width)
        d = self.up8(d) + self.skip8(s8)
        bb, h8, w8, cc = d.shape
        d = self.dec8(d.reshape(bb, h8 * w8, cc)).reshape(bb, h8, w8, cc)
        d = self.up4(d) + self.skip4(s4)
        logits = self.out(d)[..., 0]
        up = resize_bilinear(logits[..., None], img.shape[1:3])[..., 0]
        return torch.sigmoid(up)


def init_flax_style_(model: SaliencyTransformer,
                     generator: torch.Generator) -> None:
    """Random init from ``generator`` with the JAX module's initializers:
    flax's layer defaults and the saliency token N(0, 0.02²)."""
    init_flax_layers_(model, generator)
    with torch.no_grad():
        model.saliency_token.normal_(0.0, 0.02, generator=generator)
