"""The UNet trunk and phase 2's matting net (counterpart of the part of
regen3d_tpu/models/unet.py that ``MattingUNet`` runs; ``ddim_sample`` and
the diffusion consumers of ``UNet`` are ROADMAP Queue 1 item 5).

Residual blocks with an optional timestep FiLM, flash-attention blocks at
the low-resolution levels, strided-conv downsampling and nearest-2× then
conv upsampling, skips concatenated as ``[h, skip]``. The modules follow
the flax ones' numerics: the trunk computes in ``cfg.dtype`` (bf16 by
default), GroupNorm takes its statistics in f32 (flax's fast variance,
E[x²] − E[x]², eps 1e-6) with f32 scale and bias, the strided ``SAME``
convolutions pad (0, 1) (``layers.Conv``), and the ``out`` convolution is
f32. Names follow the flax tree, so ``models/from_jax.py`` maps it. Built
on the card unless ``device`` is given.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from regen3d_tpu_torch.models.layers import (
    Attention,
    Conv,
    Dense,
    init_flax_layers_,
    timestep_embedding,
)

GN_EPS = 1e-6


def _groups(ch: int, target: int = 32) -> int:
    """Largest group count ≤ target that divides the channel count."""
    g = min(target, ch)
    while g > 1 and ch % g:
        g -= 1
    return g


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 7          # x4 upscaler: 4 latent + 3 lowres
    out_channels: int = 4
    base: int = 128
    mults: Tuple[int, ...] = (1, 2, 4, 4)
    attn_levels: Tuple[int, ...] = (2, 3)
    blocks_per_level: int = 2
    num_heads: int = 8
    time_conditioned: bool = True
    dtype: torch.dtype = torch.bfloat16


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` on NHWC: f32 statistics over (H, W, C/G) by
    the fast variance, f32 ``weight`` (flax's ``scale``) and ``bias``,
    output in ``dtype``."""

    def __init__(self, ch, dtype=torch.float32, device="cuda"):
        super().__init__()
        self.groups, self.dtype = _groups(ch), dtype
        self.weight = nn.Parameter(torch.ones(ch, device=device))
        self.bias = nn.Parameter(torch.zeros(ch, device=device))

    def forward(self, x):                       # (B, H, W, C)
        b, h, w, c = x.shape
        xf = x.float().reshape(b, h, w, self.groups, c // self.groups)
        mean = xf.mean((1, 2, 4), keepdim=True)
        var = torch.clamp_min(xf.square().mean((1, 2, 4), keepdim=True)
                              - mean.square(), 0.0)
        # flax's order: (x − mean) · (rsqrt(var + eps) · scale) + bias
        mul = torch.rsqrt(var + GN_EPS) * self.weight.reshape(
            self.groups, c // self.groups)
        y = ((xf - mean) * mul).reshape(b, h, w, c) + self.bias
        return y.to(self.dtype)


class ResBlock(nn.Module):
    """GroupNorm → SiLU → conv1 (→ FiLM by the timestep) → GroupNorm →
    SiLU → conv2, plus the input (through a 1×1 ``skip`` where the width
    changes)."""

    def __init__(self, in_ch, out_ch, dtype, t_dim=None, device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = GroupNorm(in_ch, **kw)
        self.conv1 = Conv(in_ch, out_ch, 3, **kw)
        self.film = (Dense(t_dim, 2 * out_ch, **kw) if t_dim is not None
                     else None)
        self.norm2 = GroupNorm(out_ch, **kw)
        self.conv2 = Conv(out_ch, out_ch, 3, **kw)
        self.skip = Conv(in_ch, out_ch, 1, **kw) if in_ch != out_ch else None

    def forward(self, x, t_emb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if t_emb is not None:
            scale, shift = self.film(F.silu(t_emb))[:, None, None, :].chunk(
                2, dim=-1)
            h = h * (1 + scale) + shift
        h = self.conv2(F.silu(self.norm2(h)))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class AttnBlock2D(nn.Module):
    """x + attention over the H·W positions of GroupNorm(x)."""

    def __init__(self, ch, num_heads, dtype, device="cuda"):
        super().__init__()
        self.norm = GroupNorm(ch, dtype=dtype, device=device)
        self.attn = Attention(ch, num_heads, dtype=dtype, device=device)

    def forward(self, x):
        b, h, w, c = x.shape
        y = self.attn(self.norm(x).reshape(b, h * w, c))
        return x + y.reshape(b, h, w, c)


class UNet(nn.Module):
    def __init__(self, cfg: UNetConfig, device="cuda"):
        super().__init__()
        c = self.cfg = cfg
        kw = dict(dtype=c.dtype, device=device)
        t_dim = None
        if c.time_conditioned:
            t_dim = c.base * 4
            self.t1 = Dense(c.base, t_dim, **kw)
            self.t2 = Dense(t_dim, t_dim, **kw)
        self.stem = Conv(c.in_channels, c.base, 3, **kw)
        width, skips = c.base, [c.base]
        for li, mult in enumerate(c.mults):
            ch = c.base * mult
            for bi in range(c.blocks_per_level):
                self.add_module(f"down{li}_{bi}",
                                ResBlock(width, ch, c.dtype, t_dim, device))
                width = ch
                if li in c.attn_levels:
                    self.add_module(f"down{li}_{bi}_attn", AttnBlock2D(
                        ch, c.num_heads, c.dtype, device))
                skips.append(ch)
            if li < len(c.mults) - 1:
                self.add_module(f"down{li}_pool",
                                Conv(ch, ch, 3, stride=2, **kw))
                skips.append(ch)
        self.mid1 = ResBlock(width, width, c.dtype, t_dim, device)
        self.mid_attn = AttnBlock2D(width, c.num_heads, c.dtype, device)
        self.mid2 = ResBlock(width, width, c.dtype, t_dim, device)
        for li, mult in reversed(list(enumerate(c.mults))):
            ch = c.base * mult
            for bi in range(c.blocks_per_level + 1):
                self.add_module(f"up{li}_{bi}", ResBlock(
                    width + skips.pop(), ch, c.dtype, t_dim, device))
                width = ch
                if li in c.attn_levels:
                    self.add_module(f"up{li}_{bi}_attn", AttnBlock2D(
                        ch, c.num_heads, c.dtype, device))
            if li > 0:
                self.add_module(f"up{li}_conv", Conv(width, width, 3, **kw))
        self.out_norm = GroupNorm(width, **kw)
        self.out = Conv(width, c.out_channels, 3, dtype=torch.float32,
                        device=device)

    def forward(self, x, t=None, cond_img=None):
        """x (B, H, W, in) (``cond_img`` concatenated on channels when
        given), t (B,) timesteps in [0, 1000) → (B, H, W, out) f32."""
        c = self.cfg
        if cond_img is not None:
            x = torch.cat([x, cond_img.to(x.dtype)], -1)
        t_emb = None
        if c.time_conditioned:
            tt = t if t is not None else torch.zeros(x.shape[0],
                                                     device=x.device)
            t_emb = self.t2(F.silu(self.t1(timestep_embedding(tt, c.base))))
        h = self.stem(x.to(c.dtype))
        skips = [h]
        for li in range(len(c.mults)):
            for bi in range(c.blocks_per_level):
                h = getattr(self, f"down{li}_{bi}")(h, t_emb)
                if li in c.attn_levels:
                    h = getattr(self, f"down{li}_{bi}_attn")(h)
                skips.append(h)
            if li < len(c.mults) - 1:
                h = getattr(self, f"down{li}_pool")(h)
                skips.append(h)
        h = self.mid2(self.mid_attn(self.mid1(h, t_emb)), t_emb)
        for li in reversed(range(len(c.mults))):
            for bi in range(c.blocks_per_level + 1):
                h = torch.cat([h, skips.pop()], -1)
                h = getattr(self, f"up{li}_{bi}")(h, t_emb)
                if li in c.attn_levels:
                    h = getattr(self, f"up{li}_{bi}_attn")(h)
            if li > 0:
                # jax.image.resize "nearest" at exactly 2×: each pixel twice
                h = h.repeat_interleave(2, 1).repeat_interleave(2, 2)
                h = getattr(self, f"up{li}_conv")(h)
        return self.out(F.silu(self.out_norm(h)))


class MattingUNet(nn.Module):
    """rembg-family background matting (the isnet/u2net role,
    inpaint_nanoBanana.py:157-189): image (B, H, W, 3) in [0, 1] → alpha
    (B, H, W, 1) f32 in [0, 1]. The UNet trunk without a timestep: three
    levels (×1, ×2, ×4 of ``base``), attention with 4 heads at the
    lowest."""

    def __init__(self, base: int = 32, dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        self.base = base
        self.trunk = UNet(UNetConfig(
            in_channels=3, out_channels=1, base=base, mults=(1, 2, 4),
            attn_levels=(2,), blocks_per_level=1, num_heads=4,
            time_conditioned=False, dtype=dtype), device=device)

    def forward(self, img):
        return torch.sigmoid(self.trunk(img))


# the convolutions flax starts at zero (ResBlock.conv2, UNet.out)
ZERO_INIT_CONV = ("conv2", "out")


@torch.no_grad()
def init_flax_style_(model: nn.Module, generator: torch.Generator) -> None:
    """Random init from ``generator`` as flax initialises the JAX modules:
    lecun-normal (truncated) Dense and Conv kernels, zero biases,
    GroupNorm ones and zeros, and ``conv2`` and ``out`` at zero."""
    init_flax_layers_(model, generator)
    for name, mod in model.named_modules():
        if isinstance(mod, GroupNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, Conv) and name.rsplit(".", 1)[-1] \
                in ZERO_INIT_CONV:
            mod.weight.zero_()


@torch.no_grad()
def draw_zero_init_leaves_(model: nn.Module, generator: torch.Generator,
                           std: float = 0.02) -> None:
    """Draw the zero-initialised kernels (``conv2``, ``out``) from
    N(0, std²). At flax's init ``out`` is zero, so every alpha is
    sigmoid(0) = 0.5 whatever the image: a check of a random-init matting
    net would compare constants."""
    for name, mod in model.named_modules():
        if isinstance(mod, Conv) and name.rsplit(".", 1)[-1] \
                in ZERO_INIT_CONV:
            w = torch.empty(mod.weight.shape, device=generator.device)
            w.normal_(0.0, std, generator=generator)
            mod.weight.copy_(w)
