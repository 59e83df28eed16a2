"""The Stable-Diffusion AutoencoderKL (counterpart of
regen3d_tpu/models/sd_vae.py), in the diffusers checkpoint layout: the
latent codec of the SD-family models (the multiview texture UNet's
reference and geometry latents, and its decoded views).

Numerics as ``models/sd_unet.py``: the trunk in ``cfg.dtype`` (bf16 by
default), f32 GroupNorms (eps 1e-6) and f32 ``conv_out``, ``quant_conv``
and ``post_quant_conv``. The mid-block attention is one head of the full
width C on the flash forward: at ``SDVAEConfig()`` that is the kernel's
D = 512 (``csrc/flash_fwd.cu``'s ``fwd_wide_kernel``), over the 64²
latent grid of a 512² image. Submodules carry the flax tree's names, so
``models/from_jax.py`` maps the JAX package's parameters by name. Built on
the card unless ``device`` is given.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from regen3d_tpu_torch.models.layers import Conv, Dense
from regen3d_tpu_torch.models.sd_unet import group_norm
from regen3d_tpu_torch.ops.attention import flash_attention


@dataclasses.dataclass(frozen=True)
class SDVAEConfig:
    latent_channels: int = 4
    block_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32
    scaling_factor: float = 0.18215
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def tiny(cls) -> "SDVAEConfig":
        return cls(block_channels=(8, 16), layers_per_block=1, norm_groups=4)


class VAEResnet(nn.Module):
    """norm1/conv1, norm2/conv2 (+ conv_shortcut where the width changes),
    no timestep."""

    def __init__(self, in_ch, out_ch, groups, dtype, device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = group_norm(in_ch, groups, device)
        self.conv1 = Conv(in_ch, out_ch, 3, **kw)
        self.norm2 = group_norm(out_ch, groups, device)
        self.conv2 = Conv(out_ch, out_ch, 3, **kw)
        self.conv_shortcut = (Conv(in_ch, out_ch, 1, **kw) if in_ch != out_ch
                              else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    """The mid block's attention: group_norm, then to_q/to_k/to_v/to_out_0
    (with biases) over the H·W positions as one head of width C, plus the
    input."""

    def __init__(self, ch, groups, dtype, device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.group_norm = group_norm(ch, groups, device)
        self.to_q, self.to_k, self.to_v, self.to_out_0 = (
            Dense(ch, ch, **kw) for _ in range(4))

    def forward(self, x):
        b, h, w, c = x.shape
        y = self.group_norm(x).reshape(b, h * w, c)
        q, k, v = (p(y)[:, None].contiguous()
                   for p in (self.to_q, self.to_k, self.to_v))
        o = self.to_out_0(flash_attention(q, k, v)[:, 0])
        return x + o.reshape(b, h, w, c)


def _mid(module, ch, c, device):
    module.mid_resnet_0 = VAEResnet(ch, ch, c.norm_groups, c.dtype, device)
    module.mid_attn = VAEAttention(ch, c.norm_groups, c.dtype, device)
    module.mid_resnet_1 = VAEResnet(ch, ch, c.norm_groups, c.dtype, device)


class VAEEncoder(nn.Module):
    """Image (B, H, W, 3) → moments (B, H/f, W/f, 2·latent) f32."""

    def __init__(self, cfg: SDVAEConfig, device="cuda"):
        super().__init__()
        c = self.cfg = cfg
        kw = dict(dtype=c.dtype, device=device)
        width = c.block_channels[0]
        self.conv_in = Conv(3, width, 3, **kw)
        for i, ch in enumerate(c.block_channels):
            for j in range(c.layers_per_block):
                self.add_module(f"down_{i}_resnet_{j}", VAEResnet(
                    width, ch, c.norm_groups, c.dtype, device))
                width = ch
            if i < len(c.block_channels) - 1:
                self.add_module(f"down_{i}_downsample",
                                Conv(ch, ch, 3, stride=2, **kw))
        _mid(self, width, c, device)
        self.conv_norm_out = group_norm(width, c.norm_groups, device)
        self.conv_out = Conv(width, 2 * c.latent_channels, 3,
                             dtype=torch.float32, device=device)

    def forward(self, x):
        c = self.cfg
        h = self.conv_in(x.to(c.dtype))
        for i in range(len(c.block_channels)):
            for j in range(c.layers_per_block):
                h = getattr(self, f"down_{i}_resnet_{j}")(h)
            if i < len(c.block_channels) - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
        h = self.mid_resnet_1(self.mid_attn(self.mid_resnet_0(h)))
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class VAEDecoder(nn.Module):
    """Latent (B, h, w, latent) → image (B, h·f, w·f, 3) f32; up blocks
    named by the diffusers index (0 = deepest)."""

    def __init__(self, cfg: SDVAEConfig, device="cuda"):
        super().__init__()
        c = self.cfg = cfg
        kw = dict(dtype=c.dtype, device=device)
        width = c.block_channels[-1]
        self.conv_in = Conv(c.latent_channels, width, 3, **kw)
        _mid(self, width, c, device)
        n = len(c.block_channels)
        for i, ch in reversed(list(enumerate(c.block_channels))):
            k = n - 1 - i
            for j in range(c.layers_per_block + 1):
                self.add_module(f"up_{k}_resnet_{j}", VAEResnet(
                    width, ch, c.norm_groups, c.dtype, device))
                width = ch
            if i > 0:
                self.add_module(f"up_{k}_upsample", Conv(ch, ch, 3, **kw))
        self.conv_norm_out = group_norm(width, c.norm_groups, device)
        self.conv_out = Conv(width, 3, 3, dtype=torch.float32, device=device)

    def forward(self, z):
        c = self.cfg
        n = len(c.block_channels)
        h = self.conv_in(z.to(c.dtype))
        h = self.mid_resnet_1(self.mid_attn(self.mid_resnet_0(h)))
        for i in reversed(range(n)):
            k = n - 1 - i
            for j in range(c.layers_per_block + 1):
                h = getattr(self, f"up_{k}_resnet_{j}")(h)
            if i > 0:
                h = h.repeat_interleave(2, 1).repeat_interleave(2, 2)
                h = getattr(self, f"up_{k}_upsample")(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class SDAutoencoderKL(nn.Module):
    """encoder, decoder and the f32 1×1 ``quant_conv`` and
    ``post_quant_conv``."""

    def __init__(self, cfg: SDVAEConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        lc = cfg.latent_channels
        self.encoder = VAEEncoder(cfg, device)
        self.decoder = VAEDecoder(cfg, device)
        self.quant_conv = Conv(2 * lc, 2 * lc, 1, dtype=torch.float32,
                               device=device)
        self.post_quant_conv = Conv(lc, lc, 1, dtype=torch.float32,
                                    device=device)

    def encode(self, x):
        """(mean, logvar), each (B, h, w, latent) f32."""
        return self.quant_conv(self.encoder(x)).chunk(2, dim=-1)

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """(decoded, mean, logvar): z is the mean, or, given a
        ``generator``, the reparameterised draw
        mean + exp(½·clip(logvar, −30, 20))·ε with ε drawn from it."""
        mean, logvar = self.encode(x)
        z = mean
        if generator is not None:
            eps = torch.randn(mean.shape, generator=generator,
                              device=mean.device)
            z = mean + torch.exp(0.5 * torch.clamp(logvar, -30, 20)) * eps
        return self.decode(z), mean, logvar
