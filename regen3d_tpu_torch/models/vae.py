"""Image VAE of the AutoencoderKL family for the SD-x4 upscaler
(counterpart of regen3d_tpu/models/vae.py): a conv encoder and decoder of
``models/unet.py``'s GroupNorm + SiLU residual blocks with one mid-block
attention of 4 heads (D = 128 at ``VAEConfig()``'s 512 channels, on the
flash forward), diagonal-Gaussian latents (logvar clipped to [−30, 20])
and the 0.18215 scaling convention.

Numerics as ``models/unet.py``: the trunk in ``cfg.dtype`` (bf16 by
default), f32 GroupNorm statistics, nearest ×2 upsampling, and the f32
``out`` convolutions. Submodules carry the flax tree's names, so
``models/from_jax.py`` maps the JAX package's parameters by name. Built on
the card unless ``device`` is given.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from regen3d_tpu_torch.models.layers import Conv
from regen3d_tpu_torch.models.unet import AttnBlock2D, GroupNorm, ResBlock


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    latent_channels: int = 4
    base: int = 128
    mults: Tuple[int, ...] = (1, 2, 4, 4)   # 8× downsampling
    dtype: torch.dtype = torch.bfloat16
    scaling: float = 0.18215

    @classmethod
    def tiny(cls) -> "VAEConfig":
        return cls(latent_channels=4, base=16, mults=(1, 2))


def _mid(module, ch, c, device):
    module.mid1 = ResBlock(ch, ch, c.dtype, device=device)
    module.mid_attn = AttnBlock2D(ch, 4, c.dtype, device=device)
    module.mid2 = ResBlock(ch, ch, c.dtype, device=device)


class VAEEncoder(nn.Module):
    """Image (B, H, W, 3) in [−1, 1] → (mean, logvar), each
    (B, H/f, W/f, latent) f32, logvar clipped to [−30, 20]."""

    def __init__(self, cfg: VAEConfig, device="cuda"):
        super().__init__()
        c = self.cfg = cfg
        kw = dict(dtype=c.dtype, device=device)
        self.stem = Conv(3, c.base, 3, **kw)
        width = c.base
        for li, mult in enumerate(c.mults):
            ch = c.base * mult
            self.add_module(f"down{li}_0", ResBlock(width, ch, c.dtype,
                                                    device=device))
            self.add_module(f"down{li}_1", ResBlock(ch, ch, c.dtype,
                                                    device=device))
            width = ch
            if li < len(c.mults) - 1:
                self.add_module(f"down{li}_pool",
                                Conv(ch, ch, 3, stride=2, **kw))
        _mid(self, width, c, device)
        self.out_norm = GroupNorm(width, **kw)
        self.out = Conv(width, 2 * c.latent_channels, 3, dtype=torch.float32,
                        device=device)

    def forward(self, img):
        c = self.cfg
        h = self.stem(img.to(c.dtype))
        for li in range(len(c.mults)):
            h = getattr(self, f"down{li}_1")(getattr(self, f"down{li}_0")(h))
            if li < len(c.mults) - 1:
                h = getattr(self, f"down{li}_pool")(h)
        h = self.mid2(self.mid_attn(self.mid1(h)))
        mean, logvar = self.out(F.silu(self.out_norm(h))).chunk(2, -1)
        return mean, torch.clamp(logvar, -30.0, 20.0)


class VAEDecoder(nn.Module):
    """Latent (B, h, w, latent) → image (B, h·f, w·f, 3) f32."""

    def __init__(self, cfg: VAEConfig, device="cuda"):
        super().__init__()
        c = self.cfg = cfg
        kw = dict(dtype=c.dtype, device=device)
        width = c.base * c.mults[-1]
        self.stem = Conv(c.latent_channels, width, 3, **kw)
        _mid(self, width, c, device)
        for li, mult in reversed(list(enumerate(c.mults))):
            ch = c.base * mult
            self.add_module(f"up{li}_0", ResBlock(width, ch, c.dtype,
                                                  device=device))
            self.add_module(f"up{li}_1", ResBlock(ch, ch, c.dtype,
                                                  device=device))
            width = ch
            if li > 0:
                self.add_module(f"up{li}_conv", Conv(ch, ch, 3, **kw))
        self.out_norm = GroupNorm(width, **kw)
        self.out = Conv(width, 3, 3, dtype=torch.float32, device=device)

    def forward(self, z):
        c = self.cfg
        h = self.mid2(self.mid_attn(self.mid1(self.stem(z.to(c.dtype)))))
        for li in reversed(range(len(c.mults))):
            h = getattr(self, f"up{li}_1")(getattr(self, f"up{li}_0")(h))
            if li > 0:
                # jax.image.resize "nearest" at exactly 2×: each pixel twice
                h = h.repeat_interleave(2, 1).repeat_interleave(2, 2)
                h = getattr(self, f"up{li}_conv")(h)
        return self.out(F.silu(self.out_norm(h)))


def _scale(x: torch.Tensor, s: float, divide: bool = False) -> torch.Tensor:
    """x·s or x / s with s rounded to x's dtype first, as a weakly typed
    scalar in JAX is (a tensor operand: a CUDA division by a host scalar
    would multiply by its reciprocal)."""
    t = torch.tensor(s, dtype=x.dtype, device=x.device)
    return x / t if divide else x * t


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.encoder = VAEEncoder(cfg, device)
        self.decoder = VAEDecoder(cfg, device)

    def _draw(self, mean, logvar, eps, generator):
        if eps is None and generator is None:
            return mean
        if eps is None:
            eps = torch.randn(mean.shape, generator=generator,
                              device=mean.device)
        return mean + torch.exp(0.5 * logvar) * eps

    def forward(self, img, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """(decoded, (mean, logvar)): z is the mean, or with ``eps`` (or
        one drawn from ``generator``) mean + exp(½·logvar)·eps; the decoder
        gets z·(1/scaling)·scaling, the JAX package's arithmetic."""
        mean, logvar = self.encoder(img)
        z = self._draw(mean, logvar, eps, generator)
        s = self.cfg.scaling
        return self.decoder(_scale(_scale(z, 1.0 / s), s)), (mean, logvar)

    def encode(self, img, eps: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The scaled latent z·scaling (z drawn as in ``forward``)."""
        mean, logvar = self.encoder(img)
        return _scale(self._draw(mean, logvar, eps, generator),
                      self.cfg.scaling)

    def decode(self, z) -> torch.Tensor:
        return self.decoder(_scale(z, self.cfg.scaling, divide=True))
