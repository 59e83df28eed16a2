"""Transformer building blocks (counterpart of regen3d_tpu/models/layers.py).

The modules follow flax's numerics, which the JAX package runs:

* ``Dense`` / ``Conv`` compute in their weights' dtype (flax casts input and
  params to ``dtype``; storing the weights in that dtype is the same
  rounding);
* ``LayerNorm`` uses eps 1e-6 (torch's default is 1e-5), computes in f32 with
  f32 params and returns ``dtype``;
* GELU is the tanh approximation (flax ``nn.gelu``);
* ``Conv`` pads ``SAME`` and keeps NHWC at its interface;
* ``ConvTranspose`` is flax's ``nn.ConvTranspose`` at kernel 2, stride 2;
* every module is built on the card unless the caller passes ``device``.

Submodule names follow the flax tree, so ``models/from_jax.py`` maps
parameters by name.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from regen3d_tpu_torch.ops.attention import flash_attention

LN_EPS = 1e-6


class Dense(nn.Linear):
    """flax ``nn.Dense``: the input is cast to the weights' dtype."""

    def __init__(self, d_in, d_out, bias=True, dtype=torch.float32,
                 device="cuda"):
        super().__init__(d_in, d_out, bias=bias, dtype=dtype, device=device)

    def forward(self, x):
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class Conv(nn.Conv2d):
    """flax ``nn.Conv`` with ``SAME`` padding on NHWC tensors."""

    def __init__(self, c_in, c_out, kernel, stride=1, bias=True,
                 dtype=torch.float32, device="cuda"):
        if stride == 1 and kernel % 2 == 0:
            raise ValueError("SAME padding of an even kernel is asymmetric")
        pad = (kernel - 1) // 2 if stride == 1 else 0
        super().__init__(c_in, c_out, kernel, stride=stride, padding=pad,
                         bias=bias, dtype=dtype, device=device)

    def forward(self, x):                       # (B, H, W, C)
        if self.stride[0] > 1 and (x.shape[1] % self.stride[0]
                                   or x.shape[2] % self.stride[1]):
            raise ValueError("strided SAME conv needs a divisible input")
        y = super().forward(x.to(self.weight.dtype).permute(0, 3, 1, 2))
        return y.permute(0, 2, 3, 1)


class ConvTranspose(nn.ConvTranspose2d):
    """flax ``nn.ConvTranspose`` at kernel 2, stride 2 (``SAME``) on NHWC:
    each input pixel becomes a 2×2 output block. flax does not flip the
    kernel (``transpose_kernel=False``), so its tap (a, b) lands on output
    offset (1 − a, 1 − b); torch's tap (a, b) lands on (a, b). The weight
    holds torch's layout (in, out, 2, 2); ``models/from_jax.py`` mirrors the
    taps when it loads a flax kernel."""

    def __init__(self, c_in, c_out, dtype=torch.float32, device="cuda"):
        super().__init__(c_in, c_out, 2, stride=2, dtype=dtype, device=device)

    def forward(self, x):                       # (B, H, W, C)
        y = super().forward(x.to(self.weight.dtype).permute(0, 3, 1, 2))
        return y.permute(0, 2, 3, 1)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: f32 statistics and params, output in ``dtype``."""

    def __init__(self, dim, affine=True, dtype=torch.float32, device="cuda"):
        super().__init__()
        self.dim = dim
        self.dtype = dtype
        if affine:
            self.weight = nn.Parameter(torch.ones(dim, device=device))
            self.bias = nn.Parameter(torch.zeros(dim, device=device))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def forward(self, x):
        return F.layer_norm(x.float(), (self.dim,), self.weight, self.bias,
                            LN_EPS).to(self.dtype)


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    """flax's ``lecun_normal`` in place: a normal truncated at ±2σ, scaled
    so the variance is 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    tmp = torch.empty(weight.shape, device=weight.device)
    nn.init.trunc_normal_(tmp, 0.0, std, -2 * std, 2 * std,
                          generator=generator)
    weight.copy_(tmp)


def gelu(x):
    return F.gelu(x, approximate="tanh")


class Mlp(nn.Module):
    def __init__(self, d_in, hidden, out: Optional[int] = None,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        self.fc1 = Dense(d_in, hidden, dtype=dtype, device=device)
        self.fc2 = Dense(hidden, out or d_in, dtype=dtype, device=device)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class FusedAttention(nn.Module):
    """Self-attention with one fused qkv projection (torch-ViT layout)."""

    def __init__(self, dim, num_heads, dtype=torch.float32, device="cuda"):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim, dtype=dtype, device=device)
        self.proj = Dense(dim, dim, dtype=dtype, device=device)

    def forward(self, x):
        b, s, e = x.shape
        hd = e // self.num_heads
        qkv = self.qkv(x).reshape(b, s, 3, self.num_heads, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2).contiguous() for i in range(3))
        o = flash_attention(q, k, v)
        return self.proj(o.transpose(1, 2).reshape(b, s, e))


class ViTBlock(nn.Module):
    """Pre-norm ViT block, optional LayerScale (norm1/attn/ls1/norm2/mlp/ls2)."""

    def __init__(self, dim, num_heads, mlp_ratio=4.0, layer_scale=False,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype=dtype, device=device)
        self.attn = FusedAttention(dim, num_heads, dtype=dtype, device=device)
        self.norm2 = LayerNorm(dim, dtype=dtype, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype, device=device)
        if layer_scale:
            self.ls1 = nn.Parameter(torch.full((dim,), 1e-5, device=device))
            self.ls2 = nn.Parameter(torch.full((dim,), 1e-5, device=device))
        else:
            self.ls1 = self.ls2 = None

    def forward(self, x):
        h = self.attn(self.norm1(x))
        if self.ls1 is not None:
            h = h * self.ls1.to(h.dtype)
        x = x + h
        h = self.mlp(self.norm2(x))
        if self.ls2 is not None:
            h = h * self.ls2.to(h.dtype)
        return x + h


class PatchEmbed(nn.Module):
    """Image (B, H, W, C) → patch tokens (B, h·w, width) by a strided conv."""

    def __init__(self, patch, width, in_ch=3, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        self.proj = Conv(in_ch, width, patch, stride=patch, dtype=dtype,
                         device=device)

    def forward(self, img):
        x = self.proj(img)
        b, h, w, c = x.shape
        return x.reshape(b, h * w, c), (h, w)


def posemb_sincos_2d(h: int, w: int, dim: int, device=None) -> torch.Tensor:
    """(h·w, dim) fixed 2D sin-cos position embedding, f32."""
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device),
                          indexing="ij")
    y, x = y.reshape(-1), x.reshape(-1)
    quarter = dim // 4
    omega = 1.0 / (10000.0 ** (torch.arange(quarter, dtype=torch.float32,
                                            device=device) / quarter))
    out = torch.cat([torch.sin(x[:, None] * omega), torch.cos(x[:, None] * omega),
                     torch.sin(y[:, None] * omega), torch.cos(y[:, None] * omega)],
                    -1)
    if out.shape[-1] < dim:
        out = F.pad(out, (0, dim - out.shape[-1]))
    return out


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(x, ..., "bilinear")`` on NHWC: half-pixel centres,
    and a triangle filter widened by the scale (antialiasing) when it
    downsamples. Computed in f32, returned in x.dtype."""
    ih, iw = x.shape[1:3]
    oh, ow = out_hw
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(oh, ow),
                      mode="bilinear", align_corners=False,
                      antialias=oh < ih or ow < iw)
    return y.permute(0, 2, 3, 1).to(x.dtype)
