"""Transformer building blocks (counterpart of regen3d_tpu/models/layers.py).

The modules follow flax's numerics, which the JAX package runs:

* ``Dense`` / ``Conv`` compute in their weights' dtype (flax casts input and
  params to ``dtype``; storing the weights in that dtype is the same
  rounding);
* ``LayerNorm`` uses eps 1e-6 (torch's default is 1e-5), computes in f32 with
  f32 params and returns ``dtype``;
* GELU is the tanh approximation (flax ``nn.gelu``);
* ``Conv`` pads ``SAME`` and keeps NHWC at its interface.

Submodule names follow the flax tree, so ``models/from_jax.py`` maps
parameters by name.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from regen3d_tpu_torch.ops.attention import flash_attention

LN_EPS = 1e-6


class Dense(nn.Linear):
    """flax ``nn.Dense``: the input is cast to the weights' dtype."""

    def __init__(self, d_in, d_out, bias=True, dtype=torch.float32,
                 device=None):
        super().__init__(d_in, d_out, bias=bias, dtype=dtype, device=device)

    def forward(self, x):
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class Conv(nn.Conv2d):
    """flax ``nn.Conv`` with ``SAME`` padding on NHWC tensors."""

    def __init__(self, c_in, c_out, kernel, stride=1, bias=True,
                 dtype=torch.float32, device=None):
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


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: f32 statistics and params, output in ``dtype``."""

    def __init__(self, dim, affine=True, dtype=torch.float32, device=None):
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


def gelu(x):
    return F.gelu(x, approximate="tanh")


class Mlp(nn.Module):
    def __init__(self, d_in, hidden, out: Optional[int] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.fc1 = Dense(d_in, hidden, dtype=dtype, device=device)
        self.fc2 = Dense(hidden, out or d_in, dtype=dtype, device=device)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class FusedAttention(nn.Module):
    """Self-attention with one fused qkv projection (torch-ViT layout)."""

    def __init__(self, dim, num_heads, dtype=torch.float32, device=None):
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
                 dtype=torch.float32, device=None):
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
                 device=None):
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
