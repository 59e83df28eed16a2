"""Transformer building blocks (counterpart of regen3d_tpu/models/layers.py).

The modules follow flax's numerics, which the JAX package runs:

* ``Dense`` casts input, weight and bias to its compute ``dtype``, as flax
  does. Its parameters are stored in ``param_dtype``, which defaults to
  ``dtype``: for inference storing the weights in bf16 is flax's own
  rounding, while training keeps flax's layout (``param_dtype`` f32, bf16
  compute), since bf16 keeps 8 significant bits and an AdamW update smaller
  than 2⁻⁸ of a weight would round away. ``Conv`` does the same, and
  ``ConvTranspose`` casts its weights to its ``dtype`` for the product. A
  whole model's weights move to another storage dtype with
  ``store_params_``, which leaves every layer's compute dtype as it was
  (the trained models' ``param_dtype``);
* ``RMSNorm`` is flax's: eps 1e-6, f32 statistics and scale, output in
  ``dtype``;
* ``LayerNorm`` uses eps 1e-6 (torch's default is 1e-5), computes in f32 with
  f32 params and returns ``dtype``;
* GELU is the tanh approximation (flax ``nn.gelu``);
* ``Conv`` pads ``SAME`` and keeps NHWC at its interface;
* ``ConvTranspose`` is flax's ``nn.ConvTranspose`` (``SAME``);
* every module is built on the card unless the caller passes ``device``;
* under ``parallel/mesh.shard_params`` a ``Dense`` holds its rank's shard
  and a ``TPLayout`` (``tp``) and computes through ``parallel/tp.linear``;
  the attention modules then run the flash kernels on the rank's own heads
  (``tp`` is None on one device, where nothing changes).

Submodule names follow the flax tree, so ``models/from_jax.py`` maps
parameters by name.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from regen3d_tpu_torch.ops.attention import flash_attention
from regen3d_tpu_torch.parallel import tp as tensor_parallel

LN_EPS = 1e-6


class Dense(nn.Linear):
    """flax ``nn.Dense``: input, weight and bias are cast to ``dtype``; the
    parameters are stored in ``param_dtype`` (default ``dtype``). ``tp``
    (set by ``parallel/mesh.shard_params``) makes it a column or row
    projection over a process group."""

    def __init__(self, d_in, d_out, bias=True, dtype=torch.float32,
                 device="cuda", param_dtype=None):
        super().__init__(d_in, d_out, bias=bias, dtype=param_dtype or dtype,
                         device=device)
        self.dtype = dtype
        self.tp: Optional[tensor_parallel.TPLayout] = None

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        w = self.weight.to(self.dtype)
        if self.tp is not None:
            return tensor_parallel.linear(self.tp, x.to(self.dtype), w, b)
        return F.linear(x.to(self.dtype), w, b)


class Conv(nn.Conv2d):
    """flax ``nn.Conv`` with ``SAME`` padding on NHWC tensors. The weights
    are stored in ``param_dtype`` (default ``dtype``) and cast to ``dtype``
    for the product, as flax does."""

    def __init__(self, c_in, c_out, kernel, stride=1, bias=True,
                 dtype=torch.float32, device="cuda", param_dtype=None):
        if stride == 1 and kernel % 2 == 0:
            raise ValueError("SAME padding of an even kernel is asymmetric")
        pad = (kernel - 1) // 2 if stride == 1 else 0
        super().__init__(c_in, c_out, kernel, stride=stride, padding=pad,
                         bias=bias, dtype=param_dtype or dtype, device=device)
        self.compute_dtype = dtype

    def forward(self, x):                       # (B, H, W, C)
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        x = x.to(dt).permute(0, 3, 1, 2)
        s = self.stride[0]
        if s > 1:   # SAME: ceil(n / s) outputs, the odd pad at the end
            pads = []
            for n in (x.shape[3], x.shape[2]):
                total = max((-(-n // s) - 1) * s + self.kernel_size[0] - n, 0)
                pads += [total // 2, total - total // 2]
            if any(pads):
                x = F.pad(x, pads)
        return self._conv_forward(x, self.weight.to(dt), b).permute(0, 2, 3, 1)


class ConvTranspose(nn.ConvTranspose2d):
    """flax ``nn.ConvTranspose`` (``SAME``, no kernel flip) on NHWC: the
    output is ``stride`` times the input. flax correlates the
    stride-dilated input, padded by ``pad_a`` in front (k − 1 when
    stride > k − 1, else ⌈(k + stride − 2) / 2⌉), with the unflipped
    kernel, so its tap t lands where torch's tap k − 1 − t does; torch's
    transposed convolution with padding k − 1 − pad_a then gives the same
    positions, its tail past ``stride``·n cropped (k = 3, stride 2). The
    weight holds torch's layout (in, out, k, k); ``models/from_jax.py``
    mirrors the taps when it loads a flax kernel. It computes in ``dtype``,
    whatever dtype its weights are stored in (``store_params_``)."""

    def __init__(self, c_in, c_out, kernel=2, stride=2, dtype=torch.float32,
                 device="cuda"):
        pad_a = kernel - 1 if stride > kernel - 1 else -(-(kernel + stride - 2)
                                                          // 2)
        super().__init__(c_in, c_out, kernel, stride=stride,
                         padding=kernel - 1 - pad_a, dtype=dtype,
                         device=device)
        self.compute_dtype = dtype

    def forward(self, x):                       # (B, H, W, C)
        h, w = x.shape[1:3]
        s, dt = self.stride[0], self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        y = F.conv_transpose2d(x.to(dt).permute(0, 3, 1, 2),
                               self.weight.to(dt), b, self.stride,
                               self.padding)
        return y[:, :, :h * s, :w * s].permute(0, 2, 3, 1)


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


def store_params_(model: nn.Module, param_dtype) -> nn.Module:
    """Store every floating parameter of ``model`` in ``param_dtype`` (a
    no-op for None). The layers cast their weights to their own compute
    dtype, and the norms, embeddings and tables compute in f32, so the
    forward is unchanged up to the rounding of the stored values; with
    ``param_dtype`` f32 the model trains as flax's ``param_dtype=f32``
    split does."""
    if param_dtype is not None:
        for p in model.parameters():
            if p.is_floating_point():
                p.data = p.data.to(param_dtype)
    return model


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    """flax's ``lecun_normal`` in place: a normal truncated at ±2σ, scaled
    so the variance is 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    tmp = torch.empty(weight.shape, device=weight.device)
    nn.init.trunc_normal_(tmp, 0.0, std, -2 * std, 2 * std,
                          generator=generator)
    weight.copy_(tmp)


def init_flax_layers_(model: nn.Module, generator: torch.Generator) -> None:
    """flax's default init of every ``Dense``, ``Conv`` and
    ``ConvTranspose`` (lecun-normal truncated kernels, zero biases) and
    ``LayerNorm`` (ones, zeros) in ``model``, drawn from ``generator`` in
    module order; a model's own leaves (tokens, tables) are its to draw."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, ConvTranspose):
                w = mod.weight                       # (in, out, kh, kw)
                lecun_normal_(w, w.shape[0] * w.shape[2] * w.shape[3],
                              generator)
            elif isinstance(mod, (Dense, Conv)):
                lecun_normal_(mod.weight, mod.weight[0].numel(), generator)
            elif isinstance(mod, LayerNorm) and mod.weight is not None:
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            if isinstance(mod, (Dense, Conv, ConvTranspose)) \
                    and mod.bias is not None:
                mod.bias.zero_()


def gelu(x):
    return F.gelu(x, approximate="tanh")


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm`` over the last axis: f32 statistics and f32
    ``weight`` (flax's ``scale``), output in ``dtype``. With ``tp`` (role
    ``partial``: a q/k norm of a tensor-parallel attention, applied to this
    rank's heads) the weight's gradient sums over the group."""

    def __init__(self, dim, dtype=torch.float32, device="cuda"):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.tp: Optional[tensor_parallel.TPLayout] = None

    def forward(self, x):
        x = x.float()
        w = self.weight
        if self.tp is not None:
            w = tensor_parallel.copy_to(w, self.tp.group)
        mul = torch.rsqrt(x.square().mean(-1, keepdim=True) + LN_EPS)
        return (x * (mul * w)).to(self.dtype)


class Mlp(nn.Module):
    def __init__(self, d_in, hidden, out: Optional[int] = None,
                 dtype=torch.float32, device="cuda", param_dtype=None):
        super().__init__()
        self.fc1 = Dense(d_in, hidden, dtype=dtype, device=device,
                         param_dtype=param_dtype)
        self.fc2 = Dense(hidden, out or d_in, dtype=dtype, device=device,
                         param_dtype=param_dtype)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class FusedAttention(nn.Module):
    """Self-attention with one fused qkv projection (torch-ViT layout).
    Under tensor parallelism ``qkv`` holds this rank's heads' q, k and v
    columns (``parallel/mesh.shard_params``'s head-blocked placement), so
    the reshape below splits the rank's own heads."""

    def __init__(self, dim, num_heads, dtype=torch.float32, device="cuda"):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim, dtype=dtype, device=device)
        self.proj = Dense(dim, dim, dtype=dtype, device=device)

    def forward(self, x):
        b, s, e = x.shape
        hd = e // self.num_heads
        qkv = self.qkv(x).reshape(b, s, 3, -1, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2).contiguous() for i in range(3))
        o = flash_attention(q, k, v)
        return self.proj(o.transpose(1, 2).reshape(b, s, -1))


class Attention(nn.Module):
    """Multi-head self- or cross-attention with separate q, k, v and proj
    projections (all with bias) and, with ``qk_norm``, an RMSNorm over the
    head dim of q and k; on the flash kernels (this rank's heads under
    tensor parallelism)."""

    def __init__(self, dim, num_heads, qk_norm=False, dtype=torch.float32,
                 device="cuda", param_dtype=None):
        super().__init__()
        self.num_heads = num_heads
        kw = dict(dtype=dtype, device=device, param_dtype=param_dtype)
        self.q, self.k, self.v, self.proj = (Dense(dim, dim, **kw)
                                             for _ in range(4))
        if qk_norm:
            self.q_norm = RMSNorm(dim // num_heads, dtype=dtype, device=device)
            self.k_norm = RMSNorm(dim // num_heads, dtype=dtype, device=device)
        else:
            self.q_norm = self.k_norm = None

    def forward(self, x_q, x_kv=None):
        x_kv = x_q if x_kv is None else x_kv
        b, sq, e = x_q.shape
        hd = e // self.num_heads

        def split(t):
            return t.reshape(*t.shape[:2], -1, hd).transpose(1, 2)

        q, k, v = split(self.q(x_q)), split(self.k(x_kv)), split(self.v(x_kv))
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
        return self.proj(o.transpose(1, 2).reshape(b, sq, -1))


class TransformerBlock(nn.Module):
    """Pre-norm block: self-attention, an optional cross-attention to
    ``cond`` (``norm_cross``, ``cross``), then an MLP; LayerNorms in
    ``dtype`` (norm1/attn/norm_cross/cross/norm2/mlp)."""

    def __init__(self, dim, num_heads, mlp_ratio=4.0, use_cross=False,
                 dtype=torch.float32, device="cuda", param_dtype=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, param_dtype=param_dtype)
        self.norm1 = LayerNorm(dim, dtype=dtype, device=device)
        self.attn = Attention(dim, num_heads, **kw)
        if use_cross:
            self.norm_cross = LayerNorm(dim, dtype=dtype, device=device)
            self.cross = Attention(dim, num_heads, **kw)
        else:
            self.cross = None
        self.norm2 = LayerNorm(dim, dtype=dtype, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), **kw)

    def forward(self, x, cond=None):
        x = x + self.attn(self.norm1(x))
        if self.cross is not None:
            x = x + self.cross(self.norm_cross(x), cond)
        return x + self.mlp(self.norm2(x))


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


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding: (B,) → (B, dim) f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], -1)
    return F.pad(emb, (0, dim % 2))


def modulate(x, shift, scale):
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


class DiTBlock(nn.Module):
    """AdaLN-Zero DiT block with optional cross-attention conditioning
    (self-attention over shape-latent tokens, cross-attention to image
    tokens, each gated by the timestep embedding through ``adaLN``)."""

    def __init__(self, dim, num_heads, mlp_ratio=4.0, use_cross=True,
                 dtype=torch.float32, device="cuda", param_dtype=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, param_dtype=param_dtype)
        self.n_mod = 9 if use_cross else 6
        self.adaLN = Dense(dim, self.n_mod * dim, **kw)
        self.norm1 = LayerNorm(dim, affine=False, dtype=dtype, device=device)
        self.attn = Attention(dim, num_heads, qk_norm=True, **kw)
        if use_cross:
            self.norm_cross = LayerNorm(dim, affine=False, dtype=dtype,
                                        device=device)
            self.cross = Attention(dim, num_heads, qk_norm=True, **kw)
        else:
            self.cross = None
        self.norm2 = LayerNorm(dim, affine=False, dtype=dtype, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), **kw)

    def forward(self, x, t_emb, cond=None):
        parts = self.adaLN(F.silu(t_emb)).chunk(self.n_mod, dim=-1)
        x = x + parts[2][:, None, :] * self.attn(
            modulate(self.norm1(x), parts[0], parts[1]))
        idx = 3
        if self.cross is not None:
            x = x + parts[5][:, None, :] * self.cross(
                modulate(self.norm_cross(x), parts[3], parts[4]), cond)
            idx = 6
        h = modulate(self.norm2(x), parts[idx], parts[idx + 1])
        return x + parts[idx + 2][:, None, :] * self.mlp(h)


class PatchEmbed(nn.Module):
    """Image (B, H, W, C) → patch tokens (B, h·w, width) by a strided conv."""

    def __init__(self, patch, width, in_ch=3, dtype=torch.float32,
                 device="cuda", param_dtype=None):
        super().__init__()
        self.proj = Conv(in_ch, width, patch, stride=patch, dtype=dtype,
                         device=device, param_dtype=param_dtype)

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


def fourier_features(x: torch.Tensor, num_freqs: int = 8,
                     include_input: bool = True) -> torch.Tensor:
    """3D points (..., 3) → NeRF-style Fourier features (..., 3 + 6·F):
    sin and cos of x·2ᵏπ (k < F, computed in x's dtype), interleaved per
    frequency as [sin xyz, cos xyz], after x itself."""
    freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype,
                                device=x.device) * math.pi
    ang = x[..., None, :] * freqs[:, None]                 # (..., F, 3)
    enc = torch.cat([torch.sin(ang), torch.cos(ang)], -1)
    enc = enc.reshape(*x.shape[:-1], -1)
    return torch.cat([x, enc], -1) if include_input else enc


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


def linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)`` in f32 bit for bit as XLA's CPU
    compiler evaluates it: point i is s·(1 − i·r) + i·(e·r) with
    r = f32(1/(num − 1)), the last product fused into the add (one
    rounding), and the last point ``stop`` itself (checked at 8 to 300
    points). ``torch.linspace`` and ``np.linspace`` round other points:
    truncated to int32, 999 → 0 over n points lands one step off at 35 of
    n = 1..100."""
    f32 = np.float32
    s, e = f32(start), f32(stop)
    if num == 1:
        return np.asarray([s], f32)
    it = np.arange(num - 1, dtype=f32)
    recip = f32(1) / f32(num - 1)
    a = s * (f32(1) - it * recip)
    out = (a.astype(np.float64)
           + it.astype(np.float64) * np.float64(e * recip)).astype(f32)
    return np.concatenate([out, [e]]).astype(f32)
