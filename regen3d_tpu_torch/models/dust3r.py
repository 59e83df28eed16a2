"""DUSt3R-family pairwise stereo geometry net (counterpart of
regen3d_tpu/models/dust3r.py, the AsymmetricCroCo3DStereo role of the
``Use_VGGT: false`` phase 4).

A shared ViT encoder takes both views of a pair (stacked on the batch
axis), two decoders exchange the previous layer's tokens through
cross-attention, and per-view linear heads regress a dense pointmap, both
in view 1's camera frame, with a per-pixel confidence. Every attention is
RoPE-2D attention on the flash forward (``ops/attention.flash_attention``).

Numerics follow the JAX package's: Dense, Conv and LayerNorm as in
``models/layers.py`` (compute in ``cfg.dtype``, LayerNorm statistics and
parameters in f32); ``cos`` and ``sin`` of RoPE are cast to the activation
dtype before the products; the heads run in f32. Parameters are stored in
``cfg.dtype`` (flax's own rounding at inference) except the LayerNorms and
the f32 heads. Submodule names follow the flax tree, so
``models/from_jax.py`` maps a flax model's parameters by name.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn as nn

from regen3d_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    Mlp,
    PatchEmbed,
    init_flax_layers_,
)
from regen3d_tpu_torch.ops.attention import flash_attention


@dataclasses.dataclass(frozen=True)
class Dust3rConfig:
    patch: int = 16
    enc_width: int = 1024
    enc_depth: int = 24
    enc_heads: int = 16
    dec_width: int = 768
    dec_depth: int = 12
    dec_heads: int = 12
    rope_freq: float = 100.0      # croco's RoPE2D base frequency
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def tiny(cls) -> "Dust3rConfig":
        return cls(patch=8, enc_width=64, enc_depth=2, enc_heads=4,
                   dec_width=48, dec_depth=2, dec_heads=4)


def rope_2d(t: torch.Tensor, positions: torch.Tensor,
            base: float = 100.0) -> torch.Tensor:
    """RoPE-2D: the first half of each head dim rotated by the y position,
    the second half by x, consecutive (even, odd) pairs (croco v2).
    t: (B, H, N, D), positions: (N, 2) as (y, x); D divisible by 4."""
    d = t.shape[-1]
    d4 = d // 4
    freqs = base ** (-torch.arange(d4, dtype=torch.float32,
                                   device=t.device) / d4)

    def rot(pos1d, half):
        ang = pos1d[:, None].float() * freqs[None]          # (N, d4)
        cos = torch.cos(ang)[None, None].to(half.dtype)
        sin = torch.sin(ang)[None, None].to(half.dtype)
        a, b = half[..., 0::2], half[..., 1::2]
        return torch.stack([a * cos - b * sin, a * sin + b * cos],
                           -1).reshape(half.shape)

    return torch.cat([rot(positions[:, 0], t[..., :d // 2]),
                      rot(positions[:, 1], t[..., d // 2:])], -1)


class RopeAttention(nn.Module):
    """Multi-head attention with RoPE-2D on q and k (self or cross: the
    queries at ``pos_q``, the keys at ``pos_kv``)."""

    def __init__(self, dim, num_heads, rope_freq, dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__()
        self.num_heads, self.rope_freq = num_heads, rope_freq
        kw = dict(dtype=dtype, device=device)
        self.q, self.k, self.v, self.proj = (Dense(dim, dim, **kw)
                                             for _ in range(4))

    def forward(self, x_q, pos_q, x_kv=None, pos_kv=None):
        x_kv = x_q if x_kv is None else x_kv
        pos_kv = pos_q if pos_kv is None else pos_kv
        b, sq, e = x_q.shape
        hd = e // self.num_heads

        def split(t):
            return t.reshape(b, -1, self.num_heads, hd).transpose(1, 2)

        q = rope_2d(split(self.q(x_q)), pos_q, self.rope_freq)
        k = rope_2d(split(self.k(x_kv)), pos_kv, self.rope_freq)
        v = split(self.v(x_kv))
        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
        return self.proj(o.transpose(1, 2).reshape(b, sq, e))


class EncoderBlock(nn.Module):
    def __init__(self, dim, num_heads, rope_freq, dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype=dtype, device=device)
        self.attn = RopeAttention(dim, num_heads, rope_freq, dtype, device)
        self.norm2 = LayerNorm(dim, dtype=dtype, device=device)
        self.mlp = Mlp(dim, dim * 4, dtype=dtype, device=device)

    def forward(self, x, pos):
        x = x + self.attn(self.norm1(x), pos)
        return x + self.mlp(self.norm2(x))


class DecoderBlock(nn.Module):
    """Self-attention on the view's own tokens, cross-attention to the
    other view's (``norm_y`` on the memory), MLP: CroCo's decoder block."""

    def __init__(self, dim, num_heads, rope_freq, dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__()
        ln = dict(dtype=dtype, device=device)
        self.norm1 = LayerNorm(dim, **ln)
        self.attn = RopeAttention(dim, num_heads, rope_freq, dtype, device)
        self.norm_y = LayerNorm(dim, **ln)
        self.norm2 = LayerNorm(dim, **ln)
        self.cross_attn = RopeAttention(dim, num_heads, rope_freq, dtype,
                                        device)
        self.norm3 = LayerNorm(dim, **ln)
        self.mlp = Mlp(dim, dim * 4, dtype=dtype, device=device)

    def forward(self, x, pos, other, pos_other):
        x = x + self.attn(self.norm1(x), pos)
        mem = self.norm_y(other)
        x = x + self.cross_attn(self.norm2(x), pos, mem, pos_other)
        return x + self.mlp(self.norm3(x))


def postprocess_pointmap(fmap: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw head output (..., 4) → (pts3d (..., 3), conf (...,)) in f32: the
    'exp' radial parametrisation (direction kept, norm d → expm1(d), the
    norm floored at 1e-8) and conf = 1 + exp(clip(c, ±10))."""
    xyz = fmap[..., :3].float()
    c = fmap[..., 3].float()
    d = torch.linalg.norm(xyz, dim=-1, keepdim=True)
    pts = xyz / torch.clamp(d, min=1e-8) * torch.expm1(d)
    return pts, 1.0 + torch.exp(torch.clamp(c, -10.0, 10.0))


class LinearHead(nn.Module):
    """Dense tokens → per-pixel (pts3d, conf) by a patch-level pixel
    shuffle, in f32."""

    def __init__(self, dim, patch, device="cuda"):
        super().__init__()
        self.patch = patch
        self.proj = Dense(dim, patch * patch * 4, dtype=torch.float32,
                          device=device)

    def forward(self, tokens, grid_hw):             # (B, N, D)
        gh, gw = grid_hw
        p = self.patch
        b = tokens.shape[0]
        x = self.proj(tokens.float()).reshape(b, gh, gw, p, p, 4)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, gh * p, gw * p, 4)
        return postprocess_pointmap(x)


def patch_positions(gh: int, gw: int, device=None) -> torch.Tensor:
    """(gh·gw, 2) int (y, x) of the patch grid, row-major."""
    yy, xx = torch.meshgrid(torch.arange(gh, device=device),
                            torch.arange(gw, device=device), indexing="ij")
    return torch.stack([yy.reshape(-1), xx.reshape(-1)], -1)


class AsymmetricCroCo3DStereo(nn.Module):
    """Image pair → {pts3d1, conf1, pts3d2, conf2}; both pointmaps lie in
    view 1's camera frame (the dust3r contract). Built on the card unless
    ``device`` says otherwise."""

    def __init__(self, cfg: Dust3rConfig, device="cuda"):
        super().__init__()
        c = self.cfg = cfg
        kw = dict(dtype=c.dtype, device=device)
        self.patch = PatchEmbed(c.patch, c.enc_width, **kw)
        for i in range(c.enc_depth):
            self.add_module(f"enc{i}", EncoderBlock(
                c.enc_width, c.enc_heads, c.rope_freq, **kw))
        self.enc_norm = LayerNorm(c.enc_width, **kw)
        self.decoder_embed = Dense(c.enc_width, c.dec_width, **kw)
        for i in range(c.dec_depth):
            for v in (1, 2):
                self.add_module(f"dec{v}_{i}", DecoderBlock(
                    c.dec_width, c.dec_heads, c.rope_freq, **kw))
        self.dec_norm1 = LayerNorm(c.dec_width, **kw)
        self.dec_norm2 = LayerNorm(c.dec_width, **kw)
        self.head1 = LinearHead(c.dec_width, c.patch, device=device)
        self.head2 = LinearHead(c.dec_width, c.patch, device=device)

    def forward(self, img1, img2) -> Dict[str, torch.Tensor]:
        """img1, img2 (B, H, W, 3) in [0, 1]; H and W multiples of the
        patch."""
        c = self.cfg
        b, h, w = img1.shape[:3]
        gh, gw = h // c.patch, w // c.patch
        pos = patch_positions(gh, gw, img1.device)

        # the siamese encoder: both views through one batched stream
        both = torch.cat([img1, img2], 0).float()
        x, _ = self.patch((both - 0.5) / 0.5)
        for i in range(c.enc_depth):
            x = getattr(self, f"enc{i}")(x, pos)
        x = self.enc_norm(x)

        # two decoders exchanging the previous layer's tokens
        d1, d2 = self.decoder_embed(x[:b]), self.decoder_embed(x[b:])
        for i in range(c.dec_depth):
            p1, p2 = d1, d2
            d1 = getattr(self, f"dec1_{i}")(p1, pos, p2, pos)
            d2 = getattr(self, f"dec2_{i}")(p2, pos, p1, pos)
        pts1, conf1 = self.head1(self.dec_norm1(d1), (gh, gw))
        pts2, conf2 = self.head2(self.dec_norm2(d2), (gh, gw))
        return {"pts3d1": pts1, "conf1": conf1, "pts3d2": pts2,
                "conf2": conf2}


def init_flax_style_(model: AsymmetricCroCo3DStereo,
                     generator: torch.Generator) -> None:
    """Random init from ``generator`` as flax initialises the JAX model:
    lecun-normal (truncated) Dense and Conv kernels, zero biases,
    LayerNorm ones and zeros."""
    init_flax_layers_(model, generator)


@torch.no_grad()
def estimate_focal(pts3d: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Weiszfeld focal estimate from a pointmap (H, W, 3) in its own camera
    frame, principal point at the image centre: minimise
    Σ ‖(u, v) − f·(x/z, y/z)‖ over f, from f = max(H, W). f32 scalar."""
    h, w = pts3d.shape[:2]
    dev = pts3d.device
    vv = torch.arange(h, dtype=torch.float32, device=dev)[:, None] \
        .expand(h, w) + 0.5 - h / 2.0
    uu = torch.arange(w, dtype=torch.float32, device=dev)[None, :] \
        .expand(h, w) + 0.5 - w / 2.0
    p = pts3d.float()
    z = torch.clamp(p[..., 2], min=1e-6)
    uv = torch.stack([uu.reshape(-1), vv.reshape(-1)], -1)
    pp = torch.stack([(p[..., 0] / z).reshape(-1),
                      (p[..., 1] / z).reshape(-1)], -1)
    f = torch.tensor(float(max(h, w)), dtype=torch.float32, device=dev)
    for _ in range(iters):
        r = torch.linalg.norm(uv - f * pp, dim=-1)
        wgt = 1.0 / torch.clamp(r, min=1e-6)
        num = torch.sum(wgt * torch.sum(uv * pp, -1))
        den = torch.sum(wgt * torch.sum(pp * pp, -1))
        f = num / torch.clamp(den, min=1e-8)
    return f
