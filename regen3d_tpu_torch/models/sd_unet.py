"""The Stable-Diffusion UNet2DConditionModel (counterpart of
regen3d_tpu/models/sd_unet.py), in the diffusers checkpoint layout.

One implementation serves the JAX package's three roles: the SD-x4
upscaler UNet, Marigold's UNets (the ``marigold`` conversion family) and
the camera-conditioned multiview texture UNet of ``pipeline/texgen.py``,
which gives per-view camera indices as ``class_labels``.

The modules follow the flax ones' numerics: the trunk computes in
``cfg.dtype`` (bf16 by default), the GroupNorms take f32 statistics (flax's
fast variance, eps 1e-6) and return f32, ``conv_out`` is f32, the strided
``SAME`` convolutions pad (0, 1) (``layers.Conv``), the LayerNorms are f32
with eps 1e-6, GELU is the tanh approximation, and every attention runs on
the flash forward (``ops.attention.flash_attention``; the tiny config's
heads of 4 are the kernel's D = 4). The group count is ``_gn``'s (the
config's, or 1 where it does not divide the channels), not
``unet._groups``'s. Submodules carry the flax tree's names (``down_0_resnet_0``,
``up_{n-1-i}_...`` by the diffusers up-block index), so
``models/from_jax.py`` maps the JAX package's parameters by name. Built on
the card unless ``device`` is given.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from regen3d_tpu_torch.models.layers import (
    Conv,
    Dense,
    LayerNorm,
    gelu,
    init_flax_layers_,
    timestep_embedding,
)
from regen3d_tpu_torch.models.unet import GroupNorm
from regen3d_tpu_torch.ops.attention import flash_attention


@dataclasses.dataclass(frozen=True)
class SDUNetConfig:
    in_channels: int = 7              # x4-upscaler: 4 latent + 3 lowres
    out_channels: int = 4
    block_channels: Tuple[int, ...] = (256, 512, 512, 1024)
    layers_per_block: int = 2
    cross_attn_dim: int = 1024
    attn_head_dim: int = 64
    attn_blocks: Tuple[bool, ...] = (True, True, True, False)
    norm_groups: int = 32
    class_embeddings: Optional[int] = None   # e.g. camera indices for texgen
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def tiny(cls, in_channels: int = 7, out_channels: int = 4,
             class_embeddings: Optional[int] = None) -> "SDUNetConfig":
        return cls(in_channels=in_channels, out_channels=out_channels,
                   block_channels=(8, 16), layers_per_block=1,
                   cross_attn_dim=16, attn_head_dim=4,
                   attn_blocks=(True, False), norm_groups=4,
                   class_embeddings=class_embeddings)

    @classmethod
    def sd_x4(cls) -> "SDUNetConfig":
        return cls()

    @classmethod
    def multiview(cls, num_views: int = 6) -> "SDUNetConfig":
        """The multiview texgen variant: [noisy latent ‖ reference latent ‖
        per-view geometry latent] in (12 channels), the view index as class
        embedding, the camera as an extra cross-attention token."""
        return cls(in_channels=12, out_channels=4,
                   block_channels=(192, 384, 768, 768),
                   cross_attn_dim=768, class_embeddings=num_views)


def _gn(groups: int, ch: int) -> int:
    """The JAX package's group count: min(groups, ch) where it divides ch,
    else 1."""
    return min(groups, ch) if ch % min(groups, ch) == 0 else 1


def group_norm(ch: int, groups: int, device) -> GroupNorm:
    return GroupNorm(ch, dtype=torch.float32, device=device,
                     groups=_gn(groups, ch))


class ResnetBlock(nn.Module):
    """diffusers ResnetBlock2D: norm1/conv1 + time_emb_proj + norm2/conv2
    (+ conv_shortcut where the width changes)."""

    def __init__(self, in_ch, out_ch, t_dim, groups, dtype, device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = group_norm(in_ch, groups, device)
        self.conv1 = Conv(in_ch, out_ch, 3, **kw)
        self.time_emb_proj = Dense(t_dim, out_ch, **kw)
        self.norm2 = group_norm(out_ch, groups, device)
        self.conv2 = Conv(out_ch, out_ch, 3, **kw)
        self.conv_shortcut = (Conv(in_ch, out_ch, 1, **kw) if in_ch != out_ch
                              else None)

    def forward(self, x, t_emb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(t_emb))[:, None, None, :]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class CrossAttention(nn.Module):
    """diffusers Attention: to_q/to_k/to_v (no bias) and to_out_0, on the
    flash forward; keys and values from ``ctx`` (width ``ctx_dim``), or
    from x itself."""

    def __init__(self, dim, heads, dtype, ctx_dim=None, device="cuda"):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.heads = heads
        ctx_dim = ctx_dim or dim
        self.to_q = Dense(dim, dim, bias=False, **kw)
        self.to_k = Dense(ctx_dim, dim, bias=False, **kw)
        self.to_v = Dense(ctx_dim, dim, bias=False, **kw)
        self.to_out_0 = Dense(dim, dim, **kw)

    def forward(self, x, ctx=None):
        ctx = x if ctx is None else ctx
        b, s, e = x.shape
        hd = e // self.heads

        def split(t):
            return t.reshape(b, -1, self.heads, hd).transpose(1, 2).contiguous()

        o = flash_attention(split(self.to_q(x)), split(self.to_k(ctx)),
                            split(self.to_v(ctx)))
        return self.to_out_0(o.transpose(1, 2).reshape(b, s, e))


class GEGLUFeedForward(nn.Module):
    """diffusers FeedForward with GEGLU: net_0_proj (to 2 × 4·dim, split
    into a and the gate g) and net_2: net_2(a · gelu(g))."""

    def __init__(self, dim, dtype, device="cuda"):
        super().__init__()
        self.net_0_proj = Dense(dim, dim * 8, dtype=dtype, device=device)
        self.net_2 = Dense(dim * 4, dim, dtype=dtype, device=device)

    def forward(self, x):
        a, g = self.net_0_proj(x).chunk(2, dim=-1)
        return self.net_2(a * gelu(g))


class TransformerBlock2D(nn.Module):
    """diffusers BasicTransformerBlock: attn1 (self), attn2 (cross), ff,
    each after its LayerNorm (norm1, norm2, norm3) and added back."""

    def __init__(self, dim, heads, ctx_dim, dtype, device="cuda"):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype=dtype, device=device)
        self.attn1 = CrossAttention(dim, heads, dtype, device=device)
        self.norm2 = LayerNorm(dim, dtype=dtype, device=device)
        self.attn2 = CrossAttention(dim, heads, dtype, ctx_dim, device=device)
        self.norm3 = LayerNorm(dim, dtype=dtype, device=device)
        self.ff = GEGLUFeedForward(dim, dtype, device=device)

    def forward(self, x, ctx):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), ctx)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """diffusers Transformer2DModel at depth 1: norm, proj_in, one
    BasicTransformerBlock over the H·W positions, proj_out, plus the
    input."""

    def __init__(self, ch, heads, ctx_dim, groups, dtype, device="cuda"):
        super().__init__()
        self.norm = group_norm(ch, groups, device)
        self.proj_in = Dense(ch, ch, dtype=dtype, device=device)
        self.transformer_blocks_0 = TransformerBlock2D(ch, heads, ctx_dim,
                                                       dtype, device)
        self.proj_out = Dense(ch, ch, dtype=dtype, device=device)

    def forward(self, x, ctx):
        b, h, w, c = x.shape
        y = self.proj_in(self.norm(x)).reshape(b, h * w, c)
        y = self.transformer_blocks_0(y, ctx).reshape(b, h, w, c)
        return self.proj_out(y) + x


class SDUNet(nn.Module):
    """UNet2DConditionModel: (latents (B, H, W, in), t (B,) float
    timesteps, encoder_hidden_states (B, S, cross_attn_dim)
    [, class_labels (B,) int]) → the noise prediction (B, H, W, out) f32."""

    def __init__(self, cfg: SDUNetConfig, device="cuda"):
        super().__init__()
        c = self.cfg = cfg
        dt, g = c.dtype, c.norm_groups
        kw = dict(dtype=dt, device=device)
        t_dim = c.block_channels[0] * 4
        self.time_embedding_linear_1 = Dense(c.block_channels[0], t_dim, **kw)
        self.time_embedding_linear_2 = Dense(t_dim, t_dim, **kw)
        if c.class_embeddings is not None:
            self.class_embedding = nn.Embedding(c.class_embeddings, t_dim,
                                                device=device)

        def heads(ch):
            return max(1, ch // c.attn_head_dim)

        def block(name, in_ch, ch, attn):
            self.add_module(name.format("resnet"),
                            ResnetBlock(in_ch, ch, t_dim, g, dt, device))
            if attn:
                self.add_module(name.format("attn"), SpatialTransformer(
                    ch, heads(ch), c.cross_attn_dim, g, dt, device))

        self.conv_in = Conv(c.in_channels, c.block_channels[0], 3, **kw)
        width, skips = c.block_channels[0], [c.block_channels[0]]
        n = len(c.block_channels)
        for i, ch in enumerate(c.block_channels):
            for j in range(c.layers_per_block):
                block(f"down_{i}_{{}}_{j}", width, ch, c.attn_blocks[i])
                width = ch
                skips.append(ch)
            if i < n - 1:
                self.add_module(f"down_{i}_downsample",
                                Conv(ch, ch, 3, stride=2, **kw))
                skips.append(ch)
        self.mid_resnet_0 = ResnetBlock(width, width, t_dim, g, dt, device)
        self.mid_attn_0 = SpatialTransformer(width, heads(width),
                                             c.cross_attn_dim, g, dt, device)
        self.mid_resnet_1 = ResnetBlock(width, width, t_dim, g, dt, device)
        for i, ch in reversed(list(enumerate(c.block_channels))):
            k = n - 1 - i
            for j in range(c.layers_per_block + 1):
                block(f"up_{k}_{{}}_{j}", width + skips.pop(), ch,
                      c.attn_blocks[i])
                width = ch
            if i > 0:
                self.add_module(f"up_{k}_upsample", Conv(ch, ch, 3, **kw))
        self.conv_norm_out = group_norm(width, g, device)
        self.conv_out = Conv(width, c.out_channels, 3, dtype=torch.float32,
                             device=device)

    def forward(self, x, t, ctx, class_labels=None):
        c = self.cfg
        n = len(c.block_channels)
        t_emb = timestep_embedding(t, c.block_channels[0])
        t_emb = self.time_embedding_linear_1(t_emb.to(c.dtype))
        t_emb = self.time_embedding_linear_2(F.silu(t_emb))
        if c.class_embeddings is not None:
            t_emb = t_emb + self.class_embedding(class_labels).to(c.dtype)
        ctx = ctx.to(c.dtype)

        def block(name, h):
            h = getattr(self, name.format("resnet"))(h, t_emb)
            attn = getattr(self, name.format("attn"), None)
            return h if attn is None else attn(h, ctx)

        h = self.conv_in(x.to(c.dtype))
        skips = [h]
        for i in range(n):
            for j in range(c.layers_per_block):
                h = block(f"down_{i}_{{}}_{j}", h)
                skips.append(h)
            if i < n - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
                skips.append(h)
        h = self.mid_resnet_0(h, t_emb)
        h = self.mid_attn_0(h, ctx)
        h = self.mid_resnet_1(h, t_emb)
        for i in reversed(range(n)):
            k = n - 1 - i
            for j in range(c.layers_per_block + 1):
                h = block(f"up_{k}_{{}}_{j}", torch.cat([h, skips.pop()], -1))
            if i > 0:
                # jax.image.resize "nearest" at exactly 2×: each pixel twice
                h = h.repeat_interleave(2, 1).repeat_interleave(2, 2)
                h = getattr(self, f"up_{k}_upsample")(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


@torch.no_grad()
def init_flax_style_(model: nn.Module, generator: torch.Generator) -> None:
    """Random init from ``generator`` as flax initialises the JAX modules:
    lecun-normal (truncated) Dense and Conv kernels, zero biases, norms at
    ones and zeros, and the class embedding N(0, 1/width) (flax's Embed:
    variance scaling over the embedding width)."""
    init_flax_layers_(model, generator)
    for mod in model.modules():
        if isinstance(mod, GroupNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            w = torch.empty(mod.weight.shape, device=generator.device)
            w.normal_(0.0, mod.weight.shape[1] ** -0.5, generator=generator)
            mod.weight.copy_(w)
