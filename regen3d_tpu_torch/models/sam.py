"""SAM: promptable segmentation (counterpart of regen3d_tpu/models/sam.py).

image (B, S, S, 3) in [0, 1] → embedding (B, S/16, S/16, prompt_dim) by a
windowed ViT with SAM's decomposed relative-position bias; points, labels
and boxes → sparse prompt tokens; a two-way mask decoder → mask logits
(B, 4, 4·grid, 4·grid) and IoU predictions (B, 4). Token 0 is the
single-mask output, tokens 1-3 the multimask outputs.

Attention, as in the JAX model:

* global blocks (and any attention over at least ``flash_min_tokens``
  tokens) run ``ops/attention.flash_attention_grid_bias``, whose CUDA kernel
  reads the factored bias (B, H, S, kh) + (B, H, S, kw) and never builds the
  (S, S) bias;
* the 14² windows below that gate take the einsum path with the bias
  materialised in f32, both products accumulating in f32;
* the mask decoder's attentions run ``ops/attention.flash_attention`` at
  head dims 32 (token self-attention) and 16 (the cross-attentions).

Submodule and parameter names follow the flax tree, so
``models/from_jax.py`` maps a flax SAM's parameters by name.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from regen3d_tpu_torch.models.layers import (
    Conv,
    ConvTranspose,
    Dense,
    LayerNorm,
    Mlp,
    gelu,
    init_flax_layers_,
)
from regen3d_tpu_torch.ops.attention import (
    flash_attention,
    flash_attention_grid_bias,
)

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class SamConfig:
    image_size: int = 1024
    patch: int = 16
    width: int = 1280            # ViT-H
    depth: int = 32
    num_heads: int = 16
    window: int = 14
    global_blocks: Tuple[int, ...] = (7, 15, 23, 31)
    prompt_dim: int = 256
    dtype: torch.dtype = torch.bfloat16
    # attention over at least this many tokens takes the grid-bias kernel;
    # SAM-H's 64² global blocks always do, its 14² windows do not
    flash_min_tokens: int = 1024

    @property
    def grid(self) -> int:
        return self.image_size // self.patch

    @classmethod
    def tiny(cls) -> "SamConfig":
        return cls(image_size=64, patch=16, width=64, depth=2, num_heads=4,
                   window=2, global_blocks=(1,), prompt_dim=32)


def _window_partition(x, win):
    """(B, H, W, C) → windows (B·hh·ww, win, win, C), zero-padded to a
    multiple of ``win``, and what ``_window_unpartition`` needs."""
    b, h, w, c = x.shape
    x = F.pad(x, (0, 0, 0, (-w) % win, 0, (-h) % win))
    hh, ww = x.shape[1] // win, x.shape[2] // win
    x = x.reshape(b, hh, win, ww, win, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * hh * ww, win, win, c), (hh, ww, h, w)


def _window_unpartition(x, win, meta):
    hh, ww, h, w = meta
    b = x.shape[0] // (hh * ww)
    x = x.reshape(b, hh, ww, win, win, -1).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, hh * win, ww * win, -1)
    return x[:, :h, :w]


def _rel_pos_factors(q_hw, k_hw, rel_h, rel_w, q):
    """bias_h (B, H, qh, qw, kh) and bias_w (B, H, qh, qw, kw): q (already
    scaled, f32) against the relative-position tables looked up by
    q-row − k-row (and column)."""
    qh, qw = q_hw
    kh, kw = k_hw

    def get(rel, qs, ks):
        coords = (torch.arange(qs, device=rel.device)[:, None]
                  - torch.arange(ks, device=rel.device)[None, :]) + (ks - 1)
        return rel[coords]  # (qs, ks, d)

    b, heads, _, d = q.shape
    qr = q.reshape(b, heads, qh, qw, d)
    bias_h = torch.einsum("bnhwd,hkd->bnhwk", qr, get(rel_h, qh, kh))
    bias_w = torch.einsum("bnhwd,wkd->bnhwk", qr, get(rel_w, qw, kw))
    return bias_h, bias_w


def _rel_pos_bias(q_hw, k_hw, rel_h, rel_w, q):
    """Decomposed relative-position bias (B, H, qh·qw, kh·kw)."""
    bias_h, bias_w = _rel_pos_factors(q_hw, k_hw, rel_h, rel_w, q)
    b, heads = q.shape[:2]
    bias = bias_h[..., :, None] + bias_w[..., None, :]
    return bias.reshape(b, heads, q_hw[0] * q_hw[1], k_hw[0] * k_hw[1])


def _rel_pos_bias_factored(q_hw, k_hw, rel_h, rel_w, q):
    """The same bias left in its factors: bias_h (B, H, S, kh) and bias_w
    (B, H, S, kw), for ``flash_attention_grid_bias``."""
    bias_h, bias_w = _rel_pos_factors(q_hw, k_hw, rel_h, rel_w, q)
    b, heads = q.shape[:2]
    s = q_hw[0] * q_hw[1]
    return (bias_h.reshape(b, heads, s, k_hw[0]),
            bias_w.reshape(b, heads, s, k_hw[1]))


class SamAttention(nn.Module):
    """ViT attention with the decomposed rel-pos bias over a 2D token grid.

    With ``window`` set (and the grid larger than it), attention runs per
    window, but qkv runs once on the zero-padded full grid and proj once on
    the cropped grid, as in the JAX model. ``attn_hw`` is the attention's
    own grid (the window, or the whole grid), which sizes the rel-pos
    tables."""

    def __init__(self, dim, num_heads, attn_hw: Tuple[int, int], dtype,
                 flash_min_tokens: int = 1024, window: Optional[int] = None,
                 device="cuda"):
        super().__init__()
        self.num_heads = num_heads
        self.window = window
        self.flash_min_tokens = flash_min_tokens
        hd = dim // num_heads
        self.qkv = Dense(dim, 3 * dim, dtype=dtype, device=device)
        self.proj = Dense(dim, dim, dtype=dtype, device=device)
        self.rel_pos_h = nn.Parameter(
            torch.zeros(2 * attn_hw[0] - 1, hd, device=device))
        self.rel_pos_w = nn.Parameter(
            torch.zeros(2 * attn_hw[1] - 1, hd, device=device))

    def forward(self, x):  # (B, H, W, C)
        b, h0, w0, c = x.shape
        win = self.window
        windowed = bool(win) and (h0 > win or w0 > win)
        if windowed:
            x = F.pad(x, (0, 0, 0, (-w0) % win, 0, (-h0) % win))
        _, hg, wg, _ = x.shape
        hd = c // self.num_heads
        qkv = self.qkv(x.reshape(b, hg * wg, c))
        if windowed:
            qkv, meta = _window_partition(qkv.reshape(b, hg, wg, 3 * c), win)
            nb, h, w = qkv.shape[0], win, win
            qkv = qkv.reshape(nb, h * w, 3 * c)
        else:
            nb, h, w = b, hg, wg

        def heads(t):
            return (t.reshape(nb, h * w, self.num_heads, hd).transpose(1, 2)
                    .contiguous())

        q, k, v = (heads(t) for t in qkv.split(c, dim=-1))
        scale = hd ** -0.5
        # the bias comes from q in f32 times the scale, never from a product
        # rounded to q's dtype
        qf = q.float() * scale
        if h * w >= self.flash_min_tokens:
            bias_h, bias_w = _rel_pos_bias_factored(
                (h, w), (h, w), self.rel_pos_h, self.rel_pos_w, qf)
            o = flash_attention_grid_bias(q, k, v, bias_h.contiguous(),
                                          bias_w.contiguous(), w)
        else:
            # both products accumulate in f32 (JAX's preferred_element_type);
            # p is rounded to v's dtype before the second, as in JAX
            logits = torch.einsum("bnqd,bnkd->bnqk", q.float(), k.float())
            logits = logits * scale + _rel_pos_bias(
                (h, w), (h, w), self.rel_pos_h, self.rel_pos_w, qf)
            p = torch.softmax(logits, dim=-1)
            o = torch.einsum("bnqk,bnkd->bnqd", p.to(v.dtype).float(),
                             v.float()).to(v.dtype)
        o = o.transpose(1, 2).reshape(nb, h, w, c)
        if windowed:
            o = _window_unpartition(o, win, meta)[:, :h0, :w0]
        o = self.proj(o.reshape(b, h0 * w0, c))
        return o.reshape(b, h0, w0, c)


class SamBlock(nn.Module):
    def __init__(self, c: SamConfig, is_global: bool, device="cuda"):
        super().__init__()
        g = c.grid
        if is_global or g <= c.window:
            attn_hw, window = (g, g), (None if is_global else c.window)
        else:
            attn_hw, window = (c.window, c.window), c.window
        self.norm1 = LayerNorm(c.width, dtype=c.dtype, device=device)
        self.attn = SamAttention(c.width, c.num_heads, attn_hw, c.dtype,
                                 c.flash_min_tokens, window=window,
                                 device=device)
        self.norm2 = LayerNorm(c.width, dtype=c.dtype, device=device)
        self.mlp = Mlp(c.width, 4 * c.width, dtype=c.dtype, device=device)

    def forward(self, x):  # (B, H, W, C)
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class SamImageEncoder(nn.Module):
    """Image (B, S, S, 3) in [0, 1] → (B, S/16, S/16, prompt_dim), the neck
    output."""

    def __init__(self, c: SamConfig, device="cuda"):
        super().__init__()
        self.cfg = c
        self.patch_embed = Conv(3, c.width, c.patch, stride=c.patch,
                                dtype=c.dtype, device=device)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, c.grid, c.grid, c.width, device=device))
        for i in range(c.depth):
            self.add_module(f"block{i}", SamBlock(
                c, i in c.global_blocks, device=device))
        self.neck1 = Conv(c.width, c.prompt_dim, 1, bias=False, dtype=c.dtype,
                          device=device)
        self.neck_ln1 = LayerNorm(c.prompt_dim, dtype=c.dtype, device=device)
        self.neck2 = Conv(c.prompt_dim, c.prompt_dim, 3, bias=False,
                          dtype=c.dtype, device=device)
        self.neck_ln2 = LayerNorm(c.prompt_dim, dtype=c.dtype, device=device)

    def forward(self, img):
        c = self.cfg
        mean = torch.tensor(_MEAN, device=img.device)
        std = torch.tensor(_STD, device=img.device)
        x = self.patch_embed(((img - mean) / std).to(c.dtype))
        x = x + self.pos_embed.to(c.dtype)
        for i in range(c.depth):
            x = getattr(self, f"block{i}")(x)
        x = self.neck_ln1(self.neck1(x))
        return self.neck_ln2(self.neck2(x))


class PromptEncoder(nn.Module):
    """Points and boxes → sparse prompt tokens; the dense positional grid
    for the decoder's image attention."""

    def __init__(self, c: SamConfig, device="cuda"):
        super().__init__()
        d = c.prompt_dim
        self.pe_gauss = nn.Parameter(torch.zeros(2, d // 2, device=device))
        # pos, neg, box top-left, box bottom-right
        for i in range(4):
            setattr(self, f"point_embed{i}",
                    nn.Parameter(torch.zeros(d, device=device)))
        self.not_a_point = nn.Parameter(torch.zeros(d, device=device))

    def _pe(self, coords01):
        """Random-Fourier encoding of [0, 1]² coordinates → (..., D)."""
        proj = ((2.0 * coords01 - 1.0) @ self.pe_gauss) * (2 * math.pi)
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)

    def forward(self, points, point_labels, boxes):
        """points (B, P, 2) in [0, 1], labels (B, P) in {-1 pad, 0 negative,
        1 positive}, boxes (B, 2, 2) in [0, 1] (top-left, bottom-right) →
        sparse tokens (B, P + 2, D) f32."""
        pe_pts = self._pe(points)
        lab = point_labels[..., None]
        emb = torch.where(lab == 1, pe_pts + self.point_embed0,
                          torch.where(lab == 0, pe_pts + self.point_embed1,
                                      self.not_a_point))
        pe_box = self._pe(boxes) + torch.stack([self.point_embed2,
                                                self.point_embed3])
        return torch.cat([emb, pe_box], dim=1)

    def dense_pe(self, grid: int):
        """(grid, grid, D) positional grid; cell (i, j) encodes (x_j, y_i)."""
        dev = self.pe_gauss.device
        ys = (torch.arange(grid, dtype=torch.float32, device=dev) + 0.5) / grid
        xs = (torch.arange(grid, dtype=torch.float32, device=dev) + 0.5) / grid
        g = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1)
        return self._pe(g)


class TwoWayBlock(nn.Module):
    """Mask-decoder block: token self-attention (full width), token → image
    and image → token attention (half width), and a token MLP."""

    def __init__(self, d, num_heads, dtype, device="cuda"):
        super().__init__()
        self.num_heads = num_heads
        for name, di in (("self", d), ("t2i", d // 2), ("i2t", d // 2)):
            for part in ("q", "k", "v"):
                setattr(self, f"{name}_{part}",
                        Dense(d, di, dtype=dtype, device=device))
            setattr(self, f"{name}_out", Dense(di, d, dtype=dtype,
                                               device=device))
        for i in range(1, 5):
            setattr(self, f"ln{i}", LayerNorm(d, dtype=dtype, device=device))
        self.mlp = Mlp(d, 8 * d, dtype=dtype, device=device)

    def _attn(self, name, q, k, v):
        b = q.shape[0]

        def proj(t, part):
            t = getattr(self, f"{name}_{part}")(t)
            hd = t.shape[-1] // self.num_heads
            return (t.reshape(b, -1, self.num_heads, hd).transpose(1, 2)
                    .contiguous())

        o = flash_attention(proj(q, "q"), proj(k, "k"), proj(v, "v"))
        o = o.transpose(1, 2).reshape(b, -1, o.shape[1] * o.shape[3])
        return getattr(self, f"{name}_out")(o)

    def forward(self, tokens, image, token_pe, image_pe, skip_first_pe=False):
        q = tokens if skip_first_pe else tokens + token_pe
        tokens = self.ln1(tokens + self._attn("self", q, q, tokens))
        q = tokens + token_pe
        k = image + image_pe
        tokens = self.ln2(tokens + self._attn("t2i", q, k, image))
        tokens = self.ln3(tokens + self.mlp(tokens))
        image = self.ln4(image + self._attn("i2t", k, q, tokens))
        return tokens, image


class Mlp3(nn.Module):
    """Three-layer ReLU MLP (lin0/lin1/lin2): the hypernetworks and the IoU
    head."""

    def __init__(self, d_in, hidden, out, dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        self.lin0 = Dense(d_in, hidden, dtype=dtype, device=device)
        self.lin1 = Dense(hidden, hidden, dtype=dtype, device=device)
        self.lin2 = Dense(hidden, out, dtype=dtype, device=device)

    def forward(self, x):
        return self.lin2(F.relu(self.lin1(F.relu(self.lin0(x)))))


class MaskDecoder(nn.Module):
    """Two-way transformer → mask logits (B, 4, 4·grid, 4·grid) f32 and IoU
    predictions (B, 4) f32."""

    def __init__(self, c: SamConfig, num_masks: int = 4, device="cuda"):
        super().__init__()
        self.cfg = c
        self.num_masks = num_masks
        d = c.prompt_dim
        self.iou_token = nn.Parameter(torch.zeros(1, d, device=device))
        self.mask_tokens = nn.Parameter(torch.zeros(num_masks, d,
                                                    device=device))
        for i in range(2):
            self.add_module(f"block{i}", TwoWayBlock(d, 8, c.dtype,
                                                     device=device))
        for part in ("q", "k", "v"):
            setattr(self, f"final_{part}", Dense(d, d // 2, dtype=c.dtype,
                                                 device=device))
        self.final_out = Dense(d // 2, d, dtype=c.dtype, device=device)
        self.norm_final = LayerNorm(d, dtype=c.dtype, device=device)
        self.up1 = ConvTranspose(d, d // 4, dtype=c.dtype, device=device)
        self.up_ln = LayerNorm(d // 4, dtype=c.dtype, device=device)
        self.up2 = ConvTranspose(d // 4, d // 8, dtype=c.dtype, device=device)
        for m in range(num_masks):
            self.add_module(f"hyper{m}", Mlp3(d, d, d // 8, dtype=c.dtype,
                                              device=device))
        self.iou_head = Mlp3(d, d, num_masks, dtype=torch.float32,
                             device=device)

    def _final_attn(self, q, k, v):
        b = q.shape[0]

        def proj(t, part):
            t = getattr(self, f"final_{part}")(t)
            return t.reshape(b, -1, 8, t.shape[-1] // 8).transpose(1, 2) \
                .contiguous()

        o = flash_attention(proj(q, "q"), proj(k, "k"), proj(v, "v"))
        o = o.transpose(1, 2).reshape(b, -1, o.shape[1] * o.shape[3])
        return self.final_out(o)

    def forward(self, image_emb, image_pe, sparse_prompts):
        c = self.cfg
        d = c.prompt_dim
        b, gh, gw, _ = image_emb.shape
        out_tokens = torch.cat([self.iou_token, self.mask_tokens], dim=0)
        tokens = torch.cat([out_tokens[None].expand(b, *out_tokens.shape),
                            sparse_prompts], dim=1).to(c.dtype)
        token_pe = tokens
        img = image_emb.reshape(b, gh * gw, d)
        img_pe = image_pe.reshape(1, gh * gw, d).expand(img.shape)
        for i in range(2):
            tokens, img = getattr(self, f"block{i}")(
                tokens, img, token_pe, img_pe, skip_first_pe=(i == 0))
        tokens = self.norm_final(tokens + self._final_attn(
            tokens + token_pe, img + img_pe, img))
        iou_out = tokens[:, 0]
        mask_toks = tokens[:, 1:1 + self.num_masks]

        up = gelu(self.up_ln(self.up1(img.reshape(b, gh, gw, d))))
        up = gelu(self.up2(up))
        hyper = torch.stack([getattr(self, f"hyper{m}")(mask_toks[:, m])
                             for m in range(self.num_masks)], dim=1)
        masks = torch.einsum("bmd,bhwd->bmhw", hyper.float(), up.float())
        iou_pred = self.iou_head(iou_out.float())
        return masks, iou_pred


class SAM(nn.Module):
    """Image encoder, prompt encoder and mask decoder; ``encode`` once per
    image, ``decode`` per batch of prompts."""

    def __init__(self, c: SamConfig, device="cuda"):
        super().__init__()
        self.cfg = c
        self.image_encoder = SamImageEncoder(c, device=device)
        self.prompt_encoder = PromptEncoder(c, device=device)
        self.mask_decoder = MaskDecoder(c, device=device)

    def forward(self, img, points, point_labels, boxes):
        return self.decode(self.encode(img), points, point_labels, boxes)

    def encode(self, img):
        return self.image_encoder(img)

    def decode(self, image_emb, points, point_labels, boxes):
        sparse = self.prompt_encoder(points, point_labels, boxes)
        pe = self.prompt_encoder.dense_pe(image_emb.shape[1])
        return self.mask_decoder(image_emb, pe, sparse)


REL_POS_INIT_STD = 0.5


def init_flax_style_(model: nn.Module, generator: torch.Generator) -> None:
    """Random init from ``generator`` with the flax initializer families the
    JAX model uses: lecun-normal (truncated) Dense/Conv/ConvTranspose
    kernels, zero biases, LayerNorm ones/zeros, N(0, 1) ``pe_gauss`` and
    N(0, 0.02) position embedding, point embeddings and output tokens. The
    rel-pos tables, which flax starts at zero (where the bias vanishes and
    an attention that dropped it would go unseen), are drawn from
    N(0, REL_POS_INIT_STD²) instead."""
    init_flax_layers_(model, generator)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "pe_gauss":
                p.normal_(0.0, 1.0, generator=generator)
            elif leaf in ("pos_embed", "not_a_point", "iou_token",
                          "mask_tokens") or leaf.startswith("point_embed"):
                p.normal_(0.0, 0.02, generator=generator)
            elif leaf in ("rel_pos_h", "rel_pos_w"):
                p.normal_(0.0, REL_POS_INIT_STD, generator=generator)
