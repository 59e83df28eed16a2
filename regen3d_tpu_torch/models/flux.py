"""FLUX-family rectified-flow image transformer, MMDiT (counterpart of
regen3d_tpu/models/flux.py): the transformer of the reference's FLUX
upscaling path (FLUX.1-dev with the jasperai ControlNet upscaler), with
the flax tree's names, which ``models/conversion.py``'s ``flux`` family
maps onto the upstream diffusers ``FluxTransformer2DModel`` layout.

* ``x_in`` / ``cond_in`` token projections; ``t_in``/``t_out``,
  ``g_in``/``g_out`` and ``p_in``/``p_out``: the timestep, guidance and
  pooled-text MLPs summed into the conditioning vector;
* ``double{i}``: double-stream blocks, separate image and text streams
  with their own AdaLN modulation (shift, scale, gate twice), joint
  attention over [text ‖ image] tokens (text first, split back at the text
  length), per-head RMSNorm on q and k and a 3-axis rotary embedding on
  interleaved pairs;
* ``single{i}``: single-stream blocks over the concatenated sequence,
  attention and a tanh-GELU MLP from one modulated norm through one gated
  ``proj_out``;
* ``norm_out_lin`` (split (scale, shift), the diffusers order, where the
  blocks split shift first) and the f32 ``proj_out``.

Numerics follow flax's: parameters in f32 and compute in ``cfg.dtype``
(bf16 by default), as the JAX package's modules lay them out (FLUX.1-dev's
11.9 B parameters are 47.6 GB in f32); norms (``LayerNorm(affine=False)``,
``RMSNorm``) take f32 statistics with eps 1e-6; the rotary rotation is
computed in f32 and cast back; ``proj_out`` is an f32 Dense, which the card
runs in IEEE f32 unless the caller enables TF32 for matmuls. Every
attention goes through ``ops.attention.flash_attention``. Built on the card
unless ``device`` is given.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from regen3d_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    RMSNorm,
    gelu,
    init_flax_layers_,
    modulate,
    timestep_embedding,
)
from regen3d_tpu_torch.ops.attention import flash_attention


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    in_channels: int = 64          # 16-channel VAE latents packed 2×2
    width: int = 3072
    num_heads: int = 24            # head_dim 128
    double_depth: int = 19
    single_depth: int = 38
    cond_dim: int = 4096           # T5 joint_attention_dim
    pooled_dim: int = 768          # CLIP pooled projection
    mlp_ratio: float = 4.0
    axes_dim: Tuple[int, int, int] = (16, 56, 56)  # rotary axes (id, y, x)
    theta: float = 10000.0
    guidance: bool = True          # FLUX.1-dev has a guidance embedder
    latent_tokens: int = 1024      # default image sequence (init shapes)
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.width // self.num_heads

    @classmethod
    def tiny(cls) -> "FluxConfig":
        return cls(in_channels=8, width=64, num_heads=4, double_depth=1,
                   single_depth=2, cond_dim=32, pooled_dim=16,
                   axes_dim=(4, 6, 6), latent_tokens=16)


def rope_tables(ids: torch.Tensor, axes_dim: Tuple[int, ...], theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Position ids (B, L, n_axes) → rotary (cos, sin), each (B, L, hd/2)
    f32: per axis a of dim d, ω_j = θ^(−j/(d/2)) and angles id_a·ω, the
    axes concatenated along the head dimension."""
    cos, sin = [], []
    for a, d in enumerate(axes_dim):
        half = d // 2
        omega = theta ** (-torch.arange(half, dtype=torch.float32,
                                        device=ids.device) / half)
        ang = ids[..., a].float()[..., None] * omega
        cos.append(torch.cos(ang))
        sin.append(torch.sin(ang))
    return torch.cat(cos, -1), torch.cat(sin, -1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """Rotate (B, H, L, hd) by interleaved-pair rotary tables (B, L, hd/2),
    in f32, cast back to x's dtype."""
    xr = x.reshape(*x.shape[:-1], -1, 2).float()
    x0, x1 = xr[..., 0], xr[..., 1]
    c, s = cos[:, None], sin[:, None]
    out = torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], -1)
    return out.reshape(x.shape).to(x.dtype)


def _dense(d_in, d_out, dtype, device):
    """flax's ``nn.Dense(dtype=dtype)``: f32 parameters, compute in dtype."""
    return Dense(d_in, d_out, dtype=dtype, device=device,
                 param_dtype=torch.float32)


class QKV(nn.Module):
    """q/k/v projections, per-head RMSNorm on q and k, then the rotary
    embedding on q and k; ``prefix`` "" (image / single stream) or "add_"
    (the text stream), as the flax names carry it."""

    def __init__(self, cfg: FluxConfig, prefix: str = "", device="cuda"):
        super().__init__()
        c = self.cfg = cfg
        self.prefix = prefix
        for p in "qkv":
            self.add_module(f"{prefix}{p}", _dense(c.width, c.width,
                                                   c.dtype, device))
        for p in "qk":
            self.add_module(f"{prefix}{p}_norm", RMSNorm(
                c.head_dim, dtype=c.dtype, device=device))

    def forward(self, x, cos, sin):
        c, p = self.cfg, self.prefix
        b, s, _ = x.shape

        def proj(name):
            return getattr(self, name)(x).reshape(
                b, s, c.num_heads, c.head_dim).transpose(1, 2)

        q = getattr(self, f"{p}q_norm")(proj(f"{p}q"))
        k = getattr(self, f"{p}k_norm")(proj(f"{p}k"))
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), proj(f"{p}v")


class GeluMlp(nn.Module):
    """The diffusers FeedForward (gelu-approximate): fc1 → tanh-GELU → fc2."""

    def __init__(self, width, mlp_ratio, dtype, device="cuda"):
        super().__init__()
        hidden = int(width * mlp_ratio)
        self.fc1 = _dense(width, hidden, dtype, device)
        self.fc2 = _dense(hidden, width, dtype, device)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


def _attend(q, k, v, width):
    """Flash attention over (B, H, L, hd) → (B, L, width)."""
    o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    return o.transpose(1, 2).reshape(q.shape[0], -1, width)


class FluxDoubleBlock(nn.Module):
    """Double-stream MMDiT block (diffusers FluxTransformerBlock)."""

    def __init__(self, cfg: FluxConfig, device="cuda"):
        super().__init__()
        c = self.cfg = cfg
        w = c.width
        self.mod_img = _dense(w, 6 * w, c.dtype, device)
        self.mod_txt = _dense(w, 6 * w, c.dtype, device)
        for name in ("norm1_img", "norm1_txt", "norm2_img", "norm2_txt"):
            self.add_module(name, LayerNorm(w, affine=False, dtype=c.dtype,
                                            device=device))
        self.attn = QKV(c, device=device)
        self.attn_add = QKV(c, prefix="add_", device=device)
        self.out = _dense(w, w, c.dtype, device)
        self.ff = GeluMlp(w, c.mlp_ratio, c.dtype, device)
        self.add_out = _dense(w, w, c.dtype, device)
        self.ff_txt = GeluMlp(w, c.mlp_ratio, c.dtype, device)

    def forward(self, img, txt, vec, img_rope, txt_rope):
        svec = F.silu(vec)
        (i_shift, i_scale, i_gate,
         i_shift2, i_scale2, i_gate2) = self.mod_img(svec).chunk(6, -1)
        (t_shift, t_scale, t_gate,
         t_shift2, t_scale2, t_gate2) = self.mod_txt(svec).chunk(6, -1)
        img_n = modulate(self.norm1_img(img), i_shift, i_scale)
        txt_n = modulate(self.norm1_txt(txt), t_shift, t_scale)
        qi, ki, vi = self.attn(img_n, *img_rope)
        qt, kt, vt = self.attn_add(txt_n, *txt_rope)
        # joint attention, text first (the diffusers concat order)
        o = _attend(torch.cat([qt, qi], 2), torch.cat([kt, ki], 2),
                    torch.cat([vt, vi], 2), self.cfg.width)
        lt = txt.shape[1]
        o_txt, o_img = o[:, :lt], o[:, lt:]

        img = img + i_gate[:, None] * self.out(o_img)
        h = modulate(self.norm2_img(img), i_shift2, i_scale2)
        img = img + i_gate2[:, None] * self.ff(h)
        txt = txt + t_gate[:, None] * self.add_out(o_txt)
        h = modulate(self.norm2_txt(txt), t_shift2, t_scale2)
        txt = txt + t_gate2[:, None] * self.ff_txt(h)
        return img, txt


class FluxSingleBlock(nn.Module):
    """Single-stream block (diffusers FluxSingleTransformerBlock)."""

    def __init__(self, cfg: FluxConfig, device="cuda"):
        super().__init__()
        c = self.cfg = cfg
        w, hidden = c.width, int(c.width * c.mlp_ratio)
        self.mod = _dense(w, 3 * w, c.dtype, device)
        self.norm = LayerNorm(w, affine=False, dtype=c.dtype, device=device)
        self.attn = QKV(c, device=device)
        self.proj_mlp = _dense(w, hidden, c.dtype, device)
        self.proj_out = _dense(w + hidden, w, c.dtype, device)

    def forward(self, x, vec, rope):
        shift, scale, gate = self.mod(F.silu(vec)).chunk(3, -1)
        xn = modulate(self.norm(x), shift, scale)
        o = _attend(*self.attn(xn, *rope), self.cfg.width)
        mlp = gelu(self.proj_mlp(xn))
        return x + gate[:, None] * self.proj_out(torch.cat([o, mlp], -1))


def default_image_ids(b: int, l: int, device) -> torch.Tensor:
    """(B, L, 3) f32 ids: a square grid (0, y, x) when L is a square, else
    (0, 0, i)."""
    side = int(round(l ** 0.5))
    ar = torch.arange(l, device=device)
    zeros = torch.zeros(l, device=device)
    if side * side == l:
        ids = torch.stack([zeros, (ar // side).float(),
                           (ar % side).float()], -1)
    else:
        ids = torch.stack([zeros, zeros, ar.float()], -1)
    return ids[None].expand(b, l, 3)


class FluxTransformer(nn.Module):
    """Image-latent tokens + condition tokens → velocity prediction. The
    call signature matches ShapeDiT's (x, t, cond), so ``models/dit.sample``
    drives it (given ``latents``: FluxConfig has no ``latent_dim``);
    ``pooled`` (None: zeros), ``guidance`` (None: 3.5) and the position ids
    (None: :func:`default_image_ids`, zeros for the text) are optional."""

    def __init__(self, cfg: FluxConfig, device="cuda"):
        super().__init__()
        c = self.cfg = cfg
        w = c.width
        self.x_in = _dense(c.in_channels, w, c.dtype, device)
        self.cond_in = _dense(c.cond_dim, w, c.dtype, device)
        self.t_in = _dense(256, w, c.dtype, device)
        self.t_out = _dense(w, w, c.dtype, device)
        if c.guidance:
            self.g_in = _dense(256, w, c.dtype, device)
            self.g_out = _dense(w, w, c.dtype, device)
        self.p_in = _dense(c.pooled_dim, w, c.dtype, device)
        self.p_out = _dense(w, w, c.dtype, device)
        for i in range(c.double_depth):
            self.add_module(f"double{i}", FluxDoubleBlock(c, device))
        for i in range(c.single_depth):
            self.add_module(f"single{i}", FluxSingleBlock(c, device))
        self.norm_out_lin = _dense(w, 2 * w, c.dtype, device)
        self.norm_out = LayerNorm(w, affine=False, dtype=c.dtype,
                                  device=device)
        self.proj_out = Dense(w, c.in_channels, dtype=torch.float32,
                              device=device)

    def forward(self, x, t, cond, pooled: Optional[torch.Tensor] = None,
                guidance: Optional[torch.Tensor] = None,
                img_ids: Optional[torch.Tensor] = None,
                txt_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, L, in_channels), t (B,) in [0, 1], cond (B, Lt, cond_dim)
        → velocity (B, L, in_channels) f32."""
        c = self.cfg
        b, l, _ = x.shape
        lt = cond.shape[1]
        dev = x.device
        if img_ids is None:
            img_ids = default_image_ids(b, l, dev)
        if txt_ids is None:
            txt_ids = torch.zeros((b, lt, 3), device=dev)
        img_rope = rope_tables(img_ids, c.axes_dim, c.theta)
        txt_rope = rope_tables(txt_ids, c.axes_dim, c.theta)
        all_rope = tuple(torch.cat([tr, ir], 1)
                         for tr, ir in zip(txt_rope, img_rope))

        img = self.x_in(x)
        txt = self.cond_in(cond)
        vec = self.t_out(F.silu(self.t_in(
            timestep_embedding(t * 1000.0, 256))))
        if c.guidance:
            g = (guidance if guidance is not None
                 else torch.full((b,), 3.5, device=dev))
            vec = vec + self.g_out(F.silu(self.g_in(
                timestep_embedding(g * 1000.0, 256))))
        p = (pooled if pooled is not None
             else torch.zeros((b, c.pooled_dim), dtype=x.dtype, device=dev))
        vec = vec + self.p_out(F.silu(self.p_in(p)))

        for i in range(c.double_depth):
            img, txt = getattr(self, f"double{i}")(img, txt, vec, img_rope,
                                                   txt_rope)
        h = torch.cat([txt, img], 1)
        for i in range(c.single_depth):
            h = getattr(self, f"single{i}")(h, vec, all_rope)
        h = h[:, lt:]
        scale, shift = self.norm_out_lin(F.silu(vec)).chunk(2, -1)
        return self.proj_out(modulate(self.norm_out(h), shift, scale))


def init_flax_style_(model: nn.Module, generator: torch.Generator) -> None:
    """Random init from ``generator`` as flax initialises the JAX model:
    lecun-normal (truncated) Dense kernels, zero biases, RMSNorm scales
    one (FLUX has no zero-initialised leaf)."""
    with torch.no_grad():
        init_flax_layers_(model, generator)
        for mod in model.modules():
            if isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)
