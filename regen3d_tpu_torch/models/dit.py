"""Image-conditioned flow-matching shape DiT (counterpart of
regen3d_tpu/models/dit.py, the Hunyuan3D-2-family asset generator of
phase 3).

A set of L shape-latent tokens (L × D) is denoised by AdaLN-Zero DiT blocks
with cross-attention to image-encoder tokens; every attention runs the flash
kernels (``ops/attention.flash_attention``), forward and backward. The
objective is rectified flow: x_t = (1 − t)·x₀ + t·ε with target ε − x₀; the
sampler is Euler on a shifted timestep grid with classifier-free guidance
against a zero condition.

Parameters are f32 and the compute is ``cfg.dtype`` (bf16 by default), as
flax's ``param_dtype`` / ``dtype`` split lays them out; ``x_out`` computes
in f32. Submodule and parameter names follow the flax tree, so
``models/from_jax.py`` maps a flax ShapeDiT's parameters by name.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from regen3d_tpu_torch.models.layers import (
    Attention,
    Dense,
    DiTBlock,
    LayerNorm,
    Mlp,
    RMSNorm,
    lecun_normal_,
    modulate,
    timestep_embedding,
)

# the Dense kernels that flax starts at zero (AdaLN-Zero)
ZERO_INIT_DENSE = ("adaLN", "adaLN_out", "x_out")


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    latent_tokens: int = 512      # L: size of the shape latent set
    latent_dim: int = 64          # D: per-token latent channels
    width: int = 1024
    depth: int = 16
    num_heads: int = 16
    cond_dim: int = 768           # image-encoder token width
    mlp_ratio: float = 4.0
    # MIDI-style multi-instance denoising: every block is followed by a
    # zero-gated attention over the concatenated tokens of all instances in
    # the batch (batch = the instances of one scene)
    cross_instance: bool = False
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def tiny(cls) -> "DiTConfig":
        return cls(latent_tokens=16, latent_dim=8, width=64, depth=2,
                   num_heads=4, cond_dim=32)

    @classmethod
    def base(cls) -> "DiTConfig":
        return cls()

    @classmethod
    def large(cls) -> "DiTConfig":
        return cls(latent_tokens=1024, latent_dim=64, width=2048, depth=24,
                   num_heads=16, cond_dim=1536)


class ShapeDiT(nn.Module):
    """Velocity-prediction DiT over shape-latent token sets."""

    def __init__(self, cfg: DiTConfig, device="cuda"):
        super().__init__()
        c = self.cfg = cfg
        kw = dict(dtype=c.dtype, device=device, param_dtype=torch.float32)
        self.x_in = Dense(c.latent_dim, c.width, **kw)
        self.latent_pos = nn.Parameter(
            torch.zeros(c.latent_tokens, c.width, device=device))
        self.t_mlp = Mlp(256, c.width, out=c.width, **kw)
        self.cond_in = Dense(c.cond_dim, c.width, **kw)
        self.cond_norm = LayerNorm(c.width, dtype=c.dtype, device=device)
        for i in range(c.depth):
            self.add_module(f"block{i}", DiTBlock(
                c.width, c.num_heads, c.mlp_ratio, use_cross=True, **kw))
            if c.cross_instance:
                self.add_module(f"inst_norm{i}", LayerNorm(
                    c.width, affine=False, dtype=c.dtype, device=device))
                self.add_module(f"inst_attn{i}", Attention(
                    c.width, c.num_heads, qk_norm=True, **kw))
                self.register_parameter(f"inst_gate{i}", nn.Parameter(
                    torch.zeros(c.width, device=device)))
        self.norm_out = LayerNorm(c.width, affine=False, dtype=c.dtype,
                                  device=device)
        self.adaLN_out = Dense(c.width, 2 * c.width, **kw)
        self.x_out = Dense(c.width, c.latent_dim, dtype=torch.float32,
                           device=device)

    def forward(self, x, t, cond):
        """x (B, L, D) noisy latents, t (B,) in [0, 1], cond (B, S, cond_dim)
        → velocity (B, L, D) f32."""
        c = self.cfg
        h = self.x_in(x) + self.latent_pos[None].to(c.dtype)
        t_emb = self.t_mlp(timestep_embedding(t * 1000.0, 256))
        cond_tok = self.cond_norm(self.cond_in(cond))
        b = h.shape[0]
        for i in range(c.depth):
            h = getattr(self, f"block{i}")(h, t_emb, cond_tok)
            if c.cross_instance:
                # instance axis = batch axis: all instances' tokens attend
                # jointly
                g = getattr(self, f"inst_norm{i}")(h)
                g = getattr(self, f"inst_attn{i}")(
                    g.reshape(1, b * c.latent_tokens, c.width))
                gate = getattr(self, f"inst_gate{i}").to(h.dtype)
                h = h + gate * g.reshape(b, c.latent_tokens, c.width)
        shift, scale = self.adaLN_out(F.silu(t_emb)).chunk(2, dim=-1)
        return self.x_out(modulate(self.norm_out(h), shift, scale))

    def null_cond(self, batch: int, seq: int) -> torch.Tensor:
        """The classifier-free-guidance null condition: zeros."""
        return torch.zeros((batch, seq, self.cfg.cond_dim),
                           dtype=self.cfg.dtype,
                           device=self.latent_pos.device)


def init_flax_style_(model: ShapeDiT, generator: torch.Generator) -> None:
    """Random init from ``generator`` as flax initialises the JAX model:
    lecun-normal (truncated) Dense kernels, zero biases, LayerNorm and
    RMSNorm ones/zeros, N(0, 0.02) ``latent_pos``, and the AdaLN-Zero
    leaves (the ``adaLN``, ``adaLN_out`` and ``x_out`` kernels and every
    ``inst_gate``) at zero."""
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, Dense):
                if name.rsplit(".", 1)[-1] in ZERO_INIT_DENSE:
                    mod.weight.zero_()
                else:
                    lecun_normal_(mod.weight, mod.weight.shape[1], generator)
                mod.bias.zero_()
            elif isinstance(mod, (LayerNorm, RMSNorm)) \
                    and mod.weight is not None:
                mod.weight.fill_(1.0)
                if isinstance(mod, LayerNorm):
                    mod.bias.zero_()
        model.latent_pos.normal_(0.0, 0.02, generator=generator)
        for name, p in model.named_parameters():
            if name.startswith("inst_gate"):
                p.zero_()


def draw_zero_init_leaves_(model: ShapeDiT, generator: torch.Generator,
                           std: float = 0.02) -> None:
    """Draw the AdaLN-Zero leaves from N(0, std²). At flax's init the
    ``x_out`` kernel and every gate are zero, so the gradient stops at
    ``x_out`` and every attention's incoming gradient is exactly 0: a
    backward kernel that returned zeros would pass any gradient check.
    Every gradient check draws them non-zero first."""
    with torch.no_grad():
        for name, mod in model.named_modules():
            if name.rsplit(".", 1)[-1] in ZERO_INIT_DENSE:
                mod.weight.normal_(0.0, std, generator=generator)
        for name, p in model.named_parameters():
            if name.startswith("inst_gate"):
                p.normal_(0.0, std, generator=generator)


# -----------------------------------------------------------------------------
# Rectified-flow training and sampling
# -----------------------------------------------------------------------------

def flow_draws(x0: torch.Tensor, generator: Optional[torch.Generator],
               cond_drop_prob: float = 0.1
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The flow loss's draws for the batch ``x0`` from ``generator`` (on
    x₀'s device), in this order: t (B,) uniform, ε like x₀ normal, drop
    (B,) bool with probability ``cond_drop_prob``."""
    b = x0.shape[0]
    t = torch.rand(b, generator=generator, device=x0.device)
    eps = torch.randn(x0.shape, generator=generator, device=x0.device,
                      dtype=x0.dtype)
    drop = torch.rand(b, generator=generator,
                      device=x0.device) < cond_drop_prob
    return t, eps, drop


def flow_matching_loss(model: ShapeDiT, x0: torch.Tensor, cond: torch.Tensor,
                       generator: Optional[torch.Generator],
                       cond_drop_prob: float = 0.1,
                       draws: Optional[Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]] = None
                       ) -> torch.Tensor:
    """Rectified-flow MSE: x_t = (1 − t)·x₀ + t·ε, target ε − x₀, the
    condition zeroed for a ``cond_drop_prob`` share of the batch. The draws
    (t (B,) uniform, ε like x₀ normal, drop (B,) bool) come from
    ``generator`` (on x₀'s device) unless ``draws`` gives them."""
    t, eps, drop = draws if draws is not None else flow_draws(
        x0, generator, cond_drop_prob)
    x_t = (1.0 - t)[:, None, None] * x0 + t[:, None, None] * eps
    cond_used = cond.masked_fill(drop[:, None, None], 0.0)
    v = model(x_t, t, cond_used)
    return torch.mean((v - (eps - x0)) ** 2)


def timestep_shift(t: torch.Tensor, shift: float = 3.0) -> torch.Tensor:
    """Resolution-style timestep shift used by flow-matching samplers."""
    return shift * t / (1.0 + (shift - 1.0) * t)


@torch.no_grad()
def sample(model: ShapeDiT, cond: torch.Tensor, num_steps: int = 50,
           guidance_scale: float = 5.0, shift: float = 3.0,
           latents: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Euler flow sampler ε → x₀ (the reference's 50 steps, guidance 5.0).
    ``latents`` (B, L, D) default to N(0, 1) from ``generator``. Returns
    (B, L, D) latents."""
    c = model.cfg
    b = cond.shape[0]
    if latents is None:
        latents = torch.randn((b, c.latent_tokens, c.latent_dim),
                              generator=generator, device=cond.device)
    ts = timestep_shift(torch.linspace(1.0, 0.0, num_steps + 1,
                                       device=cond.device), shift)
    null = torch.zeros_like(cond)
    # classifier-free guidance as one 2B-batch forward; the cross-instance
    # mode keeps two, since its instance attention mixes the batch axis
    fuse_cfg = guidance_scale != 1.0 and not c.cross_instance
    x = latents
    for i in range(num_steps):
        tt = ts[i].expand(b)
        if fuse_cfg:
            v2 = model(torch.cat([x, x]), torch.cat([tt, tt]),
                       torch.cat([cond, null]))
            v_c, v_u = v2[:b], v2[b:]
            v = v_u + guidance_scale * (v_c - v_u)
        elif guidance_scale != 1.0:
            v_c, v_u = model(x, tt, cond), model(x, tt, null)
            v = v_u + guidance_scale * (v_c - v_u)
        else:
            v = model(x, tt, cond)
        x = x + (ts[i + 1] - ts[i]) * v
    return x
