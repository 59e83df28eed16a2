"""Shape VAE: point cloud ↔ latent-token set, with an SDF decoder
(counterpart of regen3d_tpu/models/shapevae.py, the Hunyuan3D-2 "vecset"
family that phase 3 decodes).

* ``ShapeEncoder``: Fourier-embedded surface samples cross-attended into
  learned latent queries, then self-attention blocks;
* ``ShapeDecoder``: ``trunk`` (the latent self-attention stack, once per
  object) and ``query`` (each point's Fourier features cross-attending the
  trunk's tokens → SDF), kept apart so a grid decode runs the trunk once and
  streams point chunks through ``query``;
* ``decode_grid`` (dense) and ``decode_grid_hierarchical`` (a coarse pass,
  the cells nearest the surface by a stable sort of −|sdf|, a fine pass in
  those cells) on the device; ``assemble_volume`` puts the volume together
  on the host.

Parameters are f32 and the compute is ``cfg.dtype`` (bf16 by default), as
flax's ``param_dtype`` / ``dtype`` split lays them out; ``out`` and
``sdf_out`` compute in f32. Submodule names follow the flax tree, so
``models/from_jax.py`` maps the parameters by name. Every attention runs the
flash kernel (``ops/attention.flash_attention``).

The grid's coordinates are built on the host in f32 as XLA's CPU compiler
evaluates ``jnp.linspace`` (``linspace_f32``), so the port's query points
are the JAX package's bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from regen3d_tpu_torch.models.layers import (
    Attention,
    Dense,
    LayerNorm,
    Mlp,
    TransformerBlock,
    fourier_features,
)
from regen3d_tpu_torch.models import layers


@dataclasses.dataclass(frozen=True)
class ShapeVAEConfig:
    latent_tokens: int = 512
    latent_dim: int = 64
    width: int = 512
    enc_depth: int = 4
    dec_depth: int = 8
    num_heads: int = 8
    num_freqs: int = 8
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def tiny(cls) -> "ShapeVAEConfig":
        return cls(latent_tokens=16, latent_dim=8, width=64, enc_depth=1,
                   dec_depth=2, num_heads=4, num_freqs=4)


def _kw(c: ShapeVAEConfig, device):
    return dict(dtype=c.dtype, device=device, param_dtype=torch.float32)


class ShapeEncoder(nn.Module):
    """Surface samples (B, N, 3) → latent tokens (B, L, D) f32."""

    def __init__(self, cfg: ShapeVAEConfig, device="cuda"):
        super().__init__()
        c = self.cfg = cfg
        kw = _kw(c, device)
        self.point_in = Dense(3 + 6 * c.num_freqs, c.width, **kw)
        self.latent_queries = nn.Parameter(
            torch.zeros(c.latent_tokens, c.width, device=device))
        self.gather_norm = LayerNorm(c.width, dtype=c.dtype, device=device)
        self.gather = Attention(c.width, c.num_heads, **kw)
        for i in range(c.enc_depth):
            self.add_module(f"block{i}",
                            TransformerBlock(c.width, c.num_heads, **kw))
        self.out_norm = LayerNorm(c.width, dtype=c.dtype, device=device)
        self.out = Dense(c.width, c.latent_dim, dtype=torch.float32,
                         device=device)

    def forward(self, points):
        c = self.cfg
        h = self.point_in(fourier_features(points, c.num_freqs))
        q = self.latent_queries[None].to(c.dtype).expand(
            points.shape[0], -1, -1)
        q = q + self.gather(self.gather_norm(q), h)
        for i in range(c.enc_depth):
            q = getattr(self, f"block{i}")(q)
        return self.out(self.out_norm(q))


class ShapeDecoder(nn.Module):
    """(latents (B, L, D), points (B, Q, 3)) → SDF (B, Q) f32."""

    def __init__(self, cfg: ShapeVAEConfig, device="cuda"):
        super().__init__()
        c = self.cfg = cfg
        kw = _kw(c, device)
        self.lat_in = Dense(c.latent_dim, c.width, **kw)
        for i in range(c.dec_depth):
            self.add_module(f"block{i}",
                            TransformerBlock(c.width, c.num_heads, **kw))
        self.query_in = Dense(3 + 6 * c.num_freqs, c.width, **kw)
        self.q_norm = LayerNorm(c.width, dtype=c.dtype, device=device)
        self.query_cross = Attention(c.width, c.num_heads, **kw)
        self.o_norm = LayerNorm(c.width, dtype=c.dtype, device=device)
        self.mlp = Mlp(c.width, 2 * c.width, **kw)
        self.out_norm = LayerNorm(c.width, dtype=c.dtype, device=device)
        self.sdf_out = Dense(c.width, 1, dtype=torch.float32, device=device)

    def trunk(self, latents):
        """latents (B, L, D) → processed latent tokens (B, L, width)."""
        h = self.lat_in(latents)
        for i in range(self.cfg.dec_depth):
            h = getattr(self, f"block{i}")(h)
        return h

    def query(self, h, points):
        """(trunk output (B, L, width), points (B, Q, 3)) → SDF (B, Q). The
        query embedding enters residually (pq + cross-attention)."""
        pq = self.query_in(fourier_features(points, self.cfg.num_freqs))
        o = pq + self.query_cross(self.q_norm(pq), h)
        o = o + self.mlp(self.o_norm(o))
        return self.sdf_out(self.out_norm(o))[..., 0]

    def forward(self, latents, points):
        return self.query(self.trunk(latents), points)


def linspace_f32(bounds: float, resolution: int) -> np.ndarray:
    """``jnp.linspace(-bounds, bounds, resolution)`` bit for bit as XLA's CPU
    compiler evaluates it (``layers.linspace_f32``)."""
    return layers.linspace_f32(-bounds, bounds, resolution)


def _lin(bounds, resolution, device) -> torch.Tensor:
    return torch.from_numpy(linspace_f32(bounds, resolution)).to(device)


def make_grid(resolution: int, bounds: float = 1.01,
              device="cpu") -> torch.Tensor:
    """(R³, 3) regular query grid in [-bounds, bounds]³ (x fastest), f32."""
    lin = _lin(bounds, resolution, device)
    zz, yy, xx = torch.meshgrid(lin, lin, lin, indexing="ij")
    return torch.stack([xx, yy, zz], -1).reshape(-1, 3)


@torch.no_grad()
def decode_grid(decoder: ShapeDecoder, latents: torch.Tensor,
                resolution: int = 256, chunk: int = 16384,
                bounds: float = 1.01) -> torch.Tensor:
    """The SDF over a dense grid in chunks of ``chunk`` points (the last
    padded with the origin), every object sharing each chunk: latents
    (B, L, D) → (B, R, R, R) volumes (z, y, x order) on the latents' device;
    a batch of one returns (R, R, R)."""
    b = latents.shape[0]
    grid = make_grid(resolution, bounds, latents.device)
    n = grid.shape[0]
    pad = (-n) % chunk
    if pad:
        grid = torch.cat([grid, grid.new_zeros((pad, 3))])
    h = decoder.trunk(latents)
    sdf = torch.cat([decoder.query(h, pts[None].expand(b, chunk, 3))
                     for pts in grid.split(chunk)], 1)[:, :n]
    vols = sdf.reshape(b, resolution, resolution, resolution)
    return vols[0] if b == 1 else vols


def _eval_point_chunks(decoder: ShapeDecoder, h: torch.Tensor,
                       pts: torch.Tensor, chunk: int) -> torch.Tensor:
    """Per-object points (B, N, 3) → SDF (B, N) through ``decoder.query`` in
    chunks of ``chunk`` points (N padded with the origin to a multiple)."""
    b, n = pts.shape[:2]
    pad = (-n) % chunk
    if pad:
        pts = torch.cat([pts, pts.new_zeros((b, pad, 3))], 1)
    return torch.cat([decoder.query(h, q) for q in pts.split(chunk, 1)],
                     1)[:, :n]


def top_cells(score: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the ``k`` largest scores per row, largest first, ties
    to the lower index (``jax.lax.top_k``'s order; ``torch.topk`` does not
    fix it): a stable descending sort."""
    return torch.sort(score, dim=-1, descending=True, stable=True).indices[
        ..., :k]


@torch.no_grad()
def decode_grid_hierarchical(decoder: ShapeDecoder, latents: torch.Tensor,
                             resolution: int = 256, factor: int = 4,
                             chunk: int = 16384, bounds: float = 1.01,
                             refine_cells: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Two-level grid decode: a coarse dense pass on the fine grid
    subsampled by ``factor`` ((R/f)³ points), the ``refine_cells`` cells
    (default min(8·C², C³)) ranked by −|sdf| (a stable descending sort:
    ties go to the lower index, as ``jax.lax.top_k``), then the f³ fine
    points of those cells. Returns (coarse volume (B, C, C, C), cell
    indices (B, K) flat z·C² + y·C + x, fine values (B, K, f³)) on the
    device, for :func:`assemble_volume`."""
    b = latents.shape[0]
    if resolution % factor:
        raise ValueError(f"resolution {resolution} % factor {factor} != 0")
    c = resolution // factor
    k = refine_cells if refine_cells is not None else min(8 * c * c, c ** 3)
    dev = latents.device
    lin = _lin(bounds, resolution, dev)
    h = decoder.trunk(latents)

    lc = lin[torch.arange(c, device=dev) * factor]
    zz, yy, xx = torch.meshgrid(lc, lc, lc, indexing="ij")
    coarse = torch.stack([xx, yy, zz], -1).reshape(1, -1, 3).expand(
        b, c ** 3, 3)
    vol_c = _eval_point_chunks(decoder, h, coarse, chunk).reshape(b, c, c, c)

    cell_idx = top_cells(-vol_c.abs().reshape(b, -1), k)

    zc, yc, xc = cell_idx // (c * c), (cell_idx // c) % c, cell_idx % c
    ar = torch.arange(factor, device=dev)
    dz, dy, dx = (t.reshape(-1) for t in torch.meshgrid(ar, ar, ar,
                                                         indexing="ij"))
    zi = zc[..., None] * factor + dz                     # (B, K, f³)
    yi = yc[..., None] * factor + dy
    xi = xc[..., None] * factor + dx
    fine_pts = torch.stack([lin[xi], lin[yi], lin[zi]], -1).reshape(
        b, k * factor ** 3, 3)
    fine = _eval_point_chunks(decoder, h, fine_pts, chunk)
    return vol_c, cell_idx, fine.reshape(b, k, factor ** 3)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def assemble_volume(vol_c, cell_idx, fine_vals,
                    resolution: int) -> np.ndarray:
    """Host-side inverse of :func:`decode_grid_hierarchical` (tensors are
    copied to the host first): the coarse volume upsampled by repetition,
    the refined cells overwritten. Returns (B, R, R, R) f32."""
    vol_c = _host(vol_c).astype(np.float32, copy=False)
    cell_idx = _host(cell_idx)
    fine_vals = _host(fine_vals).astype(np.float32, copy=False)
    b, c = vol_c.shape[:2]
    f = resolution // c
    blocks = np.broadcast_to(
        vol_c[:, :, None, :, None, :, None],
        (b, c, f, c, f, c, f)).copy()
    zc = cell_idx // (c * c)
    yc = (cell_idx // c) % c
    xc = cell_idx % c
    fine = fine_vals.reshape(b, -1, f, f, f)
    for i in range(b):
        blocks[i, zc[i], :, yc[i], :, xc[i], :] = fine[i]
    return blocks.reshape(b, resolution, resolution, resolution)
