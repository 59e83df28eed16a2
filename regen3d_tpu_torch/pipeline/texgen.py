"""Multiview texture generation: camera-conditioned diffusion → a baked
texel atlas (counterpart of regen3d_tpu/pipeline/texgen.py).

* :class:`MultiviewTexGen`: the diffusers-layout SD UNet
  (``models/sd_unet.py``, ``SDUNetConfig.multiview``) with the view index
  as class embedding; each view's input is [noisy latent ‖ reference
  latent ‖ the VAE latent of the mesh's normal map from that view's
  camera], and the cross-attention sees the patchified reference latent
  (through ``cond_proj``) plus one camera token (``cam_proj``): lh² + 1
  keys, 4,097 at 512².
* :func:`ddim_sample`: DDIM (eta 0) with all views in one batch, the JAX
  package's schedule quirks kept: betas ``linspace(8.5e-4, 1.2e-2,
  1000)``, ``alphas_bar`` read at the float timestep truncated to an
  integer, and the last step's ``t_prev = 0`` reading ``alphas_bar[0]``
  (not 1). The first noise comes from a ``torch.Generator`` or is given
  (``x0``): ``jax.random.normal`` cannot be repeated in torch.
* :func:`generate_views` / :func:`generate_views_pbr`: the reference image
  and the geometry renders through the VAE, the DDIM loop, the decode; the
  PBR ring denoises albedo and metallic-roughness views as one 2V batch
  (class ids V·material + view).
* :func:`texture_mesh` / :func:`texture_mesh_pbr`: the orbit ring, the
  geometry renders (:func:`render_geometry_maps`), generation, white
  outside the mesh's silhouette, and ``pipeline/texture.bake_texture_atlas``
  (twice for PBR, on one layout), with RealESRGAN ×4 on the albedo atlas
  when a net is given.

The modules run eagerly under ``torch.no_grad()`` on their own device; the
attentions take the flash forward (``SDUNetConfig.multiview``'s heads of
64 and the VAE's single head of 512 at full width, the tiny configs'
heads of 4 and 16).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from regen3d_tpu_torch.models.esrgan import RRDBNet, upscale_x4
from regen3d_tpu_torch.models.layers import Dense, resize_bilinear
from regen3d_tpu_torch.models.sd_unet import (
    SDUNet,
    SDUNetConfig,
    init_flax_style_,
)
from regen3d_tpu_torch.models.sd_vae import SDAutoencoderKL, SDVAEConfig
from regen3d_tpu_torch.ops.rasterize import rasterize_hard_auto
from regen3d_tpu_torch.pipeline.texture import bake_texture_atlas, orbit_views
from regen3d_tpu_torch.utils.image import decode_png, encode_png

CAM_FEATS = 13                 # rotation (9), translation (3), focal (1)
NUM_TRAIN_STEPS = 1000


@dataclasses.dataclass(frozen=True)
class TexGenConfig:
    num_views: int = 6
    resolution: int = 512
    steps: int = 15
    guidance: float = 3.0      # unused by the sampler, as in the JAX package
    latent_down: int = 8

    @classmethod
    def tiny(cls) -> "TexGenConfig":
        return cls(num_views=3, resolution=32, steps=2, guidance=1.0)


class MultiviewTexGen(nn.Module):
    """The UNet and the conditioning projections (f32); ``forward`` is one
    denoising step for all views (B = V)."""

    def __init__(self, unet_cfg: SDUNetConfig, latent_channels: int = 4,
                 device="cuda"):
        super().__init__()
        self.unet_cfg = unet_cfg
        self.cond_proj = Dense(latent_channels, unet_cfg.cross_attn_dim,
                               device=device)
        self.cam_proj = Dense(CAM_FEATS, unet_cfg.cross_attn_dim,
                              device=device)
        self.unet = SDUNet(unet_cfg, device=device)

    @property
    def device(self) -> torch.device:
        return self.cam_proj.weight.device

    def forward(self, latents, t, ref_latent, view_ids, geom_latent,
                cam_feats):
        """latents (V, h, w, C); t a float; ref_latent (h, w, C); view_ids
        (V,) int; geom_latent (V, h, w, C); cam_feats (V, 13) → the noise
        prediction (V, h, w, C) f32."""
        v = latents.shape[0]
        ref = ref_latent[None].expand(v, *ref_latent.shape)
        x = torch.cat([latents, ref, geom_latent], -1)
        toks = self.cond_proj(ref_latent.reshape(1, -1, ref_latent.shape[-1]))
        toks = toks.expand(v, *toks.shape[1:])
        cam_tok = self.cam_proj(cam_feats)[:, None, :]
        toks = torch.cat([toks, cam_tok], 1)
        tt = torch.full((v,), float(t), dtype=torch.float32,
                        device=latents.device)
        return self.unet(x, tt, toks, view_ids)


@torch.no_grad()
def render_geometry_maps(verts: np.ndarray, faces: np.ndarray,
                         cams: Sequence, resolution: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-view geometry renders on the cameras' device: camera-space
    normal maps (V, R, R, 3) in [0, 1] over a 0.5 background, and coverage
    masks (V, R, R) f32."""
    dev = cams[0].R.device
    v = torch.as_tensor(np.asarray(verts), dtype=torch.float32, device=dev)
    f = torch.as_tensor(np.asarray(faces), dtype=torch.int64, device=dev)
    tri = v[f]
    fn = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    fn = fn / torch.clamp_min(torch.linalg.norm(fn, dim=-1, keepdim=True),
                              1e-9)
    normals, masks = [], []
    for cam in cams:
        vs = cam.view_to_screen(cam.world_to_view(v))
        fid = rasterize_hard_auto(vs[None], f[None],
                                  (resolution, resolution)).face_idx[0]
        mask = fid >= 0
        n_cam = fn @ cam.R                    # world → view (row convention)
        nmap = torch.where(mask[..., None],
                           n_cam[torch.clamp_min(fid, 0).long()] * 0.5 + 0.5,
                           torch.full_like(n_cam[:1], 0.5))
        normals.append(nmap.cpu().numpy())
        masks.append(mask.float().cpu().numpy())
    return np.stack(normals), np.stack(masks)


def camera_feats(cams: Sequence) -> np.ndarray:
    """(V, 13) per-view camera conditioning: R (9), T / (|T| + 1) (3) and
    focal over image height (1), f32."""
    feats = []
    for cam in cams:
        R = cam.R.detach().cpu().numpy().astype(np.float32).reshape(-1)
        T = cam.T.detach().cpu().numpy().astype(np.float32)
        T = T / (np.linalg.norm(T) + 1.0)
        fscale = float(cam.focal[0]) / float(cam.image_size[0])
        feats.append(np.concatenate([R, T, [fscale]]))
    return np.stack(feats).astype(np.float32)


def ddim_schedule(steps: int, num_train_steps: int = NUM_TRAIN_STEPS
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(timesteps (steps,) f32 from num_train_steps − 1 down to 0, alphas_bar
    (num_train_steps,) f32)."""
    ts = np.linspace(num_train_steps - 1, 0, steps).astype(np.float32)
    betas = np.linspace(8.5e-4, 1.2e-2, num_train_steps).astype(np.float32)
    return ts, np.cumprod(1.0 - betas, dtype=np.float32)


@torch.no_grad()
def ddim_sample(model: MultiviewTexGen, ref_latent: torch.Tensor,
                shape: Tuple[int, ...], steps: int,
                geom_latent: torch.Tensor, cam_feats: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                x0: Optional[torch.Tensor] = None,
                num_train_steps: int = NUM_TRAIN_STEPS) -> torch.Tensor:
    """DDIM (eta 0) over ``steps`` from ``x0`` (else N(0, 1) noise of
    ``shape`` drawn from ``generator``), all views in one batch; the view
    ids are 0..V−1."""
    dev = model.device
    x = (x0.to(device=dev, dtype=torch.float32) if x0 is not None
         else torch.randn(tuple(shape), generator=generator, device=dev))
    view_ids = torch.arange(shape[0], device=dev)
    ts, alphas_bar = ddim_schedule(steps, num_train_steps)

    def a_bar(t):
        return torch.tensor(
            alphas_bar[min(max(int(t), 0), num_train_steps - 1)], device=dev)

    for i in range(steps):
        t = float(ts[i])
        t_prev = float(ts[i + 1]) if i + 1 < steps else 0.0
        eps = model(x, t, ref_latent, view_ids, geom_latent, cam_feats)
        ab, ab_prev = a_bar(t), a_bar(t_prev)
        x0_pred = (x - torch.sqrt(1 - ab) * eps) / torch.sqrt(ab)
        x = torch.sqrt(ab_prev) * x0_pred + torch.sqrt(1 - ab_prev) * eps
    return x


def vae_down(vae_cfg: SDVAEConfig) -> int:
    return 2 ** (len(vae_cfg.block_channels) - 1)


def vae_encode(vae: SDAutoencoderKL, x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) in [−1, 1] → the scaled latent mean (B, h, w, C)."""
    return vae.encode(x)[0] * vae.cfg.scaling_factor


def vae_decode(vae: SDAutoencoderKL, z: torch.Tensor) -> torch.Tensor:
    return vae.decode(z / vae.cfg.scaling_factor)


def _encode_geometry(vae, geom_maps, n_views, lh, dev):
    """Geometry normal maps (V, R, R, 3) → per-view latents (V, h, w, C);
    zeros (the unconditioned null) without renders."""
    c = vae.cfg
    if geom_maps is None:
        return torch.zeros((n_views, lh, lh, c.latent_channels), device=dev)
    g = torch.as_tensor(np.asarray(geom_maps), dtype=torch.float32,
                        device=dev) * 2.0 - 1.0
    side = lh * vae_down(c)
    if g.shape[1] != side:
        g = resize_bilinear(g, (side, side))
    return vae_encode(vae, g)


def _reference_latent(vae, ref_image, r, dev):
    """The reference image as the JAX package takes it (÷ 255, to
    [−1, 1], bilinear to r², antialiased where it shrinks) → its latent."""
    img = torch.as_tensor(np.asarray(ref_image), dtype=torch.float32,
                          device=dev) / 255.0 * 2.0 - 1.0
    img = resize_bilinear(img[None], (r, r))
    return vae_encode(vae, img)[0]


def _cams(cam_feats_arr, n, dev):
    if cam_feats_arr is None:
        return torch.zeros((n, CAM_FEATS), device=dev)
    return torch.as_tensor(np.asarray(cam_feats_arr), dtype=torch.float32,
                           device=dev)


def _decoded_views(vae, latents, r):
    out = torch.clamp(vae_decode(vae, latents) * 0.5 + 0.5, 0.0, 1.0)
    return resize_bilinear(out, (r, r)).cpu().numpy()


@torch.no_grad()
def generate_views(model: MultiviewTexGen, vae: SDAutoencoderKL,
                   cfg: TexGenConfig, ref_image: np.ndarray,
                   generator: Optional[torch.Generator] = None,
                   geom_maps: Optional[np.ndarray] = None,
                   cam_feats_arr: Optional[np.ndarray] = None,
                   x0: Optional[torch.Tensor] = None) -> np.ndarray:
    """Reference image (H, W, 3) (0-255 values) [+ per-view geometry
    renders and camera features] → (V, R, R, 3) views in [0, 1]."""
    dev = model.device
    r, v = cfg.resolution, cfg.num_views
    ref_latent = _reference_latent(vae, ref_image, r, dev)
    lh = ref_latent.shape[0]          # the VAE's own downsampling
    geom_latent = _encode_geometry(vae, geom_maps, v, lh, dev)
    latents = ddim_sample(model, ref_latent,
                          (v, lh, lh, vae.cfg.latent_channels), cfg.steps,
                          geom_latent, _cams(cam_feats_arr, v, dev),
                          generator=generator, x0=x0)
    return _decoded_views(vae, latents, r)


@torch.no_grad()
def generate_views_pbr(model: MultiviewTexGen, vae: SDAutoencoderKL,
                       cfg: TexGenConfig, ref_image: np.ndarray,
                       generator: Optional[torch.Generator] = None,
                       geom_maps: Optional[np.ndarray] = None,
                       cam_feats_arr: Optional[np.ndarray] = None,
                       x0: Optional[torch.Tensor] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """The PBR ring: albedo and metallic-roughness views denoised jointly
    as one 2V batch (class ids 0..V−1 albedo, V..2V−1 MR), sharing the
    geometry and camera conditioning. Returns (albedo (V, R, R, 3), mr (V,
    R, R, 3)) in [0, 1]; mr packs glTF's G = roughness, B = metallic."""
    dev = model.device
    r, v = cfg.resolution, cfg.num_views
    ref_latent = _reference_latent(vae, ref_image, r, dev)
    lh = ref_latent.shape[0]
    geom_one = _encode_geometry(vae, geom_maps, v, lh, dev)
    cams_one = _cams(cam_feats_arr, v, dev)
    latents = ddim_sample(model, ref_latent,
                          (2 * v, lh, lh, vae.cfg.latent_channels),
                          cfg.steps, torch.cat([geom_one, geom_one]),
                          torch.cat([cams_one, cams_one]),
                          generator=generator, x0=x0)
    out = _decoded_views(vae, latents, r)
    return out[:v], out[v:]


def _ring(verts, cfg, dev):
    """The orbit ring (2.2 × the largest offset from the centroid) and its
    geometry renders and camera features."""
    center = verts.mean(0)
    radius = 2.2 * float(np.abs(verts - center).max())
    ring = orbit_views(center, radius, np.zeros(
        (cfg.resolution, cfg.resolution, 3), np.float32),
        n_views=cfg.num_views, device=dev)
    cams = [cam for cam, _ in ring]
    return cams, camera_feats(cams)


def _on_white(views, masks):
    """White outside the mesh's silhouette (the reference's white-background
    views), so baked texels stay on the mesh."""
    m = masks[..., None]
    return views * m + (1.0 - m)


def texture_mesh(verts: np.ndarray, faces: np.ndarray,
                 ref_image: np.ndarray, cfg: TexGenConfig,
                 model: MultiviewTexGen, vae: SDAutoencoderKL,
                 texels_per_face: int = 8,
                 generator: Optional[torch.Generator] = None,
                 x0: Optional[torch.Tensor] = None):
    """Generate the view ring and bake a texel atlas on ``model``'s device.
    Returns (new_verts, new_faces, uvs, texture PNG bytes), as
    ``bake_texture_atlas``."""
    cams, feats = _ring(verts, cfg, model.device)
    geom, masks = render_geometry_maps(verts, faces, cams, cfg.resolution)
    views = generate_views(model, vae, cfg, ref_image, generator,
                           geom_maps=geom, cam_feats_arr=feats, x0=x0)
    views = _on_white(views, masks)
    return bake_texture_atlas(verts, faces,
                              [(cam, views[i]) for i, cam in enumerate(cams)],
                              texels_per_face=texels_per_face)


def texture_mesh_pbr(verts: np.ndarray, faces: np.ndarray,
                     ref_image: np.ndarray, cfg: TexGenConfig,
                     model: MultiviewTexGen, vae: SDAutoencoderKL,
                     texels_per_face: int = 8,
                     generator: Optional[torch.Generator] = None,
                     esrgan: Optional[RRDBNet] = None,
                     x0: Optional[torch.Tensor] = None):
    """The PBR texgen: albedo and MR rings, both atlases baked on the same
    layout, the albedo atlas upscaled ×4 by ``esrgan`` when given (its
    values truncated to 8 bits, as the JAX package writes them). Returns
    (new_verts, new_faces, uvs, albedo PNG, MR PNG)."""
    cams, feats = _ring(verts, cfg, model.device)
    geom, masks = render_geometry_maps(verts, faces, cams, cfg.resolution)
    albedo, mr = generate_views_pbr(model, vae, cfg, ref_image, generator,
                                    geom_maps=geom, cam_feats_arr=feats,
                                    x0=x0)
    albedo, mr = _on_white(albedo, masks), _on_white(mr, masks)
    nv, nf, uvs, albedo_png = bake_texture_atlas(
        verts, faces, [(cam, albedo[i]) for i, cam in enumerate(cams)],
        texels_per_face=texels_per_face)
    # the same geometry gives the same layout and UVs
    _, _, _, mr_png = bake_texture_atlas(
        verts, faces, [(cam, mr[i]) for i, cam in enumerate(cams)],
        texels_per_face=texels_per_face)
    if esrgan is not None:
        atlas = decode_png(albedo_png)[0][..., :3].astype(np.float32) / 255.0
        up = upscale_x4(esrgan, atlas)
        albedo_png = encode_png((up * 255).astype(np.uint8))
    return nv, nf, uvs, albedo_png, mr_png


def init_texgen(cfg: TexGenConfig, generator: torch.Generator,
                unet_cfg: Optional[SDUNetConfig] = None,
                vae_cfg: Optional[SDVAEConfig] = None,
                device="cuda") -> Tuple[MultiviewTexGen, SDAutoencoderKL]:
    """Random-init texgen model and VAE on ``device``, drawn from
    ``generator`` (flax's default init): ``SDUNetConfig.multiview(V)`` and
    ``SDVAEConfig()`` unless given."""
    unet_cfg = unet_cfg or SDUNetConfig.multiview(cfg.num_views)
    vae_cfg = vae_cfg or SDVAEConfig()
    model = MultiviewTexGen(unet_cfg, vae_cfg.latent_channels, device=device)
    vae = SDAutoencoderKL(vae_cfg, device=device)
    init_flax_style_(model, generator)
    init_flax_style_(vae, generator)
    return model.eval(), vae.eval()
