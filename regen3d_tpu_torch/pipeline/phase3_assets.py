"""Phase 3: per-object image → 3D asset (counterpart of
regen3d_tpu/pipeline/phase3_assets.py).

For every prepped object image (``output/findings/banana/prepped/*.png``):
the condition encoder turns the RGBA image into tokens, the flow-matching
shape DiT samples shape latents from them (50 Euler steps, guidance 5, the
conditional and null passes as one 2B batch), and the shape VAE's decoder
evaluates the SDF on a 256³ grid in two levels (a coarse 64³ pass, then the
cells nearest the surface in full); the volume is put together on the host,
meshed by marching tetrahedra, cleaned (the largest connected component),
coloured from the object image and written to ``output/3D/<name>/<name>.glb``.

All objects go through the generator together, in segments of at most 8.
The modules run eagerly under ``torch.no_grad()`` on ``device``; the noise
comes from an explicit ``torch.Generator``. The JAX package pads the batch
to buckets of 4 for its compile cache; the port pads only under
``cross_instance``, where the copies join the instance attention and so
change every instance's result. The
default generator is the committed ``checkpoints/shape_distilled.npz``
(``pipeline/shape_distill.py``), loaded on ``device``.

Two switches replace the vertex colours, as in the JAX package:
``use_multiview_texgen`` generates the view ring with the multiview
texture model (``pipeline/texgen.py``: random-init tiny SD UNet and VAE
from seed 0, ``texgen_resolution``, ``texgen_steps``, ``max_num_view``)
and bakes a texel atlas; under ``use_hunyuan21`` with
``enable_texture_hy21`` the PBR ring (``max_num_view_hy21`` views) gives
albedo and metallic-roughness atlases, the albedo upscaled by RealESRGAN
×4 when ``realesrgan_ckpt_path`` names a checkpoint.
``bake_texture_atlas`` bakes the object image from the frontal camera into
a texel atlas. Both write the GLB's ``uvs`` and ``texture_png`` (and
``mr_texture_png``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn

from regen3d_tpu_torch.artifacts import Artifacts
from regen3d_tpu_torch.camera import lookat_camera
from regen3d_tpu_torch.config import Config
from regen3d_tpu_torch.models.dit import DiTConfig, ShapeDiT
from regen3d_tpu_torch.models.dit import init_flax_style_ as init_dit_
from regen3d_tpu_torch.models.dit import sample as dit_sample
from regen3d_tpu_torch.models.layers import (
    LayerNorm,
    PatchEmbed,
    TransformerBlock,
    init_flax_layers_,
    posemb_sincos_2d,
    resize_bilinear,
)
from regen3d_tpu_torch.models.shapevae import (
    ShapeDecoder,
    ShapeVAEConfig,
    assemble_volume,
    decode_grid,
    decode_grid_hierarchical,
)
from regen3d_tpu_torch.ops.marching_cubes import marching_tetrahedra
from regen3d_tpu_torch.pipeline.texture import bake_vertex_colors
from regen3d_tpu_torch.utils.glb import MeshData, SceneData, save_glb
from regen3d_tpu_torch.utils.image import load_image_rgba
from regen3d_tpu_torch.utils.meshproc import (
    clean_mesh,
    decimate_vertex_clustering,
    fix_winding_outward,
)

log = logging.getLogger(__name__)

# the unit cube written where a volume has no level set
_PLACEHOLDER_VERTS = np.asarray(
    [[-.5, -.5, -.5], [.5, -.5, -.5], [.5, .5, -.5], [-.5, .5, -.5],
     [-.5, -.5, .5], [.5, -.5, .5], [.5, .5, .5], [-.5, .5, .5]], np.float32)
_PLACEHOLDER_FACES = np.asarray(
    [[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
     [2, 3, 7], [2, 7, 6], [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]],
    np.int32)


class CondEncoder(nn.Module):
    """Object image (B, H, W, 4) RGBA in [0, 1] → condition tokens
    (B, (H/p)·(W/p), width) f32: a patch embedding, a fixed 2D sin-cos
    position embedding, pre-norm transformer blocks in ``dtype`` and an f32
    LayerNorm (``out_norm``). Parameters are f32."""

    def __init__(self, width: int = 768, depth: int = 4, num_heads: int = 8,
                 patch: int = 16, dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        self.width, self.depth, self.patch_size = width, depth, patch
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device, param_dtype=torch.float32)
        self.patch = PatchEmbed(patch, width, in_ch=4, **kw)
        for i in range(depth):
            self.add_module(f"block{i}",
                            TransformerBlock(width, num_heads, **kw))
        self.out_norm = LayerNorm(width, dtype=torch.float32, device=device)

    def forward(self, img):
        x, (gh, gw) = self.patch(img.to(self.dtype))
        x = x + posemb_sincos_2d(gh, gw, self.width,
                                 device=x.device)[None].to(self.dtype)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        return self.out_norm(x)


def init_flax_style_(module: nn.Module, generator: torch.Generator) -> None:
    """Random init from ``generator`` as flax initialises a condition
    encoder or shape decoder: lecun-normal (truncated) Dense and Conv
    kernels, zero biases, LayerNorm ones and zeros."""
    init_flax_layers_(module, generator)


@dataclasses.dataclass
class AssetGenerator:
    """The image → 3D generator: condition encoder, shape DiT and SDF
    decoder, with the condition-image size its weights were made for and
    whether they are trained (a random-init generator caps the decode
    grid: there is nothing to resolve)."""

    dit_cfg: DiTConfig
    vae_cfg: ShapeVAEConfig
    cond: CondEncoder
    dit: ShapeDiT
    decoder: ShapeDecoder
    image_size: int = 512
    trained: bool = False

    @property
    def device(self) -> torch.device:
        return self.dit.latent_pos.device

    @classmethod
    def random_init(cls, generator: torch.Generator, tiny: bool = False,
                    image_size: int = 512, cross_instance: bool = False,
                    device="cuda") -> "AssetGenerator":
        """The JAX package's random-init generator, drawn from
        ``generator`` (on ``device``); ``cross_instance`` gives the DiT the
        MIDI instance-attention blocks. The tiny one's condition encoder
        has 4 heads of 8, which the flash forward's D = 8 instance takes."""
        dit_cfg = DiTConfig.tiny() if tiny else DiTConfig.base()
        if cross_instance:
            dit_cfg = dataclasses.replace(dit_cfg, cross_instance=True)
        vae_cfg = dataclasses.replace(
            ShapeVAEConfig.tiny() if tiny else ShapeVAEConfig(),
            latent_tokens=dit_cfg.latent_tokens,
            latent_dim=dit_cfg.latent_dim)
        cond = CondEncoder(width=dit_cfg.cond_dim, depth=2 if tiny else 4,
                           num_heads=4 if tiny else 8, device=device)
        dit = ShapeDiT(dit_cfg, device=device)
        decoder = ShapeDecoder(vae_cfg, device=device)
        init_flax_style_(cond, generator)
        init_dit_(dit, generator)
        init_flax_style_(decoder, generator)
        return cls(dit_cfg=dit_cfg, vae_cfg=vae_cfg, cond=cond, dit=dit,
                   decoder=decoder, image_size=64 if tiny else image_size,
                   trained=False)

    def generate_sdf(self, generator: torch.Generator, image, num_steps: int,
                     guidance: float, resolution: int,
                     chunk: int) -> np.ndarray:
        """image (H, W, 4) in [0, 1] → SDF volume (R, R, R)."""
        return self.generate_sdf_batch(generator, torch.as_tensor(image)[None],
                                       num_steps, guidance, resolution,
                                       chunk)[0]

    @torch.no_grad()
    def generate_sdf_batch(self, generator: torch.Generator, images,
                           num_steps: int, guidance: float, resolution: int,
                           chunk: int, extra_cond_tokens=None,
                           max_batch_per_program: int = 8) -> np.ndarray:
        """(B, H, W, 4) images → (B, R, R, R) SDF volumes on the host: the
        condition encoder, ``dit.sample`` (noise from ``generator``) and
        the grid decode, hierarchical where R is a multiple of 4 and at
        least 128, dense otherwise. ``extra_cond_tokens`` (B, T, cond_dim)
        are appended to the condition (the MIDI adapter's box tokens).
        Batches over ``max_batch_per_program`` objects go in segments,
        drawing their noise in turn from ``generator``. Under
        ``cross_instance`` a segment is padded as the JAX package pads it
        (copies of the last object up to a multiple of 4 past 2, with
        their own noise), since its instances attend to the copies."""
        b_total = images.shape[0]
        if b_total > max_batch_per_program:
            outs = []
            for s0 in range(0, b_total, max_batch_per_program):
                sl = slice(s0, min(s0 + max_batch_per_program, b_total))
                outs.append(self.generate_sdf_batch(
                    generator, images[sl], num_steps, guidance, resolution,
                    chunk, extra_cond_tokens=None if extra_cond_tokens is None
                    else extra_cond_tokens[sl],
                    max_batch_per_program=max_batch_per_program))
            return np.concatenate(outs)
        dev = self.device
        cond_tok = self.cond(torch.as_tensor(images, dtype=torch.float32,
                                             device=dev))
        if extra_cond_tokens is not None:
            extra = torch.as_tensor(extra_cond_tokens, device=dev)
            cond_tok = torch.cat([cond_tok, extra.to(cond_tok.dtype)], 1)
        if self.dit_cfg.cross_instance and b_total > 2:
            pad = 4 * ((b_total + 3) // 4) - b_total
            cond_tok = torch.cat([cond_tok, cond_tok[-1:].expand(
                pad, *cond_tok.shape[1:])])
        lat = dit_sample(self.dit, cond_tok, num_steps=num_steps,
                         guidance_scale=guidance, generator=generator)
        lat = lat[:b_total]   # the decoder sees each object alone
        if resolution % 4 == 0 and resolution >= 128:
            # the two-level decode ships ~4 MB an object to the host, not
            # the dense 256³ volume's 67 MB
            vol_c, cell_idx, fine = decode_grid_hierarchical(
                self.decoder, lat, resolution=resolution, chunk=chunk)
            return assemble_volume(vol_c, cell_idx, fine, resolution)
        vols = decode_grid(self.decoder, lat, resolution=resolution,
                           chunk=chunk)
        if vols.ndim == 3:
            vols = vols[None]
        return vols.cpu().numpy()


def extract_and_clean(vol: np.ndarray, target_faces: Optional[int] = None):
    """SDF volume → cleaned mesh: marching tetrahedra with the grid mapped
    to [−1, 1]³ (the decode grid spans ±1.01, so meshes come out 1/1.01 of
    the decoded surface, as in the JAX package: ROADMAP Queue 3 ad), the
    mesh cleaned, its largest connected component kept, decimated to
    ``target_faces`` if given, and wound outward."""
    verts, faces = marching_tetrahedra(vol, 0.0, bounds=(-1.0, 1.0))
    if len(faces) == 0:
        return verts, faces
    verts, faces = clean_mesh(verts, faces)
    faces = _largest_component(verts, faces)
    if target_faces and len(faces) > target_faces:
        verts, faces = decimate_vertex_clustering(verts, faces, target_faces)
    faces = fix_winding_outward(verts, faces)
    return verts, faces


def _largest_component(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """The faces of the largest connected component over shared vertices
    (scipy's ``connected_components`` on the face-edge graph)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    n = len(verts)
    rows = np.concatenate([faces[:, 0], faces[:, 1]])
    cols = np.concatenate([faces[:, 1], faces[:, 2]])
    adj = coo_matrix((np.ones(len(rows), np.int8), (rows, cols)),
                     shape=(n, n))
    _, labels = connected_components(adj, directed=False)
    roots = labels[faces[:, 0]]
    vals, counts = np.unique(roots, return_counts=True)
    return faces[roots == vals[np.argmax(counts)]]


def vertex_colors_from_image(verts: np.ndarray, faces: np.ndarray,
                             image: np.ndarray, device="cuda") -> np.ndarray:
    """Vertex colours baked from the object image seen by a frontal camera
    (2.2 extents in front of the mesh's centre, focal 1.1·H) on ``device``;
    vertices it does not see take the mean visible colour. Images over 256
    px are shrunk first (antialiased bilinear, as ``jax.image.resize``)."""
    rgb = image[..., :3].astype(np.float32)
    if rgb.max() > 1.001:
        rgb = rgb / 255.0
    if max(rgb.shape[:2]) > 256:
        scale = 256 / max(rgb.shape[:2])
        hw = (int(rgb.shape[0] * scale), int(rgb.shape[1] * scale))
        rgb = resize_bilinear(torch.as_tensor(rgb, device=device)[None],
                              hw)[0].cpu().numpy()
    center = verts.mean(0)
    extent = float(np.linalg.norm(verts.max(0) - verts.min(0))) + 1e-6
    cam = lookat_camera(center + np.asarray([0, 0, -2.2 * extent], np.float32),
                        center, rgb.shape[:2], focal_px=rgb.shape[0] * 1.1,
                        device=device)
    return bake_vertex_colors(verts, faces, [(cam, rgb)])


def default_shape_checkpoint() -> str:
    """The repository's ``checkpoints/shape_distilled.npz``."""
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "checkpoints", "shape_distilled.npz")


def load_default_generator(cfg: Config,
                           device="cuda") -> Optional[AssetGenerator]:
    """The ``shape_checkpoint`` config key's generator, else the
    repository's distilled checkpoint where it exists; None (with a warning
    for a configured path that is missing) when there is none."""
    path = str(cfg.get("shape_checkpoint", "") or "")
    if not path:
        cand = default_shape_checkpoint()
        path = cand if os.path.exists(cand) else ""
    if not path:
        return None
    if not os.path.exists(path):
        log.warning("phase3: shape_checkpoint %s not found", path)
        return None
    from regen3d_tpu_torch.pipeline.shape_distill import load_generator

    gen = load_generator(path, device=device)
    log.info("phase3: loaded distilled shape generator from %s "
             "(dit width %d, cond %d^2)", path, gen.dit_cfg.width,
             gen.image_size)
    return gen


def _texgen_mesh(cfg: Config, name, verts, faces, img, device) -> MeshData:
    """``use_multiview_texgen``: the JAX CLI's tiny texture model (random
    init from seed 0 for every object, noise from the config's seed), the
    RGB ring, or under ``use_hunyuan21`` with ``enable_texture_hy21`` the
    PBR ring with RealESRGAN ×4 from ``realesrgan_ckpt_path`` where that
    file exists. The reference image is the object image in [0, 1], which
    the texture path divides by 255 again, as the JAX package's does."""
    from regen3d_tpu_torch.models.sd_unet import SDUNetConfig
    from regen3d_tpu_torch.models.sd_vae import SDVAEConfig
    from regen3d_tpu_torch.pipeline import texgen as tg

    pbr = (bool(cfg.get("use_hunyuan21", False))
           and bool(cfg.get("enable_texture_hy21", True)))
    tcfg = tg.TexGenConfig(
        num_views=int(cfg.get("max_num_view_hy21", 6) if pbr
                      else cfg.get("max_num_view", 6)),
        resolution=int(cfg.get("texgen_resolution", 64)),
        steps=int(cfg.get("texgen_steps", 4)))
    ucfg = SDUNetConfig.tiny(in_channels=12, class_embeddings=(
        2 if pbr else 1) * tcfg.num_views)
    model, vae = tg.init_texgen(
        tcfg, torch.Generator(device=device).manual_seed(0), ucfg,
        SDVAEConfig.tiny(), device=device)
    noise = torch.Generator(device=device).manual_seed(
        int(cfg.get("seed", 1234567)))
    tpf = int(cfg.get("texels_per_face", 8))
    if not pbr:
        nv, nf, uvs, png = tg.texture_mesh(verts, faces, img[..., :3], tcfg,
                                           model, vae, tpf, noise)
        return MeshData(name=name, vertices=nv, faces=nf, uvs=uvs,
                        texture_png=png)
    esrgan = None
    ckpt = str(cfg.get("realesrgan_ckpt_path", "") or "")
    if ckpt and os.path.exists(ckpt):
        from regen3d_tpu_torch.models.esrgan import ESRGANConfig, RRDBNet
        from regen3d_tpu_torch.models.weights import load_model

        esrgan = load_model(RRDBNet(ESRGANConfig.x4plus(), device=device),
                            ckpt)
    nv, nf, uvs, png, mr_png = tg.texture_mesh_pbr(
        verts, faces, img[..., :3], tcfg, model, vae, tpf, noise, esrgan)
    return MeshData(name=name, vertices=nv, faces=nf, uvs=uvs,
                    texture_png=png, mr_texture_png=mr_png, metallic=1.0,
                    roughness=1.0)


def _textured_mesh(cfg: Config, name, verts, faces, img, device) -> MeshData:
    """The object's GLB mesh: the multiview texture path, the texel atlas
    of the object image from the frontal camera (``bake_texture_atlas``),
    or vertex colours."""
    if bool(cfg.get("use_multiview_texgen", False)):
        return _texgen_mesh(cfg, name, verts, faces, img, device)
    if bool(cfg.get("bake_texture_atlas", False)):
        from regen3d_tpu_torch.pipeline.texture import bake_texture_atlas

        rgb = img[..., :3]
        center = verts.mean(0)
        ext = float(np.linalg.norm(verts.max(0) - verts.min(0))) + 1e-6
        cam = lookat_camera(center + np.asarray([0, 0, -2.2 * ext],
                                                np.float32),
                            center, rgb.shape[:2],
                            focal_px=rgb.shape[0] * 1.1, device=device)
        nv, nf, uvs, png = bake_texture_atlas(
            verts, faces, [(cam, rgb)],
            texels_per_face=int(cfg.get("texels_per_face", 8)))
        return MeshData(name=name, vertices=nv, faces=nf, uvs=uvs,
                        texture_png=png)
    return MeshData(name=name, vertices=verts, faces=faces,
                    vertex_colors=vertex_colors_from_image(verts, faces, img,
                                                           device=device))


def run(cfg: Config, generator: Optional[AssetGenerator] = None,
        rng: Optional[torch.Generator] = None, device="cuda") -> List[str]:
    """Phase 3 on ``device``: one GLB per prepped object image; returns the
    names written. ``rng`` (on ``device``) defaults to the config's seed;
    ``generator`` to :func:`load_default_generator`'s, else a random-init
    tiny one."""
    art = Artifacts(cfg)
    src_dir = art.prepped_dir if os.path.isdir(art.prepped_dir) else \
        cfg.path("input_folder_hy")
    names = [os.path.splitext(f)[0] for f in sorted(os.listdir(src_dir))
             if f.lower().endswith(".png")] if os.path.isdir(src_dir) else []
    if not names:
        log.warning("phase3: no prepped object images in %s", src_dir)
        return []

    if generator is None:
        generator = load_default_generator(cfg, device=device)
    if rng is None:
        rng = torch.Generator(device=device).manual_seed(
            int(cfg.get("seed", 1234567)))
    if generator is None:
        log.warning("phase3: no checkpoint — random-init generator "
                    "(geometry will be uninformative until weights load)")
        generator = AssetGenerator.random_init(rng, tiny=True, device=device)

    if bool(cfg.get("use_hunyuan21", False)):
        # the Hunyuan3D-2.1 variant's sampling budget, same generator
        num_steps = int(cfg.get("steps_hy21", 30))
        guidance = float(cfg.get("guidance_scale_hy21", 5.0))
        resolution = int(cfg.get("octree_resolution_hy21", 256))
        chunk = int(cfg.get("num_chunks_hy21", 8000))
    else:
        num_steps = int(cfg.get("num_inf_steps_hy", 50))
        guidance = float(cfg.get("guidance_scale", 5.0))
        resolution = int(cfg.get("octree_resolution_hy", 256))
        chunk = int(cfg.get("num_chunks_hy", 16000))
    # queries per decode chunk: the power of two at or below half of it
    chunk = max(1024, 1 << (chunk - 1).bit_length() >> 1)
    target_faces = (int(cfg.get("remesh_target_num_faces", 50000))
                    if bool(cfg.get("remesh", False)) else None)
    size = generator.image_size
    res = resolution if generator.trained else \
        (min(resolution, 128) if generator.dit_cfg.width < 512 else resolution)

    raw_imgs, imgs_r = [], []
    for name in names:
        img = load_image_rgba(os.path.join(src_dir, f"{name}.png")).astype(
            np.float32) / 255.0
        raw_imgs.append(img)
        imgs_r.append(resize_bilinear(torch.as_tensor(img, device=device)[None],
                                      (size, size))[0])
    t0 = time.perf_counter()
    vols = generator.generate_sdf_batch(rng, torch.stack(imgs_r), num_steps,
                                        guidance, res, chunk)
    t_gen = time.perf_counter() - t0

    t_mesh = t_tex = 0.0
    done = []
    for name, img, vol in zip(names, raw_imgs, vols):
        t0 = time.perf_counter()
        verts, faces = extract_and_clean(vol, target_faces)
        t_mesh += time.perf_counter() - t0
        if len(faces) == 0:
            log.warning("phase3: %s produced an empty level set", name)
            verts, faces = _PLACEHOLDER_VERTS, _PLACEHOLDER_FACES
        out_path = art.asset_glb(name)
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        t0 = time.perf_counter()
        save_glb(out_path, SceneData(meshes=[_textured_mesh(
            cfg, name, verts, faces, img, device)]))
        t_tex += time.perf_counter() - t0
        done.append(name)
        log.info("phase3: %s → %d verts / %d faces", name, len(verts),
                 len(faces))
    log.info("phase3: stage breakdown — generate(batch) %.1fs, "
             "mesh-extract+clean %.1fs, texture+glb %.1fs (%d objects)",
             t_gen, t_mesh, t_tex, len(names))
    return done
