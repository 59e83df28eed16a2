"""Phase 8: scene rendering (counterpart of
regen3d_tpu/pipeline/phase8_render.py).

The reference renders with headless Blender Cycles (blender_rendering/
run.py:604-979). Where a ``blender`` executable is on PATH (and
``force_software_render`` is off) it is driven the same way; otherwise a
software renderer on ``device`` writes the same artifact set:

    rendering/render_cam1.png, render_cam1_white_bg.png, render_cam2.png

The software path: the hard z-buffer (``rasterize_hard_auto``: the binned
z-buffer where the JAX package's rule takes it, else every pixel against
every face) → per-pixel UVs and a bilinear fetch from a texture atlas of
Pillow-BICUBIC tiles → GGX metallic-roughness shading (the global
metallic/roughness and ``*_strength`` keys) → an equirect HDRI background
along the camera rays (``hdri_rotation``, ``hdri_strength``,
``hdri_white_bg``) → the Filmic-style tone map → white-background
composites; then the optional point-splat and GT renders and the scene
dump temp/blender_scene.npz. GLB, PLY, PNG and HDR IO are on the host.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import shutil
import subprocess
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from regen3d_tpu_torch.artifacts import Artifacts
from regen3d_tpu_torch.camera import Camera, camera_from_npz, lookat_camera
from regen3d_tpu_torch.config import Config
from regen3d_tpu_torch.ops import clip, full_f32
from regen3d_tpu_torch.ops.rasterize import (
    interpolate_attributes,
    rasterize_hard_auto,
    render_points_soft,
)
from regen3d_tpu_torch.utils.glb import MeshData, load_glb
from regen3d_tpu_torch.utils.image import (
    _to_rgb,
    decode_png,
    load_hdr,
    resize_pil,
    save_image,
)
from regen3d_tpu_torch.utils.meshproc import vertex_normals
from regen3d_tpu_torch.utils.ply import load_ply

log = logging.getLogger(__name__)


class PackedScene:
    """Flattened multi-GLB scene with a stacked texture atlas (host arrays).

    Each textured mesh's texture is resized to a common tile and stacked
    vertically; its UVs are remapped into the atlas (v' = (v + row)/n).
    Untextured meshes carry base or vertex colours with tex_weight 0."""

    def __init__(self, verts, faces, normals, colors, uvs, tex_weight,
                 metallic, roughness, atlas):
        self.verts = verts
        self.faces = faces
        self.normals = normals
        self.colors = colors          # (V, 3) fallback colours
        self.uvs = uvs                # (V, 2) atlas UVs
        self.tex_weight = tex_weight  # (V, 1) 1 = sample the atlas
        self.metallic = metallic      # (V, 1)
        self.roughness = roughness    # (V, 1)
        self.atlas = atlas            # (N·T, T, 3) float or None


def _load_scene_for_render(paths: List[str], cfg: Optional[Config] = None,
                           tile: int = 256) -> Optional[PackedScene]:
    """Every mesh of the GLBs that exist, packed into one scene (None when
    there is none): textures decoded (PNG only) and resized to ``tile``² by
    Pillow's BICUBIC, UVs clipped to [0, 1] (not wrapped: u or v = 1 is a
    legitimate edge coordinate), each mesh's metallic and roughness scaled
    by ``metallic_strength`` and ``roughness_strength``, the roughness
    clipped to [0.03, 1]."""
    meshes: List[MeshData] = []
    for p in paths:
        if os.path.exists(p):
            meshes += load_glb(p).meshes
    if not meshes:
        return None
    g_metal = float(cfg.get("metallic", 0.2)) if cfg else 0.2
    g_rough = float(cfg.get("roughness", 0.5)) if cfg else 0.5
    m_strength = float(cfg.get("metallic_strength", 1.0)) if cfg else 1.0
    r_strength = float(cfg.get("roughness_strength", 1.0)) if cfg else 1.0

    textured = [m for m in meshes if m.texture_png is not None
                and m.uvs is not None]
    tiles = []
    tile_of = {}
    for m in textured:
        rgb = _to_rgb(*decode_png(m.texture_png, f"{m.name} texture"))
        tex = np.asarray(resize_pil(rgb, (tile, tile), "bicubic"), np.float32) / 255.0
        tile_of[id(m)] = len(tiles)
        tiles.append(tex)
    atlas = np.concatenate(tiles, axis=0) if tiles else None
    n_tiles = max(len(tiles), 1)

    verts, faces, colors, uvs, tw, met, rgh = [], [], [], [], [], [], []
    off = 0
    for m in meshes:
        v = m.vertices
        f = m.faces + off
        base = m.base_color[:3] if m.base_color is not None else np.asarray(
            [0.7, 0.7, 0.7])
        col = (m.vertex_colors[:, :3] if m.vertex_colors is not None
               else np.tile(base[None].astype(np.float32), (len(v), 1)))
        if id(m) in tile_of:
            row = tile_of[id(m)]
            uu = np.clip(m.uvs[:, 0], 0.0, 1.0)
            vv = np.clip(m.uvs[:, 1], 0.0, 1.0)
            uv = np.stack([uu, (vv + row) / n_tiles], -1)
            w_ = np.ones((len(v), 1), np.float32)
        else:
            uv = np.zeros((len(v), 2), np.float32)
            w_ = np.zeros((len(v), 1), np.float32)
        mm = getattr(m, "metallic", g_metal)
        rr = getattr(m, "roughness", g_rough)
        met.append(np.full((len(v), 1), float(mm) * m_strength, np.float32))
        rgh.append(np.full((len(v), 1),
                           np.clip(float(rr) * r_strength, 0.03, 1.0),
                           np.float32))
        verts.append(v)
        faces.append(f)
        colors.append(col.astype(np.float32))
        uvs.append(uv.astype(np.float32))
        tw.append(w_)
        off += len(v)
    allv = np.concatenate(verts)
    allf = np.concatenate(faces).astype(np.int32)
    alln = vertex_normals(allv, allf)
    return PackedScene(allv, allf, alln, np.concatenate(colors),
                       np.concatenate(uvs), np.concatenate(tw),
                       np.concatenate(met), np.concatenate(rgh), atlas)


def tone_map(img: np.ndarray, exposure: float = 0.4, gamma: float = 0.8,
             view_transform: str = "Filmic",
             look: str = "Low Contrast") -> np.ndarray:
    """Colour management (reference: set_color_management,
    blender_rendering/run.py:376-384): exposure, the Filmic curve (a
    Hejl/Burgess-style filmic approximation; "Standard" passes linear
    through), the look's contrast S-curve around mid-grey, then gamma.
    HDR input ≥ 0, output in [0, 1]."""
    x = np.maximum(img, 0.0) * (2.0 ** exposure)
    if view_transform.lower() == "filmic":
        x = np.maximum(x - 0.004, 0.0)
        x = (x * (6.2 * x + 0.5)) / (x * (6.2 * x + 1.7) + 0.06)
    contrast = {"very low contrast": 0.7, "low contrast": 0.85,
                "medium contrast": 1.0, "none": 1.0,
                "high contrast": 1.25,
                "very high contrast": 1.5}.get(look.lower(), 1.0)
    if contrast != 1.0:
        x = np.clip(x, 0.0, 1.0)
        x = 0.5 + np.tanh((x - 0.5) * 2 * contrast) / max(
            2 * np.tanh(contrast), 1e-6)
    out = np.clip(x, 0.0, 1.0) ** (1.0 / max(gamma, 1e-3))
    return np.clip(out, 0.0, 1.0)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.norm(x, dim=-1, keepdim=True),
                               1e-8)


def _bilinear_sample(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear fetch of tex (TH, TW, 3) at uv (..., 2) in [0, 1]."""
    th, tw = tex.shape[:2]
    x = clip(uv[..., 0] * tw - 0.5, 0.0, tw - 1.0)
    y = clip(uv[..., 1] * th - 0.5, 0.0, th - 1.0)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp_max(x0 + 1, tw - 1)
    y1 = torch.clamp_max(y0 + 1, th - 1)
    fx = (x - x0.to(x.dtype))[..., None]
    fy = (y - y0.to(y.dtype))[..., None]
    return ((tex[y0, x0] * (1 - fx) + tex[y0, x1] * fx) * (1 - fy)
            + (tex[y1, x0] * (1 - fx) + tex[y1, x1] * fx) * fy)


def _sample_equirect(env: torch.Tensor, d: torch.Tensor,
                     rotation_deg: torch.Tensor) -> torch.Tensor:
    """Equirect HDRI lookup along directions d (..., 3), the mapping turned
    about the vertical as Blender's mapping node turns it (setup_hdri,
    run.py:46); u wraps as Python's ``% 1.0`` does (``torch.remainder``)."""
    rot = torch.deg2rad(rotation_deg)
    x = d[..., 0] * torch.cos(rot) - d[..., 2] * torch.sin(rot)
    z = d[..., 0] * torch.sin(rot) + d[..., 2] * torch.cos(rot)
    y = d[..., 1]
    u = torch.remainder(torch.atan2(x, -z) / (2 * math.pi), 1.0)
    v = clip(0.5 - torch.arcsin(clip(y, -1, 1)) / math.pi, 0.0, 1.0)
    return _bilinear_sample(env, torch.stack([u, v], -1))


def _ggx_shade(base, metallic, roughness, n, v, l, light_col, ambient_col):
    """One light's GGX metallic-roughness BRDF plus ambient irradiance (the
    Principled BSDF's role for the reference's metallic/roughness keys)."""
    h = _unit(l + v)
    ndl = clip((n * l).sum(-1, keepdim=True), 0.0, 1.0)
    ndv = clip((n * v).sum(-1, keepdim=True), 1e-4, 1.0)
    ndh = clip((n * h).sum(-1, keepdim=True), 0.0, 1.0)
    vdh = clip((v * h).sum(-1, keepdim=True), 0.0, 1.0)
    a = torch.clamp_min(roughness, 0.03)
    a = a * a
    a2 = a * a
    q = ndh * ndh * (a2 - 1) + 1
    D = a2 / torch.clamp_min(math.pi * (q * q), 1e-8)
    k = (roughness + 1) * (roughness + 1) / 8.0
    G = (ndl / torch.clamp_min(ndl * (1 - k) + k, 1e-8)) * \
        (ndv / torch.clamp_min(ndv * (1 - k) + k, 1e-8))
    f0 = 0.04 * (1 - metallic) + base * metallic
    t = 1 - vdh
    t2 = t * t
    F = f0 + (1 - f0) * (t2 * t2 * t)
    spec = D * G * F / torch.clamp_min(4 * ndl * ndv, 1e-8)
    diffuse = base * (1 - metallic) / math.pi
    direct = (diffuse + spec) * light_col * ndl * math.pi
    ambient = (diffuse * math.pi + f0 * 0.5) * ambient_col
    return direct + ambient


def _shade_pixels(frag, scene_t, atlas, env_map, ambient_col, hdri_strength,
                  hdri_rotation, cam: Camera, white_bg: bool):
    """The shaded linear image (H, W, 3) and the hit mask (H, W) of one
    view's fragments: texel-space colour, GGX under a light 2 m above the
    eye, the HDRI (or white) behind."""
    verts, faces, normals, colors, uvs, tw, met, rgh = scene_t
    pos = interpolate_attributes(frag, faces, verts)[0]
    nrm = interpolate_attributes(frag, faces, normals)[0]
    col = interpolate_attributes(frag, faces, colors)[0]
    uv = interpolate_attributes(frag, faces, uvs)[0]
    w_tex = interpolate_attributes(frag, faces, tw)[0]
    metallic = interpolate_attributes(frag, faces, met)[0]
    roughness = interpolate_attributes(frag, faces, rgh)[0]

    tex_col = _bilinear_sample(atlas, uv)
    base = col * (1 - w_tex) + tex_col * w_tex

    n = _unit(nrm)
    eye = cam.center
    vdir = _unit(eye - pos)
    n = n * torch.sign((n * vdir).sum(-1, keepdim=True) + 1e-12)
    up = torch.tensor([0.0, 2.0, 0.0], device=pos.device)
    ldir = _unit((eye + up) - pos)
    light = torch.tensor([0.9, 0.9, 0.9], device=pos.device)
    shaded = _ggx_shade(base, metallic, roughness, n, vdir, ldir, light,
                        ambient_col)

    hit = frag.face_idx[0] >= 0
    h, w = cam.image_size
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=pos.device) + 0.5,
        torch.arange(w, dtype=torch.float32, device=pos.device) + 0.5,
        indexing="ij")
    rays = cam.pixel_rays_world(xx, yy)
    bg = _sample_equirect(env_map, rays, hdri_rotation) * hdri_strength
    if white_bg:
        bg = torch.ones_like(bg)
    return torch.where(hit[..., None], shaded, bg), hit


def _screen_verts(cam: Camera, pts) -> torch.Tensor:
    """World points (N, 3) → screen (u, v, z) (1, N, 3) on the camera's
    device. The view transform is written out elementwise rather than as a
    matmul, so the card and the CPU round it alike and a render's coverage
    is the same on both."""
    v = torch.as_tensor(np.asarray(pts, np.float32), device=cam.R.device)
    R = cam.R
    view = (v[:, 0:1] * R[0] + v[:, 1:2] * R[1]) + v[:, 2:3] * R[2] + cam.T
    return cam.view_to_screen(view)[None]


def _on_device(cam: Camera, device) -> Camera:
    """The camera with its tensors moved to ``device``."""
    return dataclasses.replace(cam, **{f: getattr(cam, f).to(device) for f in
                                       ("R", "T", "focal", "principal")})


def render_view(cam: Camera, scene: PackedScene, cfg: Optional[Config] = None,
                chunk: int = 512, env: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """One software-rendered frame on the camera's device → linear (H, W, 3)
    and the hit mask (H, W), as host arrays: ``rasterize_hard_auto`` (with
    ``chunk`` faces a step where it takes the dense path), then the shading
    pass. Matmuls run at full f32."""
    hdri_strength = float(cfg.get("hdri_strength", 1.0)) if cfg else 1.0
    hdri_rotation = float(cfg.get("hdri_rotation", 0.0)) if cfg else 0.0
    white_bg = bool(cfg.get("hdri_white_bg", False)) if cfg else False
    dev = cam.R.device
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt,
                                                    device=dev)

    atlas = t(scene.atlas) if scene.atlas is not None else torch.ones(
        (2, 2, 3), device=dev)
    env_map = t(env) if env is not None else torch.ones((2, 4, 3),
                                                        device=dev)
    # ambient irradiance: the environment's mean (a one-bounce stand-in)
    ambient_col = env_map.reshape(-1, 3).mean(0) * hdri_strength
    scene_t = (t(scene.verts)[None], t(scene.faces, torch.int64)[None],
               t(scene.normals)[None], t(scene.colors)[None],
               t(scene.uvs)[None], t(scene.tex_weight)[None],
               t(scene.metallic)[None], t(scene.roughness)[None])
    with torch.no_grad(), full_f32():
        vs = _screen_verts(cam, scene.verts)
        frag = rasterize_hard_auto(vs, scene_t[1], cam.image_size,
                                   chunk=chunk)
        img, hit = _shade_pixels(
            frag, scene_t, atlas, env_map, ambient_col,
            t(hdri_strength), t(hdri_rotation), cam,
            white_bg=bool(white_bg or env is None))
        return img.cpu().numpy(), hit.cpu().numpy()


def run(cfg: Config, device="cuda") -> List[str]:
    """All of phase 8; returns the paths written. The software renderer runs
    on ``device``; it logs each stage's wall time ("phase8: stage
    breakdown", the seconds as the record's args: load, cam1, cam2,
    debug)."""
    art = Artifacts(cfg)
    os.makedirs(art.rendering_dir, exist_ok=True)

    blender = shutil.which("blender")
    if blender and not bool(cfg.get("force_software_render", False)):
        return _run_blender(cfg, blender)

    t_stage = time.perf_counter()
    scene = _load_scene_for_render([art.combined_scene_glb,
                                    art.ground_aligned_glb], cfg)
    if scene is None:
        log.warning("phase8: nothing to render")
        return []
    t_load = time.perf_counter() - t_stage

    res = int(cfg.get("render_resolution", 768))
    cam1 = camera_from_npz(art.camera_npz, device=device)
    h = res
    w = int(round(cam1.image_size[1] * res / cam1.image_size[0]))
    cam1 = cam1.rescaled(h, w)

    exposure = float(cfg.get("exposure", 0.4))
    gamma = float(cfg.get("gamma", 0.8))
    view_tf = str(cfg.get("view_transform", "Filmic"))
    look = str(cfg.get("look", "Low Contrast"))

    env = None
    hdri_path = cfg.path("hdri_path") if cfg.get("hdri_path") else None
    if hdri_path and os.path.exists(hdri_path):
        try:
            env = load_hdr(hdri_path)
            log.info("phase8: HDRI world %s (%dx%d)", hdri_path,
                     env.shape[1], env.shape[0])
        except Exception as e:
            log.warning("phase8: HDRI load failed (%s) — white world", e)

    t_stage = time.perf_counter()
    img1, hit1 = render_view(cam1, scene, cfg, env=env)
    img1 = tone_map(img1, exposure, gamma, view_tf, look)
    save_image(os.path.join(art.rendering_dir, "render_cam1.png"), img1)
    white = img1.copy()
    white[~hit1] = 1.0
    save_image(os.path.join(art.rendering_dir, "render_cam1_white_bg.png"),
               white)
    t_cam1 = time.perf_counter() - t_stage

    # the bird's-eye second camera above the scene's centroid
    t_stage = time.perf_counter()
    verts = scene.verts
    center = verts.mean(0)
    extent = float(np.linalg.norm(verts.max(0) - verts.min(0)))
    eye = center + np.asarray([0.3 * extent, 1.2 * extent, -0.3 * extent])
    # built on the host, so every device renders from the same camera
    cam2 = _on_device(lookat_camera(eye, center, (res, res),
                                    focal_px=res * 1.0, device="cpu"), device)
    img2, _ = render_view(cam2, scene, cfg, env=env)
    save_image(os.path.join(art.rendering_dir, "render_cam2.png"),
               tone_map(img2, exposure, gamma, view_tf, look))
    t_cam2 = time.perf_counter() - t_stage

    out = [os.path.join(art.rendering_dir, n) for n in
           ("render_cam1.png", "render_cam1_white_bg.png", "render_cam2.png")]
    t_stage = time.perf_counter()
    out += _debug_artifacts(cfg, art, scene, cam1, cam2, env,
                            exposure, gamma, view_tf, look)
    t_debug = time.perf_counter() - t_stage
    log.info("phase8 (software): wrote %d renders at %dx%d", len(out), h, w)
    log.info("phase8: stage breakdown — load %.3f s, cam1 %.3f s, cam2 %.3f "
             "s, debug %.3f s", t_load, t_cam1, t_cam2, t_debug)
    return out


def _render_pointcloud(cam: Camera, pts: np.ndarray,
                       colors: Optional[np.ndarray],
                       radius_px: float) -> np.ndarray:
    """Point-splat preview of a cloud on white (the reference's io_mesh_ply
    import and set_pc_for_render, blender run.py:108-156, 882-905)."""
    with torch.no_grad(), full_f32():
        vs = _screen_verts(cam, pts)
        cols = (None if colors is None else torch.as_tensor(
            np.asarray(colors, np.float32), device=vs.device)[None])
        img, alpha = render_points_soft(vs, cam.image_size,
                                        radius_px=radius_px, colors=cols)
    img = img[0].cpu().numpy()
    a = alpha[0].cpu().numpy()[..., None]
    return np.clip(img + (1.0 - a), 0.0, 1.0)


def _debug_artifacts(cfg: Config, art, scene, cam1: Camera, cam2: Camera,
                     env, exposure, gamma, view_tf, look) -> List[str]:
    """The reference's optional artifacts (blender run.py:604-979):
    ``render_pointclouds`` → point-splat renders of the backprojected cloud
    from both cameras; ``render_GT`` with a GT_scene → the GT scene from
    both cameras, the predicted cloud overlaid when ``render_pointclouds``
    is on too; always the packed scene and both cameras in
    temp/blender_scene.npz (the reference's tmp/blender_scene.blend)."""
    out: List[str] = []
    res_y = cam1.image_size[0]
    render_pc = bool(cfg.get("render_pointclouds", False))
    pc_path = art.combined_scene_bp_ply
    pc = None
    if render_pc and os.path.exists(pc_path):
        cloud = load_ply(pc_path)
        cols = (cloud.colors.astype(np.float32) / 255.0
                if cloud.colors is not None else None)
        pc = (cloud.vertices, cols)
        # pytorch3d's NDC radius 0.003 ≈ 1.5 px at 1024, scaled to the
        # render, at least 1.5 px so points stay visible in previews
        radius = max(1.5, 1.5 * res_y / 1024.0 * (
            float(cfg.get("pointcloud_scale", 0.002)) / 0.002))
        for cam, tag in ((cam1, "cam1"), (cam2, "cam2")):
            img = _render_pointcloud(cam, pc[0], pc[1], radius)
            p = os.path.join(art.rendering_dir,
                             f"render_pointcloud_{tag}.png")
            save_image(p, img)
            save_image(p.replace(".png", "_white_bg.png"), img)
            out.append(p)

    gt_path = cfg.path("GT_scene") if cfg.get("GT_scene") else None
    if bool(cfg.get("render_GT", False)) and gt_path \
            and os.path.exists(gt_path):
        gt_scene = _load_scene_for_render([gt_path], cfg)
        if gt_scene is not None:
            for cam, tag in ((cam1, "cam1"), (cam2, "cam2")):
                img, hit = render_view(cam, gt_scene, cfg, env=env)
                img = tone_map(img, exposure, gamma, view_tf, look)
                if pc is not None:
                    radius = max(1.5, 1.5 * res_y / 1024.0)
                    pimg = _render_pointcloud(cam, pc[0], pc[1], radius)
                    mask = (pimg < 0.999).any(-1, keepdims=True)
                    img = np.where(mask, pimg, img)
                p = os.path.join(art.rendering_dir,
                                 f"render_GT_PC_{tag}.png")
                save_image(p, img)
                white = img.copy()
                white[~hit] = 1.0
                save_image(p.replace(".png", "_white_bg.png"), white)
                out.append(p)

    dump = os.path.join(art.temp, "blender_scene.npz")
    os.makedirs(art.temp, exist_ok=True)
    host = lambda x: x.detach().cpu().numpy()
    np.savez_compressed(
        dump, verts=scene.verts, faces=scene.faces, normals=scene.normals,
        colors=scene.colors, uvs=scene.uvs, tex_weight=scene.tex_weight,
        metallic=scene.metallic, roughness=scene.roughness,
        atlas=(scene.atlas if scene.atlas is not None
               else np.ones((2, 2, 3), np.float32)),
        cam1_R=host(cam1.R), cam1_T=host(cam1.T), cam1_focal=host(cam1.focal),
        cam1_principal=host(cam1.principal),
        cam1_image_size=np.asarray(cam1.image_size),
        cam2_R=host(cam2.R), cam2_T=host(cam2.T), cam2_focal=host(cam2.focal),
        cam2_principal=host(cam2.principal),
        cam2_image_size=np.asarray(cam2.image_size))
    log.info("phase8: scene dump → %s", dump)
    return out


def _run_blender(cfg: Config, blender: str) -> List[str]:
    """Drive headless Blender with a generated script (the artifact set of
    the reference's bpy pipeline); taken only where a blender executable
    exists."""
    art = Artifacts(cfg)
    script = os.path.join(art.temp, "render_scene.py")
    os.makedirs(art.temp, exist_ok=True)
    with open(script, "w") as f:
        f.write(_BLENDER_SCRIPT)
    env = dict(os.environ,
               REGEN3D_SCENE=art.combined_scene_glb,
               REGEN3D_BG=art.ground_aligned_glb,
               REGEN3D_CAMERA=art.camera_npz,
               REGEN3D_OUT=art.rendering_dir,
               REGEN3D_SAMPLES=str(cfg.get("blender_render_samples", 8)))
    subprocess.run([blender, "-b", "-P", script], check=True, env=env)
    return [os.path.join(art.rendering_dir, "render_cam1.png"),
            os.path.join(art.rendering_dir, "render_cam1_white_bg.png")]


_BLENDER_SCRIPT = '''\
"""Generated headless-Blender scene builder (reference parity: Cycles,
denoising, camera from camera.npz, combined scene + background import)."""
import os
import bpy
import numpy as np

bpy.ops.wm.read_factory_settings(use_empty=True)
scene = bpy.context.scene
scene.render.engine = "CYCLES"
scene.cycles.samples = int(os.environ.get("REGEN3D_SAMPLES", "8"))

for key in ("REGEN3D_BG", "REGEN3D_SCENE"):
    path = os.environ.get(key, "")
    if path and os.path.exists(path):
        bpy.ops.import_scene.gltf(filepath=path)

cam_data = np.load(os.environ["REGEN3D_CAMERA"])
cam = bpy.data.cameras.new("cam1")
cam.angle_x = float(cam_data["camera_angle_x"])
ob = bpy.data.objects.new("cam1", cam)
ob.matrix_world = np.asarray(cam_data["extrinsic"]).T.tolist()
scene.collection.objects.link(ob)
scene.camera = ob

w, h = [int(x) for x in cam_data["image_size"]]
scene.render.resolution_x = w
scene.render.resolution_y = h
out = os.environ["REGEN3D_OUT"]
scene.render.filepath = os.path.join(out, "render_cam1.png")
bpy.ops.render.render(write_still=True)
scene.render.film_transparent = True
scene.render.filepath = os.path.join(out, "render_cam1_white_bg.png")
bpy.ops.render.render(write_still=True)
'''
