"""Phase 7: scene assembly, background meshing, pred↔GT alignment
(counterpart of regen3d_tpu/pipeline/phase7_assemble.py).

Reference flow (scene_optim.py:124-379 + mesh_pointclouds.py):
  * merge all fitted GLBs → combined_scene.glb with the global
    metallic/roughness and per-name "aluminium" material overrides
    (create_glb_scene, global_utils.py:506-601);
  * concatenate per-object target clouds → combined_scene_bp.ply;
  * sample surface points from the pred and GT scenes;
  * background: empty-room cloud → [s,−s,−s] frame fix → normals → Poisson
    meshing + density trim → ground alignment → vertex colours baked from
    the empty room → pointclouds/meshed/ground_aligned.glb;
  * normalize pred/GT clouds (centroid + max-norm, optional PCA pre-align)
    and run ICP (200 iters) → pred_points.ply / gt_points.ply for phase 9.

Sampling, normals, the Poisson solve, ground matching, the bake and ICP run
on ``device``; GLB/PLY IO, the Poisson iso level and trim and marching
tetrahedra on the host. Surface samples come from CPU draws seeded by the
JAX package's seeds (1 for the prediction, 2 for GT), so the card and the
CPU sample the same points (ops/sampling.py).
"""

from __future__ import annotations

import glob as globlib
import logging
import os
import shutil
import time
from typing import Dict, Optional

import numpy as np
import torch

from regen3d_tpu_torch.artifacts import Artifacts
from regen3d_tpu_torch.config import Config
from regen3d_tpu_torch.ops import full_f32
from regen3d_tpu_torch.ops.filters import estimate_normals, pca_align
from regen3d_tpu_torch.ops.icp import iterative_closest_point
from regen3d_tpu_torch.ops.knn import nn_distances
from regen3d_tpu_torch.ops.poisson import poisson_reconstruct
from regen3d_tpu_torch.ops.sampling import sample_points_from_meshes
from regen3d_tpu_torch.utils.glb import MeshData, SceneData, load_glb, save_glb
from regen3d_tpu_torch.utils.ply import load_ply, save_ply

log = logging.getLogger(__name__)


def extract_intrinsics(cfg: Config, pipeline=None) -> Optional[str]:
    """Background PBR maps from the empty room (reference:
    extract_marigold_data, scene_optim.py:68-121 — Marigold intrinsics +
    normals pipelines writing albedo/roughness/metallic/normal_map.png to
    `images_marigold_base`).

    ``pipeline`` is the intrinsics model: a callable taking the image
    (H, W, 3) in [0, 1] and returning the maps ``albedo``, ``roughness``,
    ``metallicity`` and ``normal``. Without it (as phase 7's ``run`` calls
    it) analytic priors keep the artifact set flowing: albedo = the image,
    screen-space normals from the depth prior, constant roughness/metallic
    from the config's scene defaults.
    """
    art = Artifacts(cfg)
    src = art.empty_room
    if not os.path.exists(src):
        log.warning("phase7: no empty_room.png — skipping intrinsics")
        return None
    from regen3d_tpu_torch.utils.image import load_image_rgb, save_image

    base = cfg.path("images_marigold_base",
                    "../output/findings/scene_marigold/")
    os.makedirs(base, exist_ok=True)
    img = load_image_rgb(src, max_side=None)

    if pipeline is not None:
        maps = pipeline(img)
    else:
        from regen3d_tpu_torch.pipeline.depth import estimate_depth
        depth = estimate_depth(img)
        gy, gx = np.gradient(depth.astype(np.float32))
        n = np.stack([-gx * 8.0, -gy * 8.0, np.ones_like(depth)], -1)
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
        maps = {
            "albedo": img,
            "roughness": np.full(img.shape[:2],
                                 float(cfg.get("roughness", 0.5)), np.float32),
            "metallicity": np.full(img.shape[:2],
                                   float(cfg.get("metallic", 0.2)), np.float32),
            "normal": n * 0.5 + 0.5,
        }
    save_image(os.path.join(base, "albedo_map.png"), maps["albedo"])
    save_image(os.path.join(base, "roughness_map.png"), maps["roughness"])
    save_image(os.path.join(base, "metallic_map.png"), maps["metallicity"])
    save_image(os.path.join(base, "normal_map.png"), maps["normal"])
    log.info("phase7: intrinsics maps → %s", base)
    return base


def combine_scene_glb(cfg: Config) -> Optional[str]:
    """Merge output/glb/*.glb into combined_scene.glb with material policy
    (reference: create_glb_scene, global_utils.py:506-601).

    Under ``Use_MIDI`` the MIDI baseline's scene GLB replaces the
    per-object combine (reference: scene_optim.py:180-183 copies
    glb_scene_path_midi over glb_scene_path)."""
    art = Artifacts(cfg)
    if bool(cfg.get("Use_MIDI", False)):
        midi_glb = cfg.path("glb_scene_path_midi",
                            "../output/glb/scene/combined_scene_midi.glb")
        if os.path.exists(midi_glb):
            os.makedirs(os.path.dirname(art.combined_scene_glb),
                        exist_ok=True)
            shutil.copyfile(midi_glb, art.combined_scene_glb)
            log.info("phase7: Use_MIDI — copied %s", midi_glb)
            return art.combined_scene_glb
        log.warning("phase7: Use_MIDI set but %s missing — falling back to "
                    "per-object combine", midi_glb)
    files = sorted(globlib.glob(os.path.join(art.glb_dir, "*.glb")))
    if not files:
        log.warning("phase7: no fitted GLBs to combine")
        return None
    rough = float(cfg.get("roughness", 0.5))
    metal = float(cfg.get("metallic", 0.2))
    alu_names = set(cfg.get("list_aluminium_scene", []) or [])
    alu_metal = float(cfg.get("metallic_aluminium", 0.95))
    alu_rough = float(cfg.get("roughness_aluminium", 0.025))
    alu_albedo = np.asarray(cfg.get("albedo_aluminium", [0.65, 0.65, 0.65, 1.0]))

    out = SceneData()
    for f in files:
        stem = os.path.splitext(os.path.basename(f))[0]
        scene = load_glb(f)
        for m in scene.meshes:
            md = MeshData(**{**m.__dict__})
            md.name = stem if len(scene.meshes) == 1 else f"{stem}/{m.name}"
            if stem in alu_names:
                md.metallic, md.roughness = alu_metal, alu_rough
                md.base_color = alu_albedo
            else:
                md.metallic, md.roughness = metal, rough
            out.meshes.append(md)
    save_glb(art.combined_scene_glb, out)
    log.info("phase7: combined %d GLBs → %s", len(files), art.combined_scene_glb)
    return art.combined_scene_glb


def backproject_scene_ply(cfg: Config) -> Optional[str]:
    """Concatenate per-object phase-5 clouds → combined_scene_bp.ply
    (reference: create_pred_ply_scene, global_utils.py:605-664)."""
    art = Artifacts(cfg)
    plys = sorted(globlib.glob(os.path.join(art.pointclouds_dir, "*.ply")))
    pts = [load_ply(p).vertices for p in plys]
    if not pts:
        return None
    save_ply(art.combined_scene_bp_ply, np.concatenate(pts))
    return art.combined_scene_bp_ply


def glb_to_point_cloud(path, num_samples: int, seed: int = 0,
                       device="cuda") -> np.ndarray:
    """Surface-sample a GLB scene (reference: load_glb_to_point_cloud,
    global_utils.py:696-753 — pytorch3d sample_points_from_meshes).

    ``path`` may be a single GLB path or a list of paths whose meshes are
    merged before area-weighted sampling."""
    paths = [path] if isinstance(path, str) else list(path)
    meshes = []
    for p in paths:
        meshes.extend(load_glb(p).meshes)
    verts = np.concatenate([m.vertices for m in meshes])
    offs = np.cumsum([0] + [m.vertices.shape[0] for m in meshes[:-1]])
    faces = np.concatenate([m.faces + o for m, o in zip(meshes, offs)])
    (pts,) = sample_points_from_meshes(
        torch.as_tensor(verts, dtype=torch.float32, device=device),
        torch.as_tensor(faces, dtype=torch.int64, device=device),
        num_samples, seed)
    return pts.cpu().numpy()


def mesh_background(cfg: Config, device="cuda") -> Optional[str]:
    """Empty-room cloud → Poisson mesh → ground_aligned.glb
    (reference: mesh_background, mesh_pointclouds.py:555-619; frame fix
    [s,−s,−s] at set_vggt_cloud :27-81).

    A failure of the colour bake is logged and the mesh is written without
    colours, as the JAX package does."""
    art = Artifacts(cfg)
    if not os.path.exists(art.points_empty_ply):
        log.warning("phase7: no empty-room cloud — skipping background mesh")
        return None
    # points_emptyRoom.ply is stored in the RAW VGGT world (reference
    # contract); re-base into the pose world with the reference's
    # set_vggt_cloud matrix diag(s,−s,−s) (mesh_pointclouds.py:27-81)
    from regen3d_tpu_torch.transforms.conventions import vggt_raw_to_world
    pts = vggt_raw_to_world(load_ply(art.points_empty_ply).vertices,
                            float(cfg.get("vggt_scene_scale", 2.0)))
    # subsample for tractable normals/poisson
    max_pts = 60000
    if len(pts) > max_pts:
        sel = np.random.default_rng(int(cfg.get("seed", 1234567))).choice(
            len(pts), max_pts, replace=False)
        pts = pts[sel]
    pts = pts.astype(np.float32)
    with torch.no_grad(), full_f32():
        normals = estimate_normals(
            torch.as_tensor(pts, device=device), k=min(24, len(pts) - 1),
            viewpoint=torch.zeros(3, device=device)).cpu().numpy()
    verts, faces = poisson_reconstruct(
        pts, normals,
        resolution=int(cfg.get("background_poisson_resolution", 128)),
        density_quantile=0.05, device=device)
    if len(faces) == 0:
        log.warning("phase7: background meshing produced no faces")
        return None
    verts = _match_grounds(cfg, verts, device)
    # camera-projected coloring from the empty room (the reference's
    # `use_baked_image_only` projected-UV material, blender run.py:434-550)
    vcolors = None
    if os.path.exists(art.empty_room) and os.path.exists(art.camera_npz):
        try:
            from regen3d_tpu_torch.camera import camera_from_npz
            from regen3d_tpu_torch.pipeline.texture import bake_vertex_colors
            from regen3d_tpu_torch.utils.image import load_image_rgb

            img = load_image_rgb(art.empty_room, max_side=512).astype(
                np.float32) / 255.0
            cam = camera_from_npz(art.camera_npz, render_hw=img.shape[:2],
                                  device=device)
            vcolors = bake_vertex_colors(verts, faces, [(cam, img)])
        except Exception:
            log.exception("phase7: background projection failed (non-fatal)")
    save_glb(art.ground_aligned_glb, SceneData(meshes=[
        MeshData(name="background", vertices=verts, faces=faces,
                 vertex_colors=vcolors,
                 base_color=np.asarray([0.8, 0.8, 0.8, 1.0]),
                 metallic=float(cfg.get("metallic_strength", 0.15)),
                 roughness=float(cfg.get("roughness_strength", 0.65)))]))
    log.info("phase7: background mesh %d verts / %d faces", len(verts), len(faces))
    return art.ground_aligned_glb


@torch.no_grad()
def ground_offset(band: torch.Tensor, target: torch.Tensor, bound: float):
    """XZ nearest neighbour of each band point among the plane samples;
    the mean Y difference over the matches within ``bound`` and their
    count."""
    zeros_b = torch.zeros_like(band[:, 0])
    zeros_t = torch.zeros_like(target[:, 0])
    bxz = torch.stack([band[:, 0], band[:, 2], zeros_b], -1)
    txz = torch.stack([target[:, 0], target[:, 2], zeros_t], -1)
    d, idx = nn_distances(bxz, txz)
    b = torch.tensor(bound, dtype=torch.float32, device=band.device)
    ok = d <= b * b
    dy = torch.where(ok, target[idx.long(), 1] - band[:, 1],
                     torch.zeros_like(d))
    cnt = ok.sum()
    return dy.sum() / torch.clamp_min(cnt, 1).to(dy.dtype), cnt


def _match_grounds(cfg: Config, verts: np.ndarray, device="cuda") -> np.ndarray:
    """Align the background mesh's ground to the fitted floor plane
    (reference: match_grounds, mesh_pointclouds.py:280-458 — iterative XZ-
    radius NN mean-Y offset against PLANE_SAMPLED.ply).

    The reference iterates (query, mean-Y shift) up to 20 times, but the
    shift is uniform in Y so the XZ matches and the low band are loop-
    invariant: the converged total offset IS the first masked mean."""
    art = Artifacts(cfg)
    plane_path = os.path.join(art.temp, "debug", "PLANE_SAMPLED.ply")
    if not os.path.exists(plane_path):
        return verts
    target = load_ply(plane_path).vertices.astype(np.float32)
    radius = float(cfg.get("point_search_radius", 0.05))
    v = verts.copy()
    band = v[v[:, 1] <= np.quantile(v[:, 1], 0.1)].astype(np.float32)
    if len(band) == 0 or len(target) == 0:
        return v
    with full_f32():
        offset, cnt = ground_offset(torch.as_tensor(band, device=device),
                                    torch.as_tensor(target, device=device),
                                    max(radius * 10, 0.2))
    if int(cnt) == 0:
        return v
    v[:, 1] += float(offset)
    log.info("phase7: ground matched (%d matches, shift %.4f)",
             int(cnt), float(offset))
    return v


def normalize_cloud(pts: torch.Tensor) -> torch.Tensor:
    """Centroid + max-norm normalization (scene_optim.py:270-303)."""
    x = pts - pts.mean(0)
    scale = torch.linalg.norm(x, dim=1).max()
    return x / torch.clamp_min(scale, 1e-12)


def align_and_export(cfg: Config, device="cuda") -> Dict[str, float]:
    """Sample pred/GT scenes, normalize, optional PCA pre-align, ICP, write
    pred_points.ply / gt_points.ply (scene_optim.py:213-379)."""
    art = Artifacts(cfg)
    n = int(cfg.get("num_samples", 60000))
    gt_path = cfg.path("GT_scene")
    if gt_path is None or not os.path.exists(gt_path):
        log.warning("phase7: no GT scene — skipping alignment")
        return {}
    if not os.path.exists(art.combined_scene_glb):
        log.warning("phase7: no combined scene — skipping alignment")
        return {}
    pred = glb_to_point_cloud(art.combined_scene_glb, n, seed=1, device=device)
    gt = glb_to_point_cloud(gt_path, n, seed=2, device=device)

    pred_n = normalize_cloud(torch.as_tensor(pred, device=device))
    gt_n = normalize_cloud(torch.as_tensor(gt, device=device))
    if bool(cfg.get("use_pca_align", False)):
        R, t = pca_align(pred_n, gt_n)
        with full_f32():
            pred_n = pred_n @ R + t
    stats = {}
    if bool(cfg.get("use_icp", True)):
        res = iterative_closest_point(
            pred_n, gt_n,
            max_iterations=int(cfg.get("icp_max_iterations", 200)),
            estimate_scale=bool(cfg.get("icp_estimate_scale", False)))
        pred_n = res.aligned
        stats = {"icp_rmse": float(res.rmse), "icp_iters": int(res.num_iters)}
        log.info("phase7: ICP rmse=%.5f after %d iters", stats["icp_rmse"],
                 res.num_iters)
        # persist the similarity for replay onto GLBs (apply_similarity_to_glb)
        np.savez(os.path.join(os.path.dirname(art.pred_points_ply),
                              "icp_transform.npz"),
                 R=res.R.cpu().numpy(), t=res.t.cpu().numpy(),
                 s=res.s.cpu().numpy(), rmse=res.rmse.cpu().numpy())
    save_ply(art.pred_points_ply, pred_n.cpu().numpy())
    save_ply(art.gt_points_ply, gt_n.cpu().numpy())
    return stats


def scene_vs_gt_metrics(cfg: Config, device="cuda") -> Dict[str, float]:
    """FULL-scene quality vs GT_scene: pred = combined objects + the
    background mesh (exactly what phase 8 renders), same normalize +
    ICP + metric path as the reference eval.

    NOT a reference metric (run_eval.py scores the objects-only combined
    scene). Keys are prefixed ``scene_`` and ``_incl_bg``-suffixed to keep
    the reference metric set intact."""
    from regen3d_tpu_torch.ops.metrics import evaluate_clouds

    art = Artifacts(cfg)
    gt_path = cfg.path("GT_scene")
    if gt_path is None or not os.path.exists(gt_path):
        return {}
    paths = [p for p in (art.combined_scene_glb, art.ground_aligned_glb)
             if os.path.exists(p)]
    if not paths:
        return {}
    n = int(cfg.get("num_samples", 60000))
    pred = glb_to_point_cloud(paths, n, seed=1, device=device)
    gt = glb_to_point_cloud(gt_path, n, seed=2, device=device)
    pred_n = normalize_cloud(torch.as_tensor(pred, device=device))
    gt_n = normalize_cloud(torch.as_tensor(gt, device=device))
    res = iterative_closest_point(
        pred_n, gt_n,
        max_iterations=int(cfg.get("icp_max_iterations", 200)),
        estimate_scale=bool(cfg.get("icp_estimate_scale", False)))
    m = evaluate_clouds(res.aligned, gt_n, tau=0.1)
    return {"scene_chamfer_incl_bg": float(m["chamfer_pcu"]),
            "scene_fscore_incl_bg": float(m["fscore"]),
            "scene_icp_rmse_incl_bg": float(res.rmse)}


def apply_similarity_to_glb(glb_path: str, R: np.ndarray, t: np.ndarray,
                            s: float, out_path: Optional[str] = None) -> str:
    """Apply a stored ICP similarity to a GLB in place (reference:
    apply_icp_results_to_glb, global_utils.py:756-813). Row convention:
    v' = (v @ R)·s + t."""
    scene = load_glb(glb_path)
    out = SceneData()
    for m in scene.meshes:
        md = MeshData(**{**m.__dict__})
        md.vertices = ((m.vertices @ np.asarray(R)) * float(s)
                       + np.asarray(t)).astype(np.float32)
        out.meshes.append(md)
    dst = out_path or glb_path
    save_glb(dst, out)
    return dst


def run(cfg: Config, device="cuda") -> Dict[str, float]:
    """All of phase 7; returns the ICP stats and logs each stage's wall
    time ("phase7: stage breakdown", the seconds as the record's args).
    Every stage ends in host arrays, so the times include the device's."""
    t = []

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(cfg, *args)
        t.append(time.perf_counter() - t0)
        return out

    timed(extract_intrinsics)
    timed(combine_scene_glb)
    timed(backproject_scene_ply)
    timed(mesh_background, device)
    stats = timed(align_and_export, device)
    log.info("phase7: stage breakdown — intrinsics %.3f s, combine %.3f s, "
             "backproject %.3f s, background %.3f s, align %.3f s", *t)
    return stats
