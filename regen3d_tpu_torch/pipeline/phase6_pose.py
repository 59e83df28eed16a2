"""Phase 6: artifacts in → batched pose fit → fitted GLBs out (counterpart of
regen3d_tpu/pipeline/phase6_pose.py; reference pose_matching_planar.py:
859-1716 and scene_reconstruction/run.py).

Per object: load the asset GLB, clean and decimate it, decide on-floor
(mask overlap with the floor finding), load the phase-5 target cloud, make
the coarse init (Y-up OBB volume scale, centroid, yaw grid search); floor
objects fit in the frame of the fitted floor plane with their bottom on it.
Then every object goes through one batched Adam fit
(:func:`pipeline.pose_fit.fit_poses`), and the fitted pose is replayed on
the full-resolution meshes, saved to output/glb/<stem>.glb, with a GIF of
the fit where PIL is present.

Under a process group of several ranks (``torch.distributed``, every rank
running the phase on the same bus) the object axis is split over them
(:func:`pipeline.pose_fit.fit_poses_sharded` over ``make_mesh(tp=1)``), as
the JAX package shards it over several chips, unless ``shard_pose_fit`` is
false (``parallel/fleet.run_fleet`` sets it so: its ranks run different
scenes); otherwise it is padded to a multiple of 4, as the JAX package pads
it on one chip. The RANSAC floor fit draws its samples from a
``torch.Generator`` seeded with ``cfg.seed`` (JAX draws from
``jax.random.PRNGKey(seed)``, which torch cannot reproduce).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from regen3d_tpu_torch.artifacts import Artifacts, parse_finding_stem
from regen3d_tpu_torch.camera import camera_from_npz
from regen3d_tpu_torch.config import Config
from regen3d_tpu_torch.ops import full_f32
from regen3d_tpu_torch.ops.obb import aabb, oriented_bounding_box_2d_up
from regen3d_tpu_torch.ops.plane import (
    fit_plane_ransac,
    fit_plane_svd,
    plane_transforms,
)
from regen3d_tpu_torch.parallel.mesh import make_mesh
from regen3d_tpu_torch.pipeline.pose_fit import (
    FitConfig,
    FitResult,
    ObjectBatch,
    PoseParams,
    find_best_initial_yaw,
    fit_poses,
    fit_poses_sharded,
    pad_batch_to,
    pose_transform,
)
from regen3d_tpu_torch.utils.glb import MeshData, SceneData, load_glb, save_glb
from regen3d_tpu_torch.utils.image import (
    dilate_mask,
    load_mask,
    mask_bbox,
    resize_nearest,
    save_image,
)
from regen3d_tpu_torch.utils.meshproc import clean_mesh, decimate_vertex_clustering
from regen3d_tpu_torch.utils.ply import load_ply, save_ply

log = logging.getLogger(__name__)

_FIT_FACES = 2048      # decimated silhouette mesh budget per object (default)
_FIT_POINTS = 4096     # target-cloud budget per object (default)


def _pad_to(arr: np.ndarray, n: int, fill=0.0,
            subsample: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Pad ``arr`` to ``n`` rows with a validity mask.

    Overflow: ``subsample=True`` (point clouds only) takes a random subset;
    anything face-indexed raises, since dropping vertices would corrupt the
    mesh (callers decimate first)."""
    m = len(arr)
    mask = np.zeros(n, bool)
    mask[:min(m, n)] = True
    if m > n:
        if not subsample:
            raise ValueError(
                f"_pad_to overflow: {m} rows > budget {n} — decimate before "
                "padding (vertex/face subsampling would corrupt the mesh)")
        sel = np.random.default_rng(0).choice(m, n, replace=False)
        return arr[sel], np.ones(n, bool)
    pad_shape = (n - m,) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, arr.dtype)]), mask


def _floor_overlap(obj_mask: np.ndarray, floor_mask: Optional[np.ndarray],
                   label: str, floor_names: List[str]) -> bool:
    """On-floor test: bbox overlap with the floor mask or a listed name
    (reference: pose_matching_planar.py:980-1046)."""
    if any(fn in label for fn in floor_names):
        return True
    if floor_mask is None:
        return False
    x0, y0, x1, y1 = mask_bbox(dilate_mask(obj_mask, 3))
    fx0, fy0, fx1, fy1 = mask_bbox(floor_mask)
    ix = max(0, min(x1, fx1) - max(x0, fx0))
    iy = max(0, min(y1, fy1) - max(y0, fy0))
    return ix > 0 and iy > 0


def _write_floor_debug(art, floor_cloud, plane) -> None:
    """Floor-fit debug PLYs (reference: pose_matching_planar.py:676-768):
    FLOOR.ply (raw cloud), FLOOR_RESIDUALS.ply (residual-coloured),
    PLANE_SAMPLED.ply (a grid on the fitted plane, phase 7's ground target)."""
    dbg = os.path.join(art.temp, "debug")
    os.makedirs(dbg, exist_ok=True)
    pts = np.asarray(floor_cloud, np.float32)
    save_ply(os.path.join(dbg, "FLOOR.ply"), pts)
    dev = plane.normal.device
    tp = torch.from_numpy(pts).to(dev)
    resid = plane.signed_distance(tp).abs().cpu().numpy()
    t = np.clip(resid / max(np.quantile(resid, 0.95), 1e-9), 0, 1)
    colors = np.stack([t * 255, (1 - t) * 80, (1 - t) * 255], -1).astype(np.uint8)
    save_ply(os.path.join(dbg, "FLOOR_RESIDUALS.ply"), pts, colors=colors)

    # regular grid on the plane, covering the floor cloud's footprint
    in_plane = plane.project(tp).cpu().numpy()
    lo, hi = in_plane.min(0), in_plane.max(0)
    n = 40
    us = np.linspace(0, 1, n)
    gx, gz = np.meshgrid(us, us)
    grid = lo[None, :] + np.stack(
        [gx.ravel(), np.full(n * n, 0.5), gz.ravel()], -1) * (hi - lo)[None, :]
    grid_on_plane = plane.project(
        torch.from_numpy(grid.astype(np.float32)).to(dev)).cpu().numpy()
    save_ply(os.path.join(dbg, "PLANE_SAMPLED.ply"), grid_on_plane)
    log.info("phase6: floor debug artifacts → %s", dbg)


def fit_floor_plane(cfg: Config, floor_points: np.ndarray, device="cuda",
                    ransac_idx: Optional[torch.Tensor] = None):
    """SVD or RANSAC floor plane, whichever puts more points within 5 cm
    (reference: extract_and_fit_floor_plane, pose_matching_planar.py:
    477-770). RANSAC draws from a generator seeded with ``cfg.seed``, or
    takes ``ransac_idx`` (its (2000, 3) sample indices) where given."""
    pts = torch.from_numpy(np.asarray(floor_points, np.float32)).to(device)
    up = torch.tensor([0.0, 1.0, 0.0], device=device)
    svd_plane = fit_plane_svd(pts, up_hint=up)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(cfg.get("seed", 1234567)))
    ransac_plane, _ = fit_plane_ransac(pts, gen, num_iters=2000,
                                       threshold=0.05, up_hint=up,
                                       idx=ransac_idx)
    d_svd = (svd_plane.signed_distance(pts).abs() < 0.05).float().mean()
    d_ran = (ransac_plane.signed_distance(pts).abs() < 0.05).float().mean()
    return ransac_plane if float(d_ran) >= float(d_svd) else svd_plane


def fit_path(cfg: Config) -> str:
    """``"sharded"`` where a process group of several ranks runs and
    ``shard_pose_fit`` holds (default true), else ``"padded"`` (JAX's
    choice on ``jax.device_count()``)."""
    import torch.distributed as dist

    several = dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1
    return "sharded" if several and bool(cfg.get("shard_pose_fit", True)) \
        else "padded"


def run(cfg: Config, device="cuda",
        ransac_idx: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """Fit every object with a phase-5 cloud and a phase-3 asset. Returns
    {stem: final loss}."""
    with full_f32():
        return _run(cfg, device, ransac_idx)


def _run(cfg, device, ransac_idx):
    art = Artifacts(cfg)
    stems = [s for s in art.list_findings() if parse_finding_stem(s)]
    ignore = set(cfg.get("ignore_classes", []))
    img_size = int(cfg.get("image_size_DR", 1024))
    fit_faces = int(cfg.get("fit_max_faces", _FIT_FACES))
    fit_points = int(cfg.get("fit_max_points", _FIT_POINTS))
    t_ = lambda a: torch.from_numpy(np.asarray(a)).to(device)

    # --- gather per-object data ---------------------------------------------
    jobs = []
    floor_mask = None
    floor_cloud = None
    for s in art.list_findings():
        parsed = parse_finding_stem(s)
        label = parsed[0] if parsed else s
        if "floor" in label:
            p = os.path.join(art.masks_dir, f"{s}.png")
            if os.path.exists(p):
                floor_mask = load_mask(p)
            pc = os.path.join(art.pointclouds_dir, f"{s}.ply")
            if os.path.exists(pc):
                floor_cloud = load_ply(pc).vertices

    for stem in stems:
        label = parse_finding_stem(stem)[0]
        if any(ig in label for ig in ignore):
            continue
        glb_path = art.asset_glb(stem)
        pc_path = os.path.join(art.pointclouds_dir, f"{stem}.ply")
        mask_path = os.path.join(art.masks_dir, f"{stem}.png")
        if not (os.path.exists(glb_path) and os.path.exists(pc_path)
                and os.path.exists(mask_path)):
            log.warning("phase6: missing artifacts for %s — skipped", stem)
            continue
        jobs.append((stem, label, glb_path, pc_path, mask_path))
    if not jobs:
        log.warning("phase6: nothing to fit")
        return {}

    t_stage = time.perf_counter()
    cam_full = camera_from_npz(art.camera_npz, device=device)
    orig_h, orig_w = cam_full.image_size
    # tile-aligned render size (the binned rasterizers' requirement)
    bin_tile = int(cfg.get("bin_tile", 32))
    render_h = (img_size // bin_tile) * bin_tile
    render_w = (int(round(orig_w * img_size / orig_h)) // bin_tile) * bin_tile
    cam = cam_full.rescaled(render_h, render_w)
    # edge rasterizer with hoisted bins at production resolutions; the
    # exact streaming SoftRas for small (test) renders
    use_edge = bool(cfg.get("use_edge_raster", render_h >= 256))
    use_binned = bool(cfg.get("use_binned_raster", False))

    # floor plane (shared by all on-floor objects)
    plane = None
    if floor_cloud is not None and len(floor_cloud) > 32:
        plane = fit_floor_plane(cfg, floor_cloud, device, ransac_idx)
        w2p, p2w = plane_transforms(plane)
        if bool(cfg.get("write_debug_artifacts", True)):
            _write_floor_debug(art, floor_cloud, plane)
    # floor_object_names lists labels that are on the floor by name
    # (pose_matching_planar.py:980-1046)
    floor_names = [str(n) for n in cfg.get("floor_object_names", [])]

    # background AABB from the empty-room cloud (bbox hinge loss)
    bbox_lo = np.asarray([-1e3, -1e3, -1e3], np.float32)
    bbox_hi = np.asarray([1e3, 1e3, 1e3], np.float32)
    if os.path.exists(art.points_empty_ply):
        # points_emptyRoom.ply is in the RAW VGGT world; the pose world is
        # diag(s, −s, −s) of it (the reference's set_vggt_cloud)
        from regen3d_tpu_torch.transforms.conventions import vggt_raw_to_world
        bg = vggt_raw_to_world(
            load_ply(art.points_empty_ply).vertices,
            float(cfg.get("vggt_scene_scale", 2.0))).astype(np.float32)
        pad = float(cfg.get("background_bbox_extents", -0.02))
        lo, hi = aabb(t_(bg), pad=pad)
        bbox_lo, bbox_hi = lo.cpu().numpy(), hi.cpu().numpy()

    # --- build the padded batch -----------------------------------------------
    b = len(jobs)
    vmax = fit_faces // 2 + 2
    batch_np = {
        "verts": np.zeros((b, vmax, 3), np.float32),
        "verts_mask": np.zeros((b, vmax), bool),
        "faces": np.zeros((b, fit_faces, 3), np.int32),
        "faces_mask": np.zeros((b, fit_faces), bool),
        "target_mask": np.zeros((b, render_h, render_w), np.float32),
        "target_points": np.zeros((b, fit_points, 3), np.float32),
        "points_mask": np.zeros((b, fit_points), bool),
        "pivot_R": np.tile(np.eye(3, dtype=np.float32)[None], (b, 1, 1)),
        "pivot_t": np.zeros((b, 3), np.float32),
        "on_floor": np.zeros(b, bool),
    }
    init_t = np.zeros((b, 3), np.float32)
    init_yaw = np.zeros(b, np.float32)
    init_logs = np.zeros(b, np.float32)
    full_meshes = []   # original-resolution scenes for the final export
    prep_info = []     # (mesh_c, scale0, y_off) per job, replayed at export

    t_floor = time.perf_counter() - t_stage
    t_stage = time.perf_counter()
    for i, (stem, label, glb_path, pc_path, mask_path) in enumerate(jobs):
        scene = load_glb(glb_path)
        allv = np.concatenate([m.vertices for m in scene.meshes])
        allf = np.concatenate([
            m.faces + off for m, off in
            zip(scene.meshes,
                np.cumsum([0] + [m.vertices.shape[0] for m in scene.meshes[:-1]]))
        ])
        allv, allf = clean_mesh(allv, allf)
        full_meshes.append(scene)

        target = load_ply(pc_path).vertices.astype(np.float32)
        obj_mask = load_mask(mask_path)
        m_img = resize_nearest(obj_mask, (render_h, render_w))

        on_floor = _floor_overlap(obj_mask, floor_mask, label,
                                  ["floor"] + floor_names) and plane is not None

        # ---- coarse init (OBB volume scale + centroid + yaw grid) -----------
        tgt = t_(target)
        obb_t = oriented_bounding_box_2d_up(tgt)
        mesh_c = allv.mean(0)
        v_centered = allv - mesh_c
        obb_m = oriented_bounding_box_2d_up(t_(v_centered))
        vol_ratio = float(obb_t.volume) / max(float(obb_m.volume), 1e-12)
        scale0 = float(np.cbrt(max(vol_ratio, 1e-12)))
        v_scaled = v_centered * scale0

        # decimate until both the face and the vertex budget fit (vertex
        # clustering targets faces; tighten rather than subsample)
        target_faces = fit_faces
        dv, df = decimate_vertex_clustering(v_scaled, allf, target_faces)
        while (len(dv) > vmax or len(df) > fit_faces) and target_faces > 8:
            target_faces = int(target_faces * 0.8)
            dv, df = decimate_vertex_clustering(v_scaled, allf, target_faces)
        y_off = 0.0
        if on_floor:
            # pivot: the plane frame; the object's bottom is baked to y = 0
            # so the frozen vertical translation keeps it on the plane
            c = w2p.apply(tgt).cpu().numpy().mean(0)
            y_off = float(-dv[:, 1].min())
            batch_np["pivot_R"][i] = p2w.R.cpu().numpy()
            batch_np["pivot_t"][i] = p2w.t.cpu().numpy()
            v_fit = dv + np.asarray([0.0, y_off, 0.0], np.float32)
            init_t[i] = [c[0], 0.0, c[2]]
            batch_np["on_floor"][i] = True
        else:
            v_fit = dv
            init_t[i] = target.mean(0)
        prep_info.append((mesh_c, scale0, y_off))

        if bool(cfg.get("use_rotation_grid_search", True)):
            steps = int(cfg.get("grid_rotation_steps", 8))
            tgt_local = (w2p.apply(tgt).cpu().numpy()
                         - [init_t[i][0], 0, init_t[i][2]]
                         if on_floor else target - init_t[i])
            yaw = find_best_initial_yaw(
                t_(v_fit.astype(np.float32)), t_(tgt_local.astype(np.float32)),
                num_steps=steps, chunk=1024)
            init_yaw[i] = float(yaw) / float(cfg.get("rotation_speed_mult", 8.0))
            if bool(cfg.get("debug_save", False)):
                _dump_rotation_grid(cfg, stem, v_fit,
                                    tgt_local.astype(np.float32), steps,
                                    float(yaw))

        vv, vm = _pad_to(v_fit.astype(np.float32), vmax)
        ff, fm = _pad_to(df.astype(np.int32), fit_faces)
        tp, pm = _pad_to(target, fit_points, subsample=True)
        batch_np["verts"][i] = vv
        batch_np["verts_mask"][i] = vm
        batch_np["faces"][i] = np.clip(ff, 0, max(int(vm.sum()) - 1, 0))
        batch_np["faces_mask"][i] = fm
        batch_np["target_mask"][i] = m_img.astype(np.float32)
        batch_np["target_points"][i] = tp
        batch_np["points_mask"][i] = pm

    t_prep = time.perf_counter() - t_stage
    t_stage = time.perf_counter()
    batch = ObjectBatch(
        **{k: t_(v) for k, v in batch_np.items()},
        object_valid=torch.ones(b, dtype=torch.bool, device=device),
        bbox_lo=t_(bbox_lo), bbox_hi=t_(bbox_hi))

    fit_cfg = FitConfig(
        image_hw=(render_h, render_w),
        sigma=float(cfg.get("sigma", 5e-7)),
        w_sil=float(cfg.get("silhoutte_loss", 0.1)),
        w_3d=float(cfg.get("loss_3d", 0.1)),
        w_bbox=float(cfg.get("loss_bbox", 0.01)),
        use_5dof=bool(cfg.get("use_5DOF", True)),
        rotation_speed_mult=float(cfg.get("rotation_speed_mult", 8.0)),
        learning_rate=float(cfg.get("learning_rate", 0.005)),
        max_iterations=int(cfg.get("max_iterations", 300)),
        early_stop_grad=float(cfg.get("early_stop_grad_threshold", 5e-3)),
        early_stop_min_iters=int(cfg.get("early_stop_min_iterations", 200)),
        use_binned_raster=use_binned,
        use_edge_raster=use_edge,
        bin_tile=bin_tile,
        faces_per_tile=int(cfg.get("faces_per_tile", 128)),
        bin_margin_px=float(cfg.get("bin_margin_px", 64.0)),
    )
    init = PoseParams(translation=t_(init_t), yaw=t_(init_yaw),
                      rot_aa=torch.zeros(b, 3, device=device),
                      log_scale=t_(init_logs))
    log.info("phase6: fitting %d objects in one batch (%dx%d, %d iters)",
             b, render_h, render_w, fit_cfg.max_iterations)
    if fit_path(cfg) == "sharded":
        # the object axis over 'dp' (the reference's per-object process
        # pool, SURVEY §2.11)
        mesh = make_mesh(tp=1)
        log.info("phase6: sharding the objects over dp=%d", mesh.size(0))
        result = fit_poses_sharded(init, batch, cam, fit_cfg, mesh)
    else:
        # the object axis padded to a multiple of 4, as the JAX package pads
        # it on one chip
        batch_p, init_p, _ = pad_batch_to(batch, init, 4)
        r = fit_poses(init_p, batch_p, cam, fit_cfg)
        result = FitResult(
            params=PoseParams(*(x[:b] for x in r.params)),
            losses=r.losses[:b], num_iters=r.num_iters,
            converged=r.converged[:b], history=r.history[:, :b])
    losses = result.losses.cpu().numpy()
    t_fit = time.perf_counter() - t_stage
    t_stage = time.perf_counter()

    # --- apply the final poses to the full-resolution meshes, export ---------
    os.makedirs(art.glb_dir, exist_ok=True)
    out: Dict[str, float] = {}
    params = PoseParams(*(x.cpu().numpy() for x in result.params))
    converged = result.converged.cpu().numpy()
    for i, (stem, label, glb_path, *_rest) in enumerate(jobs):
        scene = full_meshes[i]
        mesh_c, scale0, y_off = prep_info[i]
        # replay the fit-space prep and the fitted pose on the ORIGINAL
        # (full-resolution, textured) submeshes
        s0 = np.exp(params.log_scale[i])
        yaw = params.yaw[i] * fit_cfg.rotation_speed_mult
        cy, sy = np.cos(yaw), np.sin(yaw)
        # transforms.rotations.yaw_rotation's matrix, applied as x @ R
        R = np.asarray([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
        t = params.translation[i].copy()
        if batch_np["on_floor"][i]:
            t[1] = 0.0
        meshes_out = []
        for m in scene.meshes:
            mv = (m.vertices - mesh_c) * scale0
            mv = mv + np.asarray([0.0, y_off, 0.0], np.float32)
            mv = (mv * s0) @ R + t
            mv = mv @ batch_np["pivot_R"][i] + batch_np["pivot_t"][i]
            meshes_out.append(MeshData(**{**m.__dict__, "vertices":
                                          mv.astype(np.float32)}))
        save_glb(art.fitted_glb(stem), SceneData(meshes=meshes_out))
        out[stem] = float(losses[i])
        log.info("phase6: %s loss=%.4f converged=%s", stem, losses[i],
                 bool(converged[i]))

    t_export = time.perf_counter() - t_stage
    t_stage = time.perf_counter()
    if bool(cfg.get("write_fit_gifs", True)) and fit_cfg.record_history:
        _write_gifs(art, jobs, batch, result, fit_cfg, cam)
    if bool(cfg.get("debug_save", False)):
        final_v = pose_transform(result.params, batch, fit_cfg)
        _dump_silhouette_debug(cfg, jobs, batch, final_v, fit_cfg, cam)
    log.info("phase6: stage breakdown — floor/cam %.1fs, per-object prep "
             "%.1fs, fit %.1fs, export %.1fs, gif/debug %.1fs (%d objects)",
             t_floor, t_prep, t_fit, t_export,
             time.perf_counter() - t_stage, b)
    return out


def _dump_rotation_grid(cfg, stem: str, verts: np.ndarray,
                        target: np.ndarray, steps: int,
                        best_yaw: float) -> None:
    """Rotation-grid debug PLYs (reference: pose_matching_planar.py:243-330
    under debug_save): output/rot_grid_debug/<stem>/ gets the centred
    target and mesh, every candidate rotation and the winner."""
    from regen3d_tpu_torch.transforms.rotations import yaw_rotation

    out_dir = os.path.join(cfg.path("output", "../output"),
                           "rot_grid_debug", stem)
    os.makedirs(out_dir, exist_ok=True)
    save_ply(os.path.join(out_dir, "target_centered.ply"), target)
    save_ply(os.path.join(out_dir, "mesh_centered.ply"), verts)
    angles = np.arange(steps, dtype=np.float32) * (2 * np.pi / steps)
    for a in angles:
        deg = float(a) * 180.0 / np.pi
        R = yaw_rotation(torch.tensor(a)).numpy()
        save_ply(os.path.join(out_dir, f"mesh_rot_{deg:.1f}.ply"),
                 (verts @ R).astype(np.float32))
    best_deg = best_yaw * 180.0 / np.pi
    Rb = yaw_rotation(torch.tensor(best_yaw, dtype=torch.float32)).numpy()
    save_ply(os.path.join(out_dir, f"mesh_rot_best_{best_deg:.1f}.ply"),
             (verts @ Rb).astype(np.float32))
    log.info("phase6: rotation-grid debug → %s (%d candidates)", out_dir,
             steps)


def _dump_silhouette_debug(cfg, jobs, batch, final_v, fit_cfg, cam) -> None:
    """current_silhouette / mask debug PNGs in the temp dir (reference:
    save_img_to_temp, global_utils.py:421-441, called at
    pose_matching_planar.py:947,1620)."""
    from regen3d_tpu_torch.ops.rasterize import soft_silhouette

    temp_dir = cfg.path("temp", "../temp")
    os.makedirs(temp_dir, exist_ok=True)
    with torch.no_grad():
        vs = cam.view_to_screen(cam.world_to_view(final_v))
        alpha = soft_silhouette(
            vs, batch.faces, fit_cfg.image_hw,
            sigma=max(fit_cfg.sigma, 1e-5), faces_mask=batch.faces_mask,
            chunk=fit_cfg.face_chunk).cpu().numpy()
    for i, (stem, *_rest) in enumerate(jobs):
        save_image(os.path.join(temp_dir, f"current_silhouette_{stem}.png"),
                   alpha[i])
        save_image(os.path.join(temp_dir, f"mask_{stem}.png"),
                   batch.target_mask[i].cpu().numpy())
    log.info("phase6: silhouette debug renders → %s", temp_dir)


def render_fit_frame(flat_params: torch.Tensor, batch: ObjectBatch,
                     fit_cfg: FitConfig, gcam):
    """One GIF frame batch: every object at a recorded pose (B, 8),
    rasterized and Phong-shaded at ``gcam``'s size → (images (B, h, w, 3),
    fragments)."""
    from regen3d_tpu_torch.ops.rasterize import phong_shade, rasterize_hard

    p = PoseParams(translation=flat_params[:, 0:3], yaw=flat_params[:, 3],
                   rot_aa=flat_params[:, 4:7], log_scale=flat_params[:, 7])
    with torch.no_grad():
        v = pose_transform(p, batch, fit_cfg)
        vs = gcam.view_to_screen(gcam.world_to_view(v))
        frag = rasterize_hard(vs, batch.faces, gcam.image_size,
                              faces_mask=batch.faces_mask,
                              chunk=fit_cfg.face_chunk)
        n = torch.zeros_like(v) + torch.tensor([0.0, 0, -1], device=v.device)
        col = torch.full_like(v, 0.6)
        light = gcam.center + torch.tensor([0, 2.0, 0], device=v.device)
        img = phong_shade(frag, batch.faces, v, n, col, light_pos=light,
                          camera_pos=gcam.center)
    return img, frag


def _write_gifs(art, jobs, batch, result, fit_cfg, cam,
                every: int = 5, gif_res: int = 160) -> None:
    """Per-object optimization GIFs: Phong-render every 5th recorded pose
    (reference: pose_matching_planar.py:1687-1716)."""
    from regen3d_tpu_torch.utils.image import save_gif

    n_it = int(result.num_iters)
    frames_idx = list(range(0, n_it + 1, every)) or [0]
    h = gif_res
    w = int(round(cam.image_size[1] * gif_res / cam.image_size[0]))
    gcam = cam.rescaled(h, w)
    per_obj_frames = {i: [] for i in range(len(jobs))}
    for fi in frames_idx:
        imgs = render_fit_frame(result.history[fi], batch, fit_cfg,
                                gcam)[0].cpu().numpy()
        for i in range(len(jobs)):
            per_obj_frames[i].append(imgs[i])
    for i, (stem, *_r) in enumerate(jobs):
        save_gif(os.path.join(art.glb_dir, f"{stem}.gif"),
                 per_obj_frames[i], fps=8)
