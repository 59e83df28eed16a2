"""Phase 4: camera + point-cloud estimation → artifact export (counterpart
of regen3d_tpu/pipeline/phase4_camera.py).

Reference flow (minimal_demo_vggt.py): VGGT forward on [input image,
empty_room.png] → depth/conf/pose → unproject → confidence-filtered cloud →
COLMAP sparse dir + points.ply/points_emptyRoom.ply + image_list.txt, then
export_vggt_data (:76-262) converts frame-0's camera through R_fix →
camera.npz and writes scene_vggt.ply (B2P + Y-flip + vggt_scene_scale).

The model is the port's :class:`~regen3d_tpu_torch.models.vggt.VGGT`,
called under ``torch.no_grad()`` on ``device``; every attention runs on the
flash-attention kernel there. The export is numpy on the host and writes
the JAX package's artifact set byte for byte (same npz keys, COLMAP text
layout and PLY conventions), so the two packages' artifacts are
interchangeable. The point cap draws with numpy's generator, so both keep
the same rows.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Tuple

import numpy as np
import torch

from regen3d_tpu_torch.artifacts import Artifacts
from regen3d_tpu_torch.camera import save_camera_npz
from regen3d_tpu_torch.config import Config
from regen3d_tpu_torch.transforms.conventions import (
    opencv_extrinsic_to_blender_world,
    vggt_points_to_scene_ply,
)
from regen3d_tpu_torch.transforms.rotations import matrix_to_quat
from regen3d_tpu_torch.utils.colmapio import (
    ColmapCamera,
    ColmapImage,
    ColmapReconstruction,
    focal_and_angle,
)
from regen3d_tpu_torch.utils.image import load_image_rgb
from regen3d_tpu_torch.utils.ply import save_ply

log = logging.getLogger(__name__)


def align_pointclouds_obb(source: np.ndarray, target: np.ndarray):
    """Per-axis bbox scale + translate-to-target-center alignment (the
    unproject variant's empty-room alignment,
    minimal_demo_vggt_unproject.py:39-120: no rotation, per-axis scale
    from centered extents, aligned = centered·scale + target_center).

    Returns (aligned (N, 3), scale (3,), R=I (3, 3), t (3,))."""
    sc = source.mean(0)
    tc = target.mean(0)
    s_cent = source - sc
    t_cent = target - tc
    s_ext = s_cent.max(0) - s_cent.min(0)
    t_ext = t_cent.max(0) - t_cent.min(0)
    scale = np.divide(t_ext, s_ext, out=np.ones_like(t_ext),
                      where=s_ext > 1e-6)
    aligned = s_cent * scale + tc
    t = tc - sc * scale
    return aligned, scale, np.eye(3), t


def align_pointclouds_pca(source: np.ndarray, target: np.ndarray):
    """Principal-axes alignment (minimal_demo_vggt_unproject.py:123-186):
    R = target_axesᵀ·source_axes from per-cloud PCA, then translate to the
    target center. Returns (aligned, R, t)."""
    sc = source.mean(0)
    tc = target.mean(0)
    s_cent = source - sc
    t_cent = target - tc

    def principal_axes(x):
        # rows = components sorted by descending eigenvalue (sklearn PCA
        # convention the reference relies on)
        cov = (x.T @ x) / max(len(x) - 1, 1)
        w, v = np.linalg.eigh(cov)
        return v[:, ::-1].T

    axes_s = principal_axes(s_cent)
    axes_t = principal_axes(t_cent)
    R = axes_t.T @ axes_s
    aligned = s_cent @ R.T + tc
    t = tc - sc @ R.T
    return aligned, R, t


def matrix_to_qvec(R: np.ndarray) -> np.ndarray:
    """World→cam R → COLMAP qvec (wxyz, w ≥ 0), computed in f32 as the JAX
    package computes it (x64 off), returned in f64."""
    q = matrix_to_quat(torch.as_tensor(np.asarray(R), dtype=torch.float32))
    return q.numpy().astype(np.float64)


def export_reconstruction(
    cfg: Config,
    frames: Dict[str, Dict[str, np.ndarray]],
) -> None:
    """Write the phase-4 artifact set from per-frame geometry.

    frames: ordered {image_name: {"points": (N,3) world pts [OpenCV/VGGT
    frame], "colors": optional (N,3) uint8, "R": (3,3) world→cam,
    "t": (3,), "fx","fy","cx","cy": floats, "width","height": ints}}.
    First frame = main image, optional second = empty room.
    """
    art = Artifacts(cfg)
    os.makedirs(art.colmap_sparse, exist_ok=True)
    names = list(frames)
    scale = float(cfg.get("vggt_scene_scale", 2.0))

    # --- rebase so the frame-0 camera is the identity --------------------------
    # VGGT's world frame is the first camera; rebasing explicitly makes the
    # artifact contract exact for any pose output (minimal_demo_vggt.py:186)
    fr0 = frames[names[0]]
    R0 = np.asarray(fr0["R"], np.float64)
    t0 = np.asarray(fr0["t"], np.float64)
    rebased: Dict[str, Dict[str, np.ndarray]] = {}
    for name in names:
        fr = dict(frames[name])
        R = np.asarray(fr["R"], np.float64)
        t = np.asarray(fr["t"], np.float64)
        fr["R"] = R @ R0.T
        fr["t"] = t - (R @ R0.T) @ t0
        pts = np.asarray(fr["points"], np.float64).reshape(-1, 3)
        fr["points"] = pts @ R0.T + t0   # world → frame-0 camera frame
        rebased[name] = fr
    frames = rebased

    # --- COLMAP sparse (raw OpenCV/VGGT world — the COLMAP contract) ----------
    rec = ColmapReconstruction()
    all_pts = []
    all_cols = []
    for i, name in enumerate(names):
        fr = frames[name]
        rec.cameras[i + 1] = ColmapCamera(
            camera_id=i + 1, model="PINHOLE",
            width=int(fr["width"]), height=int(fr["height"]),
            params=np.asarray([fr["fx"], fr["fy"], fr["cx"], fr["cy"]]))
        rec.images[i + 1] = ColmapImage(
            image_id=i + 1, qvec=matrix_to_qvec(fr["R"]),
            tvec=np.asarray(fr["t"], np.float64), camera_id=i + 1, name=name)
        pts = np.asarray(fr["points"], np.float32).reshape(-1, 3)
        cols = fr.get("colors")
        all_pts.append(pts)
        all_cols.append(cols if cols is not None
                        else np.full((len(pts), 3), 128, np.uint8))
    rec.points = np.concatenate(all_pts) if all_pts else np.zeros((0, 3))
    rec.colors = np.concatenate(all_cols) if all_cols else np.zeros((0, 3), np.uint8)
    rec.write(art.colmap_sparse)
    with open(art.image_list_txt, "w") as f:
        f.write("\n".join(names) + "\n")

    # --- camera.npz: R_fix·[R|t] with UNSCALED translation ---------------------
    # (the reference's layout, minimal_demo_vggt.py:160-204; the
    # vggt_scene_scale lives only in the clouds, exact because frame 0 = I)
    ext0 = None
    for i, name in enumerate(names):
        fr = frames[name]
        E = np.eye(4)
        E[:3, :3] = fr["R"]
        E[:3, 3] = np.asarray(fr["t"], np.float64)
        ext_blender = opencv_extrinsic_to_blender_world(E)
        focal, _ = focal_and_angle(int(fr["width"]), fr["fx"], fr["fy"])
        if i == 0:
            ext0 = ext_blender
            save_camera_npz(art.camera_npz, ext_blender, focal,
                            (int(fr["width"]), int(fr["height"])))
        elif i == 1:
            save_camera_npz(art.camera_empty_npz, ext_blender, focal,
                            (int(fr["width"]), int(fr["height"])))

    # --- raw-world per-frame clouds (reference: minimal_demo_vggt.py:534-580) --
    # points.ply: frame-0 cloud; points_emptyRoom_pre.ply: frame-1 raw;
    # points_emptyRoom.ply: frame-1 per-axis bbox-scale-matched to frame 0
    # about its own centroid. All in the raw (rebased) VGGT world.
    pts_by_frame = [np.asarray(frames[n]["points"], np.float64) for n in names]
    save_ply(os.path.join(art.colmap_sparse, "points.ply"),
             pts_by_frame[0].astype(np.float32), colors=all_cols[0])
    if len(names) >= 2:
        p1 = pts_by_frame[1]
        save_ply(os.path.join(art.colmap_sparse, "points_emptyRoom_pre.ply"),
                 p1.astype(np.float32), colors=all_cols[1])
        if len(p1) and len(pts_by_frame[0]):
            src_ext = p1.max(0) - p1.min(0)
            tgt_ext = pts_by_frame[0].max(0) - pts_by_frame[0].min(0)
            ax_scale = np.divide(tgt_ext, src_ext,
                                 out=np.ones_like(tgt_ext),
                                 where=src_ext > 1e-6)
            c = p1.mean(0)
            p1 = (p1 - c) * ax_scale + c
        save_ply(os.path.join(art.colmap_sparse, "points_emptyRoom.ply"),
                 p1.astype(np.float32), colors=all_cols[1])
        # the unproject variant's OBB alignment artifact
        # (minimal_demo_vggt_unproject.py:705-722: empty → main, per-axis
        # scale + translate to the MAIN cloud's center)
        if len(pts_by_frame[1]) and len(pts_by_frame[0]):
            aligned, _, _, _ = align_pointclouds_obb(
                pts_by_frame[1], pts_by_frame[0])
            save_ply(os.path.join(art.colmap_sparse,
                                  "points_emptyRoom_aligned.ply"),
                     aligned.astype(np.float32), colors=all_cols[1])

    # scene_vggt.ply: the reference's point fix
    # (minimal_demo_vggt.py:176-186) — phase 5 undoes it via B2P(I) + Y-flip.
    q = vggt_points_to_scene_ply(pts_by_frame[0], ext0, scale)
    save_ply(art.scene_cloud_ply, q.astype(np.float32))
    log.info("phase4: exported %d frames, %d scene points",
             len(names), len(pts_by_frame[0]))


def preprocess_square(path: str, resolution: int):
    """One image → (the model's (resolution, resolution, 3) f32 input, the
    (resolution, resolution) mask of model pixels inside the image, (h, w)).
    The image is padded to a square of ones, centred (aspect kept: the
    upstream load_and_preprocess_images_square contract, never a
    distorting resize), and resized with ``jax.image.resize``'s bilinear
    filter, which antialiases when it shrinks."""
    from regen3d_tpu_torch.models.layers import resize_bilinear

    arr = load_image_rgb(path, max_side=None)
    h, w = arr.shape[:2]
    side = max(h, w)
    off_y, off_x = (side - h) // 2, (side - w) // 2
    canvas = np.ones((side, side, 3), np.float32)
    canvas[off_y:off_y + h, off_x:off_x + w] = arr.astype(np.float32) / 255.0
    im = resize_bilinear(torch.from_numpy(canvas)[None],
                         (resolution, resolution))[0].numpy()
    vm = np.zeros((side, side), bool)
    vm[off_y:off_y + h, off_x:off_x + w] = True
    yy = np.clip((np.arange(resolution) + 0.5) * side / resolution, 0,
                 side - 1).astype(np.int64)
    return im, vm[yy][:, yy], (h, w)


def run_vggt_inference(
    cfg: Config,
    model,
    image_paths: Tuple[str, ...],
    resolution: int = 518,
    device="cuda",
) -> Dict[str, Dict[str, np.ndarray]]:
    """VGGT forward + unprojection + confidence filtering.

    Mirrors process_single_image_vggt (minimal_demo_vggt.py:368-584):
    images are square-padded (:func:`preprocess_square`), depth, conf and
    pose decoded on ``device``, padded rows/cols masked out of the cloud,
    the remainder filtered by conf_thres_value and capped at
    max_points_for_colmap (numpy's generator, on the host).
    """
    from regen3d_tpu_torch.models.vggt import (
        pose_encoding_to_camera,
        unproject_depth,
    )

    conf_thr = float(cfg.get("conf_thres_value", 1.0))
    max_pts = int(cfg.get("max_points_for_colmap", 10_000_000))

    prep = [preprocess_square(p, resolution) for p in image_paths]
    batch = torch.from_numpy(np.stack([im for im, _, _ in prep]))[None]
    batch = batch.to(device)                      # (1, F, H, W, 3)
    with torch.no_grad():
        out = model(batch)
        cam = pose_encoding_to_camera(out["pose_enc"][0],
                                      (resolution, resolution))
        ba_diag = None
        if bool(cfg.get("use_ba", False)) and len(image_paths) >= 2:
            cam = refine_cameras_with_tracks(cfg, batch[0], out, cam,
                                             resolution)
            ba_diag = cam.pop("_ba", None)
        pts_all = [unproject_depth(out["depth"][0, i], cam, i).reshape(-1, 3)
                   for i in range(len(image_paths))]
    frames: Dict[str, Dict[str, np.ndarray]] = {}
    for i, p in enumerate(image_paths):
        conf = out["depth_conf"][0, i].cpu().numpy()
        pts = pts_all[i].cpu().numpy()
        keep = (conf.reshape(-1) >= conf_thr) & prep[i][1].reshape(-1)
        pts = pts[keep]
        if len(pts) > max_pts:
            sel = np.random.default_rng(int(cfg.get("seed", 1234567))).choice(
                len(pts), max_pts, replace=False)
            pts = pts[sel]
        orig_h, orig_w = prep[i][2]
        # intrinsics from model resolution back to the original image
        # (rename_colmap_recons_and_rescale_camera, minimal_demo_vggt.py:
        # 325-363): the pad kept the aspect, so the scale is uniform and the
        # principal point stays at the image centre
        s = max(orig_h, orig_w) / resolution
        frames[os.path.basename(p)] = {
            "points": pts,
            "R": cam["R"][i].cpu().numpy().astype(np.float64),
            "t": cam["t"][i].cpu().numpy().astype(np.float64),
            "fx": float(cam["fx"][i]) * s, "fy": float(cam["fy"][i]) * s,
            "cx": orig_w / 2.0, "cy": orig_h / 2.0,
            "width": orig_w, "height": orig_h,
        }
    if ba_diag is not None:
        first = frames[os.path.basename(image_paths[0])]
        first["ba_rmse_px"] = float(ba_diag["rmse_px"])
        first["ba_n_tracks_used"] = int(ba_diag["n_tracks_used"])
    return frames


def refine_cameras_with_tracks(cfg: Config, images, out, cam,
                               resolution: int):
    """The `use_ba: true` role (minimal_demo_vggt.py:414-456): track
    query-frame keypoints across frames, seed 3D from frame-0 depth, run
    joint structure+pose BA, and return refined cameras.

    Shi-Tomasi/NCC tracks (ops/tracks.py) and the Schur-complement damped
    Gauss-Newton (ops/bundle_adjust.py::joint_bundle_adjust) on the images'
    device, in place of predict_tracks and pycolmap's bundle adjustment.
    Two passes with a `max_reproj_error` outlier gate between them (the
    reference's batch_np_matrix_to_pycolmap filter, :446); the gates and
    the seeding are numpy in f32, as in the JAX package.
    """
    from regen3d_tpu_torch.ops.bundle_adjust import joint_bundle_adjust
    from regen3d_tpu_torch.ops.tracks import predict_tracks

    dev = images.device
    n_pts = min(int(cfg.get("max_query_pts", 4096)), 2048)
    vis_thresh = float(cfg.get("vis_thresh", 0.2))
    max_err = float(cfg.get("max_reproj_error", 8.0))
    shared = bool(cfg.get("shared_camera", False))

    def host(x):
        return x.cpu().numpy()

    tr = predict_tracks(images, num_points=n_pts)
    xy = host(tr.xy)                             # (F, K, 2) model pixels
    vis = host(tr.vis)
    query_xy = host(tr.query_xy)

    # seed structure: frame-0 depth at the query keypoints, unprojected
    # through the frame-0 camera into the (shared VGGT) world
    depth0 = host(out["depth"][0, 0])
    qx = np.clip(np.round(query_xy[:, 0]).astype(int), 0, resolution - 1)
    qy = np.clip(np.round(query_xy[:, 1]).astype(int), 0, resolution - 1)
    z0 = depth0[qy, qx]
    fx0, fy0 = float(cam["fx"][0]), float(cam["fy"][0])
    cx0, cy0 = float(cam["cx"][0]), float(cam["cy"][0])
    cam_pts = np.stack([(query_xy[:, 0] - cx0) / fx0 * z0,
                        (query_xy[:, 1] - cy0) / fy0 * z0,
                        z0], -1)
    R0 = host(cam["R"][0])                       # column world→cam
    t0 = host(cam["t"][0])
    pts_w = (cam_pts - t0) @ R0                  # Rᵀ(x_cam − t), rows

    # joint BA is row-convention (x_cam = X @ R_row + t): R_row = Rᵀ
    R_row = np.transpose(host(cam["R"]), (0, 2, 1))
    t_all = host(cam["t"])
    f_all = (host(cam["fx"]) + host(cam["fy"])) / 2.0
    pp = np.stack([host(cam["cx"]), host(cam["cy"])], -1)

    w = (vis > vis_thresh).astype(np.float32)
    w[:, z0 <= 1e-6] = 0.0                       # no depth seed → drop

    def _reproj_err(pts, R_row, t_all, f_all):
        v = np.einsum("nk,mkj->mnj", pts, R_row) + t_all[:, None]
        z = np.maximum(v[..., 2], 1e-6)
        proj = pp[:, None] + f_all[:, None, None] * v[..., :2] / z[..., None]
        return np.linalg.norm(proj - xy, axis=-1)

    def dev_t(x):
        return torch.as_tensor(np.asarray(x), device=dev)

    res = None
    for _pass in range(2):
        # gate outlier tracks against the current model before optimizing
        # (the reference filters with max_reproj_error against the VGGT
        # init, :446); an L2 GN with gross mismatches diverges otherwise
        w_eff = w * (_reproj_err(pts_w, R_row, t_all, f_all) < max_err)
        res = joint_bundle_adjust(
            dev_t(pts_w), dev_t(xy), dev_t(w_eff), dev_t(R_row),
            dev_t(t_all), dev_t(f_all), dev_t(pp), max_iterations=25,
            shared_focal=shared)
        pts_w = host(res.points3d)
        R_row = host(res.R)
        t_all = host(res.T)
        f_all = host(res.focal)
    w = w * (_reproj_err(pts_w, R_row, t_all, f_all) < max_err)

    n_used = int((w.sum(0) >= 2).sum())
    err_fin = _reproj_err(pts_w, R_row, t_all, f_all)
    rmse = float(np.sqrt((w * err_fin ** 2).sum()
                         / max(w.sum(), 1.0)))
    log.info("phase4 BA: %d/%d tracks used, reproj RMSE %.3f px",
             n_used, n_pts, rmse)
    ratio = dev_t(f_all / np.maximum(
        (host(cam["fx"]) + host(cam["fy"])) / 2.0, 1e-6))
    return {"R": dev_t(np.transpose(R_row, (0, 2, 1))),
            "t": dev_t(t_all),
            "fx": cam["fx"] * ratio, "fy": cam["fy"] * ratio,
            "cx": cam["cx"], "cy": cam["cy"],
            "_ba": {"rmse_px": rmse, "n_tracks_used": n_used,
                    "points3d": pts_w}}


def run(cfg: Config, model=None, device="cuda") -> None:
    """Phase-4 entry: VGGT on [input image, empty_room if present] → export.
    ``model`` is a VGGT on ``device``; without one this raises before any
    work, as the JAX package does (no checkpoint reader is ported yet)."""
    art = Artifacts(cfg)
    inputs = [cfg.path("input_image")]
    if os.path.exists(art.empty_room):
        inputs.append(art.empty_room)
    if model is None:
        raise RuntimeError(
            "phase 4 requires a VGGT model + params (no pretrained weights "
            "ship in this environment — pass a checkpoint via "
            "models.weights.load_checkpoint, or call export_reconstruction "
            "with precomputed geometry)")
    frames = run_vggt_inference(cfg, model, tuple(inputs), device=device)
    export_reconstruction(cfg, frames)
