"""Whole-scene serving step, phases 4→6 in one call (counterpart of
regen3d_tpu/pipeline/scene_step.py).

VGGT forward → depth unprojection → per-object static-size cloud crop (the
phase-5 mask crop as a top-k selection) → batched pose fit → posed scene
vertices, with no host round trip between the stages' tensors.

Over a (dp, tp) mesh (``mesh``) the VGGT forward runs on the parameters
``parallel/mesh.shard_params`` placed over 'tp' and the object axis of the
fit is split over 'dp' (``fit_poses_sharded``), as the JAX package's step
runs under a mesh (``__graft_entry__._dryrun_scene_step``); every rank
passes the same inputs and gets the whole result.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from regen3d_tpu_torch.camera import Camera
from regen3d_tpu_torch.models.vggt import pose_encoding_to_camera, unproject_depth
from regen3d_tpu_torch.pipeline.pose_fit import (
    FitConfig,
    ObjectBatch,
    PoseParams,
    fit_poses,
    fit_poses_sharded,
    pose_transform,
)


class SceneStepResult(NamedTuple):
    params: PoseParams           # fitted per-object poses
    verts_world: torch.Tensor    # (K, Vmax, 3) posed mesh vertices
    losses: torch.Tensor         # (K,) final fit losses
    depth: torch.Tensor          # (H, W) VGGT depth of the query frame
    points: torch.Tensor         # (K, P, 3) extracted per-object clouds
    points_valid: torch.Tensor   # (K, P) bool


def _extract_object_points(cloud, conf, masks, num_points):
    """For each object mask (K, N) pick the ``num_points`` highest-confidence
    cloud points inside it → ((K, P, 3) points, (K, P) valid).

    Scores are rounded to bf16 first, as the JAX step does; among equal
    scores the lowest index wins (``lax.top_k``'s order), which a stable
    descending sort reproduces."""
    score = torch.where(masks, conf[None, :], float("-inf"))
    score = score.to(torch.bfloat16).float()
    val, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    val, idx = val[:, :num_points], idx[:, :num_points]
    return cloud[idx], torch.isfinite(val)


def nanmedian(x: torch.Tensor, dim: int) -> torch.Tensor:
    """numpy's nanmedian: the mean of the two middle values for an even
    count (``torch.nanmedian`` returns the lower one), NaN if all are NaN."""
    n = (~torch.isnan(x)).sum(dim, keepdim=True)
    s = torch.sort(torch.where(torch.isnan(x), float("inf"), x), dim=dim).values
    lo = torch.gather(s, dim, torch.clamp((n - 1) // 2, min=0))
    hi = torch.gather(s, dim, torch.clamp(n // 2, max=x.shape[dim] - 1))
    med = (lo + hi) / 2
    return torch.where(n > 0, med, float("nan")).squeeze(dim)


def scene_step(
    model,
    images: torch.Tensor,        # (F, S, S, 3) in [0, 1] (frame 0 = query)
    masks: torch.Tensor,         # (K, S, S) bool object masks (query frame)
    verts: torch.Tensor,         # (K, Vmax, 3) canonical asset meshes
    verts_mask: torch.Tensor,    # (K, Vmax) bool
    faces: torch.Tensor,         # (K, Fmax, 3) int32
    faces_mask: torch.Tensor,    # (K, Fmax) bool
    fit_cfg: FitConfig,
    num_points: int = 1024,
    image_hw: Optional[Tuple[int, int]] = None,
    mesh=None,
) -> SceneStepResult:
    """One scene inference step (phases 4→6); over ``mesh``, the fit's
    objects split over its 'dp' ranks."""
    s = images.shape[1]
    k = masks.shape[0]
    dev = images.device

    # --- phase 4: VGGT forward + unprojection ------------------------------
    with torch.no_grad():
        out = model(images[None])
    cam_dec = pose_encoding_to_camera(out["pose_enc"][0], (s, s))
    depth = out["depth"][0, 0]
    conf = out["depth_conf"][0, 0].reshape(-1)
    cloud = unproject_depth(depth, cam_dec, 0).reshape(-1, 3)

    # --- phase 5: per-object static-size crop (the mask IS the hit test) ---
    pts, pts_valid = _extract_object_points(cloud, conf, masks.reshape(k, -1),
                                            num_points)

    # --- phase 6: batched pose fit ------------------------------------------
    # VGGT's camera is OpenCV (u = cx + fx·x/z); Camera is P3D-sign
    # (u = cx − fx·x/z): view_p3d = D·(R_cv·x + t) with D = diag(−1, −1, 1)
    D = torch.tensor([-1.0, -1.0, 1.0], device=dev)
    cam = Camera(R=cam_dec["R"][0].float().T * D[None, :],
                 T=cam_dec["t"][0].float() * D,
                 focal=torch.stack([cam_dec["fx"][0], cam_dec["fy"][0]]),
                 principal=torch.stack([cam_dec["cx"][0], cam_dec["cy"][0]]),
                 image_size=image_hw or (s, s))
    # a fit coarser than the frame max-pools the masks and rescales the camera
    fh, fw = fit_cfg.image_hw
    if (fh, fw) != (s, s):
        if s % fh or s % fw:
            raise ValueError(f"fit_cfg.image_hw {fit_cfg.image_hw} must divide "
                             f"the frame size {s} for mask pooling")
        masks_fit = masks.reshape(k, fh, s // fh, fw, s // fw).amax((2, 4))
        cam = cam.rescaled(fh, fw)
    else:
        masks_fit = masks

    med = nanmedian(torch.where(pts_valid[..., None], pts, float("nan")), 1)
    med = torch.nan_to_num(med, nan=2.0)
    batch = ObjectBatch(
        verts=verts, verts_mask=verts_mask, faces=faces, faces_mask=faces_mask,
        target_mask=masks_fit.float(),
        target_points=torch.where(pts_valid[..., None], pts,
                                  torch.zeros_like(pts)),
        points_mask=pts_valid,
        pivot_R=torch.eye(3, device=dev).expand(k, 3, 3),
        pivot_t=torch.zeros(k, 3, device=dev),
        on_floor=torch.zeros(k, dtype=torch.bool, device=dev),
        object_valid=pts_valid.any(1),
        bbox_lo=torch.tensor([-100.0, -100.0, 1e-3], device=dev),
        bbox_hi=torch.tensor([100.0, 100.0, 100.0], device=dev))
    init = PoseParams.zeros(k, device=dev)._replace(translation=med)
    res = fit_poses(init, batch, cam, fit_cfg) if mesh is None else \
        fit_poses_sharded(init, batch, cam, fit_cfg, mesh)
    with torch.no_grad():
        posed = pose_transform(res.params, batch, fit_cfg)
    return SceneStepResult(params=res.params, verts_world=posed,
                           losses=res.losses, depth=depth, points=pts,
                           points_valid=pts_valid)
