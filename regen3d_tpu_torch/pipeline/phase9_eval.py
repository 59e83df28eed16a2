"""Phase 9: metric evaluation vs the ground-truth scene (counterpart of
regen3d_tpu/pipeline/phase9_eval.py).

Reference flow (run_eval.py:71-254): load pred_points.ply/gt_points.ply
written by phase 7 → 3D metrics (Chamfer ×2, F-score τ=0.1, volume IoU,
Hausdorff, P/R@0.01, Wasserstein) → 2D metrics
(PSNR/SSIM/LPIPS of render_cam1_white_bg.png vs the input image) →
timestamped evaluation dir with json/csv + comparison vs the previous run.

The rendered image is resized to the input's size with LANCZOS as Pillow
computes it (utils/image.resize_pil). LPIPS runs when the caller passes
``lpips_fn``; loading a converted ``lpips_checkpoint`` needs the orbax
reader, not ported yet (ROADMAP Queue 1 item 1), and raises.
"""

from __future__ import annotations

import logging
import os
from typing import Dict

import torch

from regen3d_tpu_torch.artifacts import Artifacts
from regen3d_tpu_torch.config import Config
from regen3d_tpu_torch.ops.metrics import evaluate_clouds, psnr, ssim
from regen3d_tpu_torch.utils.evalstore import dump_evaluation
from regen3d_tpu_torch.utils.image import load_image_rgb, resize_pil
from regen3d_tpu_torch.utils.ply import load_ply

log = logging.getLogger(__name__)


def run(cfg: Config, lpips_fn=None, device="cuda") -> Dict[str, float]:
    """Every metric phase 9 can compute on this bus, written to
    output/evaluation/<timestamp>/. A failure of the metrics that include
    the background is logged and leaves their keys out, as the JAX package
    does."""
    art = Artifacts(cfg)
    metrics: Dict[str, float] = {}

    if lpips_fn is None and cfg.get("lpips_checkpoint"):
        raise NotImplementedError(
            "phase 9: lpips_checkpoint needs the orbax weight reader "
            "(models/weights.py), which is not ported yet; pass lpips_fn")

    # --- 3D block --------------------------------------------------------------
    if os.path.exists(art.pred_points_ply) and os.path.exists(art.gt_points_ply):
        pred = torch.as_tensor(load_ply(art.pred_points_ply).vertices,
                               device=device)
        gt = torch.as_tensor(load_ply(art.gt_points_ply).vertices,
                             device=device)
        metrics.update(evaluate_clouds(pred, gt, tau=0.1))
        log.info("phase9: 3D metrics on %d/%d points", pred.shape[0], gt.shape[0])
    else:
        log.warning("phase9: pred/gt point clouds missing — skipping 3D metrics")

    # full-scene variant incl. the background mesh (NOT a reference
    # metric — see phase7_assemble.scene_vs_gt_metrics docstring)
    if bool(cfg.get("eval_scene_incl_background", True)):
        try:
            from regen3d_tpu_torch.pipeline.phase7_assemble import (
                scene_vs_gt_metrics,
            )
            metrics.update(scene_vs_gt_metrics(cfg, device=device))
        except Exception:
            log.exception("phase9: scene-incl-background metrics failed")

    # --- 2D block --------------------------------------------------------------
    pred_img_path = art.predicted_image
    input_path = cfg.path("input_image")
    if os.path.exists(pred_img_path) and input_path and os.path.exists(input_path):
        pred_img = load_image_rgb(pred_img_path, max_side=None)
        ref_img = load_image_rgb(input_path, max_side=None)
        if pred_img.shape != ref_img.shape:
            pred_img = resize_pil(pred_img, ref_img.shape[:2], "lanczos")
        p = torch.as_tensor(pred_img, dtype=torch.float32, device=device) / 255.0
        r = torch.as_tensor(ref_img, dtype=torch.float32, device=device) / 255.0
        metrics["psnr"] = float(psnr(p, r))
        metrics["ssim"] = float(ssim(p, r))
        if lpips_fn is not None:
            metrics["lpips"] = float(lpips_fn(p, r))
    else:
        log.warning("phase9: rendered/input image missing — skipping 2D metrics")

    out_dir = dump_evaluation(art.eval_dir, metrics,
                              config_values=dict(cfg.values))
    log.info("phase9: wrote %s (%d metrics)", out_dir, len(metrics))
    return metrics
