"""Evaluation metric suite of phase 9 (counterpart of
regen3d_tpu/ops/metrics.py).

Replaces the reference metric stack (run_eval.py:48-222 + utils/metrics.py):
3D — symmetric Chamfer (pytorch3d-convention squared + pcu-convention
euclidean), Hausdorff, F-score(τ), volume IoU (bbox mode), precision/recall
@threshold, 1-D Wasserstein on flattened coordinates, all from two nearest-
neighbour passes; 2D — PSNR, SSIM (LPIPS lives in models/lpips.py).
Products and convolutions run without TF32.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from regen3d_tpu_torch.ops import full_f32
from regen3d_tpu_torch.ops.knn import nn_distances


def volume_iou_bbox(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Axis-aligned bounding-box volume IoU (reference: compute_volume_iou
    bbox mode, utils/metrics.py:131-189)."""
    p_lo, p_hi = pred.min(0).values, pred.max(0).values
    g_lo, g_hi = gt.min(0).values, gt.max(0).values
    inter = torch.prod(torch.clamp_min(torch.minimum(p_hi, g_hi)
                                       - torch.maximum(p_lo, g_lo), 0))
    vol_p = torch.prod(p_hi - p_lo)
    vol_g = torch.prod(g_hi - g_lo)
    return inter / torch.clamp_min(vol_p + vol_g - inter, 1e-12)


def wasserstein_flat(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """1-D Wasserstein distance between the flattened coordinate
    distributions (reference flattens xyz into one sample set,
    run_eval.py:160-168). Sort-based closed form; resamples to the smaller
    count via linear quantile interpolation when sizes differ."""
    a = torch.sort(pred.reshape(-1)).values
    b = torch.sort(gt.reshape(-1)).values
    n = min(a.shape[0], b.shape[0])
    q = (torch.arange(n, dtype=torch.float32, device=a.device) + 0.5) / n

    def quantiles(x):
        idx = q * (x.shape[0] - 1)
        lo = torch.floor(idx).long()
        hi = torch.clamp_max(lo + 1, x.shape[0] - 1)
        w = idx - lo
        return x[lo] * (1 - w) + x[hi] * w

    return (quantiles(a) - quantiles(b)).abs().mean()


@torch.no_grad()
def evaluate_clouds(pred: torch.Tensor, gt: torch.Tensor,
                    tau: float = 0.1) -> Dict[str, float]:
    """The full 3D metric block of run_eval.py:133-168: both Chamfer
    conventions, Hausdorff, F-score at τ with its precision and recall, P/R
    at 1 cm, bbox volume IoU and the flat Wasserstein distance."""
    d_pg, _ = nn_distances(pred, gt)   # squared
    d_gp, _ = nn_distances(gt, pred)
    r_pg = torch.sqrt(d_pg)
    r_gp = torch.sqrt(d_gp)
    tau = torch.tensor(tau, dtype=torch.float32)
    precision = (r_pg < tau).float().mean()
    recall = (r_gp < tau).float().mean()
    out = {
        "chamfer_p3d": d_pg.mean() + d_gp.mean(),
        "chamfer_pcu": 0.5 * (r_pg.mean() + r_gp.mean()),
        "hausdorff": torch.maximum(r_pg.max(), r_gp.max()),
        "fscore": 2 * precision * recall
        / torch.clamp_min(precision + recall, 1e-12),
        "precision_tau": precision,
        "recall_tau": recall,
        "precision_001": (r_pg < 0.01).float().mean(),
        "recall_001": (r_gp < 0.01).float().mean(),
        "volume_iou_bbox": volume_iou_bbox(pred, gt),
        "wasserstein": wasserstein_flat(pred, gt),
    }
    return {k: float(v) for k, v in out.items()}


# --- 2D image metrics ---------------------------------------------------------

def psnr(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0
         ) -> torch.Tensor:
    mse = ((pred - target) ** 2).mean()
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp_min(mse, 1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5,
                     device="cpu") -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return g[:, None] * g[None, :]


def ssim(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0
         ) -> torch.Tensor:
    """Structural similarity (Wang et al.) of (H, W[, C]) images, 11×11
    gaussian window without padding, per-channel averaged — skimage's
    default configuration used by the reference (run_eval.py PSNR/SSIM
    block)."""
    if pred.ndim == 2:
        pred = pred[..., None]
        target = target[..., None]
    c = pred.shape[-1]
    k = _gaussian_kernel(device=pred.device).to(pred.dtype)[None, None].expand(
        c, 1, 11, 11)
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2

    def filt(x):
        # depthwise: one group per channel
        return F.conv2d(x.permute(2, 0, 1)[None], k, groups=c)[0]

    with full_f32():
        mu_p = filt(pred)
        mu_t = filt(target)
        mu_pp = filt(pred * pred)
        mu_tt = filt(target * target)
        mu_pt = filt(pred * target)
    var_p = mu_pp - mu_p ** 2
    var_t = mu_tt - mu_t ** 2
    cov = mu_pt - mu_p * mu_t
    s = ((2 * mu_p * mu_t + c1) * (2 * cov + c2)) / (
        (mu_p ** 2 + mu_t ** 2 + c1) * (var_p + var_t + c2))
    return s.mean()
