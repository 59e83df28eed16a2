"""Pose-fit losses (counterpart of regen3d_tpu/ops/losses.py).

Every function takes a leading object axis and reduces over all other axes,
returning one value per object: the JAX functions are these per object,
under ``vmap``. Silhouette loss = 0.75·dice + 0.25·(BCE | focal).
"""

from __future__ import annotations

from typing import Optional

import torch

from regen3d_tpu_torch.ops import clip

_EPS = 1e-7


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def dice_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """1 − Dice coefficient over soft masks."""
    p, t = _flat(pred), _flat(target)
    inter = torch.sum(p * t, dim=1)
    return 1.0 - (2.0 * inter + _EPS) / (p.sum(1) + t.sum(1) + _EPS)


def bce_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on probabilities."""
    p = clip(_flat(pred), _EPS, 1.0 - _EPS)
    t = _flat(target)
    return -torch.mean(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p), dim=1)


def focal_loss(pred: torch.Tensor, target: torch.Tensor,
               alpha: float = 0.5, gamma: float = 2.0) -> torch.Tensor:
    """Focal loss on probabilities (the planar model's silhouette term)."""
    p = clip(_flat(pred), _EPS, 1.0 - _EPS)
    pos = _flat(target) > 0.5
    pt = torch.where(pos, p, 1.0 - p)
    at = torch.where(pos, alpha, 1.0 - alpha)
    return torch.mean(-at * (1.0 - pt) ** gamma * torch.log(pt), dim=1)


def silhouette_loss(pred: torch.Tensor, target: torch.Tensor,
                    use_focal: bool = False) -> torch.Tensor:
    """0.75·dice + 0.25·(focal | bce)."""
    pixel_term = (focal_loss(pred, target) if use_focal
                  else bce_loss(pred, target))
    return 0.75 * dice_loss(pred, target) + 0.25 * pixel_term


def bbox_hinge_loss(verts: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                    verts_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean penetration of vertices (B, V, 3) outside the AABB [lo, hi]."""
    under = clip(lo - verts, 0.0)
    over = clip(verts - hi, 0.0)
    pen = torch.sum(under + over, dim=-1)                 # (B, V)
    if verts_mask is not None:
        m = verts_mask.to(pen.dtype)
        return torch.sum(pen * m, 1) / clip(m.sum(1), 1.0)
    return pen.mean(1)
