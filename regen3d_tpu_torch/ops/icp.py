"""Iterative closest point (counterpart of regen3d_tpu/ops/icp.py).

Replaces pytorch3d ``iterative_closest_point`` (reference: scene_optim.py:
332-350 — 200 iterations, estimate_scale=False, on ~60-100k-point clouds).

Each iteration is one nearest-neighbour pass
(:func:`regen3d_tpu_torch.ops.knn.nn_distances`) and a closed-form Umeyama
solve. The JAX package keeps the loop on the device (``lax.while_loop``);
here the host reads the stopping condition once per iteration (one
``.item()``), evaluated in f32 on the device as JAX evaluates it. The loop
runs without autograd and without TF32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from regen3d_tpu_torch.ops import full_f32
from regen3d_tpu_torch.ops.knn import nn_distances
from regen3d_tpu_torch.transforms.rigid import umeyama


class ICPResult(NamedTuple):
    R: torch.Tensor          # (3, 3) row-vector rotation
    t: torch.Tensor          # (3,)
    s: torch.Tensor          # scalar
    rmse: torch.Tensor       # final RMSE
    num_iters: int           # iterations actually run
    aligned: torch.Tensor    # (N, 3) transformed source


@torch.no_grad()
def iterative_closest_point(
    src: torch.Tensor,
    dst: torch.Tensor,
    max_iterations: int = 200,
    estimate_scale: bool = False,
    relative_rmse_thr: float = 1e-6,
) -> ICPResult:
    """Align src → dst. Returns the accumulated similarity and aligned cloud.

    Stops after ``max_iterations``, or from the third iteration on when the
    RMSE moved by at most ``relative_rmse_thr`` of its previous value."""
    with full_f32():
        # centroid alignment (+ variance-matched scale when estimating)
        # keeps NN correspondences from collapsing the scale from a cold start
        mu_s, mu_d = src.mean(0), dst.mean(0)
        if estimate_scale:
            var_s = ((src - mu_s) ** 2).sum(-1).mean()
            var_d = ((dst - mu_d) ** 2).sum(-1).mean()
            s = torch.sqrt(var_d / torch.clamp_min(var_s, 1e-12))
        else:
            s = torch.ones((), dtype=src.dtype, device=src.device)
        t = mu_d - mu_s * s
        R = torch.eye(3, dtype=src.dtype, device=src.device)
        inf = torch.tensor(float("inf"), dtype=src.dtype, device=src.device)
        rmse, prev = inf, inf
        i = 0
        while i < max_iterations:
            if i >= 2 and not bool(
                    (prev - rmse).abs()
                    > relative_rmse_thr * torch.clamp_min(prev, 1e-12)):
                break
            x = (src @ R) * s + t
            _, idx = nn_distances(x, dst)
            corr = dst[idx.long()]
            R, t, s = umeyama(src, corr, estimate_scale=estimate_scale)
            x2 = (src @ R) * s + t
            prev, rmse = rmse, torch.sqrt(((x2 - corr) ** 2).sum(-1).mean())
            i += 1
        aligned = (src @ R) * s + t
    return ICPResult(R=R, t=t, s=s, rmse=rmse, num_iters=i, aligned=aligned)
