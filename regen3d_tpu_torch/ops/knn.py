"""Nearest-neighbour, kNN and Chamfer ops (counterpart of
regen3d_tpu/ops/knn.py).

Squared distances use the expansion ‖x−y‖² = ‖x‖² + ‖y‖² − 2·x·yᵀ (a
(N, 3) × (3, M) matmul, as the JAX package rounds it; not ``torch.cdist``,
whose formula differs), streamed over target chunks. Matmuls run without
TF32 (:func:`regen3d_tpu_torch.ops.full_f32`): TF32's 10-bit mantissa would
move nearest neighbours. Ties go to the lowest target index, as JAX's
``argmin`` and ``lax.top_k`` give them: first index within a chunk, strict
``<`` across chunks.

:func:`nn_distances` is differentiable in both clouds through a custom
backward that gathers the matched targets (O(N)) instead of keeping the
distance matrix: ``gx = g·2(x − y[idx])`` and ``gy`` scatter-adds ``−gx``
into the matched targets in a fixed order (``ops.scatter_add_rows``; CUDA's
``index_add_`` adds in no fixed order, and a fit through it did not repeat
bit for bit).

All functions take optional validity masks for padded clouds.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from regen3d_tpu_torch.ops import full_f32, scatter_add_rows

_BIG = 1e30


def _pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(N, 3), (M, 3) → (N, M) squared euclidean distances."""
    x2 = (x * x).sum(-1, keepdim=True)                    # (N, 1)
    y2 = (y * y).sum(-1, keepdim=True).T                  # (1, M)
    xy = x @ y.T
    return torch.clamp_min(x2 + y2 - 2.0 * xy, 0.0)


def _chunked_nn(x: torch.Tensor, y: torch.Tensor,
                y_mask: Optional[torch.Tensor], chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each x (N, 3): (min sq-dist to a valid y (M, 3), argmin index)."""
    m = y.shape[0]
    chunk = min(chunk, m)
    best_d = best_i = None
    with full_f32():
        for c0 in range(0, m, chunk):
            d = _pairwise_sqdist(x, y[c0:c0 + chunk])
            if y_mask is not None:
                d = torch.where(y_mask[None, c0:c0 + chunk], d,
                                torch.full_like(d, _BIG))
            dmin, imin = d.min(-1)
            imin = imin.int() + c0
            if best_d is None:      # JAX's start: _BIG at index 0
                best_d = torch.full_like(dmin, _BIG)
                best_i = torch.zeros_like(imin)
            take = dmin < best_d
            best_d = torch.where(take, dmin, best_d)
            best_i = torch.where(take, imin, best_i)
    return best_d, best_i


class _NNDistances(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, x_mask, y_mask, chunk):
        d, i = _chunked_nn(x, y, y_mask, chunk)
        if x_mask is not None:
            d = torch.where(x_mask, d, torch.zeros_like(d))
        ctx.save_for_backward(x, y, i, x_mask)
        ctx.mark_non_differentiable(i)
        return d, i

    @staticmethod
    def backward(ctx, g_d, _g_i):
        x, y, idx, x_mask = ctx.saved_tensors
        diff = 2.0 * (x - y[idx.long()])     # d‖x−y*‖²/dx with y* fixed
        if x_mask is not None:
            diff = torch.where(x_mask[:, None], diff, torch.zeros_like(diff))
        gx = g_d[:, None] * diff
        # dL/dy: −gx scatter-added into the matched targets
        gy = scatter_add_rows(torch.zeros_like(y), idx, -gx)
        return gx, gy, None, None, None


def nn_distances(
    x: torch.Tensor,
    y: torch.Tensor,
    x_mask: Optional[torch.Tensor] = None,
    y_mask: Optional[torch.Tensor] = None,
    chunk: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Squared distance + index of the nearest valid y for every x.

    x (N, 3), y (M, 3), optional bool masks → (sqdist (N,), idx (N,) int32).
    Invalid x rows get sqdist 0."""
    return _NNDistances.apply(x, y, x_mask, y_mask, chunk)


def knn_points(
    x: torch.Tensor,
    y: torch.Tensor,
    k: int,
    y_mask: Optional[torch.Tensor] = None,
    chunk: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K nearest valid targets per query → (sqdists (N, K), idx (N, K))
    ascending. A running top-K is merged with each target chunk by a stable
    sort, so equal distances keep the lower index first, as ``lax.top_k``
    does."""
    n, m = x.shape[0], y.shape[0]
    chunk = min(chunk, m)
    best_d = torch.full((n, k), _BIG, dtype=torch.float32, device=x.device)
    best_i = torch.zeros((n, k), dtype=torch.int32, device=x.device)
    with full_f32():
        for c0 in range(0, m, chunk):
            yc = y[c0:c0 + chunk]
            d = _pairwise_sqdist(x, yc)
            if y_mask is not None:
                d = torch.where(y_mask[None, c0:c0 + chunk], d,
                                torch.full_like(d, _BIG))
            ii = (torch.arange(yc.shape[0], dtype=torch.int32,
                               device=x.device) + c0).expand(n, -1)
            cat_d = torch.cat([best_d, d], 1)
            cat_i = torch.cat([best_i, ii], 1)
            best_d, pos = torch.sort(cat_d, dim=1, stable=True)
            best_d, pos = best_d[:, :k], pos[:, :k]
            best_i = torch.gather(cat_i, 1, pos)
    return best_d, best_i


def chamfer_distance(
    x: torch.Tensor,
    y: torch.Tensor,
    x_mask: Optional[torch.Tensor] = None,
    y_mask: Optional[torch.Tensor] = None,
    chunk: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bidirectional NN squared distances + indices:
    (dist_x→y, dist_y→x, idx_x, idx_y), differentiable through
    :func:`nn_distances`."""
    d_xy, i_xy = nn_distances(x, y, x_mask, y_mask, chunk)
    d_yx, i_yx = nn_distances(y, x, y_mask, x_mask, chunk)
    return d_xy, d_yx, i_xy, i_yx


def chamfer_loss(
    x: torch.Tensor,
    y: torch.Tensor,
    x_mask: Optional[torch.Tensor] = None,
    y_mask: Optional[torch.Tensor] = None,
    chunk: int = 2048,
) -> torch.Tensor:
    """Symmetric mean chamfer (the scalar used by losses/metrics)."""
    d_xy, d_yx, _, _ = chamfer_distance(x, y, x_mask, y_mask, chunk)
    nx = x.shape[0] if x_mask is None else torch.clamp_min(x_mask.sum(), 1)
    ny = y.shape[0] if y_mask is None else torch.clamp_min(y_mask.sum(), 1)
    return d_xy.sum() / nx + d_yx.sum() / ny

