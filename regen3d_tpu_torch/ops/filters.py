"""Point-cloud filters and normal estimation for phase 5 and PCA
pre-alignment for phase 7 (counterpart of regen3d_tpu/ops/filters.py;
reference: pc_utils.py:79-153 and extract_pc_object.py:188-225).

Filters return boolean keep-masks; compaction happens at file export.
DBSCAN is density-filtered connected components by min-label propagation
over the eps-graph, as in the JAX package. Normals are the smallest
eigenvector of each point's kNN covariance, oriented toward the viewpoint;
a collinear neighbourhood has no defined normal (two zero eigenvalues) and
its eigenvector is whatever the solver returns.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from regen3d_tpu_torch.ops import full_f32
from regen3d_tpu_torch.ops.knn import _pairwise_sqdist, knn_points

# cuSOLVER's batched eigh (cusolverDnXsyevBatched) refuses very large
# batches of 3×3 matrices
_EIGH_BATCH = 16384


def _quantile(values: torch.Tensor, q: float) -> torch.Tensor:
    """Linear quantile of each column of ``values`` (N, C), rounded as
    ``jnp.quantile`` rounds it: rank q·(N − 1) in f32, then
    low·(1 − w) + high·w. One sort per column keeps clear of
    ``torch.quantile``'s limit of 2²⁴ elements."""
    n = values.shape[0]
    srt = torch.stack([torch.sort(values[:, c]).values
                       for c in range(values.shape[1])], 1)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=values.device)
    pos = f32(q) * f32(n - 1)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    w_hi = pos - lo
    w_lo = 1.0 - w_hi
    return srt[lo.long()] * w_lo + srt[hi.long()] * w_hi


def quantile_filter(
    points: torch.Tensor,
    q: float = 0.02,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Keep points inside the [q, 1−q] quantile box per axis, the quantiles
    over the valid points (reference: filter_points_by_quantile,
    pc_utils.py:79-108)."""
    valid = points if mask is None else points[mask]
    if valid.shape[0] == 0:
        return torch.zeros(points.shape[0], dtype=torch.bool,
                           device=points.device)
    lo = _quantile(valid, q)
    hi = _quantile(valid, 1.0 - q)
    keep = ((points >= lo) & (points <= hi)).all(-1)
    return keep if mask is None else keep & mask


def dbscan_largest_cluster(
    points: torch.Tensor,
    eps: float = 0.1,
    min_points: int = 10,
    mask: Optional[torch.Tensor] = None,
    num_sweeps: int = 32,
    chunk: int = 1024,
) -> torch.Tensor:
    """Keep-mask of the largest DBSCAN cluster (reference: filter_dbscan,
    pc_utils.py:112-153).

    A point is core with ≥ min_points neighbours within eps. Labels start as
    point indices; each sweep gives every point the least label among its
    in-eps core neighbours (and its own), which converges to the connected
    components of the core graph, border points attached, in at most
    ``num_sweeps`` sweeps."""
    n = points.shape[0]
    dev = points.device
    valid = (torch.ones(n, dtype=torch.bool, device=dev) if mask is None
             else mask)
    eps2 = eps * eps
    big = 2 ** 30
    chunks = [slice(c0, c0 + chunk) for c0 in range(0, n, chunk)]
    with full_f32():
        deg = torch.zeros(n, dtype=torch.int64, device=dev)
        for sl in chunks:
            d = _pairwise_sqdist(points, points[sl])
            deg += ((d <= eps2) & valid[None, sl]).sum(1)
        core = (deg >= min_points) & valid
        labels = torch.where(valid, torch.arange(n, device=dev),
                             torch.full((n,), big, device=dev))
        for _ in range(num_sweeps):
            best = torch.full((n,), big, dtype=torch.int64, device=dev)
            for sl in chunks:
                d = _pairwise_sqdist(points, points[sl])
                neigh = (d <= eps2) & core[None, sl]
                cand = torch.where(neigh, labels[None, sl],
                                   torch.full_like(d, big, dtype=torch.int64))
                best = torch.minimum(best, cand.min(1).values)
            # core points adopt the least label; border points attach
            labels = torch.where(valid, torch.minimum(labels, best),
                                 torch.full_like(labels, big))
    counts = torch.bincount(labels[valid & (labels < big)], minlength=n)
    return valid & (labels == torch.argmax(counts[:n]))


def estimate_normals(
    points: torch.Tensor,
    k: int = 30,
    viewpoint: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    chunk: int = 2048,
) -> torch.Tensor:
    """Per-point normals from kNN-PCA, oriented toward ``viewpoint``
    (reference: Open3D estimate_normals + orientation,
    extract_pc_object.py:188-211)."""
    _, idx = knn_points(points, points, k, y_mask=mask, chunk=chunk)
    neigh = points[idx.long()]                       # (N, K, 3)
    x = neigh - neigh.mean(1, keepdim=True)
    with full_f32():
        cov = torch.einsum("nki,nkj->nij", x, x) / k  # (N, 3, 3)
    # smallest eigenvectors, in batches of at most _EIGH_BATCH matrices
    normals = torch.cat([torch.linalg.eigh(c)[1][..., 0]
                         for c in cov.split(_EIGH_BATCH)])
    if viewpoint is not None:
        sign = torch.sign(((viewpoint - points) * normals).sum(-1, keepdim=True))
        normals = normals * torch.where(sign == 0, torch.ones_like(sign), sign)
    return normals


def pca_align(src: torch.Tensor, dst: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotation+translation aligning src's principal axes to dst's
    (reference: align_clouds_pca, scene_optim.py:29-64 /
    align_pointclouds_pca, minimal_demo_vggt_unproject.py:122-186).
    Returns (R, t) for ``src @ R + t``, R proper: src's least axis is
    flipped where the product has det −1.

    The sign of each eigenvector is the solver's choice (LAPACK's or
    cuSOLVER's), so R can differ between packages and devices by a 180°
    turn about an axis (ROADMAP Queue 3 w), as it can in the JAX package.
    """

    def axes_of(p):
        mu = p.mean(0)
        x = p - mu
        with full_f32():
            cov = x.T @ x / p.shape[0]
        return mu, torch.linalg.eigh(cov)[1]        # columns ascending

    mu_s, v_s = axes_of(src)
    mu_d, v_d = axes_of(dst)
    with full_f32():
        det = torch.linalg.det(v_s @ v_d.T)
        flip = torch.ones(3, dtype=src.dtype, device=src.device)
        flip[0] = torch.where(det < 0, -1.0, 1.0)
        R = (v_s * flip) @ v_d.T
        t = mu_d - mu_s @ R
    return R, t
