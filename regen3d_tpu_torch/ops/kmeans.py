"""k-means for phase 1's weightless proposer, without scikit-learn.

The JAX package clusters with ``sklearn.cluster.KMeans(n_clusters=k,
n_init=4, random_state=seed)``; the card's machine has no scikit-learn, so
this module carries a copy of what that call runs, from scikit-learn 1.9.0
(BSD-3-Clause; ``sklearn/cluster/_kmeans.py``, ``_k_means_lloyd.pyx``,
``_k_means_common.pyx`` and ``metrics/pairwise.py``), in numpy on the host
in float32 as scikit-learn computes it:

* X is centred on its mean (``KMeans.fit``); the tolerance is
  ``TOL · mean(var(X))`` of the uncentred X (``_tolerance``);
* each of the ``N_INIT`` runs is seeded by greedy k-means++
  (``_kmeans_plusplus``: 2 + ⌊ln k⌋ local trials a centre, the same
  ``RandomState`` calls in the same order, squared distances computed in
  float64 by chunks and rounded to float32 as ``_euclidean_distances_upcast``
  does), then runs Lloyd's iterations (``_kmeans_single_lloyd``) until the
  labels stop changing or the squared centre shift falls to the tolerance,
  at most ``MAX_ITER``, and a final E-step when the labels did not settle;
* the E-step takes ``‖c‖² − 2·x·c`` in float32 and the first centre at the
  minimum; the M-step sums each cluster's points in sample order in
  float32 (scikit-learn's order with one OpenMP thread: with more its
  per-thread sums meet in the order the threads finish), relocates empty
  clusters to the farthest points and scales by 1 / count;
* the run with the least inertia wins, the earlier one on a tie or when
  two runs give the same partition (``_is_same_clustering``).

:func:`kmeans_predict` labels every pixel on the device in torch with the
same E-step, its products accumulated as scikit-learn's sgemm does. Points
that lie within rounding of two centres may still take either label where
a BLAS sums in another order (ROADMAP Queue 3 ak).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

# The JAX package's one call, KMeans(n_clusters=k, n_init=4,
# random_state=seed): n_init as it sets it, max_iter and tol at
# scikit-learn's defaults.
N_INIT = 4
MAX_ITER = 300
TOL = 1e-4


@dataclass
class KMeansFit:
    """What :func:`kmeans_fit` chose: ``centers`` (k, f) float32 in X's
    frame, ``labels`` of the fitted points, the winning run's ``inertia``
    and iterations, every run's k-means++ ``init_indices`` (rows of X) and
    the index of the winning run (``best_init``)."""

    centers: np.ndarray
    labels: np.ndarray
    inertia: float
    n_iter: int
    init_indices: List[np.ndarray]
    best_init: int


def _row_norms(x: np.ndarray) -> np.ndarray:
    return np.einsum("ij,ij->i", x, x)


def _sq_distances(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Squared distances (len(a), len(b)) of float32 rows: float64 chunks,
    −2·a·bᵀ + ‖a‖² + ‖b‖², rounded to float32 and clipped at 0, in
    ``_euclidean_distances_upcast``'s batches."""
    na, nb, f = a.shape[0], b.shape[0], a.shape[1]
    maxmem = max(((na + nb) * f + na * nb) / 10, 10 * 2 ** 17)
    tmp = 2 * f
    batch = max(int((-tmp + math.sqrt(tmp ** 2 + 4 * maxmem)) / 2), 1)
    out = np.empty((na, nb), np.float32)
    for i in range(0, na, batch):
        ac = a[i:i + batch].astype(np.float64)
        aa = _row_norms(ac)[:, None]
        for j in range(0, nb, batch):
            bc = b[j:j + batch].astype(np.float64)
            d = -2 * (ac @ bc.T)
            d += aa
            d += _row_norms(bc)[None, :]
            out[i:i + batch, j:j + batch] = d.astype(np.float32)
    np.maximum(out, 0, out=out)
    return out


def _plusplus(x: np.ndarray, k: int, rs: np.random.RandomState):
    """Greedy k-means++ → (centres (k, f), their row indices)."""
    n, f = x.shape
    sw = np.ones(n, x.dtype)
    trials = 2 + int(np.log(k))
    centers = np.empty((k, f), x.dtype)
    first = rs.choice(n, p=sw / sw.sum())
    idx = np.full(k, -1, dtype=int)
    centers[0] = x[first]
    idx[0] = first
    closest = _sq_distances(centers[0, np.newaxis], x)
    pot = closest @ sw
    for c in range(1, k):
        rand_vals = rs.uniform(size=trials) * pot
        cand = np.searchsorted(np.cumsum(sw * closest), rand_vals)
        np.clip(cand, None, closest.size - 1, out=cand)
        dist = _sq_distances(x[cand], x)
        np.minimum(closest, dist, out=dist)
        cand_pot = dist @ sw.reshape(-1, 1)
        best = np.argmin(cand_pot)
        pot = cand_pot[best]
        closest = dist[best]
        centers[c] = x[cand[best]]
        idx[c] = cand[best]
    return centers, idx


def _assign(x: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """The E-step: the first centre at the least ‖c‖² − 2·x·c (float32)."""
    d = _row_norms(centers)[None, :] - 2.0 * (x @ centers.T)
    return np.argmin(d, axis=1).astype(np.int32)


def _ordered_sums(x: np.ndarray, labels: np.ndarray, k: int):
    """Per-cluster float32 sums of the rows in sample order, and counts."""
    sums = np.zeros((k, x.shape[1]), np.float32)
    counts = np.zeros(k, np.float32)
    for j in range(k):
        rows = x[labels == j]
        if len(rows):
            sums[j] = np.cumsum(rows, axis=0, dtype=np.float32)[-1]
            counts[j] = len(rows)
    return sums, counts


def _m_step(x, labels, centers_old, k):
    """New centres from the labels (``lloyd_iter_chunked_dense``'s update,
    ``_relocate_empty_clusters_dense``, ``_average_centers``)."""
    sums, counts = _ordered_sums(x, labels, k)
    empty = np.where(counts == 0)[0].astype(np.int32)
    if len(empty):
        dist = ((x - centers_old[labels]) ** 2).sum(axis=1)
        far = np.argpartition(dist, -len(empty))[:-len(empty) - 1:-1]
        if np.max(dist) != 0:
            for new_id, far_idx in zip(empty, far):
                old_id = labels[far_idx]
                sums[old_id] -= x[far_idx]
                sums[new_id] = x[far_idx]
                counts[new_id] = 1.0
                counts[old_id] -= 1.0
    biggest = int(np.argmax(counts))
    for j in range(k):
        if counts[j] > 0:
            sums[j] *= np.float32(1.0 / np.float64(counts[j]))
        else:       # a centre not scaled yet when biggest > j, as there
            sums[j] = sums[biggest]
    return sums


def _sq_rows(d: np.ndarray) -> np.ndarray:
    """Σ d² of each row in float32 as ``_euclidean_dense_dense`` adds it:
    each group of four features left to right, added to the running sum,
    then the features left over one at a time."""
    sq = d * d
    n4 = sq.shape[1] // 4
    out = np.zeros(sq.shape[0], np.float32)
    for i in range(n4):
        out += ((sq[:, 4 * i] + sq[:, 4 * i + 1]) + sq[:, 4 * i + 2]) \
            + sq[:, 4 * i + 3]
    for i in range(4 * n4, sq.shape[1]):
        out += sq[:, i]
    return out


def _lloyd(x, centers, tol, max_iter):
    """``_kmeans_single_lloyd`` → (labels, inertia, centres, iterations)."""
    k = centers.shape[0]
    labels_old = np.full(x.shape[0], -1, np.int32)
    strict = False
    for i in range(max_iter):
        labels = _assign(x, centers)
        new = _m_step(x, labels, centers, k)
        shift = np.sqrt(_sq_rows(new - centers).astype(np.float64)
                        ).astype(np.float32)
        centers = new
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if (shift ** 2).sum() <= tol:
            break
        labels_old = labels
    if not strict:
        labels = _assign(x, centers)
    inertia = np.cumsum(_sq_rows(x - centers[labels]), dtype=np.float32)[-1]
    return labels, float(inertia), centers, i + 1


def _same_clustering(a: np.ndarray, b: np.ndarray, k: int) -> bool:
    """True when two labellings are one partition up to renaming."""
    mapping = np.full(k, -1, np.int64)
    for la, lb in zip(a, b):
        if mapping[la] == -1:
            mapping[la] = lb
        elif mapping[la] != lb:
            return False
    return True


def kmeans_fit(x: np.ndarray, k: int, seed: int) -> KMeansFit:
    """``KMeans(n_clusters=k, n_init=4, random_state=seed).fit(x)`` on the
    host: (N, f) points → :class:`KMeansFit` with the centres in x's
    frame."""
    x = np.array(x, dtype=np.float32, order="C", copy=True)
    tol = np.mean(np.var(x, axis=0)) * TOL
    rs = np.random.RandomState(seed)
    x_mean = x.mean(axis=0)
    x -= x_mean
    best = None
    inits = []
    for run in range(N_INIT):
        init, idx = _plusplus(x, k, rs)
        inits.append(idx)
        labels, inertia, centers, n_iter = _lloyd(x, init, tol, MAX_ITER)
        if best is None or (inertia < best[1] and not _same_clustering(
                labels, best[0], k)):
            best = (labels, inertia, centers, n_iter, run)
    labels, inertia, centers, n_iter, run = best
    return KMeansFit(centers + x_mean, labels, inertia, n_iter, inits, run)


def kmeans_predict(x: torch.Tensor, centers: np.ndarray) -> torch.Tensor:
    """The E-step over every row of x (N, f) float32, on x's device →
    (N,) int64 labels: ‖c‖² − 2·x·c, the first centre at the minimum.
    x·c is accumulated over the features in order with one rounding to
    float32 a step, as a fused multiply-add does in scikit-learn's sgemm
    (x_f·c_f is exact in float64, so each step is the sum rounded to
    float64 and then to float32)."""
    c = torch.from_numpy(np.ascontiguousarray(centers, np.float64)).to(x.device)
    cn = torch.from_numpy(_row_norms(np.asarray(centers, np.float32))).to(x.device)
    x64 = x.double()
    acc = (x64[:, :1] * c[:, 0]).float()
    for f in range(1, x.shape[1]):
        acc = (x64[:, f:f + 1] * c[:, f] + acc.double()).float()
    return torch.argmin(cn[None, :] - 2.0 * acc, dim=1)
