"""Point ↔ triangle-mesh distances (counterpart of the pose-fit subset of
regen3d_tpu/ops/point_mesh.py).

Functions take a leading object axis: points (B, P, 3), verts (B, V, 3),
faces (B, F, 3), masks (B, P) / (B, F). The exact symmetric loss runs its
O(P·F) search without autograd and differentiates only the matched
(point, face) pairs, as the JAX ``custom_vjp`` does; the top-k loss takes
the exact distance over the k nearest candidates by centroid, through
autograd. Every gather's backward adds in a fixed order (``ops.take_rows``,
``ops.scatter_add_rows``), so a fit through either repeats bit for bit on
the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from regen3d_tpu_torch.ops import clip, scatter_add_rows
from regen3d_tpu_torch.ops.knn import knn_points
from regen3d_tpu_torch.ops.rasterize import gather_faces, gather_rows

_BIG = 1e30


def point_triangle_distance(p, a, b, c):
    """Squared distance from points to triangles, broadcasting (..., 3)."""
    ab, ac = b - a, c - a
    ap, bp, cp = p - a, p - b, p - c
    d1, d2 = (ab * ap).sum(-1), (ac * ap).sum(-1)
    d3, d4 = (ab * bp).sum(-1), (ac * bp).sum(-1)
    d5, d6 = (ab * cp).sum(-1), (ac * cp).sum(-1)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    eps = 1e-12

    def safe(x):
        return torch.where(x.abs() < eps, torch.full_like(x, eps), x)

    v_ab = clip(d1 / safe(d1 - d3), 0.0, 1.0)
    p_ab = a + v_ab[..., None] * ab
    w_ac = clip(d2 / safe(d2 - d6), 0.0, 1.0)
    p_ac = a + w_ac[..., None] * ac
    w_bc = clip((d4 - d3) / safe((d4 - d3) + (d5 - d6)), 0.0, 1.0)
    p_bc = b + w_bc[..., None] * (c - b)
    denom = safe(va + vb + vc)
    p_in = a + (vb / denom)[..., None] * ab + (vc / denom)[..., None] * ac

    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    on_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)

    closest = p_in
    for cond, cand in ((on_bc, p_bc), (on_ac, p_ac), (on_ab, p_ab),
                       (in_c, c), (in_b, b), (in_a, a)):
        closest = torch.where(cond[..., None], cand, closest)
    diff = p - closest
    return (diff * diff).sum(-1)


def _masked_min(d, mask, best_d, best_i, offset):
    """Fold one chunk's (B, N, C) distances into the running min/argmin."""
    if mask is not None:
        d = torch.where(mask, d, torch.full_like(d, _BIG))
    dmin, imin = d.min(-1)          # first index among ties, as jnp.argmin
    take = dmin < best_d
    return (torch.where(take, dmin, best_d),
            torch.where(take, imin.int() + offset, best_i))


def points_to_mesh_distance(points, verts, faces, points_mask=None,
                            faces_mask=None, chunk: int = 512
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min squared distance of each point to the mesh → (d (B, P), face idx)."""
    tri = gather_faces(verts, faces)                    # (B, F, 3, 3)
    b, n_p = points.shape[:2]
    f = tri.shape[1]
    chunk = min(chunk, f)
    best_d = torch.full((b, n_p), _BIG, dtype=torch.float32,
                        device=points.device)
    best_i = torch.zeros((b, n_p), dtype=torch.int32, device=points.device)
    p = points[:, :, None, :]
    for c0 in range(0, f, chunk):
        t = tri[:, None, c0:c0 + chunk]                 # (B, 1, C, 3, 3)
        d = point_triangle_distance(p, t[..., 0, :], t[..., 1, :], t[..., 2, :])
        mk = None if faces_mask is None else faces_mask[:, None, c0:c0 + chunk]
        best_d, best_i = _masked_min(d, mk, best_d, best_i, c0)
    if points_mask is not None:
        best_d = torch.where(points_mask, best_d, torch.zeros_like(best_d))
    return best_d, best_i


def _face_to_point_min(tri, points, points_mask, faces_mask, chunk):
    """(min sq-dist (B, F), argmin point idx (B, F)) for each face."""
    b, f = tri.shape[:2]
    n_p = points.shape[1]
    pchunk = min(chunk, n_p)
    best_d = torch.full((b, f), _BIG, dtype=torch.float32, device=tri.device)
    best_i = torch.zeros((b, f), dtype=torch.int32, device=tri.device)
    t = tri[:, :, None]                                 # (B, F, 1, 3, 3)
    for c0 in range(0, n_p, pchunk):
        pc = points[:, None, c0:c0 + pchunk]            # (B, 1, C, 3)
        d = point_triangle_distance(pc, t[..., 0, :], t[..., 1, :], t[..., 2, :])
        mk = None if points_mask is None else points_mask[:, None, c0:c0 + pchunk]
        best_d, best_i = _masked_min(d, mk, best_d, best_i, c0)
    return best_d, best_i


def _counts(points, faces, points_mask, faces_mask):
    n_pts = (torch.full((points.shape[0],), float(points.shape[1]),
                        device=points.device) if points_mask is None
             else torch.clamp(points_mask.sum(1), min=1).float())
    n_f = (torch.full((faces.shape[0],), float(faces.shape[1]),
                      device=faces.device) if faces_mask is None
           else torch.clamp(faces_mask.sum(1), min=1).float())
    return n_pts, n_f


class _PointMeshFaceDistance(torch.autograd.Function):
    @staticmethod
    def forward(ctx, verts, points, faces, points_mask, faces_mask, chunk):
        d_pf, idx_pf = points_to_mesh_distance(points, verts, faces,
                                               points_mask, faces_mask, chunk)
        tri = gather_faces(verts, faces)
        d_fp, idx_fp = _face_to_point_min(tri, points, points_mask,
                                          faces_mask, chunk)
        if faces_mask is not None:
            d_fp = torch.where(faces_mask, d_fp, torch.zeros_like(d_fp))
        n_pts, n_f = _counts(points, faces, points_mask, faces_mask)
        ctx.save_for_backward(verts, points, faces, idx_pf, idx_fp, n_pts,
                              n_f, points_mask, faces_mask)
        return d_pf.sum(1) / n_pts + d_fp.sum(1) / n_f

    @staticmethod
    def backward(ctx, g):
        (verts, points, faces, idx_pf, idx_fp, n_pts, n_f, points_mask,
         faces_mask) = ctx.saved_tensors
        b, n_v = verts.shape[:2]
        ones = torch.ones_like
        w_pf = (ones(points[..., 0]) if points_mask is None
                else points_mask.float()) * (g / n_pts)[:, None]
        w_fp = (ones(faces[..., 0], dtype=torch.float32) if faces_mask is None
                else faces_mask.float()) * (g / n_f)[:, None]
        f_pf = gather_rows(faces, idx_pf)                # (B, P, 3)
        with torch.enable_grad():
            # point → face pairs: each point against its matched triangle
            p1 = points.detach().requires_grad_()
            t1 = gather_faces(verts, f_pf).detach().requires_grad_()
            d1 = point_triangle_distance(p1, t1[..., 0, :], t1[..., 1, :],
                                         t1[..., 2, :])
            g_points, g_tri_pf = torch.autograd.grad(d1, (p1, t1), w_pf)
            # face → point pairs: each triangle against its matched point
            t2 = gather_faces(verts, faces).detach().requires_grad_()
            p2 = gather_rows(points, idx_fp).detach().requires_grad_()
            d2 = point_triangle_distance(p2, t2[..., 0, :], t2[..., 1, :],
                                         t2[..., 2, :])
            g_tri_fp, g_pts_fp = torch.autograd.grad(d2, (t2, p2), w_fp)

        # both triangle gradients into the vertices, then the face → point
        # gradients into the points, each in a fixed order
        off = (torch.arange(b, device=verts.device) * n_v)[:, None, None]
        g_verts = scatter_add_rows(
            torch.zeros(b * n_v, 3, dtype=verts.dtype, device=verts.device),
            torch.cat([(f_pf.long() + off).reshape(-1),
                       (faces.long() + off).reshape(-1)]),
            torch.cat([g_tri_pf.reshape(-1, 3), g_tri_fp.reshape(-1, 3)]))
        n_p = points.shape[1]
        offp = (torch.arange(b, device=points.device) * n_p)[:, None]
        g_points = scatter_add_rows(g_points.reshape(-1, 3),
                                    (idx_fp.long() + offp).reshape(-1),
                                    g_pts_fp.reshape(-1, 3))
        return (g_verts.reshape(b, n_v, 3), g_points.reshape(b, n_p, 3),
                None, None, None, None)


def point_mesh_face_distance_fast(
    verts: torch.Tensor,
    faces: torch.Tensor,
    points: torch.Tensor,
    points_mask: Optional[torch.Tensor] = None,
    faces_mask: Optional[torch.Tensor] = None,
    chunk: int = 512,
) -> torch.Tensor:
    """Symmetric point↔mesh loss per object (B,): mean over points of the
    min face sq-distance plus mean over faces of the min point sq-distance,
    with the argmin-pair backward (O(P+F) work)."""
    pm = None if points_mask is None else points_mask.bool()
    fm = None if faces_mask is None else faces_mask.bool()
    return _PointMeshFaceDistance.apply(verts, points, faces, pm, fm, chunk)


def _masked_mean(d, mask):
    """Per-object mean over the last axis of (B, N), over the valid entries
    where a mask is given (at least one in the divisor)."""
    if mask is None:
        return d.mean(-1)
    d = torch.where(mask, d, torch.zeros_like(d))
    return d.sum(-1) / torch.clamp(mask.sum(-1), min=1)


def point_mesh_face_distance_topk(
    verts: torch.Tensor,
    faces: torch.Tensor,
    points: torch.Tensor,
    points_mask: Optional[torch.Tensor] = None,
    faces_mask: Optional[torch.Tensor] = None,
    k: int = 16,
    chunk: int = 2048,
) -> torch.Tensor:
    """Candidate-pruned symmetric point↔mesh loss per object (B,): each
    point's exact squared distance to the nearest of its ``k`` nearest faces
    by centroid (``knn_points``), and each face's to the nearest of its k
    nearest points, each term a mean over the valid entries. It equals the
    exact loss wherever the nearest face (point) is among the k. The
    minimum over candidates splits its gradient evenly among equal
    distances (``amin``), as JAX's ``min`` does."""
    tri = gather_faces(verts, faces)                      # (B, F, 3, 3)
    centroids = tri.mean(2)
    b, f = faces.shape[:2]
    n_p = points.shape[1]
    k, kp = min(k, f), min(k, n_p)
    with torch.no_grad():
        idx = torch.stack([knn_points(
            points[i], centroids[i], k,
            None if faces_mask is None else faces_mask[i].bool(), chunk)[1]
            for i in range(b)])                           # (B, P, k)
        pidx = torch.stack([knn_points(
            centroids[i], points[i], kp,
            None if points_mask is None else points_mask[i].bool(), chunk)[1]
            for i in range(b)])                           # (B, F, kp)

    # point → face: each point against its candidate triangles
    cand = gather_rows(tri, idx)                          # (B, P, k, 3, 3)
    d = point_triangle_distance(points[:, :, None, :], cand[..., 0, :],
                                cand[..., 1, :], cand[..., 2, :])
    if faces_mask is not None:
        d = torch.where(gather_rows(faces_mask.bool(), idx), d,
                        torch.full_like(d, _BIG))
    term_pf = _masked_mean(d.amin(-1), None if points_mask is None
                           else points_mask.bool())

    # face → point: each triangle against its candidate points
    cand_p = gather_rows(points, pidx)                    # (B, F, kp, 3)
    t = tri[:, :, None]
    d2 = point_triangle_distance(cand_p, t[..., 0, :], t[..., 1, :],
                                 t[..., 2, :])
    if points_mask is not None:
        d2 = torch.where(gather_rows(points_mask.bool(), pidx), d2,
                         torch.full_like(d2, _BIG))
    term_fp = _masked_mean(d2.amin(-1), None if faces_mask is None
                           else faces_mask.bool())
    return term_pf + term_fp
