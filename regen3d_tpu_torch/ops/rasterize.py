"""Differentiable soft silhouettes for the pose fit (counterpart of the
pose-fit subset of regen3d_tpu/ops/rasterize.py).

Every function takes a leading object axis: ``verts_screen`` (B, V, 3) as
``Camera.view_to_screen`` gives it, ``faces`` (B, F, 3) int, ``faces_mask``
(B, F) bool. Distances are in pytorch3d NDC units (the shorter image side
spans [-1, 1]), so sigma values carry over from the reference.

* :func:`soft_silhouette` is the exact streaming SoftRas: faces stream in
  chunks against the full pixel grid; each chunk is checkpointed, so backward
  recomputes its (pixels × chunk) planes instead of storing them.
* :func:`soft_silhouette_edge` is the tile-binned min-edge formulation in
  plain PyTorch; ``ops/silhouette_kernel.py`` runs the same binned tiles
  through the CUDA kernels.
* :func:`soft_silhouette_binned` is the exact SoftRas per 64² tile over
  the tile's top-K overlapping faces (the fit's ``use_binned_raster``).
* :func:`rasterize_hard` is the non-differentiable z-buffer (phase 6's fit
  GIFs, the bakes), with :func:`interpolate_attributes` and
  :func:`phong_shade` on its fragments; :func:`rasterize_hard_binned` is
  the same z-buffer per tile over the tile's overlapping faces, and
  :func:`rasterize_hard_auto` picks between them by the JAX package's rule
  (:func:`hard_raster_path`; phase 8's renders).
* :func:`render_points_soft` splats a point cloud (phase 8's debug renders).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from regen3d_tpu_torch.ops import clip, take_rows


def gather_faces(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """verts (B, V, C), faces (B, F, 3) → per-face corners (B, F, 3, C).
    The backward adds into the vertices in a fixed order."""
    return gather_rows(verts, faces)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...), idx (B, ...) → x[b, idx[b]] for every b. The backward
    adds in a fixed order (``ops.take_rows``), where the indexing backward's
    accumulating ``index_put_`` on the card does not."""
    b, n = x.shape[:2]
    off = (torch.arange(b, device=x.device) * n).reshape(
        -1, *([1] * (idx.dim() - 1)))
    return take_rows(x.reshape(b * n, *x.shape[2:]), idx.long() + off)


def _faces_mask(faces: torch.Tensor, faces_mask) -> torch.Tensor:
    if faces_mask is None:
        return torch.ones(faces.shape[:2], dtype=torch.bool,
                          device=faces.device)
    return faces_mask.bool()


def _pixel_grid(h: int, w: int, device=None) -> torch.Tensor:
    """(H*W, 2) pixel-centre coordinates (u, v)."""
    vv, uu = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32),
                            indexing="ij")
    return torch.stack([(uu + 0.5).reshape(-1), (vv + 0.5).reshape(-1)], -1)


def _point_segment_sqdist(p, a, b):
    """Squared 2D distance point→segment, broadcasting."""
    ab = b - a
    t = torch.sum((p - a) * ab, -1) / clip(torch.sum(ab * ab, -1), 1e-12)
    t = clip(t, 0.0, 1.0)
    d = p - (a + t[..., None] * ab)
    return torch.sum(d * d, -1)


def _edge_functions(p, v0, v1, v2):
    """Edge functions (cross-product z) e0, e1, e2 of p against the edges
    v0v1, v1v2, v2v0, and the doubled signed area; broadcasting."""
    def edge(a, b):
        return ((b[..., 0] - a[..., 0]) * (p[..., 1] - a[..., 1])
                - (b[..., 1] - a[..., 1]) * (p[..., 0] - a[..., 0]))

    area = ((v1[..., 0] - v0[..., 0]) * (v2[..., 1] - v0[..., 1])
            - (v1[..., 1] - v0[..., 1]) * (v2[..., 0] - v0[..., 0]))
    return edge(v0, v1), edge(v1, v2), edge(v2, v0), area


def _inside(e0, e1, e2, area):
    s = torch.sign(area)
    s = torch.where(s == 0, torch.ones_like(s), s)
    return (e0 * s >= 0) & (e1 * s >= 0) & (e2 * s >= 0)


def _barycentric(e0, e1, e2, area):
    """Screen barycentrics (weights of v0, v1, v2) from the edge functions."""
    denom = torch.where(area.abs() < 1e-12, torch.full_like(area, 1e-12), area)
    return torch.stack([e1 / denom, e2 / denom, e0 / denom], -1)


def _face_coverage(pix: torch.Tensor, tri: torch.Tensor):
    """Signed squared distance (negative inside) and inside mask for every
    (pixel, face): pix (..., P, 2), tri (..., C, 3, 2) → (..., P, C) each."""
    p = pix[..., :, None, :]                              # (..., P, 1, 2)
    v0 = tri[..., None, :, 0, :]                          # (..., 1, C, 2)
    v1 = tri[..., None, :, 1, :]
    v2 = tri[..., None, :, 2, :]
    inside = _inside(*_edge_functions(p, v0, v1, v2))
    d_edge = torch.minimum(_point_segment_sqdist(p, v0, v1),
                           torch.minimum(_point_segment_sqdist(p, v1, v2),
                                         _point_segment_sqdist(p, v2, v0)))
    return torch.where(inside, -d_edge, d_edge), inside


def _soft_chunk(pix, tri, mk, znear, ndc, sigma):
    """Σ over one face chunk of log(1 − sigmoid(−signed/σ)) → (B, P)."""
    ok = mk & torch.all(tri[..., 2] > znear, dim=-1)      # (B, C)
    signed, _ = _face_coverage(pix, tri[..., :2] * ndc)   # (B, P, C)
    contrib = -F.softplus(-signed / sigma)
    contrib = torch.where(ok[:, None, :], contrib, torch.zeros_like(contrib))
    return contrib.sum(-1)


def soft_silhouette(
    verts_screen: torch.Tensor,
    faces: torch.Tensor,
    image_hw: Tuple[int, int],
    sigma: float = 5e-7,
    faces_mask: Optional[torch.Tensor] = None,
    znear: float = 1e-3,
    chunk: int = 256,
) -> torch.Tensor:
    """Exact streaming SoftRas silhouette → alpha (B, H, W) in [0, 1]."""
    h, w = image_hw
    ndc = 2.0 / min(h, w)
    pix = _pixel_grid(h, w, verts_screen.device) * ndc
    f = faces.shape[1]
    chunk = min(chunk, f)
    tri3 = gather_faces(verts_screen, faces)              # (B, F, 3, 3)
    fmask = _faces_mask(faces, faces_mask)
    acc = torch.zeros(verts_screen.shape[0], h * w,
                      dtype=verts_screen.dtype, device=verts_screen.device)
    for c0 in range(0, f, chunk):
        part = checkpoint(_soft_chunk, pix, tri3[:, c0:c0 + chunk],
                          fmask[:, c0:c0 + chunk], znear, ndc, sigma,
                          use_reentrant=False)
        acc = acc + part
    return (1.0 - torch.exp(acc)).reshape(-1, h, w)


def face_edge_coeffs(tri2: torch.Tensor) -> torch.Tensor:
    """(..., F, 3, 2) triangles → (..., F, 3, 3) edge lines (a, b, c):
    a·px + b·py + c is the signed distance to the edge line, positive on the
    interior side."""
    v0 = tri2
    v1 = torch.roll(tri2, -1, dims=-2)
    d = v1 - v0
    # eps inside the sqrt: a zero-length edge has a finite gradient
    length = torch.sqrt(torch.sum(d * d, -1) + 1e-20)
    n = torch.stack([-d[..., 1], d[..., 0]], -1) / length[..., None]
    c = -torch.sum(n * v0, -1)
    area = ((tri2[..., 1, 0] - tri2[..., 0, 0]) * (tri2[..., 2, 1] - tri2[..., 0, 1])
            - (tri2[..., 1, 1] - tri2[..., 0, 1]) * (tri2[..., 2, 0] - tri2[..., 0, 0]))
    s = torch.where(area >= 0, 1.0, -1.0)[..., None]
    return torch.cat([n * s[..., None], (c * s)[..., None]], -1)


def edge_face_setup(verts_screen, faces, image_hw, faces_mask, znear):
    """Shared set-up of the edge paths: (coeffs (B, F, 3, 3), ok (B, F)).
    Faces behind znear, masked or of zero area are not ok."""
    h, w = image_hw
    ndc = 2.0 / min(h, w)
    tri = gather_faces(verts_screen, faces)
    ok = _faces_mask(faces, faces_mask) & torch.all(tri[..., 2] > znear, -1)
    tri2 = tri[..., :2] * ndc
    area2 = ((tri2[..., 1, 0] - tri2[..., 0, 0]) * (tri2[..., 2, 1] - tri2[..., 0, 1])
             - (tri2[..., 1, 1] - tri2[..., 0, 1])
             * (tri2[..., 2, 0] - tri2[..., 0, 0]))
    # a zero-area face has edge distance 0 everywhere and would darken its tile
    ok = ok & (area2.abs() > 1e-14)
    return face_edge_coeffs(tri2), ok


def _edge_contrib(pix_h, coeffs, valid, sigma):
    """Σ_f log(1 − p_f) over pixel sets × face sets, min-edge distance.

    pix_h (S, P, 3) homogeneous NDC pixels; coeffs (B, S, K, 3, 3);
    valid (B, S, K) → (B, S, P)."""
    px = pix_h[None, :, :, 0:1]                           # (1, S, P, 1)
    py = pix_h[None, :, :, 1:2]
    A = coeffs[:, :, None]                                # (B, S, 1, K, 3, 3)

    def e(j):
        return px * A[..., j, 0] + (py * A[..., j, 1] + A[..., j, 2])

    dmin = torch.minimum(e(0), torch.minimum(e(1), e(2)))  # (B, S, P, K)
    contrib = -F.softplus(dmin * dmin.abs() / sigma)
    contrib = torch.where(valid[:, :, None, :], contrib,
                          torch.zeros_like(contrib))
    return contrib.sum(-1)


def soft_silhouette_edge(
    verts_screen: torch.Tensor,
    faces: torch.Tensor,
    image_hw: Tuple[int, int],
    sigma: float = 5e-7,
    faces_mask: Optional[torch.Tensor] = None,
    znear: float = 1e-3,
    tile: int = 64,
    faces_per_tile: int = 128,
    tiles_per_step: int = 8,
    bins: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Tile-binned min-edge soft silhouette in plain PyTorch → (B, H, W)."""
    h, w = image_hw
    ndc = 2.0 / min(h, w)
    coeffs, ok = edge_face_setup(verts_screen, faces, image_hw, faces_mask,
                                 znear)
    if bins is None:
        bins = compute_silhouette_bins(verts_screen, faces, image_hw, sigma,
                                       faces_mask, znear, tile, faces_per_tile)
    sel_idx, sel_valid = bins
    nty, ntx = h // tile, w // tile
    n_tiles = nty * ntx
    dev = verts_screen.device
    base = _pixel_grid(tile, tile, dev)
    tids = torch.arange(n_tiles, device=dev)
    tile_off = torch.stack([(tids % ntx) * tile, (tids // ntx) * tile], -1)

    def step(idxs, valids, offs):
        co = gather_rows(coeffs, idxs)                     # (B, S, K, 3, 3)
        va = valids & gather_rows(ok, idxs)
        pix = (base[None] + offs[:, None, :].to(base.dtype)) * ndc
        pix_h = torch.cat([pix, torch.ones_like(pix[..., :1])], -1)
        return _edge_contrib(pix_h, co, va, sigma)

    accs = [checkpoint(step, sel_idx[:, t0:t0 + tiles_per_step],
                       sel_valid[:, t0:t0 + tiles_per_step],
                       tile_off[t0:t0 + tiles_per_step], use_reentrant=False)
            for t0 in range(0, n_tiles, tiles_per_step)]
    acc = _untile(torch.cat(accs, 1), image_hw, tile)      # (B, H·W)
    return (1.0 - torch.exp(acc)).reshape(-1, h, w)


def _tile_overlap(tri: torch.Tensor, ok: torch.Tensor,
                  image_hw: Tuple[int, int], tile: int, pad) -> torch.Tensor:
    """Which faces' screen bounding boxes, grown by ``pad`` pixels, overlap
    each ``tile``² tile: tri (B, F, 3, ≥2) screen corners, ok (B, F) →
    (B, T, F) bool, tiles in row-major order. Faces not ok overlap none."""
    h, w = image_hw
    dev = tri.device
    uv = tri[..., :2]
    big = torch.tensor(1e9, dtype=uv.dtype, device=dev)
    lo = torch.where(ok[..., None], uv.min(2).values - pad, big)
    hi = torch.where(ok[..., None], uv.max(2).values + pad, -big)
    nty, ntx = h // tile, w // tile
    ty = torch.arange(nty, device=dev) * tile
    tx = torch.arange(ntx, device=dev) * tile
    ov_x = ((lo[:, None, :, 0] < (tx[:, None] + tile))
            & (hi[:, None, :, 0] > tx[:, None]))          # (B, ntx, F)
    ov_y = ((lo[:, None, :, 1] < (ty[:, None] + tile))
            & (hi[:, None, :, 1] > ty[:, None]))          # (B, nty, F)
    return (ov_y[:, :, None, :] & ov_x[:, None, :, :]).reshape(
        tri.shape[0], nty * ntx, -1)


def _top_overlapping(overlap: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first ``k`` overlapping faces of each tile by index →
    (idx (B, T, k) int32, valid (B, T, k) bool).

    ``lax.top_k`` puts the lowest index first among equal scores, and the
    overlap scores are 0/1, so almost everything ties: a stable descending
    sort keeps exactly the lowest-index overlapping faces, as JAX does
    (``torch.topk`` promises no order among ties)."""
    score, idx = torch.sort(overlap.to(torch.uint8), dim=-1, descending=True,
                            stable=True)
    return idx[..., :k].int(), score[..., :k] > 0


def compute_silhouette_bins(
    verts_screen: torch.Tensor,
    faces: torch.Tensor,
    image_hw: Tuple[int, int],
    sigma: float = 5e-7,
    faces_mask: Optional[torch.Tensor] = None,
    znear: float = 1e-3,
    tile: int = 64,
    faces_per_tile: int = 128,
    margin_px: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-K overlapping faces per image tile → (sel_idx, valid), (B, T, K):
    the face bounding boxes grown by the sigma falloff, a pixel and
    ``margin_px``, the lowest-index faces first."""
    h, w = image_hw
    ndc = 2.0 / min(h, w)
    k = min(faces_per_tile, faces.shape[1])
    with torch.no_grad():
        tri = gather_faces(verts_screen, faces)
        ok = _faces_mask(faces, faces_mask) & torch.all(tri[..., 2] > znear, -1)
        # f32 arithmetic throughout, as the JAX function rounds it
        pad_px = (torch.sqrt(torch.tensor(sigma * 20.0, dtype=torch.float32,
                                          device=tri.device)) / ndc
                  + 1.0 + margin_px)
        return _top_overlapping(_tile_overlap(tri, ok, image_hw, tile, pad_px),
                                k)


def _tile_pixels(image_hw: Tuple[int, int], tile: int, device
                 ) -> torch.Tensor:
    """The pixel centres of each ``tile``² tile, (T, tile², 2), tiles and
    the pixels in each in row-major order: the dense grid's own values."""
    h, w = image_hw
    pix = _pixel_grid(h, w, device).reshape(h // tile, tile, w // tile, tile, 2)
    return pix.permute(0, 2, 1, 3, 4).reshape(-1, tile * tile, 2)


def _untile(x: torch.Tensor, image_hw: Tuple[int, int], tile: int
            ) -> torch.Tensor:
    """(B, T, tile², ...) per-tile values → (B, H·W, ...) in image order."""
    h, w = image_hw
    nty, ntx = h // tile, w // tile
    rest = x.shape[3:]
    x = x.reshape(x.shape[0], nty, ntx, tile, tile, *rest)
    return x.transpose(2, 3).reshape(x.shape[0], h * w, *rest)


def soft_silhouette_binned(
    verts_screen: torch.Tensor,
    faces: torch.Tensor,
    image_hw: Tuple[int, int],
    sigma: float = 5e-7,
    faces_mask: Optional[torch.Tensor] = None,
    znear: float = 1e-3,
    tile: int = 64,
    faces_per_tile: int = 256,
    tiles_per_step: int = 8,
) -> torch.Tensor:
    """Tile-binned exact SoftRas silhouette → alpha (B, H, W): each ``tile``²
    tile sums log(1 − sigmoid(−signed/σ)) over its top-K overlapping faces
    (:func:`compute_silhouette_bins` without a margin), which equals
    :func:`soft_silhouette` where K covers every overlapping face. Each step
    of ``tiles_per_step`` tiles is checkpointed, so backward recomputes its
    (pixels × K) planes instead of storing them."""
    h, w = image_hw
    assert h % tile == 0 and w % tile == 0, "image must be tile-aligned"
    ndc = 2.0 / min(h, w)
    sel_idx, sel_valid = compute_silhouette_bins(
        verts_screen, faces, image_hw, sigma, faces_mask, znear, tile,
        faces_per_tile)
    tri2 = gather_faces(verts_screen, faces)[..., :2] * ndc   # (B, F, 3, 2)
    pix = _tile_pixels(image_hw, tile, verts_screen.device) * ndc

    def step(idxs, valids, pix_s):
        signed, _ = _face_coverage(pix_s, gather_rows(tri2, idxs))
        contrib = -F.softplus(-signed / sigma)               # (B, S, P, K)
        contrib = torch.where(valids[:, :, None, :], contrib,
                              torch.zeros_like(contrib))
        return contrib.sum(-1)

    n_tiles = pix.shape[0]
    accs = [checkpoint(step, sel_idx[:, t0:t0 + tiles_per_step],
                       sel_valid[:, t0:t0 + tiles_per_step],
                       pix[t0:t0 + tiles_per_step], use_reentrant=False)
            for t0 in range(0, n_tiles, tiles_per_step)]
    acc = _untile(torch.cat(accs, 1), image_hw, tile)
    return (1.0 - torch.exp(acc)).reshape(-1, h, w)


_BIG = 1e30


class Fragments(NamedTuple):
    """Per-pixel hard z-buffer output for a batch of objects."""

    face_idx: torch.Tensor  # (B, H, W) int32, -1 = background
    bary: torch.Tensor      # (B, H, W, 3) perspective-corrected barycentrics
    depth: torch.Tensor     # (B, H, W) view-space z (+inf = background)


def _hard_pairs(p, tri, ok):
    """The perspective-correct depth of every (pixel, face) pair, _BIG where
    the face does not cover the pixel or is not ok: p (..., P, 1, 2), tri
    (..., 1, C, 3, 3), ok (..., 1, C) → (..., P, C). The dense and the
    binned z-buffers both call it, so a pair's depth is the same float on
    either path; 1/z's three terms are added left to right, as the JAX
    package's reduction adds them."""
    v = [tri[..., j, :2] for j in range(3)]
    e0, e1, e2, area = _edge_functions(p, *v)
    denom = torch.where(area.abs() < 1e-12, torch.full_like(area, 1e-12), area)
    # 1/z interpolates linearly on screen
    inv_z = (e1 / denom / tri[..., 0, 2] + e2 / denom / tri[..., 1, 2]
             + e0 / denom / tri[..., 2, 2])
    zpix = 1.0 / torch.clamp_min(inv_z, 1e-12)
    covered = _inside(e0, e1, e2, area) & ok
    return torch.where(covered, zpix, torch.full_like(zpix, _BIG))


def _fold_min(zpix, ids, best_z, best_i):
    """Fold one chunk's (..., C) depths, their face ids (..., C) or the
    chunk's first id, into the running z-buffer: the first index among
    equal depths in the chunk, the earlier chunk on a tie across chunks."""
    zmin, imin = zpix.min(-1)
    fid = (imin.int() + ids if not torch.is_tensor(ids)
           else torch.gather(ids, -1, imin[..., None])[..., 0])
    take = zmin < best_z
    return torch.where(take, zmin, best_z), torch.where(take, fid, best_i)


def rasterize_hard(
    verts_screen: torch.Tensor,
    faces: torch.Tensor,
    image_hw: Tuple[int, int],
    faces_mask: Optional[torch.Tensor] = None,
    znear: float = 1e-3,
    chunk: int = 256,
) -> Fragments:
    """Non-differentiable z-buffer: for each pixel the nearest covering face
    (perspective-correct depth), the lowest face index among equal depths,
    as JAX's chunked argmin (first within a chunk, strict ``<`` across
    chunks) gives it. Every pixel is tested against every face."""
    h, w = image_hw
    pix = _pixel_grid(h, w, verts_screen.device)
    p = pix[:, None, :]
    f = faces.shape[1]
    chunk = min(chunk, f)
    tri3 = gather_faces(verts_screen, faces)              # (B, F, 3, 3)
    fmask = _faces_mask(faces, faces_mask)
    best_z = torch.full(verts_screen.shape[:1] + (h * w,), _BIG,
                        dtype=verts_screen.dtype, device=verts_screen.device)
    best_i = torch.full_like(best_z, -1, dtype=torch.int32)
    with torch.no_grad():
        for c0 in range(0, f, chunk):
            tri = tri3[:, c0:c0 + chunk]
            ok = fmask[:, c0:c0 + chunk] & torch.all(tri[..., 2] > znear, -1)
            zpix = _hard_pairs(p, tri[:, None], ok[:, None, :])
            best_z, best_i = _fold_min(zpix, c0, best_z, best_i)
        return _fragments_from_zbuffer(verts_screen, faces, best_z, best_i,
                                       image_hw)


def _hard_overlap(verts_screen, faces, image_hw, faces_mask, znear, tile):
    """(corners (B, F, 3, 3), tile overlap (B, T, F)) of the hard z-buffer's
    binning: bounding boxes grown by one pixel; a masked face, or one with a
    corner at or before ``znear``, overlaps no tile."""
    tri = gather_faces(verts_screen, faces)
    ok = _faces_mask(faces, faces_mask) & torch.all(tri[..., 2] > znear, -1)
    return tri, _tile_overlap(tri, ok, image_hw, tile, 1.0)


def _binned_zbuffer(verts_screen, faces, image_hw, tri, overlap, k, tile,
                    tiles_per_step=8, chunk=512) -> Fragments:
    """The binned z-buffer from _hard_overlap's corners and overlap, ``k``
    candidates a tile."""
    dev = verts_screen.device
    sel_idx, sel_ok = _top_overlapping(overlap, k)                # (B, T, K)
    pix = _tile_pixels(image_hw, tile, dev)                       # (T, P, 2)
    b, n_tiles = sel_idx.shape[:2]
    zs, ids = [], []
    for t0 in range(0, n_tiles, tiles_per_step):
        idx = sel_idx[:, t0:t0 + tiles_per_step]
        p = pix[t0:t0 + tiles_per_step][None, :, :, None, :]
        best_z = torch.full((b,) + p.shape[1:3], _BIG,
                            dtype=verts_screen.dtype, device=dev)
        best_i = torch.full_like(best_z, -1, dtype=torch.int32)
        for c0 in range(0, k, chunk):
            ic = idx[..., c0:c0 + chunk]                          # (B, S, C)
            zpix = _hard_pairs(
                p, gather_rows(tri, ic)[:, :, None],
                sel_ok[:, t0:t0 + tiles_per_step, None, c0:c0 + chunk])
            best_z, best_i = _fold_min(
                zpix, ic[:, :, None, :].expand(zpix.shape), best_z, best_i)
        zs.append(best_z)
        ids.append(best_i)
    z = _untile(torch.cat(zs, 1), image_hw, tile)
    fid = _untile(torch.cat(ids, 1), image_hw, tile)
    return _fragments_from_zbuffer(verts_screen, faces, z, fid, image_hw)


def rasterize_hard_binned(
    verts_screen: torch.Tensor,
    faces: torch.Tensor,
    image_hw: Tuple[int, int],
    faces_mask: Optional[torch.Tensor] = None,
    znear: float = 1e-3,
    tile: int = 64,
    faces_per_tile: int = 256,
    tiles_per_step: int = 8,
    chunk: int = 512,
) -> Fragments:
    """Tile-binned z-buffer: each ``tile``² tile tests its pixels against
    only the first ``faces_per_tile`` faces (by index) whose bounding box,
    grown by a pixel, overlaps it, ``chunk`` of them at a time over
    ``tiles_per_step`` tiles. A pair's depth is computed as the dense path
    computes it (:func:`_hard_pairs`) and the candidates are in ascending
    index order, so where ``faces_per_tile`` ≥ :func:`max_faces_per_tile`
    the fragments equal :func:`rasterize_hard`'s bit for bit."""
    h, w = image_hw
    assert h % tile == 0 and w % tile == 0, "image must be tile-aligned"
    with torch.no_grad():
        tri, overlap = _hard_overlap(verts_screen, faces, image_hw,
                                     faces_mask, znear, tile)
        return _binned_zbuffer(verts_screen, faces, image_hw, tri, overlap,
                               min(faces_per_tile, faces.shape[1]), tile,
                               tiles_per_step, chunk)


def max_faces_per_tile(
    verts_screen: torch.Tensor,
    faces: torch.Tensor,
    image_hw: Tuple[int, int],
    faces_mask: Optional[torch.Tensor] = None,
    znear: float = 1e-3,
    tile: int = 64,
) -> torch.Tensor:
    """Each object's largest count of faces overlapping one tile, (B,): the
    ``faces_per_tile`` that makes :func:`rasterize_hard_binned` lossless."""
    with torch.no_grad():
        overlap = _hard_overlap(verts_screen, faces, image_hw, faces_mask,
                                znear, tile)[1]
        return overlap.sum(-1, dtype=torch.int32).max(-1).values


# the binned z-buffer's faces per tile: the smallest bucket ≥ the true
# count is taken, and above the last the dense path runs
_K_BUCKETS = (128, 256, 512, 1024, 2048)


class RasterPath(NamedTuple):
    """Which z-buffer :func:`rasterize_hard_auto` runs: ``path`` "dense" or
    "binned", ``k`` the binned path's faces per tile (None when dense) and
    ``kmax`` the measured per-tile maximum (None where it was not needed)."""

    path: str
    k: Optional[int]
    kmax: Optional[int]


def _dense_by_shape(image_hw, n_faces: int, tile: int) -> bool:
    h, w = image_hw
    return bool(h % tile or w % tile or n_faces <= 2 * _K_BUCKETS[0])


def _path_for(kmax: int, n_faces: int) -> RasterPath:
    k = next((b for b in _K_BUCKETS if b >= kmax), None)
    if k is None or k >= n_faces:
        return RasterPath("dense", None, kmax)
    return RasterPath("binned", k, kmax)


def hard_raster_path(
    verts_screen: torch.Tensor,
    faces: torch.Tensor,
    image_hw: Tuple[int, int],
    faces_mask: Optional[torch.Tensor] = None,
    znear: float = 1e-3,
    tile: int = 64,
) -> RasterPath:
    """The JAX package's dispatch rule: the dense z-buffer when the image is
    not tile-aligned, when there are at most 2·128 faces, when the largest
    per-tile overlap exceeds the last bucket (2048) or when its bucket is
    not below the face count; else the binned path at that bucket. The
    overlap is the largest over the batch."""
    if _dense_by_shape(image_hw, faces.shape[1], tile):
        return RasterPath("dense", None, None)
    kmax = int(max_faces_per_tile(verts_screen, faces, image_hw, faces_mask,
                                  znear, tile).max())
    return _path_for(kmax, faces.shape[1])


def rasterize_hard_auto(
    verts_screen: torch.Tensor,
    faces: torch.Tensor,
    image_hw: Tuple[int, int],
    faces_mask: Optional[torch.Tensor] = None,
    znear: float = 1e-3,
    chunk: int = 256,
    tile: int = 64,
) -> Fragments:
    """:func:`rasterize_hard` or :func:`rasterize_hard_binned`, as
    :func:`hard_raster_path` decides (it reads the overlap on the host); the
    binned path reuses the overlap the decision counted."""
    if not _dense_by_shape(image_hw, faces.shape[1], tile):
        with torch.no_grad():
            tri, overlap = _hard_overlap(verts_screen, faces, image_hw,
                                         faces_mask, znear, tile)
            path = _path_for(int(overlap.sum(-1, dtype=torch.int32).max()),
                             faces.shape[1])
            if path.path == "binned":
                return _binned_zbuffer(verts_screen, faces, image_hw, tri,
                                       overlap, path.k, tile)
        del tri, overlap
    return rasterize_hard(verts_screen, faces, image_hw, faces_mask, znear,
                          chunk)


def _fragments_from_zbuffer(verts_screen, faces, z, fid, image_hw
                            ) -> Fragments:
    """The winning faces' perspective-corrected barycentrics from a flat
    (B, H·W) depth and face-id buffer."""
    h, w = image_hw
    pix = _pixel_grid(h, w, verts_screen.device)
    f = faces.shape[1]
    safe = torch.clamp(fid, 0, f - 1)
    tri_win = gather_faces(verts_screen, gather_rows(faces, safe))  # (B, P, 3, 3)
    v = [tri_win[..., j, :2] for j in range(3)]
    bary_screen = _barycentric(*_edge_functions(pix, *v))
    wgt = bary_screen / torch.clamp_min(tri_win[..., 2], 1e-12)
    persp = wgt / torch.clamp_min(wgt.sum(-1, keepdim=True), 1e-12)
    bg = fid < 0
    b = fid.shape[0]
    return Fragments(
        face_idx=fid.reshape(b, h, w),
        bary=torch.where(bg[..., None], torch.zeros_like(persp),
                         persp).reshape(b, h, w, 3),
        depth=torch.where(bg, torch.full_like(z, float("inf")),
                          z).reshape(b, h, w))


def interpolate_attributes(frag: Fragments, faces: torch.Tensor,
                           vertex_attrs: torch.Tensor) -> torch.Tensor:
    """Barycentric blend of per-vertex attributes (B, V, D) at each pixel →
    (B, H, W, D), zeros on the background."""
    b, h, w = frag.face_idx.shape
    fid = frag.face_idx.reshape(b, -1)
    tri_attr = gather_faces(vertex_attrs,
                            gather_rows(faces, torch.clamp_min(fid, 0)))
    out = torch.einsum("bpk,bpkd->bpd", frag.bary.reshape(b, -1, 3), tri_attr)
    out = torch.where((fid >= 0)[..., None], out, torch.zeros_like(out))
    return out.reshape(b, h, w, -1)


def phong_shade(
    frag: Fragments,
    faces: torch.Tensor,
    verts_world: torch.Tensor,
    normals_world: torch.Tensor,
    colors: torch.Tensor,
    light_pos: torch.Tensor,
    camera_pos: torch.Tensor,
    ambient: float = 0.35,
    diffuse: float = 0.6,
    specular: float = 0.15,
    shininess: float = 32.0,
    background: float = 1.0,
) -> torch.Tensor:
    """Per-pixel Phong shading → (B, H, W, 3) in [0, 1] (pytorch3d
    HardPhongShader + PointLights; reference render_utils.py:108-119).
    ``light_pos`` and ``camera_pos`` are (3,), shared by the batch."""
    pos = interpolate_attributes(frag, faces, verts_world)
    nrm = interpolate_attributes(frag, faces, normals_world)
    col = interpolate_attributes(frag, faces, colors)

    def unit(x):
        return x / torch.clamp_min(torch.linalg.norm(x, dim=-1, keepdim=True),
                                   1e-8)

    n, l, v = unit(nrm), unit(light_pos - pos), unit(camera_pos - pos)
    ndl = (n * l).sum(-1, keepdim=True)
    refl = 2 * ndl * n - l
    spec = torch.clamp_min((refl * v).sum(-1, keepdim=True), 0.0) ** shininess
    shaded = col * (ambient + diffuse * ndl.abs()) + specular * spec
    bg = (frag.face_idx < 0)[..., None]
    return torch.clamp(torch.where(bg, torch.full_like(shaded, background),
                                   shaded), 0.0, 1.0)


def render_points_soft(
    points_screen: torch.Tensor,
    image_hw: Tuple[int, int],
    radius_px: float = 3.0,
    colors: Optional[torch.Tensor] = None,
    points_mask: Optional[torch.Tensor] = None,
    chunk: int = 1024,
    znear: float = 1e-3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Point splats (pytorch3d PointsRasterizer's role; reference
    render_utils.py:122-140): points_screen (B, N, 3) → (rgb (B, H, W, 3),
    alpha (B, H, W)). Each pixel takes the colour of the nearest point in z
    whose disc of ``radius_px`` covers it (the first index on a tie, white
    where none does), and alpha = 1 − Π(1 − cover) with cover = 1 − d²/r²
    clipped below 1, summed as logs, ``chunk`` points at a time."""
    h, w = image_hw
    dev = points_screen.device
    pix = _pixel_grid(h, w, dev)
    b, n = points_screen.shape[:2]
    chunk = min(chunk, n)
    pmask = (torch.ones((b, n), dtype=torch.bool, device=dev)
             if points_mask is None else points_mask.bool())
    cols = (torch.full((b, n, 3), 0.5, dtype=points_screen.dtype, device=dev)
            if colors is None else colors)
    r2 = radius_px * radius_px
    best_z = torch.full((b, h * w), _BIG, dtype=points_screen.dtype,
                        device=dev)
    best_rgb = torch.ones((b, h * w, 3), dtype=points_screen.dtype,
                          device=dev)
    acc = torch.zeros((b, h * w), dtype=points_screen.dtype, device=dev)
    with torch.no_grad():
        for c0 in range(0, n, chunk):
            pc = points_screen[:, None, c0:c0 + chunk]        # (B, 1, C, 3)
            dx = pix[:, None, 0] - pc[..., 0]
            dy = pix[:, None, 1] - pc[..., 1]
            d2 = dx * dx + dy * dy                            # (B, P, C)
            hit = ((d2 <= r2) & pmask[:, None, c0:c0 + chunk]
                   & (pc[..., 2] > znear))
            z = torch.where(hit, pc[..., 2], torch.full_like(d2, _BIG))
            zmin, imin = z.min(-1)
            rgb = gather_rows(cols[:, c0:c0 + chunk], imin)
            take = zmin < best_z
            best_z = torch.where(take, zmin, best_z)
            best_rgb = torch.where(take[..., None], rgb, best_rgb)
            cover = torch.where(hit, 1.0 - d2 / r2, torch.zeros_like(d2))
            acc = acc + torch.log1p(-torch.clamp_max(cover, 1 - 1e-6)).sum(-1)
        alpha = 1.0 - torch.exp(acc)
        rgb = torch.where((best_z < _BIG)[..., None], best_rgb,
                          torch.ones_like(best_rgb))
        return rgb.reshape(b, h, w, 3), alpha.reshape(b, h, w)
