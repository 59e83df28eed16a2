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
* :func:`rasterize_hard` is the non-differentiable z-buffer (phase 6's fit
  GIFs, phase 8), with :func:`interpolate_attributes` and
  :func:`phong_shade` on its fragments.
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
    (pixel, face): pix (P, 2), tri (..., C, 3, 2) → (..., P, C) each."""
    p = pix[:, None, :]                                   # (P, 1, 2)
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
    acc = torch.cat(accs, 1)                               # (B, T, P)
    alpha = (1.0 - torch.exp(acc)).reshape(-1, nty, ntx, tile, tile)
    return alpha.permute(0, 1, 3, 2, 4).reshape(-1, h, w)


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
    """Top-K overlapping faces per image tile → (sel_idx, valid), (B, T, K).

    ``lax.top_k`` puts the lowest index first among equal scores, and the
    overlap scores are 0/1, so almost everything ties: a stable descending
    sort keeps exactly the lowest-index overlapping faces, as JAX does
    (``torch.topk`` promises no order among ties)."""
    h, w = image_hw
    ndc = 2.0 / min(h, w)
    f = faces.shape[1]
    k = min(faces_per_tile, f)
    dev = verts_screen.device
    with torch.no_grad():
        tri = gather_faces(verts_screen, faces)
        ok = _faces_mask(faces, faces_mask) & torch.all(tri[..., 2] > znear, -1)
        # f32 arithmetic throughout, as the JAX function rounds it
        pad_px = (torch.sqrt(torch.tensor(sigma * 20.0, dtype=torch.float32,
                                          device=dev)) / ndc + 1.0 + margin_px)
        uv = tri[..., :2]
        big = torch.tensor(1e9, dtype=uv.dtype, device=dev)
        lo = torch.where(ok[..., None], uv.min(2).values - pad_px, big)
        hi = torch.where(ok[..., None], uv.max(2).values + pad_px, -big)
        nty, ntx = h // tile, w // tile
        ty = torch.arange(nty, device=dev) * tile
        tx = torch.arange(ntx, device=dev) * tile
        ov_x = ((lo[:, None, :, 0] < (tx[:, None] + tile))
                & (hi[:, None, :, 0] > tx[:, None]))          # (B, ntx, F)
        ov_y = ((lo[:, None, :, 1] < (ty[:, None] + tile))
                & (hi[:, None, :, 1] > ty[:, None]))          # (B, nty, F)
        overlap = (ov_y[:, :, None, :] & ov_x[:, None, :, :]).reshape(
            -1, nty * ntx, f)
        score, idx = torch.sort(overlap.float(), dim=-1, descending=True,
                                stable=True)
        return idx[..., :k].int(), score[..., :k] > 0.5


_BIG = 1e30


class Fragments(NamedTuple):
    """Per-pixel hard z-buffer output for a batch of objects."""

    face_idx: torch.Tensor  # (B, H, W) int32, -1 = background
    bary: torch.Tensor      # (B, H, W, 3) perspective-corrected barycentrics
    depth: torch.Tensor     # (B, H, W) view-space z (+inf = background)


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
    chunks) gives it."""
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
            zs = tri[..., 2]                              # (B, C, 3)
            ok = fmask[:, c0:c0 + chunk] & torch.all(zs > znear, -1)
            v = [tri[:, None, :, j, :2] for j in range(3)]  # (B, 1, C, 2)
            e = _edge_functions(p, *v)
            bary = _barycentric(*e)                       # (B, P, C, 3)
            # perspective-correct depth: 1/z interpolates linearly on screen
            inv_z = (bary / zs[:, None]).sum(-1)
            zpix = 1.0 / torch.clamp_min(inv_z, 1e-12)
            covered = _inside(*e) & ok[:, None, :]
            zpix = torch.where(covered, zpix, torch.full_like(zpix, _BIG))
            zmin, imin = zpix.min(-1)
            take = zmin < best_z
            best_z = torch.where(take, zmin, best_z)
            best_i = torch.where(take, imin.int() + c0, best_i)
        return _fragments_from_zbuffer(verts_screen, faces, best_z, best_i,
                                       image_hw)


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
