"""Tile-binned edge silhouette on the CUDA kernels (counterpart of
regen3d_tpu/ops/pallas_rasterize.py).

The tile function, per 32×32 tile (P = 1024 pixels) and its K binned faces:
``acc[p] = −Σ_k valid_k·softplus(z)`` with ``z = d·|d|/σ``, ``d`` the
smallest of the three edge values; the caller takes ``alpha = 1 − exp(acc)``.
Its backward routes ``g·(−sigmoid(z))·2|d|/σ·valid`` to the argmin edge and
returns the edge-coefficient gradients; vertex gradients then flow through
autograd of :func:`face_edge_coeffs` and the bin gather.

``silhouette_tiles_fwd`` / ``silhouette_tiles_bwd`` launch the kernels of
``csrc/silhouette.cu`` on CUDA tensors and run the plain PyTorch versions
beside them (``*_plain``) on CPU tensors. One launch covers every object.
Everything is f32; the backward's sums must not go through TF32.

The kernels skip every (face, 8×8 pixel block) pair whose terms are all
exactly 0 in f32 (``z ≤ Z_CUT`` at every pixel of the block);
:func:`silhouette_cull_plain` repeats that decision for the tests.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from regen3d_tpu_torch import kernels
from regen3d_tpu_torch.ops.rasterize import (
    compute_silhouette_bins,
    edge_face_setup,
    gather_rows,
)

TILE = 32
P = TILE * TILE
_PLAIN_BLOCKS = 64      # tiles per step of the plain version (bounds memory)
# f32 exp, softplus and sigmoid are exactly 0 at and below this z
Z_CUT = -105.0
CULL_BLOCK = 8          # side of the kernels' pixel blocks


def _base_pix(ndc: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(P,) NDC offsets (pu, pv) of a tile's pixels; flat p = v·TILE + u."""
    p = torch.arange(P, device=device)
    pu = ((p % TILE).float() + 0.5) * ndc
    pv = ((p // TILE).float() + 0.5) * ndc
    return pu, pv


def _edges(coeffs, uv, pu, pv):
    """Edge values (n, 3K, P), origin folded into c as the kernel does."""
    a, b, c = coeffs[..., 0:1], coeffs[..., 1:2], coeffs[..., 2:3]
    c2 = a * uv[:, None, 0:1] + b * uv[:, None, 1:2] + c
    return a * pu + b * pv + c2


def _nonempty(nvalid):
    return torch.nonzero(nvalid > 0).flatten()


def silhouette_tiles_fwd_plain(nvalid, coeffs, valid, tile_uv, inv_sigma,
                               ndc):
    """Plain version of the forward tile function: (N, P) accumulators.

    nvalid (N,) i32, coeffs (N, 3K, 3) edge-major, valid (N, K) f32,
    tile_uv (T, 2) with N a multiple of T (objects × tiles)."""
    n, k = valid.shape
    pu, pv = _base_pix(ndc, coeffs.device)
    acc = torch.zeros(n, P, dtype=torch.float32, device=coeffs.device)
    rows = _nonempty(nvalid)
    for s in range(0, rows.numel(), _PLAIN_BLOCKS):
        r = rows[s:s + _PLAIN_BLOCKS]
        e = _edges(coeffs[r], tile_uv[r % tile_uv.shape[0]], pu, pv)
        dmin = torch.minimum(e[:, :k], torch.minimum(e[:, k:2 * k], e[:, 2 * k:]))
        z = dmin * dmin.abs() * inv_sigma
        contrib = valid[r][:, :, None] * torch.nn.functional.softplus(z)
        acc[r] = -contrib.sum(1)
    return acc


def silhouette_tiles_bwd_plain(nvalid, coeffs, valid, tile_uv, g, inv_sigma,
                               ndc):
    """Plain version of the backward tile function: g (N, P) → dc (N, 3K, 3)."""
    n, k = valid.shape
    pu, pv = _base_pix(ndc, coeffs.device)
    dc = torch.zeros_like(coeffs)
    rows = _nonempty(nvalid)
    for s in range(0, rows.numel(), _PLAIN_BLOCKS):
        r = rows[s:s + _PLAIN_BLOCKS]
        uv = tile_uv[r % tile_uv.shape[0]]
        e = _edges(coeffs[r], uv, pu, pv)
        e0, e1, e2 = e[:, :k], e[:, k:2 * k], e[:, 2 * k:]
        dmin = torch.minimum(e0, torch.minimum(e1, e2))
        z = dmin * dmin.abs() * inv_sigma
        sv = (g[r][:, None, :] * (-torch.sigmoid(z))
              * (2.0 * dmin.abs() * inv_sigma) * valid[r][:, :, None])
        # argmin-edge routing, ties broken left to right
        m0 = (e0 == dmin).float()
        m1 = torch.where(e1 == dmin, 1.0 - m0, torch.zeros_like(m0))
        m2 = torch.clamp(1.0 - m0 - m1, min=0.0)
        S = torch.cat([sv * m0, sv * m1, sv * m2], 1)        # (n, 3K, P)
        rowsum = S.sum(-1)
        du = (S * pu).sum(-1) + uv[:, None, 0] * rowsum
        dv = (S * pv).sum(-1) + uv[:, None, 1] * rowsum
        dc[r] = torch.stack([du, dv, rowsum], -1)
    return dc


def pixel_blocks(device=None) -> torch.Tensor:
    """(P,) the 8×8 pixel block (by·4 + bx) of each tile pixel p = v·TILE + u,
    as :func:`silhouette_cull_plain` numbers them."""
    p = torch.arange(P, device=device)
    n = TILE // CULL_BLOCK
    return (p // TILE // CULL_BLOCK) * n + (p % TILE) // CULL_BLOCK


def silhouette_cull_radius(inv_sigma: float) -> np.float32:
    """The kernels' cull radius in f32: sqrt(−Z_CUT / inv_sigma)·(1 + 2⁻¹⁰),
    each operation rounded as ``csrc/silhouette.cu::cull_radius`` rounds it.
    An edge value below −r gives z < Z_CUT."""
    q = np.float32(-Z_CUT) / np.float32(inv_sigma)
    return np.float32(np.sqrt(q)) * np.float32(1.0 + 2.0 ** -10)


def silhouette_cull_plain(nvalid, coeffs, valid, tile_uv, inv_sigma, ndc,
                          radius=None):
    """Which (row, face, 8×8 pixel block) pairs the kernels evaluate:
    (N, K, 16) bool, block index by·4 + bx. A pair is dropped when its row
    or face is empty, or when for some edge the value at the block's corner
    where the edge is largest, plus a margin for rounding, is below
    −``radius`` (default :func:`silhouette_cull_radius`). Every operation is
    rounded as the kernels round it, so the decision is theirs bit for bit.
    For the tests and the chip check; the port's path does not call it."""
    n, k = valid.shape
    dev = coeffs.device
    r = silhouette_cull_radius(inv_sigma) if radius is None else radius
    ndc_t = torch.tensor(ndc, dtype=torch.float32, device=dev)
    uv = tile_uv[torch.arange(n, device=dev) % tile_uv.shape[0]]
    a, b, c = coeffs[..., 0], coeffs[..., 1], coeffs[..., 2]     # (N, 3K)
    c2 = a * uv[:, 0:1] + b * uv[:, 1:2] + c
    xmax = (TILE - 1 + 0.5) * ndc_t
    margin = (a.abs() * xmax + b.abs() * xmax + c2.abs()) * 2.0 ** -20
    first = torch.arange(0, TILE, CULL_BLOCK, device=dev).float()
    lo = (first + 0.5) * ndc_t                                   # (4,)
    hi = (first + (CULL_BLOCK - 1) + 0.5) * ndc_t
    x = torch.where(a[..., None] >= 0, hi, lo)                   # (N, 3K, bx)
    y = torch.where(b[..., None] >= 0, hi, lo)                   # (N, 3K, by)
    top = (a[..., None, None] * x[..., None, :]
           + b[..., None, None] * y[..., :, None]) + c2[..., None, None]
    out = (top + margin[..., None, None]) < -float(r)            # (N, 3K, by, bx)
    out = out[:, :k] | out[:, k:2 * k] | out[:, 2 * k:]
    keep = ~out.reshape(n, k, -1)
    return keep & (valid != 0)[..., None] & (nvalid > 0)[:, None, None]


def _check_cuda(what, **tensors):
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{what}: {name} is on {t.device}, not CUDA")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")


def _check_args(nvalid, coeffs, valid, tile_uv):
    n, k = valid.shape
    if coeffs.shape != (n, 3 * k, 3) or nvalid.shape != (n,):
        raise ValueError(f"silhouette: bad shapes {tuple(coeffs.shape)}, "
                         f"{tuple(nvalid.shape)} for valid {(n, k)}")
    if tile_uv.shape[-1] != 2 or n % tile_uv.shape[0]:
        raise ValueError("silhouette: tile_uv must be (T, 2) with N % T == 0")
    if (coeffs.dtype, valid.dtype, tile_uv.dtype, nvalid.dtype) != (
            torch.float32, torch.float32, torch.float32, torch.int32):
        raise ValueError("silhouette: coeffs/valid/tile_uv f32, nvalid i32")


def silhouette_tiles_fwd(nvalid, coeffs, valid, tile_uv, inv_sigma, ndc):
    """Forward tile function: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    _check_args(nvalid, coeffs, valid, tile_uv)
    if coeffs.device.type == "cpu":
        return silhouette_tiles_fwd_plain(nvalid, coeffs, valid, tile_uv,
                                          inv_sigma, ndc)
    _check_cuda("silhouette_fwd", nvalid=nvalid, coeffs=coeffs, valid=valid,
                tile_uv=tile_uv)
    n, k = valid.shape
    acc = torch.empty(n, P, dtype=torch.float32, device=coeffs.device)
    err = kernels.lib("silhouette").silhouette_fwd(
        nvalid.data_ptr(), coeffs.data_ptr(), valid.data_ptr(),
        tile_uv.data_ptr(), acc.data_ptr(), n, tile_uv.shape[0], k,
        inv_sigma, ndc, kernels.stream_ptr(coeffs.device))
    kernels.check(err, "silhouette_fwd")
    kernels.LAUNCHES["silhouette_fwd"] += 1
    return acc


def silhouette_tiles_bwd(nvalid, coeffs, valid, tile_uv, g, inv_sigma, ndc):
    """Backward tile function: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    _check_args(nvalid, coeffs, valid, tile_uv)
    if g.shape != (valid.shape[0], P) or g.dtype != torch.float32:
        raise ValueError(f"silhouette_bwd: g must be f32 (N, {P})")
    if coeffs.device.type == "cpu":
        return silhouette_tiles_bwd_plain(nvalid, coeffs, valid, tile_uv, g,
                                          inv_sigma, ndc)
    _check_cuda("silhouette_bwd", nvalid=nvalid, coeffs=coeffs, valid=valid,
                tile_uv=tile_uv, g=g)
    if g.data_ptr() % 16:       # the kernel reads g in 16-byte vectors
        g = g.clone()
    n, k = valid.shape
    dc = torch.empty_like(coeffs)
    err = kernels.lib("silhouette").silhouette_bwd(
        nvalid.data_ptr(), coeffs.data_ptr(), valid.data_ptr(),
        tile_uv.data_ptr(), g.data_ptr(), dc.data_ptr(), n,
        tile_uv.shape[0], k, inv_sigma, ndc, kernels.stream_ptr(coeffs.device))
    kernels.check(err, "silhouette_bwd")
    kernels.LAUNCHES["silhouette_bwd"] += 1
    return dc


class EdgeSilhouette(torch.autograd.Function):
    """acc = tile function(coeffs); differentiable in ``coeffs`` only."""

    @staticmethod
    def forward(ctx, coeffs, nvalid, valid, tile_uv, inv_sigma, ndc):
        ctx.save_for_backward(nvalid, coeffs, valid, tile_uv)
        ctx.consts = (inv_sigma, ndc)
        return silhouette_tiles_fwd(nvalid, coeffs, valid, tile_uv,
                                    inv_sigma, ndc)

    @staticmethod
    def backward(ctx, g):
        nvalid, coeffs, valid, tile_uv = ctx.saved_tensors
        dc = silhouette_tiles_bwd(nvalid, coeffs, valid, tile_uv,
                                  g.contiguous(), *ctx.consts)
        return dc, None, None, None, None, None


def edge_tile_inputs(verts_screen, faces, image_hw, sigma=5e-7,
                     faces_mask=None, znear=1e-3, faces_per_tile=64,
                     bins=None):
    """The tile function's inputs for a batch of objects: (coeffs (B·T, 3K,
    3) edge-major, nvalid (B·T,), valid (B·T, K), tile_uv (T, 2)).
    ``coeffs`` is differentiable in the screen vertices."""
    h, w = image_hw
    if h % TILE or w % TILE:
        raise ValueError(f"image_hw {image_hw} must be a multiple of {TILE}")
    k = max(8, (faces_per_tile + 7) // 8 * 8)
    ndc = 2.0 / min(h, w)
    coeffs, ok = edge_face_setup(verts_screen, faces, image_hw, faces_mask,
                                 znear)
    if bins is None:
        bins = compute_silhouette_bins(verts_screen, faces, image_hw, sigma,
                                       faces_mask, znear, TILE, k)
    sel_idx, sel_valid = bins
    b, t, k = sel_idx.shape
    # edge-major: (B, T, K, 3 edges, 3) → (B, T, 3 edges, K, 3) → (B·T, 3K, 3)
    co = gather_rows(coeffs, sel_idx).transpose(2, 3).reshape(b * t, 3 * k, 3)
    va = (sel_valid & gather_rows(ok, sel_idx)).float().reshape(b * t, k)
    ntx = w // TILE
    tids = torch.arange(t, device=verts_screen.device)
    tile_uv = torch.stack([(tids % ntx) * TILE * ndc,
                           (tids // ntx) * TILE * ndc], -1).float()
    return co.contiguous(), va.sum(-1).int(), va.contiguous(), tile_uv


def tile_consts(image_hw, sigma):
    """(inv_sigma, ndc) as the tile function takes them, rounded to f32."""
    return (float(np.float32(1.0 / sigma)),
            float(np.float32(2.0 / min(image_hw))))


def soft_silhouette_edge_kernel(
    verts_screen: torch.Tensor,
    faces: torch.Tensor,
    image_hw: Tuple[int, int],
    sigma: float = 5e-7,
    faces_mask: Optional[torch.Tensor] = None,
    znear: float = 1e-3,
    faces_per_tile: int = 64,
    bins: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Edge silhouette on fixed 32-px tiles through the tile kernels:
    verts_screen (B, V, 3), faces (B, F, 3) → alpha (B, H, W)."""
    h, w = image_hw
    co, nvalid, va, tile_uv = edge_tile_inputs(
        verts_screen, faces, image_hw, sigma, faces_mask, znear,
        faces_per_tile, bins)
    acc = EdgeSilhouette.apply(co, nvalid, va, tile_uv,
                               *tile_consts(image_hw, sigma))
    alpha = 1.0 - torch.exp(acc)
    b = verts_screen.shape[0]
    alpha = alpha.reshape(b, h // TILE, w // TILE, TILE, TILE)
    return alpha.permute(0, 1, 3, 2, 4).reshape(b, h, w)
