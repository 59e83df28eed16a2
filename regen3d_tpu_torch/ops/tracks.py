"""Cross-frame point tracks for bundle adjustment, the `use_ba` path
(counterpart of regen3d_tpu/ops/tracks.py).

The reference predicts tracks with the VGGT track head seeded by
ALIKED+SuperPoint keypoints (minimal_demo_vggt.py:414-430). This keeps the
JAX package's role and arithmetic: query-frame keypoints propagated to
every frame with a per-observation visibility score:

  1. keypoints: Shi-Tomasi min-eigenvalue response (two 3×3 gradient
     correlations + a 5×5 box filter, zero padding as XLA's "SAME"), a 5×5
     max-pool NMS (``max_pool2d`` pads with −inf, as ``reduce_window``),
     then the top K by a stable descending sort, so equal responses keep
     the lower flat index first, as ``lax.top_k`` does (``torch.topk``'s
     tie order is not fixed);
  2. descriptors: zero-mean, ℓ2-normalized P×P bilinear patches (K, D);
  3. matching: one (K, D) @ (D, G) product against the target frame's
     stride grid of patches, then refinement rounds over a shrinking 3×3
     offset pattern with a correlation soft-argmax → sub-pixel positions.

Convolutions and products run at full f32 (no TF32 on the card).
Visibility = best NCC score in [-1, 1]; callers threshold with the
reference's `vis_thresh` (default 0.2, minimal_demo_vggt.py:436).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from regen3d_tpu_torch.ops import full_f32


class Tracks(NamedTuple):
    xy: torch.Tensor        # (F, K, 2) pixel positions per frame
    vis: torch.Tensor       # (F, K) visibility/confidence score in [-1, 1]
    query_xy: torch.Tensor  # (K, 2) keypoint positions in the query frame


def _gray(img: torch.Tensor) -> torch.Tensor:
    if img.dim() == 3:
        return img @ torch.tensor([0.299, 0.587, 0.114], dtype=img.dtype,
                                  device=img.device)
    return img


def _conv2(img: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """2-D cross-correlation with zero padding to the same size (odd k)."""
    r = k.shape[0] // 2
    return F.conv2d(img[None, None], k[None, None].to(img.dtype),
                    padding=r)[0, 0]


def shi_tomasi_keypoints(img: torch.Tensor, num_points: int,
                         nms_radius: int = 2, border: int = 8
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-K corner keypoints of an (H, W[, 3]) image in [0, 1].

    Returns (xy (K, 2) float pixel coords, score (K,))."""
    dev = img.device
    with full_f32():
        g = _gray(img)
        sob = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0],
                            [-1.0, 0.0, 1.0]], device=dev)
        ix = _conv2(g, sob / 8.0)
        iy = _conv2(g, sob.T / 8.0)
        box = torch.ones((5, 5), device=dev) / 25.0
        sxx = _conv2(ix * ix, box)
        syy = _conv2(iy * iy, box)
        sxy = _conv2(ix * iy, box)
    # min eigenvalue of [[sxx, sxy], [sxy, syy]]
    tr = sxx + syy
    det = sxx * syy - sxy * sxy
    disc = torch.sqrt(torch.clamp(tr * tr / 4.0 - det, min=0.0))
    resp = tr / 2.0 - disc

    # NMS: keep strict local maxima of a (2r+1)² window
    w = 2 * nms_radius + 1
    mx = F.max_pool2d(resp[None, None], w, stride=1,
                      padding=nms_radius)[0, 0]
    ninf = torch.full_like(resp, -torch.inf)
    resp = torch.where(resp >= mx, resp, ninf)
    h, wd = resp.shape
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(wd, device=dev)[None, :]
    inside = ((yy >= border) & (yy < h - border)
              & (xx >= border) & (xx < wd - border))
    resp = torch.where(inside, resp, ninf)

    score, idx = torch.sort(resp.reshape(-1), descending=True, stable=True)
    score, idx = score[:num_points], idx[:num_points]
    xy = torch.stack([(idx % wd).float(), (idx // wd).float()], -1)
    return xy, score


def _bilinear_patch(img: torch.Tensor, centers: torch.Tensor,
                    patch: int) -> torch.Tensor:
    """Patches of side `patch` bilinearly sampled around `centers` (..., 2)
    = (x, y). img (H, W, C). Returns (..., patch, patch, C)."""
    h, w = img.shape[:2]
    r = (patch - 1) / 2.0
    off = torch.arange(patch, dtype=torch.float32, device=img.device) - r
    gy = torch.clamp(centers[..., 1:2] + off, 0.0, h - 1.0)    # (..., P)
    gx = torch.clamp(centers[..., 0:1] + off, 0.0, w - 1.0)
    y0 = torch.floor(gy).long()
    x0 = torch.floor(gx).long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    fy = (gy - y0)[..., :, None, None]
    fx = (gx - x0)[..., None, :, None]

    def at(yi, xi):
        return img[yi[..., :, None], xi[..., None, :]]        # (..., P, P, C)

    return ((at(y0, x0) * (1 - fx) + at(y0, x1) * fx) * (1 - fy)
            + (at(y1, x0) * (1 - fx) + at(y1, x1) * fx) * fy)


def patch_descriptors(img: torch.Tensor, xy: torch.Tensor,
                      patch: int = 8) -> torch.Tensor:
    """Zero-mean, ℓ2-normalized flattened patches at `xy` (..., 2) →
    (..., D)."""
    if img.dim() == 2:
        img = img[..., None]
    d = _bilinear_patch(img, xy, patch)
    d = d.reshape(*xy.shape[:-1], -1)
    d = d - torch.mean(d, -1, keepdim=True)
    return d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True),
                           min=1e-6)


def _grid_descriptors(img: torch.Tensor, stride: int,
                      patch: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Descriptors on a stride grid → ((G, D), grid xy (G, 2))."""
    h, w = img.shape[:2]
    ys = torch.arange(stride // 2, h, stride, dtype=torch.float32,
                      device=img.device)
    xs = torch.arange(stride // 2, w, stride, dtype=torch.float32,
                      device=img.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    xy = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)
    return patch_descriptors(img, xy, patch), xy


def predict_tracks(images: torch.Tensor, num_points: int = 512,
                   patch: int = 8, stride: int = 4,
                   refine_steps: int = 2) -> Tracks:
    """Track query-frame (frame 0) keypoints across all frames.

    images: (F, H, W, 3) in [0, 1]. Coarse NCC match against each target
    frame's stride grid, then `refine_steps` rounds of halving the offset
    grid around the best position (correlation soft-argmax)."""
    images = images.float()
    dev = images.device
    q_xy, _ = shi_tomasi_keypoints(images[0], num_points)
    q_desc = patch_descriptors(images[0], q_xy, patch)       # (K, D)
    oy, ox = torch.meshgrid(torch.arange(-1.0, 2.0, device=dev),
                            torch.arange(-1.0, 2.0, device=dev),
                            indexing="ij")
    pattern = torch.stack([ox, oy], -1).reshape(-1, 2)       # (9, 2)
    xys, viss = [], []
    with full_f32():
        for img in images:
            g_desc, g_xy = _grid_descriptors(img, stride, patch)
            corr = q_desc @ g_desc.T                          # (K, G)
            pos = g_xy[torch.argmax(corr, dim=-1)]            # (K, 2)
            score = None
            for i in range(refine_steps):
                offs = pattern * (stride / 2.0 / (2.0 ** i))
                cand = pos[:, None, :] + offs[None]           # (K, 9, 2)
                cd = patch_descriptors(img, cand, patch)      # (K, 9, D)
                cc = torch.einsum("kd,ksd->ks", q_desc, cd)   # (K, 9)
                wgt = torch.softmax(cc * 20.0, dim=-1)
                pos = pos + wgt @ offs
                score = cc.max(-1).values
            xys.append(pos)
            viss.append(score)
    xy = torch.stack(xys)
    vis = torch.stack(viss)
    # the query frame tracks itself: pin exact positions / full confidence
    xy[0] = q_xy
    vis[0] = 1.0
    return Tracks(xy=xy, vis=vis, query_xy=q_xy)
