"""Detection data contracts, NMS and prompt-point strategies for phase 1
(a copy of regen3d_tpu/pipeline/detection.py, which imports no JAX; the port
keeps its own so that it imports nothing of the JAX package).

Mirrors the reference's ``BoundingBox``/``DetectionResult``
(src/utils/data_types.py:11-54), the greedy IoU NMS
(filter_duplicate_detections, segmentation.py:102-134) and the SAMAug-style
point generators (point_generators.py:19-144).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from regen3d_tpu_torch.utils.image import mask_centroid


@dataclass
class BoundingBox:
    xmin: float
    ymin: float
    xmax: float
    ymax: float

    @property
    def center(self) -> Tuple[float, float]:
        return (self.xmin + self.xmax) / 2.0, (self.ymin + self.ymax) / 2.0

    @property
    def area(self) -> float:
        return max(0.0, self.xmax - self.xmin) * max(0.0, self.ymax - self.ymin)

    def iou(self, other: "BoundingBox") -> float:
        ix = max(0.0, min(self.xmax, other.xmax) - max(self.xmin, other.xmin))
        iy = max(0.0, min(self.ymax, other.ymax) - max(self.ymin, other.ymin))
        inter = ix * iy
        union = self.area + other.area - inter
        return inter / union if union > 0 else 0.0

    def scaled(self, factor: float, image_wh: Tuple[int, int]) -> "BoundingBox":
        """Grow about the centre by ``factor``, clamped to the image
        (expand_bbox, segmentation.py:58-99)."""
        cx, cy = self.center
        hw = (self.xmax - self.xmin) * factor / 2.0
        hh = (self.ymax - self.ymin) * factor / 2.0
        w, h = image_wh
        return BoundingBox(max(0, cx - hw), max(0, cy - hh),
                           min(w, cx + hw), min(h, cy + hh))


@dataclass
class DetectionResult:
    score: float
    label: str
    box: BoundingBox
    mask: Optional[np.ndarray] = None          # (H, W) bool
    logits: Optional[np.ndarray] = None

    @property
    def mask_centroid(self) -> Tuple[int, int]:
        if self.mask is None:
            cx, cy = self.box.center
            return int(round(cx)), int(round(cy))
        return mask_centroid(self.mask)


def nms(detections: List[DetectionResult], iou_threshold: float = 0.5
        ) -> List[DetectionResult]:
    """Greedy score-sorted IoU dedup (segmentation.py:102-134)."""
    out: List[DetectionResult] = []
    for d in sorted(detections, key=lambda d: -d.score):
        if all(d.box.iou(k.box) < iou_threshold for k in out):
            out.append(d)
    return out


# --- prompt-point strategies (point_generators.py:19-144) ----------------------

def points_random(mask: np.ndarray, n: int, rng: np.random.Generator
                  ) -> np.ndarray:
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return np.zeros((0, 2))
    sel = rng.choice(len(xs), min(n, len(xs)), replace=False)
    return np.stack([xs[sel], ys[sel]], -1).astype(np.float32)


def points_max_entropy(image: np.ndarray, mask: np.ndarray, n: int,
                       win: int = 9) -> np.ndarray:
    """Points at local grayscale-entropy maxima inside the mask."""
    gray = image.mean(-1) if image.ndim == 3 else image
    # local variance as a cheap entropy proxy (vectorized box filter)
    k = win
    pad = k // 2
    g = np.pad(gray.astype(np.float64), pad, mode="edge")
    c = np.cumsum(np.cumsum(g, 0), 1)
    c = np.pad(c, ((1, 0), (1, 0)))
    s1 = c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]
    g2 = np.pad((gray.astype(np.float64)) ** 2, pad, mode="edge")
    c2 = np.cumsum(np.cumsum(g2, 0), 1)
    c2 = np.pad(c2, ((1, 0), (1, 0)))
    s2 = c2[k:, k:] - c2[:-k, k:] - c2[k:, :-k] + c2[:-k, :-k]
    var = s2 / (k * k) - (s1 / (k * k)) ** 2
    var = var[:gray.shape[0], :gray.shape[1]]
    var[~mask] = -1
    idx = np.argsort(var.reshape(-1))[::-1][:n]
    ys, xs = np.unravel_index(idx, var.shape)
    return np.stack([xs, ys], -1).astype(np.float32)


def points_max_distance(mask: np.ndarray, n: int) -> np.ndarray:
    """Points deepest inside the mask (distance-transform peaks)."""
    try:
        import cv2
        dist = cv2.distanceTransform(mask.astype(np.uint8), cv2.DIST_L2, 5)
    except ImportError:
        from scipy import ndimage
        dist = ndimage.distance_transform_edt(mask)
    flat = np.argsort(dist.reshape(-1))[::-1]
    pts = []
    taken = np.zeros_like(mask)
    h, w = mask.shape
    for i in flat:
        y, x = divmod(int(i), w)
        if dist[y, x] <= 0:
            break
        if taken[max(0, y - 10):y + 10, max(0, x - 10):x + 10].any():
            continue
        pts.append((x, y))
        taken[y, x] = True
        if len(pts) >= n:
            break
    return np.asarray(pts, np.float32).reshape(-1, 2)


def points_saliency(image: np.ndarray, mask: np.ndarray, n: int,
                    saliency_model) -> np.ndarray:
    """Peaks of the saliency map inside the mask (VST point strategy):
    greedy picks with a 10-px suppression window, like max_distance."""
    from scipy import ndimage
    smap = saliency_model.saliency(image).copy()
    # smooth before peak-picking: a lone bright pixel shouldn't out-rank
    # the object's interior plateau
    smap = ndimage.uniform_filter(smap, size=5)
    smap[~mask] = -1.0
    flat = np.argsort(smap.reshape(-1))[::-1]
    pts = []
    taken = np.zeros_like(mask)
    h, w = mask.shape
    for i in flat:
        y, x = divmod(int(i), w)
        if smap[y, x] <= 0:
            break
        if taken[max(0, y - 10):y + 10, max(0, x - 10):x + 10].any():
            continue
        pts.append((x, y))
        taken[y, x] = True
        if len(pts) >= n:
            break
    if not pts:                         # saliency missed the mask entirely
        return points_max_distance(mask, n)
    return np.asarray(pts, np.float32).reshape(-1, 2)


def generate_points(method: str, image: np.ndarray, mask: np.ndarray, n: int,
                    seed: int = 0, saliency_model=None) -> np.ndarray:
    """Dispatch on config `point_method` (random | max_entropy |
    max_distance | saliency). `saliency` uses the saliency net (a
    `saliency_distill.SaliencyModel`, loaded from `saliency_checkpoint`)
    when provided, else falls back to max_distance."""
    rng = np.random.default_rng(seed)
    if method == "random":
        return points_random(mask, n, rng)
    if method == "max_entropy":
        return points_max_entropy(image, mask, n)
    if method == "saliency" and saliency_model is not None:
        return points_saliency(image, mask, n, saliency_model)
    if method in ("max_distance", "saliency"):
        return points_max_distance(mask, n)
    raise ValueError(f"unknown point_method: {method}")
