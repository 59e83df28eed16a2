"""Phase 1 serving: detections → one SAM encode → batched mask decode
(counterpart of regen3d_tpu/pipeline/phase1_segmentation.py:47-225).

``detect_and_segment`` takes the image, a detector (any object with
``detect(image, labels, threshold)`` returning ``DetectionResult``s) and the
port's :class:`~regen3d_tpu_torch.models.sam.SAM`, which holds its own
weights and lives on the device it was built on. Same contract as the JAX
function: NMS, one encode per image, every detection through one batched
decode (detections padded to a bucket of 4, points to 4 with label −1), the
best-IoU head per detection, and the two-pass ``use_points`` mode.

Not ported yet: loading a detector or saliency checkpoint (a config that
names one, or ``point_method: saliency``, raises ``NotImplementedError``),
``export_findings`` and ``run``.
"""

from __future__ import annotations

import logging
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from regen3d_tpu_torch.models.layers import resize_bilinear
from regen3d_tpu_torch.pipeline.detection import (
    BoundingBox,
    DetectionResult,
    generate_points,
    mask_bbox,
    nms,
)

log = logging.getLogger(__name__)


def cluster_proposals(image: np.ndarray, num_regions: int = 6,
                      min_area_frac: float = 0.005,
                      seed: int = 0) -> List[DetectionResult]:
    """Weightless proposer: k-means over (color, position) features; each
    cluster covering at least ``min_area_frac`` of the image becomes a
    detection labelled 'object'. Needs scikit-learn."""
    from sklearn.cluster import KMeans

    h, w = image.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w]
    feats = np.concatenate([
        image.reshape(-1, 3).astype(np.float32) / 255.0 * 2.0,
        (xs.reshape(-1, 1) / w).astype(np.float32),
        (ys.reshape(-1, 1) / h).astype(np.float32),
    ], axis=1)
    sub = feats[::max(1, len(feats) // 20000)]
    km = KMeans(n_clusters=num_regions, n_init=4, random_state=seed).fit(sub)
    labels = km.predict(feats).reshape(h, w)
    out = []
    for k in range(num_regions):
        m = labels == k
        if m.mean() < min_area_frac:
            continue
        x0, y0, x1, y1 = mask_bbox(m)
        out.append(DetectionResult(
            score=float(m.mean()), label="object",
            box=BoundingBox(x0, y0, x1, y1), mask=m))
    return out


def _sam_decode_batched(sam, emb: torch.Tensor, image_hw: Tuple[int, int],
                        boxes_px: Sequence[BoundingBox],
                        points_px: Optional[Sequence[np.ndarray]] = None
                        ) -> List[np.ndarray]:
    """Decode every detection in one batched mask-decoder call.

    emb is the (1, g, g, D) embedding of ``sam.encode``; boxes_px are N
    boxes in pixels; points_px, if given, N (P_i, 2) pixel arrays of
    positive points (at most 4 are used). Returns N (H, W) bool masks, each
    from its detection's best-IoU head, resized from the 4·g² logits."""
    h, w = image_hw
    n = len(boxes_px)
    if n == 0:
        return []
    n_pad = -(-n // 4) * 4
    max_p = 4
    boxes = np.zeros((n_pad, 2, 2), np.float32)
    pts = np.zeros((n_pad, max_p, 2), np.float32)
    labs = -np.ones((n_pad, max_p), np.float32)      # -1 = pad token
    for i, bb in enumerate(boxes_px):
        boxes[i] = [[bb.xmin / w, bb.ymin / h], [bb.xmax / w, bb.ymax / h]]
        if points_px is not None and len(points_px[i]):
            p = np.asarray(points_px[i], np.float32)[:max_p]
            pts[i, :len(p)] = p / [w, h]
            labs[i, :len(p)] = 1.0
    dev = emb.device
    masks, iou = sam.decode(emb.expand(n_pad, *emb.shape[1:]),
                            torch.from_numpy(pts).to(dev),
                            torch.from_numpy(labs).to(dev),
                            torch.from_numpy(boxes).to(dev))
    best = np.argmax(iou.float().cpu().numpy(), axis=1)[:n]
    picked = masks[torch.arange(n, device=dev), torch.from_numpy(best).to(dev)]
    logits = resize_bilinear(picked[..., None].float(), (h, w))[..., 0]
    return list((logits > 0).cpu().numpy())


def _refuse_unported(cfg: Mapping, detector) -> None:
    if detector is None and str(cfg.get("detector_checkpoint", "") or ""):
        raise NotImplementedError(
            "phase 1: loading a detector checkpoint is not ported; pass a "
            "detector object")
    if str(cfg.get("point_method", "")) == "saliency":
        raise NotImplementedError(
            "phase 1: point_method 'saliency' needs the saliency model, "
            "which is not ported")


@torch.no_grad()
def detect_and_segment(cfg: Mapping, image: np.ndarray, sam=None,
                       detector=None) -> List[DetectionResult]:
    """Detector → NMS → SAM masks for one (H, W, 3) uint8 image.

    cfg is the pipeline config (any mapping with ``get``): labels,
    threshold, iou_threshold, use_points, point_method, points_per_object,
    scale_bounding_boxes and seed are read. Without a detector the
    weightless ``cluster_proposals`` proposes regions; without ``sam`` each
    detection keeps its mask or gets its box filled. Returns the detections
    whose mask is non-empty."""
    _refuse_unported(cfg, detector)
    labels = list(cfg.get("labels", []))
    thr = float(cfg.get("threshold", 0.25))
    iou_thr = float(cfg.get("iou_threshold", 0.5))
    seed = int(cfg.get("seed", 1234567))

    if detector is not None:
        dets = detector.detect(image, labels, thr)
    else:
        log.warning("phase1: no detector — clustering proposals")
        dets = cluster_proposals(image, num_regions=max(6, len(labels)),
                                 seed=seed)
    dets = nms(dets, iou_thr)
    h, w = image.shape[:2]

    if sam is None:
        for d in dets:
            if d.mask is None:
                b = d.box
                m = np.zeros((h, w), bool)
                m[max(int(b.ymin), 0):min(int(np.ceil(b.ymax)), h),
                  max(int(b.xmin), 0):min(int(np.ceil(b.xmax)), w)] = True
                d.mask = m
        return [d for d in dets if d.mask is not None and d.mask.any()]

    dev = next(sam.parameters()).device
    size = sam.cfg.image_size
    img = torch.from_numpy(np.ascontiguousarray(image)).to(dev)
    img_in = resize_bilinear(img[None].float() / 255.0, (size, size))
    # one encode per image; every prompt goes through the decoder
    emb = sam.encode(img_in)

    # pass 1: box prompts only
    masks = _sam_decode_batched(sam, emb, (h, w), [d.box for d in dets])
    for d, m in zip(dets, masks):
        d.mask = m

    if bool(cfg.get("use_points", False)):
        # pass 2: points from the pass-1 masks, boxes grown about their
        # centres by scale_bounding_boxes
        scale_bb = float(cfg.get("scale_bounding_boxes", 1.25))
        n_pts = int(cfg.get("points_per_object", 1))
        method = str(cfg.get("point_method", "max_distance"))
        points_px = []
        for d in dets:
            pts_px = (generate_points(method, image, d.mask, n_pts, seed)
                      if d.mask is not None and d.mask.any()
                      else np.zeros((0, 2), np.float32))
            points_px.append(np.asarray(pts_px, np.float32))
        boxes2 = [d.box.scaled(scale_bb, (w, h)) for d in dets]
        masks = _sam_decode_batched(sam, emb, (h, w), boxes2,
                                    points_px=points_px)
        for d, m in zip(dets, masks):
            d.mask = m
    return [d for d in dets if d.mask is not None and d.mask.any()]
