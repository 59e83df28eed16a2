"""Phase 1: detections → one SAM encode → batched mask decode → the
finding images (counterpart of regen3d_tpu/pipeline/phase1_segmentation.py).

``detect_and_segment`` takes the image, a detector (any object with
``detect(image, labels, threshold)`` returning ``DetectionResult``s, such as
:class:`~regen3d_tpu_torch.models.detector.OpenVocabDetector`) and the
port's :class:`~regen3d_tpu_torch.models.sam.SAM`, which hold their own
weights and live on the device they were built on. Same contract as the JAX
function: NMS, one encode per image, every detection through one batched
decode (detections padded to a bucket of 4, points to 4 with label −1), the
best-IoU head per detection, and the two-pass ``use_points`` mode, whose
``saliency`` points come from a
:class:`~regen3d_tpu_torch.pipeline.saliency_distill.SaliencyModel` when
one is passed. Without a detector the weightless ``cluster_proposals``
runs scikit-learn's k-means as ``ops/kmeans.py`` copies it.

``export_findings`` writes the finding, banana and layout PNGs;
``run`` loads the input, detects, exports and writes ``depth.png``.

Without a model object, a ``detector_checkpoint`` or (for
``point_method: saliency``) ``saliency_checkpoint`` that names a directory
is loaded (``pipeline/detector_distill.py``,
``pipeline/saliency_distill.py``: the JAX package's orbax directories or
the port's), as is ``depth_anything_checkpoint`` (``pipeline/depth.py``);
a missing path is logged and falls back as in the JAX package. Refused:
``interactive_edit`` and ``use_banana: false`` (the editor UI and the
upscaler: ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import logging
import os
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from regen3d_tpu_torch.artifacts import Artifacts, finding_stem
from regen3d_tpu_torch.models.layers import resize_bilinear
from regen3d_tpu_torch.ops.kmeans import kmeans_fit, kmeans_predict
from regen3d_tpu_torch.pipeline import depth as depth_mod
from regen3d_tpu_torch.pipeline.detection import (
    BoundingBox,
    DetectionResult,
    generate_points,
    nms,
)
from regen3d_tpu_torch.utils.image import (
    draw_bbox,
    draw_outline,
    load_image_rgb,
    mask_bbox,
    masked_on_white,
    padded_crop,
    save_image,
    segmentation_layout,
)

log = logging.getLogger(__name__)


def proposal_features(image: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The weightless proposer's float32 features of every pixel, (H·W, 5):
    colour in [0, 2] and x / W, y / H; and the ~20,000 of them (every
    ⌊H·W / 20000⌋-th) that the k-means is fitted on."""
    h, w = image.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w]
    feats = np.concatenate([
        image.reshape(-1, 3).astype(np.float32) / 255.0 * 2.0,
        (xs.reshape(-1, 1) / w).astype(np.float32),
        (ys.reshape(-1, 1) / h).astype(np.float32),
    ], axis=1)
    return feats, feats[::max(1, len(feats) // 20000)]


def cluster_proposals(image: np.ndarray, num_regions: int = 6,
                      min_area_frac: float = 0.005, seed: int = 0,
                      device="cuda") -> List[DetectionResult]:
    """Weightless proposer: k-means over (colour, position) features; each
    cluster covering at least ``min_area_frac`` of the image becomes a
    detection labelled 'object'. The fit runs on the subsample on the host
    (``ops.kmeans.kmeans_fit``), the labelling of every pixel on
    ``device``."""
    h, w = image.shape[:2]
    feats, sub = proposal_features(image)
    fit = kmeans_fit(sub, num_regions, seed)
    labels = kmeans_predict(torch.from_numpy(feats).to(device), fit.centers)
    labels = labels.to(torch.int32).cpu().numpy().reshape(h, w)
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


def _checkpoint_dir(cfg: Mapping, key: str, fallback: str) -> Optional[str]:
    """The directory ``cfg[key]`` names, or None: a path that does not name
    a directory is logged, as the JAX package does, and the caller goes on
    to ``fallback``."""
    path = str(cfg.get(key, "") or "")
    if path and os.path.isdir(path):
        return path
    if path:
        log.warning("phase1: %s %s missing — %s", key, path, fallback)
    return None


@torch.no_grad()
def detect_and_segment(cfg: Mapping, image: np.ndarray, sam=None,
                       detector=None, saliency_model=None,
                       device=None) -> List[DetectionResult]:
    """Detector → NMS → SAM masks for one (H, W, 3) uint8 image.

    cfg is the pipeline config (any mapping with ``get``): labels,
    threshold, iou_threshold, use_points, point_method, points_per_object,
    scale_bounding_boxes, seed and the checkpoint paths are read. A
    ``detector_checkpoint`` or ``saliency_checkpoint`` directory loads the
    model not passed in, on ``device`` (default: SAM's device, else the
    card). Without a detector the weightless ``cluster_proposals``
    proposes regions, labelling pixels on ``device``; without ``sam`` each
    detection keeps its mask or gets its box filled. ``saliency_model``
    gives the ``saliency`` points. Returns the detections whose mask is
    non-empty."""
    if device is None:
        device = next(sam.parameters()).device if sam is not None else "cuda"
    if detector is None:
        ckpt = _checkpoint_dir(cfg, "detector_checkpoint",
                               "clustering fallback")
        if ckpt:
            from regen3d_tpu_torch.pipeline.detector_distill import (
                load_detector_checkpoint,
            )
            detector = load_detector_checkpoint(ckpt, device=device)
            log.info("phase1: detector checkpoint %s", ckpt)
    if str(cfg.get("point_method", "")) == "saliency" and saliency_model is None:
        ckpt = _checkpoint_dir(cfg, "saliency_checkpoint",
                               "max_distance fallback")
        if ckpt:
            from regen3d_tpu_torch.pipeline.saliency_distill import (
                SaliencyModel,
            )
            saliency_model = SaliencyModel.load(ckpt, device=device)
            log.info("phase1: saliency checkpoint %s", ckpt)
    labels = list(cfg.get("labels", []))
    thr = float(cfg.get("threshold", 0.25))
    iou_thr = float(cfg.get("iou_threshold", 0.5))
    seed = int(cfg.get("seed", 1234567))

    if detector is not None:
        dets = detector.detect(image, labels, thr)
    else:
        log.warning("phase1: no detector — clustering fallback")
        dets = cluster_proposals(image, num_regions=max(6, len(labels)),
                                 seed=seed, device=device)
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
            pts_px = (generate_points(method, image, d.mask, n_pts, seed,
                                      saliency_model=saliency_model)
                      if d.mask is not None and d.mask.any()
                      else np.zeros((0, 2), np.float32))
            points_px.append(np.asarray(pts_px, np.float32))
        boxes2 = [d.box.scaled(scale_bb, (w, h)) for d in dets]
        masks = _sam_decode_batched(sam, emb, (h, w), boxes2,
                                    points_px=points_px)
        for d, m in zip(dets, masks):
            d.mask = m
    return [d for d in dets if d.mask is not None and d.mask.any()]


def export_findings(cfg: Mapping, image: np.ndarray,
                    detections: List[DetectionResult]) -> List[str]:
    """Write the phase-1 artifact set for each detection, named by
    ``finding_stem(label, mask centroid)``: the object on white
    (``findings/fullSize``), its padded crop (``findings/cropped``), the
    outline and bbox prompt images (``banana/outline``, ``banana/bbox``)
    and the layout canvas. Returns the stems."""
    art = Artifacts(cfg)
    padding = int(cfg.get("findings_padding", 5))
    for d in (art.findings_fullsize, art.findings_cropped, art.banana_outline,
              art.banana_bbox, art.banana_layouts):
        os.makedirs(d, exist_ok=True)
    stems = []
    for d in detections:
        stem = finding_stem(d.label, d.mask_centroid)
        stems.append(stem)
        full = masked_on_white(image, d.mask)
        save_image(os.path.join(art.findings_fullsize, f"{stem}.png"), full)
        bbox = mask_bbox(d.mask)
        save_image(os.path.join(art.findings_cropped, f"{stem}.png"),
                   padded_crop(full, bbox, padding))
        outline = draw_outline(
            image, d.mask,
            color=cfg.get("banana_line_color", [255, 0, 0]),
            thickness=int(cfg.get("banana_line_thickness", 3)),
            offset_px=int(cfg.get("banana_offset_px", 5)))
        save_image(os.path.join(art.banana_outline, f"{stem}.png"), outline)
        save_image(os.path.join(art.banana_bbox, f"{stem}.png"),
                   draw_bbox(image, bbox,
                             color=cfg.get("banana_bbox_color", [255, 0, 0]),
                             thickness=int(cfg.get("banana_bbox_thickness", 2)),
                             padding=int(cfg.get("banana_bbox_padding", 6))))
        save_image(os.path.join(art.banana_layouts, f"{stem}.png"),
                   segmentation_layout(image, d.mask))
        log.info("phase1: finding %s (score %.2f)", stem, d.score)
    return stems


def run(cfg: Mapping, sam=None, detector=None, saliency_model=None,
        depth_model=None,
        detections: Optional[List[DetectionResult]] = None,
        device="cuda") -> List[str]:
    """Phase 1 on ``input_image`` (at most 1280 px a side): detect and
    segment (unless ``detections`` are given), export the findings and
    write ``depth.png`` with ``depth_model`` (a
    :class:`~regen3d_tpu_torch.models.depth_anything.DepthAnything`), the
    model of ``depth_anything_checkpoint``, or the offline prior. Models
    passed in run where they were built; models loaded from checkpoints
    and the weightless k-means run on ``device``. Unlike the JAX package,
    a failing depth step is not caught (ROADMAP Queue 3 al). Returns the
    stems."""
    if bool(cfg.get("interactive_edit", False)):
        raise NotImplementedError(
            "phase 1: interactive_edit (the browser mask editor, "
            "pipeline/editor_ui.py) is not ported (ROADMAP Queue 1 item 5)")
    if not bool(cfg.get("use_banana", True)):
        raise NotImplementedError(
            "phase 1: use_banana false upscales the crops with the diffusion "
            "upscaler (pipeline/upscale.py), which is not ported (ROADMAP "
            "Queue 1 item 5)")
    image = load_image_rgb(cfg.path("input_image"), max_side=1280)
    if detections is None:
        detections = detect_and_segment(cfg, image, sam=sam, detector=detector,
                                        saliency_model=saliency_model,
                                        device=device)
    if not detections:
        log.warning("phase1: no detections")
        return []
    stems = export_findings(cfg, image, detections)
    depth_mod.run(cfg, model=depth_model, device=device)
    return stems
