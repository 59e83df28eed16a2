"""The open-vocabulary detector's distillation: its attribute-grammar
scenes, the FCOS-style assignment and loss, the trainer, the box recall
against the clustering fallback, and the checkpoint's writer and loader
(counterpart of regen3d_tpu/pipeline/detector_distill.py).

A checkpoint is a directory of either kind ``models/weights.py`` reads (the
JAX package's orbax one or the port's), with a ``config.json`` sidecar
holding the ``DetectorConfig`` without its dtype.

The scenes are pure numpy from ``np.random.default_rng(seed)``, JAX's bit
for bit. ``distill_config`` computes in f32, as in JAX; on the card the
flash kernels take bf16 only, so the card's trainer computes in bf16 with
f32 weights (ROADMAP Queue 3 bc), where the image tower's heads are 24 wide
and the text tower's 12.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from regen3d_tpu_torch.models.detector import (
    DetectorConfig,
    OpenVocabDetector,
    init_flax_style_,
    tokenize_bytes,
)
from regen3d_tpu_torch.models.weights import (
    load_model,
    read_config_json,
    save_model,
)
from regen3d_tpu_torch.parallel.batches import BatchStream
from regen3d_tpu_torch.parallel.train import (
    OptaxAdamW,
    on_card,
    train_steps,
    warmup_cosine_decay_schedule,
)

log = logging.getLogger(__name__)

COLORS = {
    "red": (0.82, 0.13, 0.13),
    "green": (0.15, 0.65, 0.2),
    "blue": (0.15, 0.25, 0.75),
    "yellow": (0.85, 0.8, 0.15),
    "magenta": (0.75, 0.15, 0.7),
    "cyan": (0.15, 0.7, 0.75),
}
SHAPES = ("box", "disk", "tri")
VOCAB: List[str] = [f"{c} {s}" for c in COLORS for s in SHAPES]
MAX_OBJECTS = 4


# ---------------------------------------------------------------------------
# synthetic grounded-detection scenes (the JAX package's, numpy)
# ---------------------------------------------------------------------------

def _draw_shape(img, shape: str, cx, cy, w, h, color, rng):
    size = img.shape[0]
    x0, x1 = int((cx - w / 2) * size), int((cx + w / 2) * size)
    y0, y1 = int((cy - h / 2) * size), int((cy + h / 2) * size)
    x0, y0 = max(x0, 0), max(y0, 0)
    x1, y1 = min(x1, size), min(y1, size)
    if x1 <= x0 + 1 or y1 <= y0 + 1:
        return None
    yy, xx = np.mgrid[y0:y1, x0:x1]
    u = (xx - x0) / max(x1 - 1 - x0, 1)
    v = (yy - y0) / max(y1 - 1 - y0, 1)
    if shape == "box":
        m = np.ones_like(u, bool)
    elif shape == "disk":
        m = ((u - 0.5) ** 2 + (v - 0.5) ** 2) <= 0.25
    else:  # tri: isoceles, apex up
        m = np.abs(u - 0.5) <= v / 2
    col = np.clip(np.asarray(color) + rng.normal(0, 0.03, 3), 0, 1)
    shade = 0.85 + 0.3 * v[..., None]            # cheap vertical shading
    img[y0:y1, x0:x1][m] = (col * shade)[m]
    # tight box from the drawn mask (tri/disk are narrower than the rect)
    ys, xs = np.nonzero(m)
    bx0, bx1 = (x0 + xs.min()) / size, (x0 + xs.max() + 1) / size
    by0, by1 = (y0 + ys.min()) / size, (y0 + ys.max() + 1) / size
    return ((bx0 + bx1) / 2, (by0 + by1) / 2, bx1 - bx0, by1 - by0)


def synth_detection_batch(rng: np.random.Generator, batch: int, size: int
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray]:
    """(imgs (B,S,S,3) in [0,1], boxes (B,M,4) cxcywh, labels (B,M) int32
    into VOCAB, valid (B,M) bool): a room-like neutral background and 1..M
    saturated attribute-grammar objects with ≤ 0.15-IoU pairwise overlap."""
    imgs = np.zeros((batch, size, size, 3), np.float32)
    boxes = np.zeros((batch, MAX_OBJECTS, 4), np.float32)
    labels = np.zeros((batch, MAX_OBJECTS), np.int32)
    valid = np.zeros((batch, MAX_OBJECTS), bool)
    names = list(COLORS)
    for b in range(batch):
        wall = 0.55 + rng.uniform(-0.12, 0.12, 3)
        floor = wall * rng.uniform(0.55, 0.8)
        horizon = rng.uniform(0.5, 0.75)
        img = np.empty((size, size, 3), np.float32)
        img[:] = wall
        img[int(horizon * size):] = floor
        img += rng.normal(0, 0.015, img.shape)
        n = int(rng.integers(1, MAX_OBJECTS + 1))
        placed: List[Tuple[float, float, float, float]] = []
        k = 0
        for _ in range(12):                     # rejection sampling
            if k >= n:
                break
            w, h = rng.uniform(0.14, 0.38, 2)
            cx = rng.uniform(w / 2 + 0.02, 1 - w / 2 - 0.02)
            cy = rng.uniform(h / 2 + 0.02, 1 - h / 2 - 0.02)
            if any(_iou_cxcywh((cx, cy, w, h), p) > 0.15 for p in placed):
                continue
            ci = int(rng.integers(len(names)))
            si = int(rng.integers(len(SHAPES)))
            tight = _draw_shape(img, SHAPES[si], cx, cy, w, h,
                                COLORS[names[ci]], rng)
            if tight is None:
                continue
            placed.append((cx, cy, w, h))
            boxes[b, k] = tight
            labels[b, k] = ci * len(SHAPES) + si
            valid[b, k] = True
            k += 1
        imgs[b] = np.clip(img, 0, 1)
    return imgs, boxes, labels, valid


def _iou_cxcywh(a, b) -> float:
    ax0, ay0 = a[0] - a[2] / 2, a[1] - a[3] / 2
    ax1, ay1 = a[0] + a[2] / 2, a[1] + a[3] / 2
    bx0, by0 = b[0] - b[2] / 2, b[1] - b[3] / 2
    bx1, by1 = b[0] + b[2] / 2, b[1] + b[3] / 2
    iw = max(0.0, min(ax1, bx1) - max(ax0, bx0))
    ih = max(0.0, min(ay1, by1) - max(ay0, by0))
    inter = iw * ih
    union = a[2] * a[3] + b[2] * b[3] - inter
    return inter / max(union, 1e-9)


# ---------------------------------------------------------------------------
# training (anchor-free centre assignment, FCOS-style)
# ---------------------------------------------------------------------------

def distill_config(size: int = 128) -> DetectorConfig:
    """The trainable dims of the same OWL-style arch, in f32 (heads of 24
    in the image tower, 12 in the text tower)."""
    return DetectorConfig(image_size=size, patch=16, width=96, depth=4,
                          num_heads=4, text_width=48, text_depth=2,
                          text_len=16, embed_dim=48, dtype=torch.float32)


def _assign(gh: int, gw: int, boxes, labels, valid, shrink: float = 0.7):
    """Per-patch GT assignment: a patch is positive when its centre lies in
    the shrunk box of a valid GT, ties going to the smallest box (FCOS);
    every valid GT also gets its nearest patch. Among equal areas
    ``torch.argmin`` takes the first index, as ``jnp.argmin`` does.
    Returns (assigned (B,P) bool, gt_box (B,P,4), gt_label (B,P))."""
    dev = boxes.device
    ys = (torch.arange(gh, device=dev) + 0.5) / gh
    xs = (torch.arange(gw, device=dev) + 0.5) / gw
    grid = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), -1).reshape(-1, 2)
    d = torch.abs(grid[None, :, None, :] - boxes[:, None, :, :2])  # (B,P,M,2)
    inside = torch.all(d <= shrink * boxes[:, None, :, 2:] / 2, -1)
    dist2 = (d ** 2).sum(-1)                                      # (B,P,M)
    nearest = dist2 == dist2.min(dim=1, keepdim=True).values
    inside = (inside | nearest) & valid[:, None, :]
    area = boxes[..., 2] * boxes[..., 3]
    cost = torch.where(inside, area[:, None, :],
                       torch.full_like(dist2, float("inf")))
    best = torch.argmin(cost, dim=-1)                             # (B,P)
    assigned = torch.isfinite(cost.min(dim=-1).values)
    gt_box = torch.take_along_dim(boxes, best[:, :, None].expand(-1, -1, 4),
                                  dim=1)
    gt_label = torch.take_along_dim(labels, best, dim=1)
    return assigned, gt_box, gt_label


def _sigmoid_bce(logits, labels):
    """``optax.sigmoid_binary_cross_entropy``."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(
        -logits)


def detection_loss(model: OpenVocabDetector, imgs, tokens, boxes, labels,
                   valid):
    """(objectness BCE balanced by the positives + 2·box L1 at the
    positives + the text-grounding BCE over the vocabulary, {"obj", "box",
    "cls"})."""
    sim, obj, pred = model(imgs, tokens, return_logits=True)
    bsz, p, nl = sim.shape
    gh = gw = int(np.sqrt(p))
    assigned, gt_box, gt_label = _assign(gh, gw, boxes, labels, valid)
    af = assigned.float()
    pos = torch.clamp(af.sum(), min=1.0)

    obj_nll = _sigmoid_bce(obj[..., 0], af)
    w_pos = (af.numel() / pos) * 0.5
    obj_loss = (obj_nll * torch.where(assigned, w_pos, 1.0)).mean()

    box_loss = (torch.abs(pred - gt_box).sum(-1) * af).sum() / pos

    tgt = F.one_hot(gt_label.long(), nl).float() * af[..., None]
    cls_nll = _sigmoid_bce(sim, tgt)
    cls_loss = (cls_nll * torch.where(tgt > 0, float(nl), 1.0)).mean()

    return obj_loss + 2.0 * box_loss + cls_loss, {
        "obj": obj_loss, "box": box_loss, "cls": cls_loss}


def trainer_config(cfg: DetectorConfig, device) -> DetectorConfig:
    """``cfg`` as the trainer computes it on ``device``: on the card in
    bf16, the dtype the flash kernels take (Queue 3 bc), on the CPU as
    given."""
    if torch.device(device).type == "cuda":
        return dataclasses.replace(cfg, dtype=torch.bfloat16)
    return cfg


def distill_detector(cfg: Optional[DetectorConfig] = None, steps: int = 600,
                     batch: int = 8, lr: float = 2e-3, seed: int = 0,
                     log_every: int = 50, device="cuda"
                     ) -> Tuple[OpenVocabDetector, np.ndarray]:
    """Train the detector on attribute-grammar scenes → (detector with f32
    weights, the losses). chain(clip_by_global_norm(1), adamw(
    warmup_cosine_decay_schedule(0, lr, min(30, steps // 4), steps), b1
    0.9, b2 0.95, weight decay 1e-4))."""
    cfg = trainer_config(cfg or distill_config(), device)
    s = cfg.image_size
    tokens = torch.from_numpy(tokenize_bytes(VOCAB, cfg.text_len)).long().to(
        device)
    model = OpenVocabDetector(cfg, device=device, param_dtype=torch.float32)
    init_flax_style_(model, torch.Generator(device).manual_seed(seed))
    sched = warmup_cosine_decay_schedule(0.0, lr, min(30, steps // 4), steps)
    opt = OptaxAdamW(model.parameters(), sched, b1=0.9, b2=0.95,
                     weight_decay=1e-4, clip_norm=1.0)

    # after the batch the JAX trainer draws for its init
    with BatchStream(synth_detection_batch, seed, (1, s), (batch, s), steps,
                     on_card(device)) as sample:
        losses = train_steps(
            "detector", steps, sample,
            lambda i, b, lab, v: detection_loss(model, i, tokens, b, lab, v),
            opt, device, log_every)
    return model, losses


# ---------------------------------------------------------------------------
# evaluation against the clustering fallback
# ---------------------------------------------------------------------------

def box_recall(dets, gt_boxes_xyxy: np.ndarray, iou_thr: float = 0.5
               ) -> float:
    """Fraction of GT boxes matched (IoU ≥ thr) by any detection: the
    class-agnostic localisation quality, the clustering fallback's metric."""
    if not len(gt_boxes_xyxy):
        return 1.0
    hit = 0
    for g in gt_boxes_xyxy:
        for d in dets:
            bb = d.box
            ix0, iy0 = max(bb.xmin, g[0]), max(bb.ymin, g[1])
            ix1, iy1 = min(bb.xmax, g[2]), min(bb.ymax, g[3])
            inter = max(0.0, ix1 - ix0) * max(0.0, iy1 - iy0)
            ga = (g[2] - g[0]) * (g[3] - g[1])
            da = (bb.xmax - bb.xmin) * (bb.ymax - bb.ymin)
            if inter / max(ga + da - inter, 1e-9) >= iou_thr:
                hit += 1
                break
    return hit / len(gt_boxes_xyxy)


# ---------------------------------------------------------------------------
# checkpoint + phase-1 consumer
# ---------------------------------------------------------------------------


def save_detector_checkpoint(path: str, model: OpenVocabDetector) -> None:
    """``model``'s weights as the port's checkpoint directory, with its
    config as the sidecar (the JAX writer takes the params and the config;
    the port's module carries both)."""
    save_model(path, model, model.cfg)


def load_detector_checkpoint(path: str, device="cuda") -> OpenVocabDetector:
    """→ the detector with the checkpoint's weights, on ``device``. With a
    ``config.json`` sidecar the config is its dict; the JAX loader computes
    it in f32, and so does the port on the CPU, while on the card it
    computes in bf16, the type the flash kernel takes (ROADMAP Queue 3
    au). Without a sidecar, ``DetectorConfig()``. A missing directory
    raises ``FileNotFoundError``."""
    d = read_config_json(path)
    if d is None:
        cfg = DetectorConfig()
    else:
        on_cpu = torch.device(device).type == "cpu"
        cfg = DetectorConfig(**d, dtype=torch.float32 if on_cpu
                             else torch.bfloat16)
    return load_model(OpenVocabDetector(cfg, device=device), path)
