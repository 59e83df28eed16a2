"""Interactive segmentation editing, the manual editor's engine
(counterpart of regen3d_tpu/pipeline/interactive.py).

An :class:`EditSession` holds one image's editable masks and the verbs of
the reference editor: ± points, a mask from a box, delete, merge,
overlap resolution and finish, which returns the edited detections. With
the port's :class:`~regen3d_tpu_torch.models.sam.SAM` every edit
re-decodes from one cached image embedding (the encode runs once per
session, on the device the model lives on); without one, a positive or
negative point paints or erases a disc of radius 0.02·W and a box fills
its rectangle. ``pipeline/editor_ui.py`` serves the verbs over HTTP.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from regen3d_tpu_torch.models.layers import resize_bilinear
from regen3d_tpu_torch.pipeline.detection import BoundingBox, DetectionResult
from regen3d_tpu_torch.utils.image import mask_bbox


@dataclasses.dataclass
class EditableMask:
    label: str
    mask: np.ndarray                      # (H, W) bool
    points: List[Tuple[float, float, int]] = dataclasses.field(
        default_factory=list)             # (x, y, 1 or 0) prompt history
    score: float = 1.0


class EditSession:
    """A stateful editing session over one (H, W, 3) uint8 image, seeded
    with the masks of ``initial`` detections."""

    def __init__(self, image: np.ndarray, sam=None,
                 initial: Optional[List[DetectionResult]] = None):
        self.image = image
        self.h, self.w = image.shape[:2]
        self.sam = sam
        self._embedding = None
        self.masks: List[EditableMask] = [
            EditableMask(d.label, d.mask.copy(), score=d.score)
            for d in (initial or []) if d.mask is not None
        ]

    # --- SAM plumbing -----------------------------------------------------
    @torch.no_grad()
    def _embed(self) -> torch.Tensor:
        """The image's embedding, encoded once: /255, then bilinear to
        SAM's input size."""
        if self._embedding is None:
            size = self.sam.cfg.image_size
            img = torch.from_numpy(np.ascontiguousarray(self.image)).to(
                next(self.sam.parameters()).device)
            self._embedding = self.sam.encode(resize_bilinear(
                img[None].float() / 255.0, (size, size)))
        return self._embedding

    @torch.no_grad()
    def _predict(self, points, labels, box=None) -> np.ndarray:
        """The mask of the best-IoU head for the prompts: points in pixels
        normalised by (W, H) (none: one padding point), the box likewise
        (none: the whole image); its logits resized bilinearly to (H, W),
        thresholded at 0."""
        emb = self._embed()
        dev = emb.device
        if len(points):
            pts = (np.asarray(points, np.float32).reshape(1, -1, 2)
                   / [self.w, self.h]).astype(np.float32)
            labs = np.asarray(labels, np.float32).reshape(1, -1)
        else:
            pts = np.zeros((1, 1, 2), np.float32)
            labs = -np.ones((1, 1), np.float32)
        bx = (np.asarray([[[box[0] / self.w, box[1] / self.h],
                           [box[2] / self.w, box[3] / self.h]]], np.float32)
              if box else np.asarray([[[0.0, 0.0], [1.0, 1.0]]], np.float32))
        masks, iou = self.sam.decode(emb, *(torch.from_numpy(a).to(dev)
                                            for a in (pts, labs, bx)))
        best = int(np.argmax(iou[0].float().cpu().numpy()))
        logits = resize_bilinear(masks[0, best][None, ..., None].float(),
                                 (self.h, self.w))[0, ..., 0]
        return (logits > 0).cpu().numpy()

    # --- editing verbs ----------------------------------------------------
    def add_point(self, idx: int, x: float, y: float, positive: bool = True
                  ) -> None:
        """Refine mask #idx with a ± click: SAM re-decodes the mask from
        the whole point history; without SAM a disc is painted or erased."""
        m = self.masks[idx]
        m.points.append((x, y, 1 if positive else 0))
        if self.sam is not None:
            m.mask = self._predict([(px, py) for px, py, _ in m.points],
                                   [lab for _, _, lab in m.points])
        else:
            yy, xx = np.ogrid[:self.h, :self.w]
            disc = (xx - x) ** 2 + (yy - y) ** 2 <= (0.02 * self.w) ** 2
            m.mask = (m.mask | disc) if positive else (m.mask & ~disc)

    def new_from_box(self, label: str, x0: float, y0: float,
                     x1: float, y1: float) -> int:
        if self.sam is not None:
            mask = self._predict([], [], box=(x0, y0, x1, y1))
        else:
            mask = np.zeros((self.h, self.w), bool)
            mask[int(y0):int(y1), int(x0):int(x1)] = True
        self.masks.append(EditableMask(label, mask))
        return len(self.masks) - 1

    def delete(self, idx: int) -> None:
        self.masks.pop(idx)

    def merge(self, i: int, j: int) -> None:
        a, b = self.masks[i], self.masks[j]
        a.mask = a.mask | b.mask
        self.masks.pop(j)

    def resolve_overlaps(self) -> None:
        """Each pixel belongs to one mask at most: smaller masks win (the
        reference's policy for nested objects)."""
        order = sorted(range(len(self.masks)),
                       key=lambda i: self.masks[i].mask.sum())
        taken = np.zeros((self.h, self.w), bool)
        for i in order:
            m = self.masks[i]
            m.mask = m.mask & ~taken
            taken |= m.mask

    def finish(self) -> List[DetectionResult]:
        """The non-empty masks as detections, boxed by their extent."""
        out = []
        for m in self.masks:
            if not m.mask.any():
                continue
            x0, y0, x1, y1 = mask_bbox(m.mask)
            out.append(DetectionResult(score=m.score, label=m.label,
                                       box=BoundingBox(x0, y0, x1, y1),
                                       mask=m.mask))
        return out


def launch_gradio_editor(session: EditSession):
    """The JAX package's name for the editor: the dependency-free HTTP
    editor (``pipeline/editor_ui.launch_editor``)."""
    from regen3d_tpu_torch.pipeline.editor_ui import launch_editor
    return launch_editor(session)
