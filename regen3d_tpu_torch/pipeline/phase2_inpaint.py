"""Phase 2: amodal inpainting and the 3D prep (counterpart of
regen3d_tpu/pipeline/phase2_inpaint.py).

Reference flow (inpaint_nanoBanana.py): each object's amodal completion by
the Gemini image API (``prompt_AQ`` or ``banana_inpainting_prompt``), one
``prompt_empty_room`` call for empty_room.png, then ``prepare_for_hunyuan``:
2× upscale → background removal → square crop around the alpha box with a
margin → edge clean-up → 512² RGBA.

The API boundary is an injectable :class:`ImageGenClient`; without an API
key the :class:`OfflineInpainter` runs, which needs no network: an object's
completion is its finding, the empty room a fill from row medians. The
phase runs on the host in numpy but for the matting net
(``matting_checkpoint``: ``pipeline/matting.py``, on the device); PNG IO
and Pillow's BILINEAR, BICUBIC and LANCZOS resizes are the port's own
(utils/image.py), bit for bit, since the GPU machine has no PIL.
"""

from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Protocol

import numpy as np

from regen3d_tpu_torch.artifacts import Artifacts, parse_finding_stem
from regen3d_tpu_torch.config import Config
from regen3d_tpu_torch.utils.image import (
    _to_rgb,
    decode_png,
    encode_png,
    erode_mask,
    load_image_rgb,
    read_png,
    resize_pil,
    save_image,
    write_png,
)

log = logging.getLogger(__name__)

_SKIP_LABELS = ("wall", "floor", "ceiling")  # inpaint_nanoBanana.py:453


class ImageGenClient(Protocol):
    """The external image-generation boundary."""

    def generate(self, prompt: str, image: np.ndarray, *, temperature: float,
                 top_p: float, seed: int) -> np.ndarray: ...


class GeminiClient:
    """Client of the Gemini image API (reference: process_image_worker,
    inpaint_nanoBanana.py:347-406). Needs the network and GEMINI_API_KEY;
    ``google.genai`` is imported only when one is built."""

    def __init__(self, model_id: str):
        from google import genai  # type: ignore

        self._client = genai.Client()
        self._model = model_id

    def generate(self, prompt, image, *, temperature, top_p, seed):
        from google.genai import types  # type: ignore

        resp = self._client.models.generate_content(
            model=self._model,
            contents=[prompt, types.Part.from_bytes(data=encode_png(image),
                                                    mime_type="image/png")],
            config=types.GenerateContentConfig(
                temperature=temperature, top_p=top_p, seed=seed))
        for part in resp.candidates[0].content.parts:
            if part.inline_data is not None:
                return _to_rgb(*decode_png(part.inline_data.data,
                                           "Gemini response"))
        raise RuntimeError("no image in Gemini response")


class OfflineInpainter:
    """Deterministic offline stand-in: object prompts return the finding
    itself (already on white); the empty-room prompt fills the image from
    its row medians blended with the global median."""

    def __init__(self, findings_dir: str):
        self.findings_dir = findings_dir

    def generate(self, prompt, image, *, temperature, top_p, seed):
        if "EMPTY" in prompt or "empty room" in prompt.lower():
            return self._empty_room(image)
        return image

    @staticmethod
    def _empty_room(image: np.ndarray) -> np.ndarray:
        med = np.median(image.reshape(-1, 3), axis=0)
        rows = np.median(image, axis=1, keepdims=True)
        return np.clip(0.7 * rows + 0.3 * med, 0, 255).astype(np.uint8) \
            * np.ones_like(image)


def prepare_for_3d(png_path: str, out_path: str, size: int = 512,
                   margin: float = 0.08, matting=None) -> None:
    """Prep for the image-to-3D stage (reference: prepare_for_hunyuan,
    inpaint_nanoBanana.py:124-343): 2× BICUBIC upscale → alpha from
    ``matting`` (an object with ``alpha(rgb)``) or, without one, every pixel
    not white (all channels ≥ 246) → a 1-px erosion → a square canvas
    around the alpha box grown by ``margin`` on each side → ``size``² RGBA
    by LANCZOS (premultiplied, as Pillow resizes RGBA)."""
    img, mode = read_png(png_path)
    arr = _to_rgb(img, mode)
    arr = resize_pil(arr, (arr.shape[0] * 2, arr.shape[1] * 2), "bicubic")
    if matting is not None:
        alpha = (np.clip(matting.alpha(arr), 0, 1) * 255).astype(np.uint8)
        alpha = np.where(alpha > 127, alpha, 0)
    else:
        alpha = (~np.all(arr >= 246, axis=-1)).astype(np.uint8) * 255
    # conservative clean-up: drop the 1-px fringe
    core = erode_mask(alpha > 0, 1, 1)
    alpha = np.where(core, alpha, 0).astype(np.uint8)
    ys, xs = np.nonzero(alpha)
    if len(xs) == 0:
        ys, xs = np.mgrid[0:arr.shape[0], 0:arr.shape[1]]
        ys, xs = ys.ravel(), xs.ravel()
    x0, x1 = xs.min(), xs.max() + 1
    y0, y1 = ys.min(), ys.max() + 1
    side = int(max(x1 - x0, y1 - y0) * (1 + 2 * margin))
    cx, cy = (x0 + x1) // 2, (y0 + y1) // 2
    half = side // 2
    canvas = np.zeros((side, side, 4), np.uint8)
    sx0, sy0 = max(0, cx - half), max(0, cy - half)
    sx1, sy1 = min(arr.shape[1], cx + half), min(arr.shape[0], cy + half)
    dx0, dy0 = sx0 - (cx - half), sy0 - (cy - half)
    canvas[dy0:dy0 + (sy1 - sy0), dx0:dx0 + (sx1 - sx0), :3] = arr[sy0:sy1, sx0:sx1]
    canvas[dy0:dy0 + (sy1 - sy0), dx0:dx0 + (sx1 - sx0), 3] = alpha[sy0:sy1, sx0:sx1]
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    write_png(out_path, resize_pil(canvas, (size, size), "lanczos"))


def run(cfg: Config, client: Optional[ImageGenClient] = None,
        device="cuda") -> List[str]:
    """All of phase 2; returns the finding stems inpainted. A
    ``matting_checkpoint`` that names a directory loads the matting net
    (width ``matting_base``) on ``device`` for ``prepare_for_3d``; a
    missing path is logged and the threshold matte runs, as in the JAX
    package."""
    art = Artifacts(cfg)
    os.makedirs(art.inpaint_dir, exist_ok=True)
    os.makedirs(art.prepped_dir, exist_ok=True)

    if client is None:
        if os.environ.get("GEMINI_API_KEY"):
            client = GeminiClient(str(cfg.get("model_id")))
        else:
            log.warning("phase2: no API key — offline inpainter")
            client = OfflineInpainter(art.findings_fullsize)

    matting = None
    ckpt = str(cfg.get("matting_checkpoint", "") or "")
    if ckpt and os.path.isdir(ckpt):
        from regen3d_tpu_torch.pipeline.matting import MattingModel
        matting = MattingModel.load(
            ckpt, base=int(cfg.get("matting_base", 32)), device=device)
        log.info("phase2: matting checkpoint %s", ckpt)
    elif ckpt:
        log.warning("phase2: matting_checkpoint %s missing — threshold "
                    "matting fallback", ckpt)

    use_aq = bool(cfg.get("use_AQ", True))
    src_dir = art.banana_layouts if use_aq else art.banana_outline
    prompt_tpl = str(cfg.get("prompt_AQ") if use_aq
                     else cfg.get("banana_inpainting_prompt"))
    temp = float(cfg.get("genai_temperature", 1.0))
    top_p = float(cfg.get("genai_top_p", 0.95))
    seed = int(cfg.get("seed", 1234567))
    keep = bool(cfg.get("keep_existing_banans", False))

    def one(stem: str) -> Optional[str]:
        out_path = os.path.join(art.inpaint_dir, f"{stem}.png")
        if keep and os.path.exists(out_path):
            return stem
        parsed = parse_finding_stem(stem)
        label = parsed[0] if parsed else stem
        if any(s in label for s in _SKIP_LABELS):
            return None
        src = os.path.join(src_dir, f"{stem}.png")
        if not os.path.exists(src):
            src = os.path.join(art.findings_fullsize, f"{stem}.png")
        if isinstance(client, OfflineInpainter):
            # offline, the best amodal guess is the finding itself
            img = load_image_rgb(os.path.join(art.findings_fullsize,
                                              f"{stem}.png"), max_side=None)
        else:
            img = load_image_rgb(src, max_side=None)
            img = client.generate(prompt_tpl.format(object=label), img,
                                  temperature=temp, top_p=top_p, seed=seed)
        save_image(out_path, img)
        prepare_for_3d(out_path, os.path.join(art.prepped_dir, f"{stem}.png"),
                       size=512, matting=matting)
        return stem

    stems = art.list_findings()
    with ThreadPoolExecutor(max_workers=8) as pool:
        done = [s for s in pool.map(one, stems) if s]

    er_path = art.empty_room
    if not (bool(cfg.get("keep_existing_empty_rooms", True))
            and os.path.exists(er_path)):
        base = load_image_rgb(cfg.path("input_image"), max_side=1280)
        er = client.generate(str(cfg.get("prompt_empty_room")), base,
                             temperature=float(
                                 cfg.get("genai_temperature_emptyRoom", 0.5)),
                             top_p=top_p, seed=seed)
        save_image(er_path, er)
    log.info("phase2: %d objects inpainted + empty room", len(done))
    return done
