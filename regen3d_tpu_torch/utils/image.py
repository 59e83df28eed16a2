"""Host-side image utilities of the port: PNG IO, ``load_image_rgb``, mask
ops, phase 1's finding images and layouts, nearest, BICUBIC and LANCZOS
resizes, GIF, the Radiance HDR codec (counterpart of
regen3d_tpu/utils/image.py), and phase 3's RGBA load.

The GPU machine this port runs on has neither PIL nor OpenCV, so PNG files
go through a small codec on ``zlib`` and ``struct``:

* :func:`write_png` writes 8-bit L, RGB and RGBA, every row unfiltered;
* :func:`read_png` reads 8-bit non-interlaced L, LA, RGB and RGBA with all
  five row filters (PIL writes with adaptive filters) and raises on any
  other layout.

Reading converts as PIL's ``convert`` does (ITU-R 601-2 luma in PIL's
fixed point for RGB → L), and :func:`resize_nearest` reproduces PIL's
``Image.NEAREST`` index mapping, so masks come out bit for bit as the JAX
package's. :func:`load_image_rgb` composites alpha over white
(:func:`alpha_over_white`) and resizes with LANCZOS (:func:`resize_pil`)
in Pillow's fixed-point arithmetic, bit for bit; :func:`resize_pil` does
the same for BICUBIC and for RGBA and LA images, which Pillow resizes
premultiplied by alpha. Erosion and dilation are
the JAX module's numpy branches, which it takes where OpenCV is absent.
:func:`save_gif` needs PIL and imports it inside itself.
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# PNG colour type → channels, for the 8-bit layouts the codec reads
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, arr: np.ndarray) -> None:
    """uint8 (H, W), (H, W, 1), (H, W, 3) or (H, W, 4) → an 8-bit PNG."""
    data = encode_png(arr)
    with open(path, "wb") as f:
        f.write(data)


def encode_png(arr: np.ndarray) -> bytes:
    """uint8 (H, W), (H, W, 1), (H, W, 3) or (H, W, 4) → 8-bit PNG bytes,
    every row unfiltered."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        raise TypeError(f"write_png takes uint8, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.ndim != 3 or arr.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"write_png: unsupported shape {arr.shape}")
    h, w, c = arr.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(arr).reshape(h, w * c)], 1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (_PNG_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _unfilter(raw: np.ndarray, h: int, w: int, c: int) -> np.ndarray:
    """Undo the per-row filters of 8-bit samples → (H, W, C) uint8.

    Sub, Average and Paeth read the byte one pixel to the left, and Up,
    Average and Paeth the byte above, so pixel (r, x) needs (r, x−1),
    (r−1, x) and (r−1, x−1): the rows are decoded together along
    anti-diagonals r + x = d, each filter evaluated and the row's own
    selected."""
    raw = raw.reshape(h, 1 + w * c)
    ftype = raw[:, 0].astype(np.int64)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {int(ftype.max())} is not defined")
    data = raw[:, 1:].reshape(h, w, c).astype(np.int64)
    if not ftype.any():
        return data.astype(np.uint8)
    out = np.zeros((h + 1, w + 1, c), np.int64)    # row 0, column 0: zeros
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        x = d - r
        a = out[r + 1, x]                           # left
        b = out[r, x + 1]                           # above
        cc = out[r, x]                              # above-left
        p = a + b - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
        pred = np.choose(ftype[r][:, None],
                         [np.zeros_like(a), a, b, (a + b) // 2, paeth])
        out[r + 1, x + 1] = (data[r, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def read_png(path: str) -> Tuple[np.ndarray, str]:
    """An 8-bit PNG → (uint8 (H, W, C), mode "L", "LA", "RGB" or "RGBA")."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    return _decode_png(buf, path)


# leading bytes of the formats a texture or an image API may carry
_SIGNATURES = ((b"\xff\xd8\xff", "JPEG"), (b"GIF8", "GIF"), (b"BM", "BMP"),
               (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"),
               (b"\x00\x00\x00\x0cjP  ", "JPEG 2000"))


def image_format(data: bytes) -> str:
    """The name of the image format ``data`` starts with ("PNG", "JPEG",
    "WebP", ...; "unknown" when none matches)."""
    if data[:8] == _PNG_SIG:
        return "PNG"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    return next((name for sig, name in _SIGNATURES if data.startswith(sig)),
                "unknown")


def decode_png(data: bytes, what: str = "image") -> Tuple[np.ndarray, str]:
    """PNG bytes → (uint8 (H, W, C), mode), as :func:`read_png`; bytes of
    another format raise ``NotImplementedError`` naming it (no PIL on the
    GPU machine to decode them)."""
    if data[:8] != _PNG_SIG:
        raise NotImplementedError(
            f"{what}: {image_format(data)} data; only PNG is decoded (no PIL "
            "to decode other formats)")
    return _decode_png(data, what)


def _decode_png(buf: bytes, path: str) -> Tuple[np.ndarray, str]:
    pos, ihdr, idat = 8, None, []
    while pos < len(buf):
        (n,) = struct.unpack(">I", buf[pos:pos + 4])
        tag, data = buf[pos + 4:pos + 8], buf[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", buf[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(tag + data) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in chunk {tag!r}")
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if ihdr is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    w, h, depth, ctype, comp, filt, interlace = ihdr
    if depth != 8 or ctype not in _CHANNELS or comp or filt or interlace:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace}); 8-bit non-interlaced L, LA, RGB and "
            "RGBA are read")
    c = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * c):
        raise ValueError(f"{path}: IDAT holds {raw.size} bytes, expected "
                         f"{h * (1 + w * c)}")
    mode = {0: "L", 2: "RGB", 4: "LA", 6: "RGBA"}[ctype]
    return _unfilter(raw, h, w, c), mode


def _to_l(img: np.ndarray, mode: str) -> np.ndarray:
    """PIL's ``convert("L")``: luma R·299/1000 + G·587/1000 + B·114/1000 in
    its 16-bit fixed point, rounded."""
    if mode in ("L", "LA"):
        return img[..., 0]
    r, g, b = (img[..., i].astype(np.int64) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def _to_rgb(img: np.ndarray, mode: str) -> np.ndarray:
    """PIL's ``convert("RGB")``: grey replicated, alpha dropped."""
    if mode in ("L", "LA"):
        return np.repeat(img[..., :1], 3, axis=-1)
    return img[..., :3]


# --- load_image_rgb: alpha over white and LANCZOS, as Pillow computes them --

# Pillow's fixed point: 22 fractional bits in the resampler
# (libImaging/Resample.c), 7 in alpha compositing (libImaging/AlphaComposite.c)
_RESAMPLE_BITS = 22
_COMPOSITE_BITS = 7


def _lanczos(x: float) -> float:
    """Pillow's truncated sinc: sinc(x)·sinc(x/3) on [−3, 3)."""
    if not -3.0 <= x < 3.0:
        return 0.0

    def sinc(v):
        if v == 0.0:
            return 1.0
        v = v * math.pi
        return math.sin(v) / v

    return sinc(x) * sinc(x / 3.0)


def _bicubic(x: float) -> float:
    """Pillow's bicubic convolution kernel, a = −0.5, on (−2, 2)."""
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


# Pillow's filters by name: (kernel, support)
_FILTERS = {"lanczos": (_lanczos, 3.0), "bicubic": (_bicubic, 2.0)}


def _resample_coeffs(n_in: int, n_out: int, filt: str = "lanczos"
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's ``precompute_coeffs`` over the whole axis and
    ``normalize_coeffs_8bpc``: (first source index (n_out,), fixed-point
    weights (n_out, ksize) int64, 0 past each window). The arithmetic is
    Pillow's double-precision order, with libm's ``sin``."""
    kernel, base_support = _FILTERS[filt]
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = base_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(n_out, np.int64)
    kk = np.zeros((n_out, ksize), np.int64)
    ss = 1.0 / filterscale
    for xx in range(n_out):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), n_in) - xmin
        k = [kernel((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        for x, w in enumerate(k):
            w = w / ww if ww != 0.0 else w
            w = w * (1 << _RESAMPLE_BITS)
            kk[xx, x] = int(w - 0.5) if w < 0 else int(w + 0.5)
        first[xx] = xmin
    return first, kk


def _resample_axis(img: np.ndarray, n_out: int, axis: int,
                   filt: str = "lanczos") -> np.ndarray:
    """One of Pillow's 8-bit passes along ``axis`` of (H, W, C) uint8:
    Σ pixel·weight from half a unit, then >> 22 clipped to [0, 255]."""
    n_in = img.shape[axis]
    first, kk = _resample_coeffs(n_in, n_out, filt)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((n_out,) + src.shape[1:], 1 << (_RESAMPLE_BITS - 1), np.int64)
    bshape = (n_out,) + (1,) * (src.ndim - 1)
    for x in range(kk.shape[1]):
        idx = np.minimum(first + x, n_in - 1)
        acc += src[idx] * kk[:, x].reshape(bshape)
    out = np.clip(acc >> _RESAMPLE_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _premultiply(img: np.ndarray) -> np.ndarray:
    """Pillow's RGBA → RGBa (LA → La): each colour times alpha / 255 as
    (c·a + 128 + ((c·a + 128) >> 8)) >> 8."""
    x = img.astype(np.int64)
    tmp = x[..., :-1] * x[..., -1:] + 128
    return np.concatenate([((tmp >> 8) + tmp) >> 8, x[..., -1:]],
                          -1).astype(np.uint8)


def _unpremultiply(img: np.ndarray) -> np.ndarray:
    """Pillow's RGBa → RGBA (La → LA): each colour 255·c // alpha clipped
    to 255, unchanged where alpha is 0 or 255."""
    x = img.astype(np.int64)
    a = x[..., -1:]
    div = np.minimum(255 * x[..., :-1] // np.maximum(a, 1), 255)
    col = np.where((a == 0) | (a == 255), x[..., :-1], div)
    return np.concatenate([col, a], -1).astype(np.uint8)


def resize_pil(arr: np.ndarray, hw: Tuple[int, int],
               filt: str = "lanczos") -> np.ndarray:
    """``Image.fromarray(arr).resize((w, h), filter)`` of a uint8 L (H, W),
    RGB or RGBA array (or LA with ``arr`` (H, W, 2)) with ``filt``
    "lanczos" or "bicubic", bit for bit: the horizontal pass first, then
    the vertical, each only where that axis changes size; RGBA and LA are
    premultiplied by alpha before and divided after, as Pillow converts
    them to RGBa and La. The same size returns a copy, as Pillow does."""
    h, w = hw
    out = np.asarray(arr)
    if out.shape[:2] == (h, w):
        return out.copy()
    squeeze = out.ndim == 2
    if squeeze:
        out = out[..., None]
    alpha = out.shape[-1] in (2, 4)
    if alpha:
        out = _premultiply(out)
    if out.shape[1] != w:
        out = _resample_axis(out, w, 1, filt)
    if out.shape[0] != h:
        out = _resample_axis(out, h, 0, filt)
    if alpha:
        out = _unpremultiply(out)
    return out[..., 0] if squeeze else out


def alpha_over_white(rgba: np.ndarray) -> np.ndarray:
    """``Image.alpha_composite(white, img).convert("RGB")`` of (H, W, 4)
    uint8, bit for bit (Pillow's 7-bit fixed point, divisions by 255 as
    (a + (a >> 8)) >> 8)."""
    src = rgba.astype(np.int64)
    a = src[..., 3:4]
    blend = 255 * (255 - a)
    outa255 = a * 255 + blend
    coef1 = a * 255 * 255 * (1 << _COMPOSITE_BITS) // np.maximum(outa255, 1)
    coef2 = 255 * (1 << _COMPOSITE_BITS) - coef1
    tmp = src[..., :3] * coef1 + 255 * coef2 + (0x80 << _COMPOSITE_BITS)
    out = (((tmp >> 8) + tmp) >> 8) >> _COMPOSITE_BITS
    out = np.where(a == 0, 255, out)
    return out.astype(np.uint8)


def load_image_rgb(path: str, max_side: Optional[int] = 1280) -> np.ndarray:
    """A PNG → RGB uint8, as the JAX package's ``load_image_rgb`` gives it:
    alpha composited over white, then resized with LANCZOS so the longest
    side is at most ``max_side``. Other formats raise: the GPU machine has
    no PIL to decode them."""
    with open(path, "rb") as f:
        sig = f.read(16)
    if sig[:8] != _PNG_SIG:
        raise NotImplementedError(
            f"{path}: load_image_rgb reads PNG only, not {image_format(sig)} "
            "(no PIL to decode other formats)")
    img, mode = read_png(path)
    if mode in ("RGBA", "LA"):
        rgba = (img if mode == "RGBA" else
                np.concatenate([np.repeat(img[..., :1], 3, -1), img[..., 1:]],
                               -1))
        rgb = alpha_over_white(rgba)
    else:
        rgb = _to_rgb(img, mode)
    h, w = rgb.shape[:2]
    if max_side and max(w, h) > max_side:
        scale = max_side / max(w, h)
        rgb = resize_pil(rgb, (round(h * scale), round(w * scale)), "lanczos")
    return np.ascontiguousarray(rgb)


def load_image_rgba(path: str) -> np.ndarray:
    """A PNG → RGBA uint8 (H, W, 4), as PIL's ``convert("RGBA")`` gives it:
    grey replicated into R, G and B, and an opaque alpha (255) where the
    file has none."""
    img, mode = read_png(path)
    rgb = _to_rgb(img, mode)
    alpha = (img[..., -1:] if mode in ("RGBA", "LA")
             else np.full(img.shape[:2] + (1,), 255, np.uint8))
    return np.ascontiguousarray(np.concatenate([rgb, alpha], -1))


def save_image(path: str, arr: np.ndarray) -> None:
    """Array → PNG, converted to uint8 as the JAX package does (floats in
    [0, 1] scaled by 255, then clipped)."""
    if not path.lower().endswith(".png"):
        raise ValueError(f"save_image writes PNG only, not {path}")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0 if arr.max() <= 1.0 + 1e-6 else arr,
                      0, 255).astype(np.uint8)
    write_png(path, arr)


def load_mask(path: str) -> np.ndarray:
    """Grayscale mask PNG → bool (H, W)."""
    return _to_l(*read_png(path)) > 127


def mask_from_finding(path: str, white_thr: int = 250) -> np.ndarray:
    """Binary mask from a white-background finding PNG: non-white pixels
    (reference: extract_pc_object.py:66-126)."""
    rgb = _to_rgb(*read_png(path))
    return ~np.all(rgb >= white_thr, axis=-1)


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """PIL's NEAREST source index per output position: the position starts
    at half a step and adds the step (n_in / n_out, double) once per pixel,
    then truncates."""
    step = n_in / n_out
    pos = np.full(n_out, step)
    pos[0] = step * 0.5
    return np.add.accumulate(pos).astype(np.int64)


def resize_nearest(arr: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """``Image.fromarray(arr).resize((w, h), Image.NEAREST)`` without PIL."""
    h, w = hw
    return arr[_nearest_index(arr.shape[0], h)][:, _nearest_index(arr.shape[1], w)]


def erode_mask(mask: np.ndarray, pixels: int = 4, iterations: int = 4) -> np.ndarray:
    """Erode ``pixels·iterations`` times by the 4-neighbour cross, the image
    border eroding (the JAX module's branch without OpenCV;
    mask_shrink_pixels/iterations, config.yaml:265-267)."""
    out = mask.copy()
    for _ in range(iterations * pixels):
        inner = out[1:-1, 1:-1]
        inner &= out[:-2, 1:-1] & out[2:, 1:-1] & out[1:-1, :-2] & out[1:-1, 2:]
        shr = np.zeros_like(out)
        shr[1:-1, 1:-1] = inner
        out = shr
    return out


def dilate_mask(mask: np.ndarray, pixels: int = 3) -> np.ndarray:
    """Dilate ``pixels`` times by the 4-neighbour cross (the JAX module's
    branch without OpenCV)."""
    out = mask.copy()
    for _ in range(pixels):
        grown = out.copy()
        grown[1:, :] |= out[:-1, :]
        grown[:-1, :] |= out[1:, :]
        grown[:, 1:] |= out[:, :-1]
        grown[:, :-1] |= out[:, 1:]
        out = grown
    return out


def mask_centroid(mask: np.ndarray) -> Tuple[int, int]:
    """Integer (cx, cy) pixel centroid — the identity half of the
    `<label>__(cx, cy)` finding-name contract."""
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return 0, 0
    return int(round(xs.mean())), int(round(ys.mean()))


def mask_bbox(mask: np.ndarray) -> Tuple[int, int, int, int]:
    """(x0, y0, x1, y1) inclusive-exclusive bounds."""
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return 0, 0, 0, 0
    return int(xs.min()), int(ys.min()), int(xs.max()) + 1, int(ys.max()) + 1


# --- phase 1's finding images (save_masked_findings and
# save_findings_banana, segmentation.py:828-1028; create_segmentation_layout,
# global_utils.py:18-257) ------------------------------------------------------

def masked_on_white(image: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Object pixels on a white background (the finding PNG format)."""
    out = np.full_like(image, 255)
    out[mask] = image[mask]
    return out


def padded_crop(image: np.ndarray, bbox: Tuple[int, int, int, int],
                padding: int = 5) -> np.ndarray:
    """``image`` cut to ``bbox`` grown by ``padding`` px, clamped to the
    image."""
    x0, y0, x1, y1 = bbox
    h, w = image.shape[:2]
    return image[max(0, y0 - padding):min(h, y1 + padding),
                 max(0, x0 - padding):min(w, x1 + padding)]


def draw_outline(image: np.ndarray, mask: np.ndarray,
                 color: Sequence[int] = (255, 0, 0), thickness: int = 3,
                 offset_px: int = 5) -> np.ndarray:
    """A ``thickness``-px ring ``offset_px`` outside the mask, in ``color``
    (the 'banana' prompt image); dilation by the 4-neighbour cross."""
    grown = dilate_mask(mask, offset_px)
    ring = dilate_mask(grown, thickness) & ~grown
    out = image.copy()
    out[ring] = color
    return out


def draw_bbox(image: np.ndarray, bbox: Tuple[int, int, int, int],
              color: Sequence[int] = (255, 0, 0), thickness: int = 2,
              padding: int = 6) -> np.ndarray:
    """``bbox`` grown by ``padding`` px drawn as a ``thickness``-px frame."""
    x0, y0, x1, y1 = bbox
    h, w = image.shape[:2]
    x0 = max(0, x0 - padding)
    y0 = max(0, y0 - padding)
    x1 = min(w - 1, x1 + padding)
    y1 = min(h - 1, y1 + padding)
    out = image.copy()
    for t in range(thickness):
        out[max(0, y0 - t), x0:x1] = color
        out[min(h - 1, y1 + t), x0:x1] = color
        out[y0:y1, max(0, x0 - t)] = color
        out[y0:y1, min(w - 1, x1 + t)] = color
    return out


def segmentation_layout(image: np.ndarray, mask: np.ndarray,
                        panel_scale: float = 1.0) -> np.ndarray:
    """Side-by-side canvas: the image with the object outlined on the left,
    an empty white 'Extracted Object' panel on the right (the prompt canvas
    of the amodal-extraction path)."""
    h, w = image.shape[:2]
    panel_w = int(w * panel_scale)
    canvas = np.full((h + 40, w + panel_w + 30, 3), 240, np.uint8)
    canvas[30:30 + h, 10:10 + w] = draw_outline(image, mask)
    canvas[30:30 + h, w + 20:w + 20 + panel_w] = 255
    return canvas


def extract_layout_panel(layout: np.ndarray, orig_hw: Tuple[int, int],
                         panel_scale: float = 1.0) -> np.ndarray:
    """Inverse of :func:`segmentation_layout`: the 'Extracted Object' panel."""
    h, w = orig_hw
    return layout[30:30 + h, w + 20:w + 20 + int(w * panel_scale)]


def save_gif(path: str, frames: List[np.ndarray], fps: int = 10) -> None:
    """Optimization-preview GIF (reference: per-object GIFs,
    pose_matching_planar.py:1687-1716). GIF encoding needs PIL."""
    from PIL import Image

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    imgs = []
    for f in frames:
        if f.dtype != np.uint8:
            f = np.clip(f * 255.0 if f.max() <= 1.0 + 1e-6 else f,
                        0, 255).astype(np.uint8)
        imgs.append(Image.fromarray(f))
    if imgs:
        imgs[0].save(path, save_all=True, append_images=imgs[1:],
                     duration=int(1000 / fps), loop=0)


def load_hdr(path: str) -> np.ndarray:
    """A Radiance RGBE (.hdr) file → (H, W, 3) float32 linear, as the JAX
    package's loader reads it: the "-Y H +X W" layout, new-style RLE or flat
    scanlines, each channel mantissa·2^(e − 136)."""
    with open(path, "rb") as f:
        if not f.readline().startswith(b"#?"):
            raise ValueError("not a Radiance HDR file")
        while True:
            line = f.readline()
            if line in (b"\n", b"\r\n"):
                break
        dims = f.readline().split()
        if dims[0] != b"-Y" or dims[2] != b"+X":
            raise ValueError(f"unsupported HDR layout: {dims}")
        h, w = int(dims[1]), int(dims[3])
        data = f.read()

    rgbe = np.zeros((h, w, 4), np.uint8)
    pos = 0
    for y in range(h):
        if (pos + 4 <= len(data) and data[pos] == 2 and data[pos + 1] == 2
                and (data[pos + 2] << 8 | data[pos + 3]) == w):
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = data[pos]
                    pos += 1
                    if count > 128:           # a run
                        rgbe[y, x:x + count - 128, c] = data[pos]
                        pos += 1
                        x += count - 128
                    else:                     # literals
                        rgbe[y, x:x + count, c] = np.frombuffer(
                            data, np.uint8, count, pos)
                        pos += count
                        x += count
        else:                                 # a flat scanline
            rgbe[y] = np.frombuffer(data, np.uint8, w * 4, pos).reshape(w, 4)
            pos += w * 4
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp > 0, np.ldexp(1.0, exp - 136), 0.0)
    return (rgbe[..., :3].astype(np.float32) * scale[..., None]
            ).astype(np.float32)


def save_hdr(path: str, img: np.ndarray) -> None:
    """(H, W, 3) float linear → a flat (not RLE) Radiance HDR file, the JAX
    package's bytes: a shared exponent ⌊log2 max⌋ + 1 per pixel."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    m = img.max(axis=-1)
    exp = np.where(m > 1e-32, np.floor(np.log2(np.maximum(m, 1e-32))) + 1, 0)
    # mantissa = c / 2^e · 256 = c · 2^(8 − e)
    scale = np.where(m > 1e-32, np.ldexp(1.0, (8 - exp).astype(np.int32)),
                     0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(m > 1e-32, exp + 128, 0).astype(np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())
