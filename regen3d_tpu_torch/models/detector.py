"""Open-vocabulary detector for phase 1 (counterpart of
regen3d_tpu/models/detector.py): the OWL-ViT-style family the JAX package
puts in Grounding-DINO's place. A ViT image tower gives per-patch
embeddings, a byte-level text transformer one embedding per label; a
patch↔label similarity times a per-patch objectness gives the scores and a
per-patch head the boxes. ``detect(image, labels, threshold)`` returns
``DetectionResult``s, as the JAX ``detect`` does.

At ``DetectorConfig()`` the image tower is a 768² ViT (patch 16: 2,304
tokens, width 512, depth 12, 8 heads of 64) and the text tower 4 blocks of
width 256 (4 heads of 64) over 24 bytes: the flash forward kernel runs at
(1, 8, 2304, 2304, 64) and at (L labels, 4, 24, 24, 64). Numerics follow
the JAX module's dtypes: the trunks in ``cfg.dtype`` (bf16 by default,
which the kernel takes), the byte embedding, the towers' final LayerNorms
and every head in f32. The module holds its own weights, stored in
``param_dtype`` where given (f32 for training, as flax keeps them) and in
each layer's compute dtype otherwise, and is built on the card unless the
caller passes ``device``; submodule names follow the
flax tree (``models/from_jax.py``).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch
import torch.nn as nn

from regen3d_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    PatchEmbed,
    TransformerBlock,
    init_flax_layers_,
    posemb_sincos_2d,
    resize_bilinear,
    store_params_,
)
from regen3d_tpu_torch.pipeline.detection import BoundingBox, DetectionResult


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    image_size: int = 768
    patch: int = 16
    width: int = 512
    depth: int = 12
    num_heads: int = 8
    text_width: int = 256
    text_depth: int = 4
    text_len: int = 24
    embed_dim: int = 256
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def tiny(cls) -> "DetectorConfig":
        return cls(image_size=64, patch=16, width=64, depth=2, num_heads=4,
                   text_width=32, text_depth=1, text_len=12, embed_dim=32)


def tokenize_bytes(labels: List[str], max_len: int) -> np.ndarray:
    """Byte-level tokens (L, max_len) int32: the lower-cased UTF-8 bytes,
    cut to max_len − 1, then EOS (1), then zeros."""
    out = np.zeros((len(labels), max_len), np.int32)
    for i, s in enumerate(labels):
        b = s.lower().encode("utf-8")[: max_len - 1]
        out[i, :len(b)] = np.frombuffer(b, np.uint8)
        out[i, len(b)] = 1  # EOS
    return out


def _unit(z: torch.Tensor) -> torch.Tensor:
    return z / torch.clamp(torch.linalg.vector_norm(z, dim=-1, keepdim=True),
                           min=1e-8)


class TextEncoder(nn.Module):
    """(L, T) int tokens → (L, embed_dim) unit f32 label embeddings."""

    def __init__(self, c: DetectorConfig, device="cuda"):
        super().__init__()
        self.depth = c.text_depth
        self.byte_embed = nn.Embedding(257, c.text_width, device=device)
        self.pos = nn.Parameter(torch.zeros(c.text_len, c.text_width,
                                            device=device))
        for i in range(c.text_depth):
            setattr(self, f"block{i}", TransformerBlock(
                c.text_width, 4, dtype=c.dtype, device=device))
        self.norm = LayerNorm(c.text_width, device=device)
        self.proj = Dense(c.text_width, c.embed_dim, device=device)

    def forward(self, tokens):
        h = self.byte_embed(tokens) + self.pos[None]
        for i in range(self.depth):
            h = getattr(self, f"block{i}")(h)
        return _unit(self.proj(self.norm(h).mean(1)))


class DetectorImageTower(nn.Module):
    """(B, S, S, 3) in [0, 1] → ((B, P, width) f32 features, (gh, gw))."""

    def __init__(self, c: DetectorConfig, device="cuda"):
        super().__init__()
        self.dtype, self.width, self.depth = c.dtype, c.width, c.depth
        self.patch = PatchEmbed(c.patch, c.width, dtype=c.dtype,
                                device=device)
        for i in range(c.depth):
            setattr(self, f"block{i}", TransformerBlock(
                c.width, c.num_heads, dtype=c.dtype, device=device))
        self.norm = LayerNorm(c.width, device=device)

    def forward(self, img):
        x, (gh, gw) = self.patch(img.to(self.dtype))
        x = x + posemb_sincos_2d(gh, gw, self.width,
                                 device=x.device)[None].to(self.dtype)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        return self.norm(x), (gh, gw)


class OpenVocabDetector(nn.Module):
    def __init__(self, cfg: DetectorConfig = DetectorConfig(), device="cuda",
                 param_dtype=None):
        super().__init__()
        self.cfg = cfg
        self.image = DetectorImageTower(cfg, device=device)
        self.text = TextEncoder(cfg, device=device)
        self.patch_proj = Dense(cfg.width, cfg.embed_dim, device=device)
        self.box_head = Dense(cfg.width, 4, device=device)
        self.obj_head = Dense(cfg.width, 1, device=device)
        self.logit_scale = nn.Parameter(torch.tensor(2.0, device=device))
        store_params_(self, param_dtype)

    def forward(self, img, tokens, return_logits: bool = False):
        """img (B, S, S, 3) in [0, 1], tokens (L, T) → (scores (B, P, L),
        boxes (B, P, 4) as (cx, cy, w, h) in [0, 1]), f32. With
        ``return_logits`` (the distillation trainer's path), (sim (B, P, L),
        obj (B, P, 1), boxes): the pre-sigmoid similarity and objectness
        logits in place of the fused score, as the JAX module returns."""
        feats, (gh, gw) = self.image(img)
        z_img = _unit(self.patch_proj(feats))
        z_txt = self.text(tokens)
        sim = torch.einsum("bpe,le->bpl", z_img, z_txt) * torch.exp(
            self.logit_scale)
        obj = self.obj_head(feats)
        dev = feats.device
        ys = (torch.arange(gh, dtype=torch.float32, device=dev) + 0.5) / gh
        xs = (torch.arange(gw, dtype=torch.float32, device=dev) + 0.5) / gw
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        grid = torch.stack([gx, gy], -1).reshape(-1, 2)
        raw = self.box_head(feats)
        cxcy = torch.sigmoid(raw[..., :2]) * 0.5 - 0.25 + grid[None]
        boxes = torch.cat([cxcy, torch.sigmoid(raw[..., 2:])], -1)
        if return_logits:
            return sim, obj, boxes
        return torch.sigmoid(sim) * torch.sigmoid(obj), boxes

    @torch.no_grad()
    def detect(self, image: np.ndarray, labels: List[str],
               threshold: float = 0.25, max_dets: int = 32
               ) -> List[DetectionResult]:
        """(H, W, 3) uint8 → the best (patch, label) pairs, at most
        ``max_dets``, down to ``threshold``, boxes in pixels. The image is
        resized as ``jax.image.resize`` does (antialiased when it shrinks);
        the scores are ordered on the host with the JAX package's
        ``np.argsort(flat)[::-1]``, so ties fall alike."""
        c = self.cfg
        h, w = image.shape[:2]
        dev = self.logit_scale.device
        img = torch.from_numpy(np.ascontiguousarray(image)).to(dev)
        img = resize_bilinear(img[None].float() / 255.0,
                              (c.image_size, c.image_size))
        tokens = torch.from_numpy(tokenize_bytes(labels, c.text_len)).to(dev)
        scores, boxes = self(img, tokens.long())
        scores = scores[0].cpu().numpy()      # (P, L)
        boxes = boxes[0].cpu().numpy()        # (P, 4)
        flat = scores.reshape(-1)
        out: List[DetectionResult] = []
        for idx in np.argsort(flat)[::-1][:max_dets]:
            p, lab = divmod(int(idx), len(labels))
            s = float(flat[idx])
            if s < threshold:
                break
            cx, cy, bw, bh = boxes[p]
            out.append(DetectionResult(
                score=s, label=labels[lab],
                box=BoundingBox((cx - bw / 2) * w, (cy - bh / 2) * h,
                                (cx + bw / 2) * w, (cy + bh / 2) * h)))
        return out


def init_flax_style_(model: OpenVocabDetector,
                     generator: torch.Generator) -> None:
    """Random init from ``generator`` with the JAX module's initializers:
    flax's layer defaults, the byte embedding N(0, 1 / text_width) (flax
    ``Embed``'s variance scaling), the text position table N(0, 0.02²) and
    ``logit_scale`` 2."""
    init_flax_layers_(model, generator)
    with torch.no_grad():
        emb = model.text.byte_embed.weight
        emb.normal_(0.0, emb.shape[1] ** -0.5, generator=generator)
        model.text.pos.normal_(0.0, 0.02, generator=generator)
        model.logit_scale.fill_(2.0)
