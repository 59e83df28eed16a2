"""Depth distillation (counterpart of regen3d_tpu/pipeline/depth_distill.py):
synthetic rooms with exact z-buffer depth, the MiDaS scale-and-shift
invariant loss, the trainer, the luminance prior it must beat, and the
Depth-Anything checkpoint's writer and loader. The checkpoint is a
directory of either kind ``models/weights.py`` reads, with a
``config.json`` sidecar of the ``DepthAnythingConfig`` (without its dtype)
that ``pipeline/depth.py``'s ``depth_anything_checkpoint`` honours.

A room is built in view space from ``np.random.default_rng(seed)`` (the
JAX package's draws) and rendered by the port's ``ops/rasterize.
rasterize_hard`` on ``device``; XLA fuses the projection's multiply-adds
where eager PyTorch rounds each product, so a pixel centre on a face edge
can fall in the other face and disparities agree to f32 rounding elsewhere
(ROADMAP Queue 3 ag). The trainer keeps the weights in f32 and computes in
``cfg.dtype``; at ``micro_config()`` the heads are 16 wide.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np
import torch

from regen3d_tpu_torch.models.depth_anything import (
    DepthAnything,
    DepthAnythingConfig,
    init_flax_style_,
)
from regen3d_tpu_torch.models.from_jax import DEPTH_ANYTHING_CONV_TRANSPOSE
from regen3d_tpu_torch.models.weights import (
    load_model,
    read_config_json,
    save_model,
)
from regen3d_tpu_torch.ops.rasterize import rasterize_hard
from regen3d_tpu_torch.parallel.batches import BatchStream
from regen3d_tpu_torch.parallel.train import (
    OptaxAdamW,
    cosine_decay_schedule,
    on_card,
    train_steps,
)

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# synthetic rooms with exact z-buffer depth
# ---------------------------------------------------------------------------

def _quad(p0, p1, p2, p3):
    """Two triangles for the quad p0-p1-p2-p3 (in order)."""
    return [[p0, p1, p2], [p0, p2, p3]]


def _box_tris(cx, cz, w, h, d):
    """Axis-aligned box on the floor (y = +1 is down in view space); a
    list of (3, 3) view-space triangles."""
    x0, x1 = cx - w / 2, cx + w / 2
    z0, z1 = cz - d / 2, cz + d / 2
    y0, y1 = 1.0 - h, 1.0
    tris = []
    tris += _quad([x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0])
    tris += _quad([x0, y0, z0], [x0, y0, z1], [x0, y1, z1], [x0, y1, z0])
    tris += _quad([x1, y0, z0], [x1, y0, z1], [x1, y1, z1], [x1, y1, z0])
    tris += _quad([x0, y0, z0], [x1, y0, z0], [x1, y0, z1], [x0, y0, z1])
    return tris


def _room_tris(rng) -> Tuple[np.ndarray, np.ndarray]:
    """A random room in view space (+Y down, +Z forward, camera at the
    origin) → (tris (F, 3, 3) f32, albedo (F, 3) f32)."""
    zback = rng.uniform(4.0, 7.0)
    half = rng.uniform(1.6, 2.6)
    tris, alb = [], []

    def add(ts, color, jitter=0.06):
        for t in ts:
            tris.append(t)
            alb.append(np.clip(color + rng.normal(0, jitter, 3), 0.05, 1.0))

    floor_c = rng.uniform(0.25, 0.7, 3)
    wall_c = rng.uniform(0.5, 0.9, 3)
    add(_quad([-half * 2, 1.0, 0.3], [half * 2, 1.0, 0.3],
              [half * 2, 1.0, zback], [-half * 2, 1.0, zback]), floor_c)
    add(_quad([-half * 2, 1.0, zback], [half * 2, 1.0, zback],
              [half * 2, -2.0, zback], [-half * 2, -2.0, zback]), wall_c)
    add(_quad([-half, 1.0, 0.3], [-half, 1.0, zback],
              [-half, -2.0, zback], [-half, -2.0, 0.3]), wall_c * 0.9)
    add(_quad([half, 1.0, 0.3], [half, 1.0, zback],
              [half, -2.0, zback], [half, -2.0, 0.3]), wall_c * 0.85)

    for _ in range(rng.integers(1, 4)):
        cz = rng.uniform(1.6, zback - 0.8)
        cx = rng.uniform(-half * 0.7, half * 0.7)
        bw = rng.uniform(0.3, 0.9)
        bh = rng.uniform(0.3, 1.1)
        bd = rng.uniform(0.3, 0.9)
        add(_box_tris(cx, cz, bw, bh, bd), rng.uniform(0.1, 0.95, 3))

    return (np.asarray(tris, np.float32), np.asarray(alb, np.float32))


_MAX_FACES = 64


def _pad_faces(tris, alb, n=_MAX_FACES):
    f = len(tris)
    if f < n:
        pad_t = np.full((n - f, 3, 3), [0.0, 0.0, -1.0], np.float32)
        tris = np.concatenate([tris, pad_t])
        alb = np.concatenate([alb, np.zeros((n - f, 3), np.float32)])
    return tris[:n], alb[:n], min(f, n)


def _render_room(tris, alb, nfaces, size, light, fov_f):
    """View-space tris (F, 3, 3) → (rgb (S, S, 3), disparity (S, S)) on
    the tensors' device: the dense z-buffer in chunks of 64 faces, lambert
    shading from the geometric normals, 1 / depth where a face covers."""
    s = size
    fx = fy = fov_f * s
    cx = cy = s / 2.0
    v = tris.reshape(-1, 3)                     # (3F, 3)
    z = torch.clamp(v[:, 2], min=1e-3)
    u = cx + fx * v[:, 0] / z
    vv = cy + fy * v[:, 1] / z
    verts_screen = torch.stack([u, vv, v[:, 2]], -1)
    faces = torch.arange(tris.shape[0] * 3, dtype=torch.int64,
                         device=tris.device).reshape(-1, 3)
    fmask = torch.arange(tris.shape[0], device=tris.device) < nfaces
    frag = rasterize_hard(verts_screen[None], faces[None], (s, s),
                          faces_mask=fmask[None], chunk=64)
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    n = torch.linalg.cross(e1, e2)
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True),
                        min=1e-9)
    lam = 0.35 + 0.65 * torch.abs(n @ light)
    shade = alb * lam[:, None]                  # (F, 3)
    face_idx, depth = frag.face_idx[0], frag.depth[0]
    fid = torch.clamp(face_idx, min=0).long()
    rgb = torch.where((face_idx >= 0)[..., None], shade[fid],
                      torch.ones((), device=tris.device))
    disp = torch.where(torch.isfinite(depth), 1.0 / depth,
                       torch.zeros((), device=tris.device))
    return rgb, disp


def synth_depth_batch(rng: np.random.Generator, batch: int, size: int,
                      device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """(rgb (B,S,S,3) in [0,1], disparity (B,S,S) normalised to [0,1]),
    each room rendered on ``device``."""
    imgs = np.zeros((batch, size, size, 3), np.float32)
    disps = np.zeros((batch, size, size), np.float32)
    for i in range(batch):
        tris, alb = _room_tris(rng)
        tris, alb, nf = _pad_faces(tris, alb)
        light = rng.normal(size=3)
        light[2] = -abs(light[2]) - 0.5
        light /= np.linalg.norm(light)
        fov_f = rng.uniform(0.6, 1.1)
        rgb, disp = _render_room(
            torch.from_numpy(tris).to(device),
            torch.from_numpy(alb).to(device), nf, size,
            torch.from_numpy(light.astype(np.float32)).to(device),
            float(np.float32(fov_f)))
        rgb = rgb.cpu().numpy()
        rgb = np.clip(rgb + rng.normal(0, 0.01, rgb.shape), 0, 1)
        disp = disp.cpu().numpy()
        lo, hi = disp.min(), disp.max()
        imgs[i] = rgb
        disps[i] = (disp - lo) / max(hi - lo, 1e-9)
    return imgs, disps


# ---------------------------------------------------------------------------
# MiDaS-style scale-and-shift-invariant loss
# ---------------------------------------------------------------------------

def _ssi_align(pred, target):
    """Per-image least-squares (scale, shift) aligning pred to target."""
    p = pred.reshape(pred.shape[0], -1)
    t = target.reshape(target.shape[0], -1)
    pm = p.mean(1, keepdim=True)
    tm = t.mean(1, keepdim=True)
    cov = ((p - pm) * (t - tm)).mean(1, keepdim=True)
    var = ((p - pm) ** 2).mean(1, keepdim=True)
    s = cov / torch.clamp(var, min=1e-9)
    b = tm - s * pm
    return (s * p + b).reshape(pred.shape)


def ssi_loss(pred, target):
    """Scale/shift-invariant MSE + 2-scale gradient matching (MiDaS)."""
    a = _ssi_align(pred, target)
    mse = torch.mean((a - target) ** 2)
    g = 0.0
    x, t = a, target
    for _ in range(2):
        gx = torch.abs(torch.diff(x, dim=-1) - torch.diff(t, dim=-1)).mean()
        gy = torch.abs(torch.diff(x, dim=-2) - torch.diff(t, dim=-2)).mean()
        g = g + gx + gy
        x = x[:, ::2, ::2]
        t = t[:, ::2, ::2]
    return mse + 0.5 * g


def ssi_rmse(pred: np.ndarray, target: np.ndarray) -> float:
    """The held-out metric: RMSE after per-image scale/shift alignment (f32
    on the host)."""
    a = _ssi_align(torch.from_numpy(np.asarray(pred, np.float32))[None],
                   torch.from_numpy(np.asarray(target, np.float32))[None])
    a = a[0].numpy()
    return float(np.sqrt(np.mean((a - target) ** 2)))


def luminance_prior(image01: np.ndarray) -> np.ndarray:
    """The offline fallback (pipeline/depth.py's estimate_depth), the
    baseline to beat: (H, W, 3) in [0, 1] → (H, W) in [0, 1]."""
    h = image01.shape[0]
    rows = np.linspace(1.0, 0.2, h)[:, None]
    lum = image01.mean(-1)
    d = 0.8 * rows + 0.2 * (1.0 - np.abs(lum - np.median(lum)))
    return ((d - d.min()) / max(d.max() - d.min(), 1e-9)).astype(np.float32)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def micro_config(size: int = 112) -> DepthAnythingConfig:
    """A trainable Depth-Anything (the converted checkpoints' arch class,
    smaller dims: 4 heads of 16)."""
    return DepthAnythingConfig(image_size=size, patch=14, width=64, depth=4,
                               num_heads=4, out_idx=(0, 1, 2, 3),
                               features=16, out_channels=(8, 16, 32, 64))


def depth_loss(model: DepthAnything, imgs, disps) -> torch.Tensor:
    return ssi_loss(model(imgs).float(), disps)


def distill_depth(cfg: Optional[DepthAnythingConfig] = None,
                  steps: int = 400, batch: int = 8, lr: float = 1e-3,
                  seed: int = 0, log_every: int = 50, device="cuda"
                  ) -> Tuple[DepthAnything, np.ndarray]:
    """Train Depth-Anything on synthetic rooms → (net with f32 weights
    computing in ``cfg.dtype``, the losses); adamw(cosine_decay_schedule(
    lr, steps), b1 0.9, b2 0.95, weight decay 1e-4)."""
    cfg = cfg or micro_config()
    s = cfg.image_size
    model = DepthAnything(cfg, device=device, param_dtype=torch.float32)
    init_flax_style_(model, torch.Generator(device).manual_seed(seed))
    opt = OptaxAdamW(model.parameters(), cosine_decay_schedule(lr, steps),
                     b1=0.9, b2=0.95, weight_decay=1e-4)

    # after the batch the JAX trainer draws for its init
    with BatchStream(synth_depth_batch, seed, (1, s, device),
                     (batch, s, device), steps, on_card(device)) as sample:
        losses = train_steps("depth", steps, sample,
                             lambda i, d: depth_loss(model, i, d), opt,
                             device, log_every)
    return model, losses


def save_depth_checkpoint(path: str, model: DepthAnything) -> None:
    """``model``'s weights as the port's checkpoint directory, with its
    config as the sidecar."""
    save_model(path, model, model.cfg, DEPTH_ANYTHING_CONV_TRANSPOSE)


def load_depth_checkpoint(path: str, device="cuda") -> DepthAnything:
    """→ Depth-Anything with the checkpoint's weights, on ``device``, at
    the sidecar's config (``out_idx`` and ``out_channels`` back to tuples)
    or, without one, ``DepthAnythingConfig.small()`` (the ViT-S widths a
    converted checkpoint has). A missing directory raises
    ``FileNotFoundError``."""
    d = read_config_json(path)
    if d is not None:
        d["out_idx"] = tuple(d["out_idx"])
        d["out_channels"] = tuple(d["out_channels"])
        cfg = DepthAnythingConfig(**d)
    else:
        cfg = DepthAnythingConfig.small()
    return load_model(DepthAnything(cfg, device=device), path,
                      DEPTH_ANYTHING_CONV_TRANSPOSE)
