"""Shape-generator distillation (counterpart of
regen3d_tpu/pipeline/shape_distill.py): the parametric furniture grammar
with analytic SDFs, the condition renders, the dataset, the two training
stages (the shape autoencoder on truncated SDF regression, then the
conditional rectified flow on its normalised latents), the fold of the
latent normalisation into the decoder, the Chamfer evaluation, and the
checkpoint's configuration, ``.npz`` reader and writer.

The grammar, the surface sampler and the queries are numpy from
``np.random.default_rng(seed)``, JAX's draws; the condition views are
rendered by the port's ``rasterize_hard`` (a pixel centre on a face edge
can fall in the other face, ROADMAP Queue 3 ag). The trainers run their
steps as a plain loop, drawing each segment's batch indices on the host as
JAX's segment runner does (``rng.integers(0, n, (seg, batch))``); the
flow loss's t, ε and condition drop come from a ``torch.Generator``
(ROADMAP Queue 3 bd), or from the caller (``draws``). At
``DistillConfig.small()`` the heads are 32 wide, at ``micro()`` 16.

The checkpoint is one ``.npz``: every leaf of the condition encoder's, the
shape DiT's and the SDF decoder's flax trees under ``"<part>:<path>"``
(``cond``, ``dit``, ``dec``; the path's levels joined by ``/``), the first
two in f16 and the decoder in f32, and a ``__config__`` entry holding the
configuration as JSON bytes. Reading casts every leaf to f32, as the JAX
package does, and carries the trees into the port's modules through
``models/from_jax.py``.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import logging
import os
import time
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from regen3d_tpu_torch.models.dit import DiTConfig, ShapeDiT
from regen3d_tpu_torch.models.dit import flow_matching_loss
from regen3d_tpu_torch.models.dit import init_flax_style_ as init_dit_
from regen3d_tpu_torch.models.from_jax import load_from_jax, tree_from_model
from regen3d_tpu_torch.models.shapevae import (
    ShapeDecoder,
    ShapeEncoder,
    ShapeVAEConfig,
)
from regen3d_tpu_torch.ops import clip
from regen3d_tpu_torch.ops.rasterize import rasterize_hard
from regen3d_tpu_torch.parallel.train import (
    OptaxAdamW,
    cosine_decay_schedule,
    train_steps,
)
from regen3d_tpu_torch.pipeline.phase3_assets import (
    AssetGenerator,
    CondEncoder,
    init_flax_style_,
)

log = logging.getLogger(__name__)

PARTS = ("cond", "dit", "dec")


# ===========================================================================
# Parametric furniture grammar (unions of AA boxes + vertical cylinders)
# ===========================================================================

FAMILIES = ("box", "table", "chair", "stool", "shelf", "sofa", "lamp")
FAMILY_P = (0.25, 0.17, 0.15, 0.10, 0.12, 0.13, 0.08)

_CYL_SEGS = 12
_F_PAD = 160  # max part-mesh faces over the grammar (lamp: 3 cyls = 144)


@dataclasses.dataclass
class ShapeSpec:
    """boxes: (Nb, 6) [cx cy cz hx hy hz]; cyls: (Nc, 5) [cx cy cz r hh]
    (vertical, y-axis). All axis-aligned, normalised to fit ~[-0.85,0.85]³."""

    boxes: np.ndarray
    cyls: np.ndarray
    family: str


def _u(rng, a, b):
    return float(rng.uniform(a, b))


def sample_spec(rng: np.random.Generator) -> ShapeSpec:
    fam = rng.choice(FAMILIES, p=FAMILY_P)
    boxes: List[List[float]] = []
    cyls: List[List[float]] = []

    def box(cx, cy, cz, hx, hy, hz):
        boxes.append([cx, cy, cz, hx, hy, hz])

    def cyl(cx, cy, cz, r, hh):
        cyls.append([cx, cy, cz, r, hh])

    if fam == "box":
        w, h, d = _u(rng, .5, 1.6), _u(rng, .5, 1.6), _u(rng, .5, 1.6)
        box(0, h / 2, 0, w / 2, h / 2, d / 2)
    elif fam == "table":
        h = _u(rng, .7, 1.1)
        w, d, t = _u(rng, 1.0, 2.0), _u(rng, .6, 1.4), _u(rng, .06, .12)
        box(0, h - t / 2, 0, w / 2, t / 2, d / 2)
        if rng.random() < 0.25:
            cyl(0, (h - t) / 2, 0, _u(rng, .08, .2), (h - t) / 2)
            cyl(0, .03, 0, _u(rng, .3, .5), .03)
        else:
            a = _u(rng, .04, .09)
            for sx in (-1, 1):
                for sz in (-1, 1):
                    box(sx * (w / 2 - a), (h - t) / 2, sz * (d / 2 - a),
                        a, (h - t) / 2, a)
    elif fam == "chair":
        h = _u(rng, .4, .55)
        w, d = _u(rng, .45, .7), _u(rng, .45, .7)
        bh = _u(rng, .4, .7)
        box(0, h - .04, 0, w / 2, .04, d / 2)                    # seat
        box(0, h + bh / 2, -d / 2 + .03, w / 2, bh / 2, .03)     # back
        a = _u(rng, .03, .05)
        for sx in (-1, 1):
            for sz in (-1, 1):
                box(sx * (w / 2 - a), (h - .08) / 2, sz * (d / 2 - a),
                    a, (h - .08) / 2, a)
    elif fam == "stool":
        h = _u(rng, .5, .8)
        cyl(0, h - .04, 0, _u(rng, .25, .4), .04)
        cyl(0, (h - .08) / 2, 0, _u(rng, .05, .12), (h - .08) / 2)
        cyl(0, .03, 0, _u(rng, .25, .4), .03)
    elif fam == "shelf":
        w, h, d = _u(rng, .8, 1.6), _u(rng, 1.2, 2.0), _u(rng, .3, .5)
        t = .04
        box(-(w / 2 - t), h / 2, 0, t, h / 2, d / 2)             # sides
        box(w / 2 - t, h / 2, 0, t, h / 2, d / 2)
        box(0, h / 2, -d / 2 + t, w / 2, h / 2, t)               # back
        for i in range(int(rng.integers(3, 6))):
            y = h * (i + 0.5) / 5.0 + _u(rng, -.03, .03)
            box(0, y, 0, w / 2, t / 2, d / 2)
    elif fam == "sofa":
        w, d = _u(rng, 1.4, 2.2), _u(rng, .8, 1.0)
        box(0, .3, 0, w / 2, .3, d / 2)                          # base
        box(0, .75, -d / 2 + .12, w / 2, .45, .12)               # back
        for sx in (-1, 1):
            box(sx * (w / 2 - .12), .55, 0, .12, .25, d / 2)     # arms
    else:  # lamp
        h = _u(rng, 1.2, 1.8)
        cyl(0, h / 2, 0, .04, h / 2)
        cyl(0, .04, 0, _u(rng, .25, .4), .04)
        cyl(0, h - .1, 0, _u(rng, .25, .45), _u(rng, .15, .3))

    b = np.asarray(boxes, np.float32).reshape(-1, 6)
    c = np.asarray(cyls, np.float32).reshape(-1, 5)
    # normalise: the union AABB centred at the origin, max half-extent → s
    los, his = [], []
    if len(b):
        los.append((b[:, :3] - b[:, 3:]).min(0))
        his.append((b[:, :3] + b[:, 3:]).max(0))
    if len(c):
        los.append(np.stack([c[:, 0] - c[:, 3], c[:, 1] - c[:, 4],
                             c[:, 2] - c[:, 3]], -1).min(0))
        his.append(np.stack([c[:, 0] + c[:, 3], c[:, 1] + c[:, 4],
                             c[:, 2] + c[:, 3]], -1).max(0))
    lo = np.min(los, 0)
    hi = np.max(his, 0)
    center = (lo + hi) / 2
    scale = _u(rng, .6, .85) / max(float((hi - lo).max()) / 2, 1e-6)
    if len(b):
        b[:, :3] = (b[:, :3] - center) * scale
        b[:, 3:] *= scale
    if len(c):
        c[:, :3] = (c[:, :3] - center) * scale
        c[:, 3:] *= scale
    return ShapeSpec(boxes=b, cyls=c, family=str(fam))


def spec_sdf(spec: ShapeSpec, pts: np.ndarray) -> np.ndarray:
    """Exact union SDF at pts (N, 3) → (N,). Outside positive."""
    d = np.full(len(pts), 1e9, np.float32)
    for cx, cy, cz, hx, hy, hz in spec.boxes:
        q = np.abs(pts - [cx, cy, cz]) - [hx, hy, hz]
        outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
        inside = np.minimum(q.max(-1), 0.0)
        d = np.minimum(d, outside + inside)
    for cx, cy, cz, r, hh in spec.cyls:
        dr = np.hypot(pts[:, 0] - cx, pts[:, 2] - cz) - r
        dy = np.abs(pts[:, 1] - cy) - hh
        q = np.stack([dr, dy], -1)
        outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
        inside = np.minimum(q.max(-1), 0.0)
        d = np.minimum(d, outside + inside)
    return d.astype(np.float32)


def _box_mesh(cx, cy, cz, hx, hy, hz) -> np.ndarray:
    x0, x1, y0, y1, z0, z1 = cx - hx, cx + hx, cy - hy, cy + hy, cz - hz, cz + hz
    v = np.asarray([[x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
                    [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]],
                   np.float32)
    f = np.asarray([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
                    [0, 1, 5], [0, 5, 4], [2, 3, 7], [2, 7, 6],
                    [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]], np.int32)
    return v[f]


def _cyl_mesh(cx, cy, cz, r, hh, segs: int = _CYL_SEGS) -> np.ndarray:
    th = np.linspace(0, 2 * np.pi, segs, endpoint=False)
    x = cx + r * np.cos(th)
    z = cz + r * np.sin(th)
    lo = np.stack([x, np.full(segs, cy - hh), z], -1).astype(np.float32)
    hi = np.stack([x, np.full(segs, cy + hh), z], -1).astype(np.float32)
    tris = []
    clo = np.asarray([cx, cy - hh, cz], np.float32)
    chi = np.asarray([cx, cy + hh, cz], np.float32)
    for i in range(segs):
        j = (i + 1) % segs
        tris.append([lo[i], hi[i], hi[j]])
        tris.append([lo[i], hi[j], lo[j]])
        tris.append([clo, lo[j], lo[i]])
        tris.append([chi, hi[i], hi[j]])
    return np.asarray(tris, np.float32)


def spec_mesh(spec: ShapeSpec) -> Tuple[np.ndarray, np.ndarray]:
    """(tris (F, 3, 3), part_id (F,)) for rendering and surface sampling."""
    tris, pid = [], []
    p = 0
    for row in spec.boxes:
        t = _box_mesh(*row)
        tris.append(t)
        pid.append(np.full(len(t), p))
        p += 1
    for row in spec.cyls:
        t = _cyl_mesh(*row)
        tris.append(t)
        pid.append(np.full(len(t), p))
        p += 1
    return (np.concatenate(tris).astype(np.float32),
            np.concatenate(pid).astype(np.int32))


def spec_surface_points(spec: ShapeSpec, rng: np.random.Generator,
                        n: int) -> np.ndarray:
    """n area-weighted samples on the union surface (the parts' surfaces,
    samples inside another part rejected)."""
    tris, _ = spec_mesh(spec)
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    p_face = area / area.sum()
    out: List[np.ndarray] = []
    need = n
    for _ in range(4):
        m = max(need * 2, 64)
        fi = rng.choice(len(tris), m, p=p_face)
        r1 = np.sqrt(rng.random(m, dtype=np.float32))
        r2 = rng.random(m, dtype=np.float32).astype(np.float32)
        pts = ((1 - r1)[:, None] * tris[fi, 0]
               + (r1 * (1 - r2))[:, None] * tris[fi, 1]
               + (r1 * r2)[:, None] * tris[fi, 2])
        keep = spec_sdf(spec, pts) > -1e-3
        out.append(pts[keep])
        need = n - sum(len(o) for o in out)
        if need <= 0:
            break
    pts = np.concatenate(out)
    if len(pts) < n:  # degenerate grammar corner: pad by repetition
        reps = int(np.ceil(n / max(len(pts), 1)))
        pts = np.tile(pts, (reps, 1))
    return pts[:n].astype(np.float32)


# ===========================================================================
# Condition-image rendering (the prepped-object RGBA contract of phase 3)
# ===========================================================================

def _render_rgba(tris, alb, fmask, eye, right, up, fwd, f_px, size, light,
                 lam_mix):
    """Batched single-view renders: world tris (B, F, 3, 3) → RGBA
    (B, S, S, 4), the z-buffer in chunks of ``_F_PAD`` faces."""
    s = size
    b, f = tris.shape[:2]
    v = tris.reshape(b, -1, 3) - eye[:, None]
    x = (v @ right[:, :, None])[..., 0]
    y = (v @ up[:, :, None])[..., 0]
    z = torch.clamp((v @ fwd[:, :, None])[..., 0], min=1e-3)
    u_px = s / 2.0 + f_px[:, None] * x / z
    v_px = s / 2.0 - f_px[:, None] * y / z
    verts_screen = torch.stack([u_px, v_px, z], -1)
    faces = torch.arange(f * 3, dtype=torch.int64,
                         device=tris.device).reshape(1, f, 3).expand(b, f, 3)
    frag = rasterize_hard(verts_screen, faces, (s, s), faces_mask=fmask,
                          chunk=_F_PAD)
    n = torch.linalg.cross(tris[:, :, 1] - tris[:, :, 0],
                           tris[:, :, 2] - tris[:, :, 0])
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True),
                        min=1e-9)
    lam = 0.35 + 0.65 * torch.abs((n @ light[:, :, None])[..., 0])
    shade = alb * ((1 - lam_mix[:, None]) + lam_mix[:, None] * lam)[..., None]
    fid = torch.clamp(frag.face_idx, min=0).long()
    hit = frag.face_idx >= 0
    rgb = torch.gather(shade, 1, fid.reshape(b, -1, 1).expand(-1, -1, 3))
    rgb = torch.where(hit[..., None], rgb.reshape(b, s, s, 3),
                      torch.ones((), device=tris.device))
    return torch.cat([rgb, hit[..., None].float()], -1)


def render_cond_batch(specs: List[ShapeSpec], rng: np.random.Generator,
                      size: int, batch: int = 64, device="cuda"
                      ) -> np.ndarray:
    """Each spec as an RGBA condition view (N, S, S, 4) in [0, 1]: a
    frontal-ish orbit camera, lambert or flat shading, a transparent
    background (the prepped-object image phase 3 takes), ``batch`` views
    a render on ``device``."""
    n = len(specs)
    out = np.zeros((n, size, size, 4), np.float32)
    for s0 in range(0, n, batch):
        sub = specs[s0:s0 + batch]
        bt = np.zeros((len(sub), _F_PAD, 3, 3), np.float32)
        bt[..., 2] = -1.0  # behind-camera padding
        ba = np.zeros((len(sub), _F_PAD, 3), np.float32)
        bm = np.zeros((len(sub), _F_PAD), bool)
        eyes, rights, ups, fwds, fps, lights, mixes = ([] for _ in range(7))
        for i, spec in enumerate(sub):
            tris, pid = spec_mesh(spec)
            f = min(len(tris), _F_PAD)
            bt[i, :f] = tris[:f]
            cols = rng.uniform(0.1, 0.95, (pid.max() + 1, 3)).astype(np.float32)
            ba[i, :f] = cols[pid[:f]]
            bm[i, :f] = True
            az = rng.uniform(-0.6, 0.6)
            el = rng.uniform(0.08, 0.5)
            dist = rng.uniform(3.0, 3.6)
            eye = dist * np.asarray([np.cos(el) * np.sin(az), np.sin(el),
                                     -np.cos(el) * np.cos(az)], np.float32)
            fwd = -eye / np.linalg.norm(eye)
            right = np.cross([0, 1, 0], fwd)
            right = right / np.linalg.norm(right)
            up = np.cross(fwd, right)
            eyes.append(eye)
            rights.append(right.astype(np.float32))
            ups.append(up.astype(np.float32))
            fwds.append(fwd.astype(np.float32))
            fps.append(size * rng.uniform(0.85, 1.05))
            li = rng.normal(size=3)
            li[2] = -abs(li[2]) - 0.5
            lights.append((li / np.linalg.norm(li)).astype(np.float32))
            # 20% flat shading: the flat-coloured synthetic crops
            mixes.append(0.0 if rng.random() < 0.2 else 1.0)
        dev = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
        with torch.no_grad():
            rgba = _render_rgba(
                dev(bt), dev(ba), torch.from_numpy(bm).to(device),
                dev(np.stack(eyes)), dev(np.stack(rights)),
                dev(np.stack(ups)), dev(np.stack(fwds)), dev(fps), size,
                dev(np.stack(lights)), dev(mixes))
        arr = rgba.cpu().numpy()
        arr[..., :3] = np.clip(arr[..., :3] + rng.normal(0, .01, arr[..., :3].shape), 0, 1)
        out[s0:s0 + len(sub)] = arr
    return out


# ===========================================================================
# Dataset
# ===========================================================================

def build_dataset(rng: np.random.Generator, n_shapes: int, image_size: int,
                  n_surface: int = 1024, n_query: int = 1024,
                  with_images: bool = True, device="cuda") -> Dict:
    """The procedural dataset: surface samples, SDF-labelled queries (50%
    near the surface at two noise scales, 25% uniform in the cube, 25% in
    the padded box) and the condition images."""
    specs = [sample_spec(rng) for _ in range(n_shapes)]
    surf = np.zeros((n_shapes, n_surface, 3), np.float32)
    qpts = np.zeros((n_shapes, n_query, 3), np.float32)
    qsdf = np.zeros((n_shapes, n_query), np.float32)
    for i, spec in enumerate(specs):
        s = spec_surface_points(spec, rng, max(n_surface, n_query))
        surf[i] = s[:n_surface]
        k = n_query // 4
        near1 = s[:k] + rng.normal(0, .02, (k, 3))
        near2 = s[k:2 * k] + rng.normal(0, .08, (k, 3))
        unif = rng.uniform(-1.0, 1.0, (k, 3))
        lo = s.min(0) - .15
        hi = s.max(0) + .15
        bbox = rng.uniform(lo, hi, (n_query - 3 * k, 3))
        q = np.concatenate([near1, near2, unif, bbox]).astype(np.float32)
        qpts[i] = q
        qsdf[i] = spec_sdf(spec, q)
    data = {"surf": surf, "qpts": qpts, "qsdf": qsdf}
    if with_images:
        data["imgs"] = render_cond_batch(specs, rng, image_size,
                                         device=device)
    data["specs"] = specs
    return data


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    dit: DiTConfig
    vae: ShapeVAEConfig
    cond_depth: int
    cond_heads: int
    cond_patch: int
    image_size: int

    @classmethod
    def small(cls) -> "DistillConfig":
        """The committed checkpoint's scale (~10 M parameters)."""
        dit = DiTConfig(latent_tokens=64, latent_dim=16, width=256, depth=6,
                        num_heads=8, cond_dim=256)
        vae = ShapeVAEConfig(latent_tokens=64, latent_dim=16, width=256,
                             enc_depth=2, dec_depth=4, num_heads=8,
                             num_freqs=8)
        return cls(dit=dit, vae=vae, cond_depth=2, cond_heads=8,
                   cond_patch=8, image_size=64)

    @classmethod
    def micro(cls) -> "DistillConfig":
        """CPU-test scale."""
        dit = DiTConfig(latent_tokens=16, latent_dim=8, width=64, depth=2,
                        num_heads=4, cond_dim=64)
        vae = ShapeVAEConfig(latent_tokens=16, latent_dim=8, width=64,
                             enc_depth=1, dec_depth=2, num_heads=4,
                             num_freqs=6)
        return cls(dit=dit, vae=vae, cond_depth=1, cond_heads=4,
                   cond_patch=8, image_size=32)

    def cond_encoder(self, device="cuda") -> CondEncoder:
        """The condition encoder, computing in the DiT's dtype."""
        return CondEncoder(width=self.dit.cond_dim, depth=self.cond_depth,
                           num_heads=self.cond_heads, patch=self.cond_patch,
                           dtype=self.dit.dtype, device=device)

    def with_dtype(self, dtype) -> "DistillConfig":
        """The same generator computing in ``dtype`` (f32 for the plain
        reference of a bf16 run)."""
        return dataclasses.replace(
            self, dit=dataclasses.replace(self.dit, dtype=dtype),
            vae=dataclasses.replace(self.vae, dtype=dtype))


# ===========================================================================
# Training (a plain loop; each segment's batch indices drawn as JAX's
# segment runner draws them)
# ===========================================================================

def _segment_sampler(rng: np.random.Generator, n: int, batch: int,
                     seg: int, steps: int,
                     take: Callable[[np.ndarray], tuple]):
    """``sample(i)`` for ``train_steps``: at the start of each segment of
    ``seg`` steps (the last one shorter) the host draws its (k, batch)
    indices, ``rng.integers(0, n, (k, batch))``, and step i takes its row."""
    state = {"idx": None, "start": 0}

    def sample(i):
        if i == state["start"] + (0 if state["idx"] is None
                                  else len(state["idx"])):
            state["start"] = i
            state["idx"] = rng.integers(0, n, (min(seg, steps - i), batch))
        return take(state["idx"][i - state["start"]])

    return sample


SDF_TRUNC = 0.25


def init_autoencoder_(enc: ShapeEncoder, dec: ShapeDecoder,
                      generator: torch.Generator) -> None:
    """The shape autoencoder's init from ``generator``: flax's layer
    defaults and the latent queries N(0, 0.02²)."""
    init_flax_style_(enc, generator)
    with torch.no_grad():
        enc.latent_queries.normal_(0.0, 0.02, generator=generator)
    init_flax_style_(dec, generator)


def vae_loss(enc: ShapeEncoder, dec: ShapeDecoder, surf, qpts, qsdf):
    """Truncated-SDF regression (only the target clipped, weighted ×4 near
    the surface) plus 0.02 × the latent-moment regulariser."""
    lat = enc(surf)
    pred = dec(lat, qpts)
    t_gt = clip(qsdf, -SDF_TRUNC, SDF_TRUNC)
    w = 1.0 + 3.0 * (torch.abs(qsdf) < 0.05).float()
    rec = torch.sum(torch.abs(pred - t_gt) * w) / torch.sum(w)
    mu = lat.mean((0, 1))
    sd = lat.std((0, 1), correction=0)
    reg = (mu ** 2).mean() + ((sd - 1.0) ** 2).mean()
    return rec + 0.02 * reg


def train_shape_vae(cfg: DistillConfig, data: Mapping, steps: int,
                    batch: int = 32, lr: float = 1e-3, seed: int = 0,
                    seg: int = 25, log_every: int = 200, device="cuda"
                    ) -> Tuple[ShapeEncoder, ShapeDecoder, np.ndarray]:
    """Stage A: the shape autoencoder → (encoder, decoder, losses);
    adamw(cosine_decay_schedule(lr, steps, 0.05)) (b2 0.999, weight decay
    1e-4)."""
    enc = ShapeEncoder(cfg.vae, device=device)
    dec = ShapeDecoder(cfg.vae, device=device)
    init_autoencoder_(enc, dec, torch.Generator(device).manual_seed(seed))
    params = list(enc.parameters()) + list(dec.parameters())
    opt = OptaxAdamW(params, cosine_decay_schedule(lr, steps, 0.05))
    sample = _segment_sampler(
        np.random.default_rng(seed), data["surf"].shape[0], batch, seg,
        steps, lambda idx: (data["surf"][idx], data["qpts"][idx],
                            data["qsdf"][idx]))
    losses = train_steps("vae", steps, sample,
                         lambda s, q, d: vae_loss(enc, dec, s, q, d), opt,
                         device, log_every)
    return enc, dec, losses


@torch.no_grad()
def encode_latents(enc: ShapeEncoder, surf: np.ndarray, chunk: int = 128
                   ) -> np.ndarray:
    dev = enc.latent_queries.device
    outs = [enc(torch.from_numpy(surf[i:i + chunk]).to(dev)).float().cpu()
            .numpy() for i in range(0, len(surf), chunk)]
    return np.concatenate(outs).astype(np.float32)


def flow_loss(cond: CondEncoder, dit: ShapeDiT, img, lat,
              generator: Optional[torch.Generator], cond_drop: float = 0.1,
              draws=None):
    """The rectified-flow loss on the condition encoder's tokens of
    ``img``; t, ε and the condition drop from ``generator`` unless
    ``draws`` gives them (``dit.flow_matching_loss``)."""
    return flow_matching_loss(dit, lat, cond(img), generator,
                              cond_drop_prob=cond_drop, draws=draws)


def train_flow(cfg: DistillConfig, latents: np.ndarray, imgs: np.ndarray,
               steps: int, batch: int = 32, lr: float = 1e-3, seed: int = 1,
               seg: int = 25, log_every: int = 200, cond_drop: float = 0.1,
               device="cuda") -> Tuple[CondEncoder, ShapeDiT, np.ndarray]:
    """Stage B: the conditional rectified flow on normalised latents (see
    ``latent_moments``) → (condition encoder, DiT, losses); the optimiser
    as stage A's. The flow loss's draws come from the trainer's
    ``torch.Generator``, which also draws the init."""
    cond = cfg.cond_encoder(device)
    dit = ShapeDiT(cfg.dit, device=device)
    gen = torch.Generator(device).manual_seed(seed)
    init_flax_style_(cond, gen)
    init_dit_(dit, gen)
    params = list(cond.parameters()) + list(dit.parameters())
    opt = OptaxAdamW(params, cosine_decay_schedule(lr, steps, 0.05))
    sample = _segment_sampler(
        np.random.default_rng(seed), len(latents), batch, seg, steps,
        lambda idx: (imgs[idx], latents[idx]))
    losses = train_steps(
        "flow", steps, sample,
        lambda im, la: flow_loss(cond, dit, im, la, gen, cond_drop), opt,
        device, log_every)
    return cond, dit, losses


def latent_moments(latents: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel (D,) moments over (N, L)."""
    mu = latents.mean((0, 1)).astype(np.float32)
    sd = np.maximum(latents.std((0, 1)), 1e-4).astype(np.float32)
    return mu, sd


def fold_latent_norm(dec: ShapeDecoder, mu: np.ndarray, sd: np.ndarray
                     ) -> ShapeDecoder:
    """A copy of ``dec`` with the latent normalisation folded into the
    ``lat_in`` affine: dec′(z) = dec(z·σ + μ), so the serving sampler (which
    emits normalised latents) needs no extra op. Computed in f32 on the
    host in flax's kernel layout, as the JAX package does."""
    out = copy.deepcopy(dec)
    lat_in = out.lat_in
    w = np.array(lat_in.weight.detach().float().cpu()).T       # (D, width)
    b = np.array(lat_in.bias.detach().float().cpu())
    with torch.no_grad():
        lat_in.weight.copy_(torch.from_numpy(np.ascontiguousarray(
            (sd[:, None] * w).T)))
        lat_in.bias.copy_(torch.from_numpy(b + mu @ w))
    return out


def generator_params(gen: AssetGenerator) -> Dict[str, Mapping]:
    """{"cond", "dit", "dec"}: the generator's flax trees, as
    ``save_generator`` takes them."""
    return {"cond": tree_from_model(gen.cond), "dit": tree_from_model(gen.dit),
            "dec": tree_from_model(gen.decoder)}


# ===========================================================================
# Evaluation: generated mesh against the analytic GT surface
# ===========================================================================

def chamfer_np(a: np.ndarray, b: np.ndarray) -> float:
    """Symmetric mean nearest-neighbour L2 distance (the pcu convention of
    the reference's evaluation)."""
    from scipy.spatial import cKDTree

    da = cKDTree(b).query(a)[0]
    db = cKDTree(a).query(b)[0]
    return float(da.mean() + db.mean())


def eval_generator(generator: AssetGenerator, rng: np.random.Generator,
                   n_shapes: int = 16, num_steps: int = 25,
                   guidance: float = 3.0, resolution: int = 64,
                   chunk: int = 4096, n_gt: int = 4096,
                   image_size: Optional[int] = None,
                   empty_penalty: float = 2.0) -> Dict[str, float]:
    """Generate from held-out condition images; Chamfer against the
    analytic GT surface, and the shuffled-condition Chamfer (each mesh
    against the next shape's GT), whose gap shows the conditioning
    carries signal. The sampler's noise comes from a ``torch.Generator``
    seeded by the host draw JAX's PRNG key takes."""
    from regen3d_tpu_torch.ops.marching_cubes import marching_tetrahedra

    size = image_size or generator.image_size
    dev = generator.device
    specs = [sample_spec(rng) for _ in range(n_shapes)]
    imgs = render_cond_batch(specs, rng, size, device=dev)
    noise = torch.Generator(dev).manual_seed(int(rng.integers(0, 2 ** 31)))
    vols = generator.generate_sdf_batch(noise, imgs, num_steps, guidance,
                                        resolution, chunk)
    cds, cds_shuf, empties = [], [], 0
    gts = [spec_surface_points(s, rng, n_gt) for s in specs]
    for i in range(n_shapes):
        verts, faces = marching_tetrahedra(np.asarray(vols[i]), 0.0,
                                           bounds=(-1.01, 1.01))
        if len(faces) == 0 or len(verts) < 16:
            empties += 1
            cds.append(empty_penalty)
            cds_shuf.append(empty_penalty)
            continue
        if len(verts) > 8192:
            verts = verts[rng.choice(len(verts), 8192, replace=False)]
        cds.append(chamfer_np(verts, gts[i]))
        cds_shuf.append(chamfer_np(verts, gts[(i + 1) % n_shapes]))
    return {"chamfer": float(np.mean(cds)),
            "chamfer_shuffled": float(np.mean(cds_shuf)),
            "empty_frac": empties / n_shapes}


# ===========================================================================
# Whole-pipeline driver
# ===========================================================================

def distill_shape(cfg: DistillConfig, n_shapes: int = 2048,
                  vae_steps: int = 3000, flow_steps: int = 5000,
                  batch: int = 32, lr: float = 1e-3, seed: int = 0,
                  seg: int = 25, log_every: int = 200, n_surface: int = 1024,
                  n_query: int = 1024, device="cuda"
                  ) -> Tuple[AssetGenerator, Dict[str, float]]:
    """Dataset → stage A → encode and normalise → stage B → the folded
    generator, and a report of the final losses (the mean of the last 20)
    and the dataset's seconds."""
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    data = build_dataset(rng, n_shapes, cfg.image_size, n_surface=n_surface,
                         n_query=n_query, device=device)
    data_s = time.perf_counter() - t0
    log.info("dataset: %d shapes in %.1fs", n_shapes, data_s)
    enc, dec, vae_losses = train_shape_vae(
        cfg, data, vae_steps, batch=batch, lr=lr, seed=seed, seg=seg,
        log_every=log_every, device=device)
    lats = encode_latents(enc, data["surf"])
    mu, sd = latent_moments(lats)
    lats_n = ((lats - mu) / sd).astype(np.float32)
    cond, dit, flow_losses = train_flow(
        cfg, lats_n, data["imgs"], flow_steps, batch=batch, lr=lr,
        seed=seed + 1, seg=seg, log_every=log_every, device=device)
    gen = AssetGenerator(dit_cfg=cfg.dit, vae_cfg=cfg.vae, cond=cond,
                         dit=dit, decoder=fold_latent_norm(dec, mu, sd),
                         image_size=cfg.image_size, trained=True)
    report = {"vae_loss_final": float(np.mean(vae_losses[-20:])),
              "flow_loss_final": float(np.mean(flow_losses[-20:])),
              "vae_loss_first": float(np.mean(vae_losses[:20])),
              "flow_loss_first": float(np.mean(flow_losses[:20])),
              "dataset_s": data_s}
    return gen, report


def build_generator(cfg: DistillConfig, cond_params: Mapping,
                    dit_params: Mapping, dec_params: Mapping,
                    device="cuda") -> AssetGenerator:
    """The trained generator on ``device`` from its three flax trees (numpy
    leaves); every leaf must be used once."""
    cond = cfg.cond_encoder(device)
    dit = ShapeDiT(cfg.dit, device=device)
    decoder = ShapeDecoder(cfg.vae, device=device)
    for module, params in ((cond, cond_params), (dit, dit_params),
                           (decoder, dec_params)):
        load_from_jax(module, params)
    return AssetGenerator(dit_cfg=cfg.dit, vae_cfg=cfg.vae, cond=cond,
                          dit=dit, decoder=decoder,
                          image_size=cfg.image_size, trained=True)


def _flatten(tree: Mapping, prefix: str, dtype) -> Dict[str, np.ndarray]:
    """{"<prefix>:<a>/<b>/...": leaf in ``dtype``} in sorted key order."""
    out = {}
    for key in sorted(tree):
        value = tree[key]
        path = f"{prefix}/{key}" if ":" in prefix else f"{prefix}:{key}"
        if isinstance(value, Mapping):
            out.update(_flatten(value, path, dtype))
        else:
            out[path] = np.asarray(value, dtype)
    return out


def _unflatten(npz, prefix: str) -> Dict:
    """The nested tree of one part, every leaf cast to f32."""
    out: Dict = {}
    for key in npz.files:
        if not key.startswith(prefix + ":"):
            continue
        node = out
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(npz[key], np.float32)
    return out


def _config_dict(c) -> Dict:
    return {k: v for k, v in dataclasses.asdict(c).items() if k != "dtype"}


def save_generator(path: str, cfg: DistillConfig, params: Mapping) -> None:
    """One ``.npz`` from {"cond", "dit", "dec"} flax trees: f16 leaves for
    the first two, f32 for the decoder (its values place the iso-surface),
    and the JSON configuration."""
    meta = {"dit": _config_dict(cfg.dit), "vae": _config_dict(cfg.vae),
            "cond_depth": cfg.cond_depth, "cond_heads": cfg.cond_heads,
            "cond_patch": cfg.cond_patch, "image_size": cfg.image_size}
    blobs = {}
    for name in ("cond", "dit"):
        blobs.update(_flatten(params[name], name, np.float16))
    blobs.update(_flatten(params["dec"], "dec", np.float32))
    blobs["__config__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **blobs)


def load_params(path: str):
    """(DistillConfig, {"cond", "dit", "dec"}: f32 flax trees) of a
    checkpoint."""
    with np.load(path) as npz:
        meta = json.loads(bytes(npz["__config__"]).decode())
        params = {name: _unflatten(npz, name) for name in PARTS}
    cfg = DistillConfig(
        dit=DiTConfig(**meta["dit"]), vae=ShapeVAEConfig(**meta["vae"]),
        cond_depth=int(meta["cond_depth"]), cond_heads=int(meta["cond_heads"]),
        cond_patch=int(meta["cond_patch"]),
        image_size=int(meta["image_size"]))
    return cfg, params


def load_generator(path: str, device="cuda") -> AssetGenerator:
    """The serving generator of a distilled ``.npz``, on ``device``."""
    cfg, params = load_params(path)
    return build_generator(cfg, params["cond"], params["dit"], params["dec"],
                           device=device)
