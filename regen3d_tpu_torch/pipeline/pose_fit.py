"""Batched differentiable-rendering pose fit (counterpart of
regen3d_tpu/pipeline/pose_fit.py).

All objects are fitted together: per-object losses are computed batched over
the object axis, Adam moments are banked per object, and early stopping is a
per-object freeze mask. The JAX ``lax.while_loop`` is a Python loop with the
same stop rule. Losses and semantics follow the JAX package:

  loss = w_sil·(0.75·dice + 0.25·(BCE|focal)) + w_3d·point_mesh_face_distance
       + w_bbox·bbox_hinge

:func:`fit_poses_sharded` splits the object axis over a mesh's 'dp' ranks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from regen3d_tpu_torch.camera import Camera
from regen3d_tpu_torch.ops import full_f32
from regen3d_tpu_torch.ops.knn import chamfer_loss
from regen3d_tpu_torch.ops.losses import bbox_hinge_loss, silhouette_loss
from regen3d_tpu_torch.ops.point_mesh import (
    point_mesh_face_distance_fast,
    point_mesh_face_distance_topk,
)
from regen3d_tpu_torch.ops.rasterize import (
    compute_silhouette_bins,
    soft_silhouette,
    soft_silhouette_binned,
    soft_silhouette_edge,
)
from regen3d_tpu_torch.ops.silhouette_kernel import soft_silhouette_edge_kernel
from regen3d_tpu_torch.transforms.rotations import so3_exp, yaw_rotation


class ObjectBatch(NamedTuple):
    """Static-shape padded batch of objects to fit."""

    verts: torch.Tensor         # (B, Vmax, 3) pivot-frame vertices
    verts_mask: torch.Tensor    # (B, Vmax) bool
    faces: torch.Tensor         # (B, Fmax, 3) int32 (padded faces → (0,0,0))
    faces_mask: torch.Tensor    # (B, Fmax) bool
    target_mask: torch.Tensor   # (B, H, W) float32 binary object masks
    target_points: torch.Tensor  # (B, Pmax, 3) world-frame target clouds
    points_mask: torch.Tensor   # (B, Pmax) bool
    pivot_R: torch.Tensor       # (B, 3, 3) pivot→world rotation (row-vector)
    pivot_t: torch.Tensor       # (B, 3)
    on_floor: torch.Tensor      # (B,) bool, freeze vertical translation
    object_valid: torch.Tensor  # (B,) bool, padding slots in the batch
    bbox_lo: torch.Tensor       # (3,) background AABB (world)
    bbox_hi: torch.Tensor       # (3,)


class PoseParams(NamedTuple):
    translation: torch.Tensor   # (B, 3) in pivot frame
    yaw: torch.Tensor           # (B,)
    rot_aa: torch.Tensor        # (B, 3) axis-angle (use_5dof=False)
    log_scale: torch.Tensor     # (B,)

    @classmethod
    def zeros(cls, b: int, device="cuda") -> "PoseParams":
        z = lambda *s: torch.zeros(*s, dtype=torch.float32, device=device)
        return cls(z(b, 3), z(b), z(b, 3), z(b))


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """Fit knobs, the same fields and defaults as the JAX FitConfig."""

    image_hw: Tuple[int, int] = (256, 256)
    sigma: float = 5e-7
    w_sil: float = 0.1
    w_3d: float = 0.1
    w_bbox: float = 0.01
    use_focal: bool = True
    use_5dof: bool = True
    rotation_speed_mult: float = 8.0
    learning_rate: float = 0.005
    max_iterations: int = 300
    early_stop_grad: float = 5e-3
    early_stop_min_iters: int = 200
    grad_clip: float = 1.0
    face_chunk: int = 256
    point_chunk: int = 512
    record_history: bool = True
    use_binned_raster: bool = False
    bin_tile: int = 64
    faces_per_tile: int = 256
    use_edge_raster: bool = False
    bin_margin_px: float = 64.0
    # silhouette kernels (ops/silhouette_kernel.py): "auto" takes them on a
    # CUDA device at ≥512² with 32-px tiles; True forces, False disables
    use_pallas_raster: object = "auto"
    pm_topk: int = 0
    object_chunk: int = 0


def pose_transform(params: PoseParams, batch: ObjectBatch, cfg: FitConfig
                   ) -> torch.Tensor:
    """Per-object pose → world-space vertices (B, Vmax, 3)."""
    scale = torch.exp(params.log_scale)[:, None, None]
    if cfg.use_5dof:
        R = yaw_rotation(params.yaw * cfg.rotation_speed_mult)
    else:
        R = so3_exp(params.rot_aa)
    t = params.translation
    # planar objects keep their pivot-frame height (y) fixed
    keep = torch.tensor([1.0, 0.0, 1.0], dtype=t.dtype, device=t.device)
    t = torch.where(batch.on_floor[:, None], t * keep, t)
    v = torch.einsum("bvj,bjk->bvk", batch.verts * scale, R) + t[:, None, :]
    return (torch.einsum("bvj,bjk->bvk", v, batch.pivot_R)
            + batch.pivot_t[:, None, :])


def _binned_budget_ok(cfg: FitConfig, n_faces: int) -> bool:
    """Fixed-size tile bins keep the lowest-index faces when a mesh
    overflows them; require 4× headroom (n_faces·4 ≤ tiles·faces_per_tile),
    else the fit takes the exact streaming rasterizer."""
    nty = cfg.image_hw[0] // cfg.bin_tile
    ntx = cfg.image_hw[1] // cfg.bin_tile
    return n_faces * 4 <= nty * ntx * cfg.faces_per_tile


def _use_pallas(cfg: FitConfig, device: torch.device) -> bool:
    """Whether the edge path runs on the silhouette kernels."""
    if cfg.use_pallas_raster is True:
        return True
    if cfg.use_pallas_raster == "auto":
        return (torch.device(device).type == "cuda"
                and min(cfg.image_hw) >= 512 and cfg.bin_tile == 32)
    return False


def raster_path(cfg: FitConfig, n_faces: int, device) -> str:
    """The silhouette the fit runs: "edge_kernel" (tile kernels), "edge"
    (plain tile-binned edge path), "binned" (tile-binned exact SoftRas) or
    "streaming" (exact SoftRas over every face), in the JAX package's order
    of preference."""
    binned_ok = _binned_budget_ok(cfg, n_faces)
    if cfg.use_edge_raster and binned_ok:
        return "edge_kernel" if _use_pallas(cfg, device) else "edge"
    if cfg.use_binned_raster and binned_ok:
        return "binned"
    return "streaming"


def _objects_loss(v_world, verts_mask, faces, faces_mask, target_mask,
                  target_points, points_mask, bins, camera: Camera,
                  bbox_lo, bbox_hi, cfg: FitConfig) -> torch.Tensor:
    """Per-object losses (B,) for a group of objects."""
    vs = camera.view_to_screen(camera.world_to_view(v_world))
    path = raster_path(cfg, faces.shape[1], v_world.device)
    if path == "edge_kernel":
        alpha = soft_silhouette_edge_kernel(
            vs, faces, cfg.image_hw, sigma=cfg.sigma, faces_mask=faces_mask,
            faces_per_tile=cfg.faces_per_tile, bins=bins)
    elif path == "edge":
        alpha = soft_silhouette_edge(
            vs, faces, cfg.image_hw, sigma=cfg.sigma, faces_mask=faces_mask,
            tile=cfg.bin_tile, faces_per_tile=cfg.faces_per_tile, bins=bins)
    elif path == "binned":
        alpha = soft_silhouette_binned(
            vs, faces, cfg.image_hw, sigma=cfg.sigma, faces_mask=faces_mask,
            tile=cfg.bin_tile, faces_per_tile=cfg.faces_per_tile)
    else:
        alpha = soft_silhouette(vs, faces, cfg.image_hw, sigma=cfg.sigma,
                                faces_mask=faces_mask, chunk=cfg.face_chunk)
    l_sil = silhouette_loss(alpha, target_mask, use_focal=cfg.use_focal)
    if cfg.pm_topk > 0:
        l_3d = point_mesh_face_distance_topk(
            v_world, faces, target_points, points_mask, faces_mask,
            k=cfg.pm_topk, chunk=cfg.point_chunk)
    else:
        l_3d = point_mesh_face_distance_fast(v_world, faces, target_points,
                                             points_mask, faces_mask,
                                             cfg.point_chunk)
    l_box = bbox_hinge_loss(v_world, bbox_lo, bbox_hi, verts_mask)
    return cfg.w_sil * l_sil + cfg.w_3d * l_3d + cfg.w_bbox * l_box


def batch_loss(params: PoseParams, batch: ObjectBatch, camera: Camera,
               cfg: FitConfig, bins=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(total scalar, per-object losses (B,)). Padding slots contribute 0."""
    v_world = pose_transform(params, batch, cfg)
    b = v_world.shape[0]
    args = (v_world, batch.verts_mask, batch.faces, batch.faces_mask,
            batch.target_mask, batch.target_points, batch.points_mask)

    def group_loss(sl):
        grp_bins = None if bins is None else (bins[0][sl], bins[1][sl])
        return _objects_loss(*(a[sl] for a in args), grp_bins, camera,
                             batch.bbox_lo, batch.bbox_hi, cfg)

    oc = cfg.object_chunk
    if 0 < oc < b and b % oc == 0:
        # sequential checkpointed object groups: backward recomputes a group
        # instead of keeping every group's rasterizer planes alive
        per_obj = torch.cat([
            checkpoint(group_loss, slice(g0, g0 + oc), use_reentrant=False)
            for g0 in range(0, b, oc)])
    else:
        per_obj = group_loss(slice(0, b))
    per_obj = torch.where(batch.object_valid, per_obj,
                          torch.zeros_like(per_obj))
    return per_obj.sum(), per_obj


def compute_batch_bins(params: PoseParams, batch: ObjectBatch, camera: Camera,
                       cfg: FitConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-object silhouette bins from the current pose, with the motion
    margin, hoisted out of the optimization loop (edge paths)."""
    with torch.no_grad():
        v_world = pose_transform(params, batch, cfg)
        vs = camera.view_to_screen(camera.world_to_view(v_world))
        return compute_silhouette_bins(
            vs, batch.faces, cfg.image_hw, sigma=cfg.sigma,
            faces_mask=batch.faces_mask, tile=cfg.bin_tile,
            faces_per_tile=cfg.faces_per_tile, margin_px=cfg.bin_margin_px)


class FitResult(NamedTuple):
    params: PoseParams
    losses: torch.Tensor        # (B,) final per-object losses
    num_iters: int              # iterations run
    converged: torch.Tensor     # (B,) bool
    history: torch.Tensor       # (T+1, B, 8) pose history (zeros if disabled)


def _flatten_params(p: PoseParams) -> torch.Tensor:
    return torch.cat([p.translation, p.yaw[:, None], p.rot_aa,
                      p.log_scale[:, None]], -1)


def fit_poses(init_params: PoseParams, batch: ObjectBatch, camera: Camera,
              cfg: FitConfig) -> FitResult:
    """Batched Adam pose optimization with per-object clip and freeze gates."""
    with full_f32():
        return _fit(init_params, batch, camera, cfg)


def _any_active(flag: torch.Tensor) -> bool:
    return bool(flag.any())


def _fit(init_params, batch, camera, cfg, any_active=_any_active):
    """The fit's loop; ``any_active`` reads whether any object still moves
    (across every rank in the sharded fit)."""
    b = init_params.yaw.shape[0]
    dev = init_params.yaw.device
    bins = (compute_batch_bins(init_params, batch, camera, cfg)
            if cfg.use_edge_raster
            and _binned_budget_ok(cfg, batch.faces.shape[1]) else None)
    beta1, beta2, eps = 0.9, 0.999, 1e-8
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)

    params = PoseParams(*(p.detach().clone() for p in init_params))
    m = PoseParams(*(torch.zeros_like(p) for p in params))
    v = PoseParams(*(torch.zeros_like(p) for p in params))
    hist = torch.zeros(cfg.max_iterations + 1 if cfg.record_history else 1,
                       b, 8, dtype=torch.float32, device=dev)
    if cfg.record_history:
        hist[0] = _flatten_params(params)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    valid = batch.object_valid.bool()

    it = 0
    while it < cfg.max_iterations and any_active(active & valid):
        p = PoseParams(*(x.detach().requires_grad_() for x in params))
        total, _ = batch_loss(p, batch, camera, cfg, bins)
        grads = torch.autograd.grad(total, p, allow_unused=True)
        g = PoseParams(*(torch.zeros_like(x) if gx is None else gx
                         for x, gx in zip(p, grads)))
        gnorm = torch.sqrt((g.translation ** 2).sum(-1) + g.yaw ** 2
                           + (g.rot_aa ** 2).sum(-1) + g.log_scale ** 2
                           + 1e-20)
        # per-object clip to grad_clip, and freeze converged / padding slots
        clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                           max=1.0)
        gate = (active & valid).float() * clip
        g = PoseParams(g.translation * gate[:, None], g.yaw * gate,
                       g.rot_aa * gate[:, None], g.log_scale * gate)
        t = f32(it + 1)
        m = PoseParams(*(beta1 * m_ + (1 - beta1) * g_ for m_, g_ in zip(m, g)))
        v = PoseParams(*(beta2 * v_ + (1 - beta2) * g_ * g_
                         for v_, g_ in zip(v, g)))
        bc1 = 1 - f32(beta1) ** t
        bc2 = 1 - f32(beta2) ** t
        params = PoseParams(*(
            p_.detach() - cfg.learning_rate * (m_ / bc1)
            / (torch.sqrt(v_ / bc2) + eps) for p_, m_, v_ in zip(p, m, v)))
        stop_now = (gnorm < cfg.early_stop_grad) & (it >= cfg.early_stop_min_iters)
        active = active & ~stop_now
        if cfg.record_history:
            hist[it + 1] = _flatten_params(params)
        it += 1
    with torch.no_grad():
        _, per_obj = batch_loss(params, batch, camera, cfg, bins)
    return FitResult(params=params, losses=per_obj, num_iters=it,
                     converged=~active, history=hist)


def pad_batch_to(batch: ObjectBatch, params: PoseParams, multiple: int
                 ) -> Tuple[ObjectBatch, PoseParams, int]:
    """Pad the object axis to a multiple (padding slots object_valid=False,
    identity pivots). Returns (batch, params, original_b)."""
    b = batch.verts.shape[0]
    pad = (-b) % multiple
    if pad == 0:
        return batch, params, b

    def pad0(x):
        return torch.cat([x, torch.zeros((pad, *x.shape[1:]), dtype=x.dtype,
                                         device=x.device)])

    eye = torch.eye(3, device=batch.pivot_R.device).expand(pad, 3, 3)
    batch = ObjectBatch(
        verts=pad0(batch.verts), verts_mask=pad0(batch.verts_mask),
        faces=pad0(batch.faces), faces_mask=pad0(batch.faces_mask),
        target_mask=pad0(batch.target_mask),
        target_points=pad0(batch.target_points),
        points_mask=pad0(batch.points_mask),
        pivot_R=torch.cat([batch.pivot_R, eye.to(batch.pivot_R.dtype)]),
        pivot_t=pad0(batch.pivot_t), on_floor=pad0(batch.on_floor),
        object_valid=pad0(batch.object_valid),
        bbox_lo=batch.bbox_lo, bbox_hi=batch.bbox_hi)
    return batch, PoseParams(*(pad0(x) for x in params)), b


# the per-object leaves of an ObjectBatch (bbox_lo and bbox_hi are shared)
_PER_OBJECT = tuple(f for f in ObjectBatch._fields
                    if f not in ("bbox_lo", "bbox_hi"))


def fit_poses_sharded(init_params: PoseParams, batch: ObjectBatch,
                      camera: Camera, cfg: FitConfig, mesh) -> FitResult:
    """:func:`fit_poses` with the OBJECT axis split over the mesh's 'dp'
    axis (JAX's ``fit_poses_sharded``, the reference's per-object process
    pool, scene_reconstruction/run.py:88-96): the batch pads to a multiple
    of dp with :func:`pad_batch_to`, each dp rank fits its block of objects,
    and the results are gathered on every rank and trimmed back to the
    batch. The one collective inside the loop is the convergence test: the
    loop runs while any object of any rank is active (a max all-reduce of
    each rank's flag), so every rank stops at the same, global, number of
    iterations, as the single program does in JAX; each object's fit
    depends on no other object. At dp = 1 nothing is split or padded and
    no collective runs: :func:`fit_poses` bit for bit. A
    collective: every rank of the mesh calls it with the same inputs."""
    i = mesh.mesh_dim_names.index("dp")
    dp, r, group = mesh.size(i), mesh.get_local_rank(i), mesh.get_group(i)
    batch, init_params, b = pad_batch_to(batch, init_params, dp)
    n = batch.verts.shape[0] // dp
    block = slice(r * n, (r + 1) * n)
    local = batch._replace(**{f: getattr(batch, f)[block]
                              for f in _PER_OBJECT})
    local_init = PoseParams(*(x[block] for x in init_params))

    def any_active(flag):
        if dp == 1:
            return _any_active(flag)
        t = flag.any().to(torch.int32).reshape(1)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        return bool(t)

    with full_f32():
        res = _fit(local_init, local, camera, cfg, any_active)

    def gather(x, dim=0):
        if dp == 1:
            return x.narrow(dim, 0, b)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dp)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim).narrow(dim, 0, b)

    return FitResult(
        params=PoseParams(*(gather(x) for x in res.params)),
        losses=gather(res.losses),
        num_iters=res.num_iters,
        converged=gather(res.converged.to(torch.uint8)).bool(),
        history=gather(res.history, 1))


def find_best_initial_yaw(
    verts: torch.Tensor,
    target_points: torch.Tensor,
    num_steps: int = 8,
    verts_mask: Optional[torch.Tensor] = None,
    points_mask: Optional[torch.Tensor] = None,
    chunk: int = 1024,
) -> torch.Tensor:
    """Yaw grid search: score ``num_steps`` Y-rotations of the pivot-centred
    vertices against the target cloud by symmetric chamfer and return the
    best angle, the first among equal scores (reference:
    find_best_initial_yaw, pose_matching_planar.py:185-334)."""
    angles = (torch.arange(num_steps, dtype=torch.float32, device=verts.device)
              * torch.tensor(2 * math.pi / num_steps, dtype=torch.float32))
    cand = torch.einsum("vj,sjk->svk", verts, yaw_rotation(angles))
    with torch.no_grad():
        scores = torch.stack([chamfer_loss(c, target_points, verts_mask,
                                           points_mask, chunk) for c in cand])
    return angles[torch.argmin(scores)]
