"""Phase 4, the alternative under ``Use_VGGT: false``: DUSt3R pairwise stereo
and global alignment (counterpart of regen3d_tpu/pipeline/phase4_dust3r.py).

The input image (and the empty room, when phase 2 wrote one) are loaded at
``image_size``, a lone image duplicated; every ordered pair of a complete
symmetrised graph goes through the DUSt3R model; the pairwise pointmaps
are aligned (the closed-form pair viewer for two images, the 300-iteration
Adam aligner for more) and exported: ``scene.glb`` (the reference's point
cloud) and the standard phase-4 artifact set through
``phase4_camera.export_reconstruction``, so phases 5 to 7 run unchanged.

The JAX package vmaps the pairs, each a batch-1 forward; the port stacks
every pair on the batch axis of one forward (the encoder sees 2E images
for E pairs), which computes the same per-pair outputs. The aligner is
written out in torch with optax's ``adam`` under its ``linear_schedule``:
bias-corrected moments, eps outside the root, the rate at step t the
schedule's value at t counted from 0. Its loop reads nothing on the host
until it ends.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from regen3d_tpu_torch.artifacts import Artifacts
from regen3d_tpu_torch.config import Config
from regen3d_tpu_torch.models.dust3r import estimate_focal
from regen3d_tpu_torch.models.layers import resize_bilinear
from regen3d_tpu_torch.ops import full_f32
from regen3d_tpu_torch.transforms.rigid import umeyama
from regen3d_tpu_torch.transforms.rotations import matrix_to_quat, quat_to_matrix
from regen3d_tpu_torch.utils.image import load_image_rgb

log = logging.getLogger(__name__)

# optax.adam's defaults
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def make_pairs(n: int) -> List[Tuple[int, int]]:
    """Complete symmetrised scene graph: all ordered (i, j), i ≠ j."""
    return [(i, j) for i in range(n) for j in range(n) if i != j]


@torch.no_grad()
def run_pairwise(model, images: torch.Tensor,
                 pairs: Sequence[Tuple[int, int]]) -> Dict[str, torch.Tensor]:
    """Every pair through one batched forward. images: (N, H, W, 3) in
    [0, 1] on the model's device. Returns (E, H, W, ...) tensors:
    pts3d1/conf1 (view i in frame i), pts3d2/conf2 (view j in frame i)."""
    ii = torch.as_tensor([p[0] for p in pairs], device=images.device)
    jj = torch.as_tensor([p[1] for p in pairs], device=images.device)
    return model(images[ii], images[jj])


# ----------------------------------------------------------------------------
# Global alignment
# ----------------------------------------------------------------------------

def _pixel_grid(h: int, w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vv, uu) (H, W) f32 pixel centres relative to the image centre."""
    vv = torch.arange(h, dtype=torch.float32, device=device)[:, None] \
        .expand(h, w) + 0.5 - h / 2.0
    uu = torch.arange(w, dtype=torch.float32, device=device)[None, :] \
        .expand(h, w) + 0.5 - w / 2.0
    return vv, uu


def _unproject(depth: torch.Tensor, focal: torch.Tensor) -> torch.Tensor:
    """(..., H, W) depth and (...) focal → camera-frame pointmaps
    (..., H, W, 3); principal point at the image centre."""
    vv, uu = _pixel_grid(*depth.shape[-2:], depth.device)
    f = focal[..., None, None]
    return torch.stack([uu / f * depth, vv / f * depth, depth], -1)


def _c2w(quat: torch.Tensor, trans: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., 4), (..., 3) → the cam→world rotation (column convention,
    points_world = R @ p + t) and translation; the quaternion normalised."""
    return quat_to_matrix(quat / torch.linalg.norm(quat, dim=-1,
                                                   keepdim=True)), trans


def _umeyama_np(src: np.ndarray, dst: np.ndarray, wgt: np.ndarray, device):
    """umeyama on f32 tensors on ``device`` → host (R, t, s)."""
    R, t, s = umeyama(*(torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                        device=device)
                        for a in (src, dst)),
                      weights=torch.as_tensor(np.asarray(wgt),
                                              dtype=torch.float32,
                                              device=device))
    return R.cpu().numpy(), t.cpu().numpy(), s.cpu().numpy()


def _focal_np(pts: np.ndarray, device) -> float:
    return float(estimate_focal(torch.as_tensor(pts, dtype=torch.float32,
                                                device=device)))


def mst_init(pred: Dict[str, np.ndarray], pairs: Sequence[Tuple[int, int]],
             n_images: int, device="cuda") -> Dict[str, np.ndarray]:
    """Pose, depth and focal init by spanning-tree propagation: edges sorted
    by mean confidence; for a tree edge (i, j) with i placed, the
    similarity of j's own-frame pointmap onto j's pointmap in i's frame
    composed onto i's pose. Host numpy, with umeyama and the focal estimate
    on ``device``."""
    e_of = {p: k for k, p in enumerate(pairs)}
    conf_means = {p: float(np.mean(pred["conf2"][e_of[p]])) for p in pairs}
    order = sorted(pairs, key=lambda p: -conf_means[p])

    c2w = [None] * n_images
    c2w[0] = np.eye(4)
    placed = {0}
    progress = True
    while len(placed) < n_images and progress:
        progress = False
        for (i, j) in order:
            if i in placed and j not in placed:
                own = np.asarray(pred["pts3d1"][e_of[(j, i)]]).reshape(-1, 3)
                in_i = np.asarray(pred["pts3d2"][e_of[(i, j)]]).reshape(-1, 3)
                wgt = np.asarray(pred["conf2"][e_of[(i, j)]]).reshape(-1)
                R, t, s = _umeyama_np(own, in_i, wgt, device)
                # row convention: own @ R * s + t ≈ in_i ⇒ column M = s·Rᵀ
                M = np.eye(4)
                M[:3, :3] = s * R.T
                M[:3, 3] = t
                c2w[j] = c2w[i] @ M
                placed.add(j)
                progress = True
    for k in range(n_images):
        if c2w[k] is None:   # a disconnected image
            c2w[k] = np.eye(4)

    depths = np.stack([np.maximum(np.asarray(pred["pts3d1"][e_of[
        (i, (i + 1) % n_images) if (i, (i + 1) % n_images) in e_of
        else next(p for p in pairs if p[0] == i)]])[..., 2], 1e-3)
        for i in range(n_images)])
    focals = np.stack([np.float32(_focal_np(
        pred["pts3d1"][e_of[next(p for p in pairs if p[0] == i)]], device))
        for i in range(n_images)])
    return {"c2w": np.stack(c2w), "depth": depths, "focal": focals}


def linear_schedule(lr: float, end: float, steps: int, t: int) -> float:
    """optax.linear_schedule(lr, end, steps) at step t."""
    frac = 1.0 - min(max(t, 0), steps) / steps
    return (lr - end) * frac + end


def align_loss(p: Dict[str, torch.Tensor], x1, x2, w1, w2, ii, jj
               ) -> torch.Tensor:
    """The aligner's loss: the confidence-weighted distance between each
    edge's scaled, pose-transformed pairwise pointmaps and the global
    pointmaps they should equal, over E·H·W. Image 0's pose and edge 0's
    scale are frozen (replaced, so their gradient is 0)."""
    quat = torch.cat([torch.tensor([[1.0, 0.0, 0.0, 0.0]],
                                   device=p["quat"].device), p["quat"][1:]])
    trans = torch.cat([torch.zeros_like(p["trans"][:1]), p["trans"][1:]])
    logs = torch.cat([torch.zeros_like(p["log_scale"][:1]),
                      p["log_scale"][1:]])
    R, t = _c2w(quat, trans)                            # (N, 3, 3), (N, 3)
    pts_cam = _unproject(torch.exp(p["log_depth"]),
                         torch.exp(p["log_focal"][:, 0]))
    chi = pts_cam @ R.transpose(-1, -2)[:, None] + t[:, None, None]
    s = torch.exp(logs[:, 0])[:, None, None, None]
    Ri = R[ii].transpose(-1, -2)[:, None]
    ti = t[ii][:, None, None]
    pr1 = (s * x1) @ Ri + ti
    pr2 = (s * x2) @ Ri + ti
    # eps-safe norm: a plain norm's gradient is NaN at a zero residual
    d1 = torch.sqrt(torch.sum((chi[ii] - pr1) ** 2, -1) + 1e-12)
    d2 = torch.sqrt(torch.sum((chi[jj] - pr2) ** 2, -1) + 1e-12)
    total = torch.sum(w1 * d1) + torch.sum(w2 * d2)
    e, h, w = x1.shape[:3]
    return total / (e * h * w)


def global_align(pred: Dict[str, np.ndarray],
                 pairs: Sequence[Tuple[int, int]], n_images: int,
                 niter: int = 300, lr: float = 0.01,
                 device="cuda") -> Dict[str, np.ndarray]:
    """The global aligner (upstream PointCloudOptimizer: 300 iterations, lr
    0.01 under a linear schedule to lr·1e-3) on ``device`` in f32.
    Variables: per-image log-depthmaps, cam→world quaternion and
    translation, log-focals; per-edge log-scales. Returns host arrays
    c2w (N, 4, 4), depth (N, H, W), focal (N,), pts3d (N, H, W, 3)."""
    init = mst_init(pred, pairs, n_images, device=device)
    h, w = pred["pts3d1"].shape[1:3]

    def dev(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=device)

    ii = torch.as_tensor([p[0] for p in pairs], device=device)
    jj = torch.as_tensor([p[1] for p in pairs], device=device)
    x1, x2 = dev(pred["pts3d1"]), dev(pred["pts3d2"])
    # log-confidence weights (upstream conf_trf = log), ≥ 0
    w1 = torch.clamp(torch.log(dev(pred["conf1"])), min=0.0)
    w2 = torch.clamp(torch.log(dev(pred["conf2"])), min=0.0)
    rots = np.stack([init["c2w"][k][:3, :3] / np.cbrt(max(np.linalg.det(
        init["c2w"][k][:3, :3]), 1e-9)) for k in range(n_images)])
    params = {
        "log_depth": torch.log(dev(init["depth"])),
        "quat": matrix_to_quat(dev(rots)),
        "trans": dev(init["c2w"][:, :3, 3]),
        "log_focal": torch.log(dev(init["focal"]))[:, None],
        "log_scale": torch.zeros((len(pairs), 1), device=device),
    }
    names = list(params)
    for v in params.values():
        v.requires_grad_(True)
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    losses = torch.empty(niter, device=device)
    with full_f32():
        for step in range(niter):
            loss = align_loss(params, x1, x2, w1, w2, ii, jj)
            grads = torch.autograd.grad(loss, [params[k] for k in names])
            losses[step] = loss.detach()
            c1 = 1.0 - ADAM_B1 ** (step + 1)
            c2 = 1.0 - ADAM_B2 ** (step + 1)
            rate = linear_schedule(lr, lr * 1e-3, niter, step)
            with torch.no_grad():
                for k, g in zip(names, grads):
                    mu[k] = (1 - ADAM_B1) * g + ADAM_B1 * mu[k]
                    nu[k] = (1 - ADAM_B2) * g * g + ADAM_B2 * nu[k]
                    upd = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + ADAM_EPS)
                    params[k] -= rate * upd

    p = {k: v.detach().cpu().numpy().copy() for k, v in params.items()}
    p["quat"][0] = np.asarray([1.0, 0, 0, 0])
    p["trans"][0] = 0.0
    quats = p["quat"] / np.linalg.norm(p["quat"], axis=-1, keepdims=True)
    depth = np.exp(p["log_depth"]).reshape(n_images, h, w)
    focal = np.exp(p["log_focal"][:, 0])
    with full_f32():
        Rt = quat_to_matrix(dev(quats))
        pts = (_unproject(dev(depth), dev(focal)) @ Rt.transpose(-1, -2)[:, None]
               + dev(p["trans"])[:, None, None]).cpu().numpy()
    c2w = np.tile(np.eye(4), (n_images, 1, 1))
    c2w[:, :3, :3] = Rt.cpu().numpy()
    c2w[:, :3, 3] = p["trans"]
    losses = losses.cpu().numpy()
    log.info("dust3r aligner: %d iters, loss %.5f → %.5f",
             niter, float(losses[0]), float(losses[-1]))
    return {"c2w": c2w, "depth": depth, "focal": focal, "pts3d": pts,
            "losses": losses}


def pair_viewer(pred: Dict[str, np.ndarray],
                pairs: Sequence[Tuple[int, int]], device="cuda"
                ) -> Dict[str, np.ndarray]:
    """The two-image closed-form scene (upstream PairViewer): frame 0 is the
    world; focals by Weiszfeld; camera 1's pose from the conf-weighted
    similarity of its own-frame pointmap onto its pointmap in frame 0."""
    e01 = pairs.index((0, 1))
    e10 = pairs.index((1, 0))
    pts0 = np.asarray(pred["pts3d1"][e01])          # view 0 in frame 0
    pts1_in0 = np.asarray(pred["pts3d2"][e01])      # view 1 in frame 0
    pts1_own = np.asarray(pred["pts3d1"][e10])      # view 1 in frame 1
    conf1 = np.asarray(pred["conf2"][e01])

    f0 = _focal_np(pts0, device)
    f1 = _focal_np(pts1_own, device)
    R, t, s = _umeyama_np(pts1_own.reshape(-1, 3), pts1_in0.reshape(-1, 3),
                          conf1.reshape(-1), device)
    c2w1 = np.eye(4)
    c2w1[:3, :3] = float(s) * R.T
    c2w1[:3, 3] = t
    c2w = np.stack([np.eye(4), c2w1])
    depth = np.stack([np.maximum(pts0[..., 2], 1e-6),
                      np.maximum(pts1_own[..., 2], 1e-6)])
    pts1_world = (pts1_own.reshape(-1, 3) @ c2w1[:3, :3].T
                  + c2w1[:3, 3]).reshape(pts0.shape)
    return {"c2w": c2w, "depth": depth, "focal": np.asarray([f0, f1]),
            "pts3d": np.stack([pts0, pts1_world])}


# ----------------------------------------------------------------------------
# Export
# ----------------------------------------------------------------------------

def export_dust3r_scene(cfg: Config, scene: Dict[str, np.ndarray],
                        images: np.ndarray, names: Sequence[str],
                        confs: np.ndarray) -> None:
    """Write the reference's dust3r artifacts (``scene.glb``, a point cloud
    rebased by inv(c2w₀·OpenGL·RotY180)) and the standard phase-4 artifact
    set, so downstream phases run unchanged."""
    from regen3d_tpu_torch.pipeline.phase4_camera import export_reconstruction
    from regen3d_tpu_torch.utils.glb import save_pointcloud_glb

    art = Artifacts(cfg)
    os.makedirs(art.pre3d_dir, exist_ok=True)
    min_conf = float(cfg.get("min_conf_thr", 3.0))
    h, w = scene["depth"].shape[1:3]

    masks = confs >= min_conf
    # keep every pixel of a frame the threshold would empty (random-init
    # nets)
    for k in range(len(masks)):
        if not masks[k].any():
            masks[k][:] = True

    opengl = np.diag([1.0, -1.0, -1.0, 1.0])
    roty = np.diag([-1.0, 1.0, -1.0, 1.0])
    world_fix = np.linalg.inv(scene["c2w"][0] @ opengl @ roty)
    pts = np.concatenate([scene["pts3d"][k][masks[k]]
                          for k in range(len(names))])
    cols = np.concatenate([images[k][masks[k]] for k in range(len(names))])
    pts_fixed = pts @ world_fix[:3, :3].T + world_fix[:3, 3]
    save_pointcloud_glb(os.path.join(art.pre3d_dir, "scene.glb"),
                        pts_fixed.reshape(-1, 3),
                        (cols.reshape(-1, 3) * 255).astype(np.uint8))

    frames: Dict[str, Dict[str, np.ndarray]] = {}
    for k, name in enumerate(names):
        w2c = np.linalg.inv(scene["c2w"][k])
        frames[name] = {
            "points": scene["pts3d"][k][masks[k]].reshape(-1, 3),
            "colors": (images[k][masks[k]].reshape(-1, 3) * 255
                       ).astype(np.uint8),
            "R": w2c[:3, :3], "t": w2c[:3, 3],
            "fx": float(scene["focal"][k]), "fy": float(scene["focal"][k]),
            "cx": w / 2.0, "cy": h / 2.0, "width": w, "height": h,
        }
    export_reconstruction(cfg, frames)


def run(cfg: Config, model=None) -> None:
    """Phase-4 DUSt3R entry (``Use_VGGT: false``) with ``model`` (an
    ``AsymmetricCroCo3DStereo`` on the device it runs on); without one this
    raises before any work, as the JAX package does."""
    art = Artifacts(cfg)
    inputs = [cfg.path("input_image")]
    if os.path.exists(art.empty_room):
        inputs.append(art.empty_room)
    if model is None:
        raise RuntimeError(
            "dust3r phase 4 requires a model + params (no pretrained "
            "weights ship in this environment — convert a checkpoint via "
            "scripts/convert_weights.py and pass it in)")
    run_from_model(cfg, model, tuple(inputs))


def load_images(image_paths: Sequence[str], res: int, device
                ) -> torch.Tensor:
    """(N, res, res, 3) f32 in [0, 1] on ``device``: each image resized as
    ``jax.image.resize(..., "bilinear")`` (antialiased when it shrinks)."""
    imgs = []
    for p in image_paths:
        arr = load_image_rgb(p, max_side=None).astype(np.float32) / 255.0
        imgs.append(resize_bilinear(torch.from_numpy(arr).to(device)[None],
                                    (res, res))[0])
    return torch.stack(imgs)


def run_from_model(cfg: Config, model, image_paths: Tuple[str, ...],
                   resolution: int = None) -> None:
    """Load (a lone image duplicated so the pair graph is not empty) →
    pairwise inference → align → export, on the model's device."""
    device = next(model.parameters()).device
    res = resolution or int(cfg.get("image_size", 512))
    res = max(model.cfg.patch, (res // model.cfg.patch) * model.cfg.patch)

    names = [os.path.basename(p) for p in image_paths]
    if len(image_paths) == 1:
        image_paths = (image_paths[0], image_paths[0])
        names = [names[0], "duplicate_" + names[0]]
    images_t = load_images(image_paths, res, device)
    images = images_t.cpu().numpy()

    pairs = make_pairs(len(images))
    pred = {k: v.cpu().numpy() for k, v in
            run_pairwise(model, images_t, pairs).items()}

    if len(images) > 2:
        scene = global_align(pred, pairs, len(images),
                             niter=int(cfg.get("dust3r_niter", 300)),
                             device=device)
    else:
        scene = pair_viewer(pred, pairs, device=device)

    confs = np.stack([pred["conf1"][pairs.index((k, (k + 1) % len(images)))]
                      for k in range(len(images))])
    export_dust3r_scene(cfg, scene, images, names, confs)
    log.info("phase4-dust3r: %d frames aligned and exported", len(names))
