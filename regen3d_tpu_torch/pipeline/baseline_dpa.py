"""DeepPriorAssembly comparison baseline, the ``Use_DPA: true`` workflow and
``-p 11`` (counterpart of regen3d_tpu/pipeline/baseline_dpa.py).

Five stages, each writing its directory under ``dpa_output``:

  segmentation → inpainting → object_generation → geometry →
  final_registration

backed by the port's own engines: phase 1's detector and SAM engine, the
phase-2 inpainting client (the offline inpainter by default) for each
object's amodal completion, the flow-matching generator at half the phase-3
step count, the monocular depth prior unprojected to a scene cloud, and
the batched 5-DOF silhouette and cloud pose fit (``pose_fit.fit_poses``;
the tile-binned edge silhouette when H and W divide by 32, which runs on
the silhouette kernels on the card at 512² and above).

The generator, the depth model and the fit run on ``device`` (the
generator's when one is passed); the stages' files are written on the
host. Each object's target points are drawn on the host from
``default_rng(0)``, as in the JAX package.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional

import numpy as np
import torch

from regen3d_tpu_torch.camera import Camera
from regen3d_tpu_torch.config import Config
from regen3d_tpu_torch.models.layers import resize_bilinear
from regen3d_tpu_torch.pipeline.depth import estimate_depth
from regen3d_tpu_torch.pipeline.phase1_segmentation import detect_and_segment
from regen3d_tpu_torch.pipeline.phase2_inpaint import OfflineInpainter
from regen3d_tpu_torch.pipeline.phase3_assets import (
    AssetGenerator,
    extract_and_clean,
)
from regen3d_tpu_torch.pipeline.pose_fit import (
    FitConfig,
    ObjectBatch,
    PoseParams,
    fit_poses,
    pose_transform,
)
from regen3d_tpu_torch.utils.glb import MeshData, SceneData, save_glb
from regen3d_tpu_torch.utils.image import load_image_rgb, save_image
from regen3d_tpu_torch.utils.ply import save_ply

log = logging.getLogger(__name__)

STAGES = ("segmentation", "inpainting", "object_generation", "geometry",
          "final_registration")
# target points per object in the registration
POINTS_PER_OBJECT = 1024


def inpaint_objects(image: np.ndarray, dets, client, seed: int,
                    out_dir: str) -> List[np.ndarray]:
    """Each detection's box crop, outside its mask on white, completed by
    ``client`` and written to ``object_<i>.png``."""
    inpainted = []
    for i, d in enumerate(dets):
        x0, y0 = max(int(d.box.xmin), 0), max(int(d.box.ymin), 0)
        x1, y1 = int(np.ceil(d.box.xmax)), int(np.ceil(d.box.ymax))
        crop = image[y0:y1, x0:x1]
        m = d.mask[y0:y1, x0:x1]
        masked = (crop * m[..., None]
                  + 255 * (1 - m[..., None])).astype(np.uint8)
        prompt = f"complete the {d.label} object, white background"
        try:
            out = client.generate(prompt, masked, temperature=0.4,
                                  top_p=0.95, seed=seed)
        except Exception as e:                      # pragma: no cover
            log.warning("dpa: inpaint failed (%s) — masked crop", e)
            out = masked
        inpainted.append(np.asarray(out))
        save_image(os.path.join(out_dir, f"object_{i}.png"),
                   np.asarray(out).astype(np.uint8))
    return inpainted


def object_crops(inpainted: List[np.ndarray], size: int, device
                 ) -> torch.Tensor:
    """(B, size, size, 4) on ``device``: each completed object, opaque,
    resized bilinearly (antialiased when it shrinks)."""
    crops = []
    for img in inpainted:
        rgba = np.concatenate(
            [np.asarray(img, np.float32) / 255.0,
             np.ones((*np.asarray(img).shape[:2], 1), np.float32)], -1)
        crops.append(resize_bilinear(torch.from_numpy(rgba).to(device)[None],
                                     (size, size))[0])
    return torch.stack(crops)


def depth_cloud(depth: np.ndarray) -> np.ndarray:
    """(H, W) relative depth → (H, W, 3) camera-frame cloud: z = 4·d + 1,
    focal max(H, W), principal point at the centre."""
    h, w = depth.shape
    focal = max(h, w) * 1.0
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32) + 0.5
    z = depth.astype(np.float32) * 4.0 + 1.0
    return np.stack([(xx - w / 2) / focal * z, (yy - h / 2) / focal * z, z],
                    -1)


def registration_problem(objects, dets, cloud: np.ndarray, h: int, w: int,
                         device):
    """(ObjectBatch, init PoseParams) of the 5-DOF registration on
    ``device``: each mesh centred and scaled to the unit cube, its mask, and
    up to POINTS_PER_OBJECT of the cloud's points under its mask drawn
    without replacement from ``default_rng(0)``; each object starts at the
    median depth of its points (3 without any)."""
    n = len(objects)
    vmax = max(len(v) for _, v, _ in objects)
    fmax = max(len(f) for _, _, f in objects)
    pmax = POINTS_PER_OBJECT
    V = np.zeros((n, vmax, 3), np.float32)
    Vm = np.zeros((n, vmax), bool)
    F = np.zeros((n, fmax, 3), np.int32)
    Fm = np.zeros((n, fmax), bool)
    M = np.zeros((n, h, w), np.float32)
    P = np.zeros((n, pmax, 3), np.float32)
    Pm = np.zeros((n, pmax), bool)
    for bi, (i, verts, faces) in enumerate(objects):
        c = verts.mean(0)
        verts = (verts - c) / (np.abs(verts - c).max() + 1e-6)
        V[bi, :len(verts)] = verts
        Vm[bi, :len(verts)] = True
        F[bi, :len(faces)] = faces
        Fm[bi, :len(faces)] = True
        M[bi] = dets[i].mask
        pts = cloud[dets[i].mask]
        if len(pts):
            sel = np.random.default_rng(0).choice(
                len(pts), min(pmax, len(pts)), replace=False)
            P[bi, :len(sel)] = pts[sel]
            Pm[bi, :len(sel)] = True
    med_z = np.asarray([np.median(P[bi][Pm[bi]][:, 2]) if Pm[bi].any()
                        else 3.0 for bi in range(n)], np.float32)

    def t(a):
        return torch.from_numpy(a).to(device)

    batch = ObjectBatch(
        verts=t(V), verts_mask=t(Vm), faces=t(F), faces_mask=t(Fm),
        target_mask=t(M), target_points=t(P), points_mask=t(Pm),
        pivot_R=torch.eye(3, device=device)[None].repeat(n, 1, 1),
        pivot_t=torch.zeros((n, 3), device=device),
        on_floor=torch.zeros(n, dtype=torch.bool, device=device),
        object_valid=torch.ones(n, dtype=torch.bool, device=device),
        bbox_lo=torch.tensor([-100.0, -100.0, 0.1], device=device),
        bbox_hi=torch.tensor([100.0, 100.0, 100.0], device=device))
    init = PoseParams.zeros(n, device=device)._replace(
        translation=t(np.stack([np.zeros(n), np.zeros(n), med_z],
                               -1).astype(np.float32)))
    return batch, init


def fit_config(cfg: Config, h: int, w: int) -> FitConfig:
    """The registration's fit: 5-DOF, ``dpa_iterations`` iterations (no
    early stop before them), the binned edge silhouette (32-px tiles, 64
    faces a tile) when H and W divide by 32."""
    iters = int(cfg.get("dpa_iterations", 60))
    return FitConfig(
        image_hw=(h, w), use_5dof=True, max_iterations=iters,
        early_stop_min_iters=iters, sigma=float(cfg.get("sigma", 1e-5)),
        record_history=False,
        use_edge_raster=(h % 32 == 0 and w % 32 == 0),
        bin_tile=32, faces_per_tile=64)


def run(cfg: Config, sam=None, detector=None,
        generator: Optional[AssetGenerator] = None, inpaint_client=None,
        depth_model=None, device="cuda") -> Optional[str]:
    """The five-stage DPA chain; returns the final scene GLB's path, or
    None when nothing was detected or meshed."""
    if generator is not None:
        device = generator.device
    out_root = cfg.path("dpa_output", "../output/dpa/")
    dirs = {s: os.path.join(out_root, s) for s in STAGES}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    image = load_image_rgb(cfg.path("input_image"), max_side=None)
    h, w = image.shape[:2]
    seed = int(cfg.get("seed", 1234567))

    # stage 1: segmentation
    dets = detect_and_segment(cfg, image, sam=sam, detector=detector,
                              device=device)
    if not dets:
        log.warning("dpa: no detections")
        return None
    for i, d in enumerate(dets):
        save_image(os.path.join(dirs["segmentation"], f"mask_{i}.png"),
                   d.mask.astype(np.float32))

    # stage 2: inpainting (each object's amodal completion)
    client = inpaint_client or OfflineInpainter(dirs["segmentation"])
    inpainted = inpaint_objects(image, dets, client, seed, dirs["inpainting"])

    # stage 3: object generation
    if generator is None:
        log.warning("dpa: no checkpoint — random-init generator")
        generator = AssetGenerator.random_init(
            torch.Generator(device=device).manual_seed(seed), tiny=True,
            device=device)
    size = 64 if generator.dit_cfg.width < 512 else 512
    res = int(cfg.get("octree_resolution_hy", 256))
    if generator.dit_cfg.width < 512:
        res = min(res, 96)
    vols = generator.generate_sdf_batch(
        torch.Generator(device=device).manual_seed(seed),
        object_crops(inpainted, size, device),
        int(cfg.get("num_inf_steps_hy", 50)) // 2,
        float(cfg.get("guidance_scale", 5.0)), res, 2048)
    objects = []
    for i in range(len(dets)):
        verts, faces = extract_and_clean(vols[i], 2048)
        if len(faces):
            objects.append((i, verts, faces))
            save_glb(os.path.join(dirs["object_generation"],
                                  f"object_{i}.glb"),
                     SceneData(meshes=[MeshData(name=f"object_{i}",
                                                vertices=verts,
                                                faces=faces)]))
    if not objects:
        log.warning("dpa: no non-empty objects")
        return None

    # stage 4: scene geometry from the depth prior
    cloud = depth_cloud(estimate_depth(image, depth_model))
    save_ply(os.path.join(dirs["geometry"], "scene.ply"),
             cloud.reshape(-1, 3)[::7])

    # stage 5: 5-DOF registration
    focal = max(h, w) * 1.0
    cam = Camera(R=torch.eye(3, device=device),
                 T=torch.zeros(3, device=device),
                 focal=torch.tensor([focal, focal], device=device),
                 principal=torch.tensor([w / 2.0, h / 2.0], device=device),
                 image_size=(h, w))
    batch, init = registration_problem(objects, dets, cloud, h, w, device)
    fit_cfg = fit_config(cfg, h, w)
    result = fit_poses(init, batch, cam, fit_cfg)
    with torch.no_grad():
        fitted = pose_transform(result.params, batch, fit_cfg).cpu().numpy()
    verts_mask = batch.verts_mask.cpu().numpy()
    meshes = [MeshData(name=f"{dets[i].label}_{i}",
                       vertices=fitted[bi][verts_mask[bi]], faces=faces)
              for bi, (i, _, faces) in enumerate(objects)]
    out_glb = os.path.join(dirs["final_registration"], "scene.glb")
    save_glb(out_glb, SceneData(meshes=meshes))
    log.info("dpa: %d objects registered → %s", len(meshes), out_glb)
    return out_glb
