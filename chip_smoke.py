#!/usr/bin/env python3
"""Drive the PyTorch port (regen3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on one line:

1. device and build: the card's name and power limit as nvidia-smi gives
   them, and the nvcc build of every kernel source (all started together);
2. every hand-written kernel against its plain PyTorch version on the same
   inputs at the shapes the main paths give it, with the tolerance stated,
   and three times (median of timed launches after warm-up): the kernel's,
   the plain version's and, where one PyTorch call computes the same
   function, that call's; beside them the least time the card could take
   (bytes over 3.35 TB/s or operations over the peak rate of their type);
3. scene_step at the full VGGT-1B width and depth (random weights from a
   seed), 2 frames and 8 objects, checked finite and, on a small config,
   against the same step on the CPU's plain versions;
4. fit_poses at phase 6's default configuration (1024², 32-px tiles, 128
   faces per tile, edge rasterizer, 2048 faces and 4096 points per object,
   300 iterations): 5 iterations against the plain edge path, then the full
   fit on the kernels;
5. phase-1 serving: a small SAM on the card (bf16, kernels) against the same
   weights on the CPU (f32, plain versions), then detect_and_segment with
   SAM-H at full size (1024², 32 blocks, width 1280, random weights from a
   seed) on a 960×1280 synthetic room with 8 boxes from a fixed detector and
   both decoder passes: one encode per call, every mask finite and
   non-empty.

Launch counts are zeroed just before each main-path phase and read just
after it; the launches that compare a kernel with its plain version are not
counted. The line before the last is the per-kernel JSON summary; the last
line is {"ok": true, "device": {...}}. Any failure exits non-zero without it.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# (B, H, Sq, Sk, D): VGGT-1B's backbone, frame and global blocks and camera
# trunk; SAM-H's mask decoder at 8 boxes (token self-attention, token →
# image, image → token)
FLASH_SHAPES = [(2, 16, 1370, 1370, 64), (2, 16, 1374, 1374, 64),
                (1, 16, 2748, 2748, 64), (1, 16, 2, 2, 128),
                (8, 8, 11, 11, 32), (8, 8, 11, 4096, 16),
                (8, 8, 4096, 11, 16)]
# SAM-H's global blocks: (B, H, S, D) with a 64 × 64 key grid
GB_SHAPE, GB_GRID = (1, 16, 4096, 80), (64, 64)
KERNELS = {
    "flash_fwd": dict(route="cuda", source="regen3d_tpu_torch/csrc/flash_fwd.cu",
                      replaces="regen3d_tpu/ops/attention.py:46"),
    "flash_gb_fwd": dict(route="cuda",
                         source="regen3d_tpu_torch/csrc/flash_gb_fwd.cu",
                         replaces="regen3d_tpu/ops/attention.py:355"),
    "silhouette_fwd": dict(route="cuda",
                           source="regen3d_tpu_torch/csrc/silhouette.cu",
                           replaces="regen3d_tpu/ops/pallas_rasterize.py:64"),
    "silhouette_bwd": dict(route="cuda",
                           source="regen3d_tpu_torch/csrc/silhouette.cu",
                           replaces="regen3d_tpu/ops/pallas_rasterize.py:85"),
}
# H100 SXM peaks (NVIDIA's data sheet, dense, at the 700-W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12}
# f32 operations per (pixel, valid face) pair in the silhouette kernels: about
# 20 for the three edge lines, the min, z and the sums, plus the
# transcendentals (exp and log1p forward, exp backward)
SIL_OPS_PER_PAIR = {"fwd": 22, "bwd": 21}


def bound(ops, nbytes, kind):
    """(ms, "bytes" or "operations"): the least time the card could take to
    move ``nbytes`` and do ``ops`` operations of type ``kind``."""
    t_ops = ops / PEAK_OPS_PER_S[kind]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def attention_work(b, h, sq, sk, d, bias_cols=0):
    """(operations, bytes) of attention forward: the two products
    (2·Sq·Sk·D multiply-adds each), q/k/v read and o written in bf16, the
    lse written and, for the grid-bias kernel, its f32 bias factors read."""
    ops = 4 * b * h * sq * sk * d
    nbytes = (2 * b * h * (2 * sq + 2 * sk) * d + 4 * b * h * sq
              + 4 * b * h * sq * bias_cols)
    return ops, nbytes


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps=10, warmup=2):
    """Median ms of ``fn()`` over ``reps`` runs timed by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def phase_device(kernels):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"device: {smi}")
    t0 = time.perf_counter()
    built = kernels.build()
    for name in kernels.SOURCES:
        kernels.lib(name)
    log(f"build: {time.perf_counter() - t0:.1f} s wall for "
        f"{sorted(built) or 'nothing (up to date)'}")
    for name, text in kernels.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    return smi


def phase_kernels(results):
    """Each kernel against its plain version at the main paths' shapes."""
    import torch
    import torch.nn.functional as F

    from regen3d_tpu_torch.ops import attention as att
    from regen3d_tpu_torch.ops import silhouette_kernel as sk

    gen = torch.Generator(device="cuda").manual_seed(0)
    # flash: bf16 inputs, plain version in f32 on the same bf16 values.
    # o tolerance: bf16 rounding of the output (2^-8 relative) plus 2e-3 for
    # f32 accumulation in another order; lse: f32 sums, 1e-4.
    worst_o = worst_lse = 0.0
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0)
    work = [0, 0]   # operations and bytes over all shapes
    for b, h, sq, skv, d in FLASH_SHAPES:
        q = torch.randn((b, h, sq, d), generator=gen, device="cuda")
        k, v = (torch.randn((b, h, skv, d), generator=gen, device="cuda")
                for _ in range(2))
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        with torch.no_grad():
            o, lse = att.flash_attention_fwd(q, k, v)
            o_ref, lse_ref = att.attention_reference(q.float(), k.float(),
                                                     v.float())
        torch.cuda.synchronize()
        err_o = (o.float() - o_ref).abs()
        tol = 2.0 ** -8 * o_ref.abs() + 2e-3
        shape = (b, h, sq, skv, d)
        if not bool((err_o <= tol).all()):
            raise AssertionError(f"flash {shape}: o error {err_o.max():.3e} "
                                 f"over bound")
        err_lse = float((lse - lse_ref).abs().max())
        if err_lse > 1e-4:
            raise AssertionError(f"flash {shape}: lse error {err_lse:.3e}")
        worst_o = max(worst_o, float(err_o.max()))
        worst_lse = max(worst_lse, err_lse)
        t_k = cuda_ms(lambda: att.flash_attention_fwd(q, k, v))
        t_p = cuda_ms(lambda: att.attention_reference(q.float(), k.float(),
                                                      v.float()), reps=5)
        t_l = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        ops, nbytes = attention_work(b, h, sq, skv, d)
        work[0] += ops
        work[1] += nbytes
        t_b, by = bound(ops, nbytes, "bf16")
        for key, t in zip(("ms", "plain_ms", "library_ms"), (t_k, t_p, t_l)):
            tot[key] += t
        log(f"flash_fwd {shape}: o err {err_o.max():.3e}, lse err "
            f"{err_lse:.3e}; kernel {t_k:.3f} ms, plain {t_p:.3f} ms, "
            f"sdpa {t_l:.3f} ms, bound {t_b:.4f} ms ({by})")
    t_b, by = bound(*work, "bf16")
    results["flash_fwd"] = dict(
        max_abs_err=worst_o, max_abs_err_lse=worst_lse,
        tolerance="o: 2^-8*|o| + 2e-3 (bf16 output); lse: 1e-4",
        bound_ms=t_b, bound_by=by,
        timed=f"sum over the {len(FLASH_SHAPES)} main-path shapes "
              f"(B, H, Sq, Sk, D) {FLASH_SHAPES}", **tot)

    # grid-bias flash at SAM-H's global blocks, non-zero bias factors of the
    # size SAM's rel-pos tables give; same tolerance and reasons as flash
    b, h, s, d = GB_SHAPE
    kh, kw = GB_GRID
    q, k, v = (torch.randn(GB_SHAPE, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    bias_h = 0.5 * torch.randn((b, h, s, kh), generator=gen, device="cuda")
    bias_w = 0.5 * torch.randn((b, h, s, kw), generator=gen, device="cuda")
    with torch.no_grad():
        o, lse = att.flash_attention_grid_bias_fwd(q, k, v, bias_h, bias_w, kw)
        o_ref, lse_ref = att.grid_bias_reference(q.float(), k.float(),
                                                 v.float(), bias_h, bias_w, kw)
    torch.cuda.synchronize()
    err_o = (o.float() - o_ref).abs()
    if not bool((err_o <= 2.0 ** -8 * o_ref.abs() + 2e-3).all()):
        raise AssertionError(f"flash_gb {GB_SHAPE}: o error "
                             f"{err_o.max():.3e} over bound")
    err_lse = float((lse - lse_ref).abs().max())
    if err_lse > 1e-4:
        raise AssertionError(f"flash_gb {GB_SHAPE}: lse error {err_lse:.3e}")
    # the library yardstick gets the (S, S) bias built beforehand, untimed
    mask = (bias_h[..., :, None] + bias_w[..., None, :]).reshape(b, h, s, s) \
        .to(torch.bfloat16)
    t_k = cuda_ms(lambda: att.flash_attention_grid_bias_fwd(
        q, k, v, bias_h, bias_w, kw))
    t_p = cuda_ms(lambda: att.grid_bias_reference(
        q.float(), k.float(), v.float(), bias_h, bias_w, kw), reps=5)
    t_l = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                         attn_mask=mask))
    del mask
    t_b, by = bound(*attention_work(b, h, s, s, d, kh + kw), "bf16")
    log(f"flash_gb_fwd {GB_SHAPE} grid {GB_GRID}: o err {err_o.max():.3e}, "
        f"lse err {err_lse:.3e}; kernel {t_k:.3f} ms, plain {t_p:.3f} ms, "
        f"sdpa with the bias built beforehand (untimed) {t_l:.3f} ms, bound "
        f"{t_b:.4f} ms ({by})")
    results["flash_gb_fwd"] = dict(
        max_abs_err=float(err_o.max()), max_abs_err_lse=err_lse,
        tolerance="o: 2^-8*|o| + 2e-3 (bf16 output); lse: 1e-4", ms=t_k,
        plain_ms=t_p, library_ms=t_l, bound_ms=t_b, bound_by=by)
    del q, k, v, o_ref

    # silhouette: the phase-6 batch at its initial pose
    batch, cam, cfg, _gt = phase6_problem()
    from regen3d_tpu_torch.pipeline.pose_fit import (
        compute_batch_bins,
        pose_transform,
    )
    init = phase6_init(_gt)
    bins = compute_batch_bins(init, batch, cam, cfg)
    with torch.no_grad():
        vs = cam.view_to_screen(cam.world_to_view(pose_transform(init, batch,
                                                                 cfg)))
        co, nvalid, va, uv = sk.edge_tile_inputs(
            vs, batch.faces, cfg.image_hw, cfg.sigma, batch.faces_mask,
            faces_per_tile=cfg.faces_per_tile, bins=bins)
    consts = sk.tile_consts(cfg.image_hw, cfg.sigma)
    n_busy = int((nvalid > 0).sum())
    acc_k = sk.silhouette_tiles_fwd(nvalid, co, va, uv, *consts)
    acc_p = sk.silhouette_tiles_fwd_plain(nvalid, co, va, uv, *consts)
    torch.cuda.synchronize()
    # alpha = 1 − exp(acc): f32 sums over ≤128 faces in another order and
    # the transcendentals' last bits → atol 1e-5
    err_a = float((torch.exp(acc_k) - torch.exp(acc_p)).abs().max())
    if err_a > 1e-5:
        raise AssertionError(f"silhouette_fwd alpha error {err_a:.3e}")
    g = torch.randn(acc_k.shape, generator=gen, device="cuda")
    dc_k = sk.silhouette_tiles_bwd(nvalid, co, va, uv, g, *consts)
    dc_p = sk.silhouette_tiles_bwd_plain(nvalid, co, va, uv, g, *consts)
    # Σ|terms| of every dc element: with |g| every term of a sum has one sign
    # (pixel offsets and tile origins are ≥ 0), so the plain sums are exact
    # magnitudes.
    dc_abs = sk.silhouette_tiles_bwd_plain(nvalid, co, va, uv, g.abs(),
                                           *consts).abs()
    torch.cuda.synchronize()
    # dc, elementwise: the same argmin routing (edge values are rounded
    # identically) and f32 sums over 1024 pixels in another order, whose
    # error is a few √1024·2^-24 of Σ|terms| → 2e-5·Σ|terms|. A misrouted
    # pixel or a dropped tile-origin fold moves its element by far more.
    diff = (dc_k - dc_p).abs()
    err_dc = float(diff.max())
    scale = float(dc_p.abs().max())
    ratio = float((diff / dc_abs.clamp_min(1e-30)).max())
    if not bool((diff <= 2e-5 * dc_abs).all()):
        raise AssertionError(f"silhouette_bwd dc error {ratio:.3e} of its "
                             f"element's sum of |terms| (tol 2e-5)")
    t = {}
    t["fk"] = cuda_ms(lambda: sk.silhouette_tiles_fwd(nvalid, co, va, uv, *consts))
    t["fp"] = cuda_ms(lambda: sk.silhouette_tiles_fwd_plain(nvalid, co, va, uv,
                                                           *consts), reps=5)
    t["bk"] = cuda_ms(lambda: sk.silhouette_tiles_bwd(nvalid, co, va, uv, g,
                                                      *consts))
    t["bp"] = cuda_ms(lambda: sk.silhouette_tiles_bwd_plain(nvalid, co, va, uv,
                                                           g, *consts), reps=5)
    # bound: the (pixel, valid face) pairs of this batch, and every input
    # read once and every output written once
    pairs = float(va.sum()) * acc_k.shape[-1]
    in_bytes = 4 * (nvalid.numel() + co.numel() + va.numel() + uv.numel())
    b_f = bound(SIL_OPS_PER_PAIR["fwd"] * pairs, in_bytes + 4 * acc_k.numel(),
                "f32")
    b_b = bound(SIL_OPS_PER_PAIR["bwd"] * pairs,
                in_bytes + 4 * (g.numel() + dc_k.numel()), "f32")
    log(f"silhouette ({batch.faces.shape[0]} objects, {cfg.image_hw[0]}², "
        f"K={va.shape[1]}, {n_busy}/{nvalid.numel()} tiles busy, "
        f"{pairs:.3e} pixel-face pairs): alpha err "
        f"{err_a:.3e}, dc err {err_dc:.3e} at max |dc| {scale:.3e}, worst "
        f"{ratio:.3e} of its element's sum of |terms|; fwd kernel "
        f"{t['fk']:.3f} ms vs plain {t['fp']:.3f} ms (bound {b_f[0]:.4f} ms, "
        f"{b_f[1]}), bwd kernel {t['bk']:.3f} ms vs plain {t['bp']:.3f} ms "
        f"(bound {b_b[0]:.4f} ms, {b_b[1]}); no single PyTorch call computes "
        f"either")
    results["silhouette_fwd"] = dict(max_abs_err=err_a, ms=t["fk"],
                                     plain_ms=t["fp"], bound_ms=b_f[0],
                                     bound_by=b_f[1], library_ms=None,
                                     tolerance="alpha atol 1e-5")
    results["silhouette_bwd"] = dict(max_abs_err=err_dc, max_rel_err=ratio,
                                     ms=t["bk"], plain_ms=t["bp"],
                                     bound_ms=b_b[0], bound_by=b_b[1],
                                     library_ms=None,
                                     tolerance="elementwise 2e-5 * sum|terms|")


def _torus(n_major=32, n_minor=32, R=0.25, r=0.08):
    """Closed torus mesh with 2·n_major·n_minor faces (2048 by default)."""
    import math

    import torch

    i = torch.arange(n_major).repeat_interleave(n_minor)
    j = torch.arange(n_minor).repeat(n_major)
    u = i * (2 * math.pi / n_major)
    v = j * (2 * math.pi / n_minor)
    verts = torch.stack([(R + r * torch.cos(v)) * torch.cos(u), r * torch.sin(v),
                         (R + r * torch.cos(v)) * torch.sin(u)], -1)
    a = i * n_minor + j
    b = ((i + 1) % n_major) * n_minor + j
    c = ((i + 1) % n_major) * n_minor + (j + 1) % n_minor
    d = i * n_minor + (j + 1) % n_minor
    faces = torch.cat([torch.stack([a, b, c], -1), torch.stack([a, c, d], -1)])
    return verts.float(), faces.int()


@functools.lru_cache(maxsize=None)
def phase6_problem(dev="cuda", size=1024, n_obj=8, n_points=4096):
    """Phase 6's default fit problem: tori at ground-truth poses, their
    masks (rendered by the plain edge path) and surface samples as targets."""
    import torch

    from regen3d_tpu_torch.camera import Camera
    from regen3d_tpu_torch.ops.rasterize import soft_silhouette_edge
    from regen3d_tpu_torch.pipeline.pose_fit import (
        FitConfig,
        ObjectBatch,
        PoseParams,
        compute_batch_bins,
        pose_transform,
    )

    gen = torch.Generator(device="cpu").manual_seed(6)
    cfg = FitConfig(image_hw=(size, size), sigma=5e-7, bin_tile=32,
                    faces_per_tile=128, use_edge_raster=True,
                    bin_margin_px=64.0, max_iterations=300,
                    early_stop_min_iters=200, record_history=True)
    cam = Camera(R=torch.eye(3, device=dev), T=torch.zeros(3, device=dev),
                 focal=torch.tensor([1.17 * size, 1.17 * size], device=dev),
                 principal=torch.tensor([size / 2, size / 2], device=dev),
                 image_size=(size, size))
    verts, faces = _torus()
    k = n_obj
    gx = torch.tensor([-0.9, -0.3, 0.3, 0.9] * 2)[:k]
    gy = torch.tensor([0.45] * 4 + [-0.45] * 4)[:k]
    gt = PoseParams(
        translation=torch.stack([gx, gy, torch.full((k,), 3.0)], -1).to(dev),
        yaw=(torch.rand(k, generator=gen) * 0.2).to(dev),
        rot_aa=torch.zeros(k, 3, device=dev),
        log_scale=torch.zeros(k, device=dev))
    nv, nf = verts.shape[0], faces.shape[0]
    batch = ObjectBatch(
        verts=verts[None].expand(k, nv, 3).contiguous().to(dev),
        verts_mask=torch.ones(k, nv, dtype=torch.bool, device=dev),
        faces=faces[None].expand(k, nf, 3).contiguous().to(dev),
        faces_mask=torch.ones(k, nf, dtype=torch.bool, device=dev),
        target_mask=torch.zeros(k, size, size, device=dev),
        target_points=torch.zeros(k, n_points, 3, device=dev),
        points_mask=torch.ones(k, n_points, dtype=torch.bool, device=dev),
        pivot_R=torch.eye(3, device=dev).expand(k, 3, 3).contiguous(),
        pivot_t=torch.zeros(k, 3, device=dev),
        on_floor=torch.zeros(k, dtype=torch.bool, device=dev),
        object_valid=torch.ones(k, dtype=torch.bool, device=dev),
        bbox_lo=torch.tensor([-10.0, -10.0, 0.1], device=dev),
        bbox_hi=torch.tensor([10.0, 10.0, 20.0], device=dev))
    with torch.no_grad():
        v_gt = pose_transform(gt, batch, cfg)
        bins = compute_batch_bins(gt, batch, cam, cfg)
        # targets from the plain edge path, not from the kernels under test
        mask = soft_silhouette_edge(
            cam.view_to_screen(cam.world_to_view(v_gt)), batch.faces,
            cfg.image_hw, cfg.sigma, tile=cfg.bin_tile,
            faces_per_tile=cfg.faces_per_tile, bins=bins) > 0.5
        # surface samples: random barycentric points on random faces
        fi = torch.randint(0, nf, (k, n_points), generator=gen).to(dev)
        w = torch.rand(k, n_points, 3, generator=gen).to(dev)
        w = w / w.sum(-1, keepdim=True)
        tri = v_gt[torch.arange(k, device=dev)[:, None, None],
                   batch.faces[torch.arange(k, device=dev)[:, None], fi].long()]
        pts = (tri * w[..., None]).sum(-2)
    batch = batch._replace(target_mask=mask.float(), target_points=pts)
    return batch, cam, cfg, gt


def phase6_init(gt):
    import torch

    off = torch.tensor([0.04, -0.03, 0.08], device=gt.yaw.device)
    return gt._replace(translation=gt.translation + off, yaw=gt.yaw + 0.02,
                       log_scale=gt.log_scale + 0.05)


def phase_fit(results, iters_check=5):
    import dataclasses

    import torch

    from regen3d_tpu_torch import kernels
    from regen3d_tpu_torch.pipeline.pose_fit import (
        batch_loss,
        fit_poses,
        raster_path,
    )

    batch, cam, cfg, gt = phase6_problem()
    init = phase6_init(gt)
    n_faces = batch.faces.shape[1]
    path = raster_path(cfg, n_faces, "cuda")
    log(f"fit path: {path} (binned gate passed: "
        f"{n_faces * 4 <= (1024 // 32) ** 2 * cfg.faces_per_tile})")
    if path != "edge_kernel":
        raise AssertionError(f"phase-6 fit took the {path} path")
    # 5 iterations on the kernels against 5 on the plain edge path. The
    # tolerance is one Adam step (lr = 5e-3) on params and 1e-2 relative on
    # losses: saturated alphas next to the clip bound turn f32 rounding into
    # gradient noise that two summation orders do not share, and Adam's
    # first step moves each component by lr·sign(g).
    short = dataclasses.replace(cfg, max_iterations=iters_check,
                                early_stop_min_iters=iters_check)
    plain = dataclasses.replace(short, use_pallas_raster=False)
    if raster_path(plain, n_faces, "cuda") != "edge":
        raise AssertionError("plain fit did not take the plain edge path")
    r_k = fit_poses(init, batch, cam, short)
    r_p = fit_poses(init, batch, cam, plain)
    torch.cuda.synchronize()
    p_err = max(float((a - b).abs().max()) for a, b in zip(r_k.params, r_p.params))
    l_err = float(((r_k.losses - r_p.losses).abs() / r_p.losses.abs()).max())
    log(f"fit {iters_check} iters kernels vs plain: params max err "
        f"{p_err:.3e} (tol 5e-3), losses max rel err {l_err:.3e} (tol 1e-2)")
    if not (p_err <= 5e-3 and l_err <= 1e-2):
        raise AssertionError("kernel fit disagrees with the plain fit")

    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fit_poses(init, batch, cam, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    with torch.no_grad():
        l0 = batch_loss(init, batch, cam, cfg)[1]
    d0 = float((init.translation - gt.translation).norm(dim=-1).mean())
    d1 = float((res.params.translation - gt.translation).norm(dim=-1).mean())
    log(f"fit_poses phase-6 default (8 objects, 2048 faces, 4096 points, "
        f"1024²): {res.num_iters} iters in {dt:.2f} s "
        f"({1000 * dt / max(res.num_iters, 1):.1f} ms/iter); loss "
        f"{float(l0.mean()):.4f} -> {float(res.losses.mean()):.4f}; mean "
        f"translation error {d0:.4f} -> {d1:.4f} m; launches {counts}")
    if counts["silhouette_fwd"] == 0 or counts["silhouette_bwd"] == 0:
        raise AssertionError("the fit did not launch the silhouette kernels")
    if not (torch.isfinite(res.losses).all() and res.losses.mean() < l0.mean()
            and d1 < d0):
        raise AssertionError("the phase-6 fit did not improve the poses")
    results["fit_launches"] = counts
    results["fit_sec"] = dt
    results["fit_iters"] = int(res.num_iters)


def _scene_inputs(cfg, dev, k=8, seed=0):
    """bench.py's scene_step workload: 2 frames, 8 box masks, 512-vertex
    1024-face meshes."""
    import numpy as np
    import torch

    s = cfg.image_size
    rng = np.random.default_rng(seed)
    imgs = torch.from_numpy(rng.random((2, s, s, 3)).astype(np.float32)).to(dev)
    masks = np.zeros((k, s, s), bool)
    if s >= 518:
        for i in range(k):
            y, x = 40 + 90 * (i % 4), 40 + 90 * (i // 4)
            masks[i, y:y + 120, x:x + 120] = True
    else:
        for i in range(k):
            masks[i, (i * 3) % s:(i * 3) % s + s // 3,
                  (i * 7) % s:(i * 7) % s + s // 3] = True
    verts = torch.from_numpy(rng.uniform(-0.2, 0.2, (k, 512, 3))
                             .astype(np.float32)).to(dev)
    faces = torch.from_numpy(rng.integers(0, 512, (k, 1024, 3))
                             .astype(np.int32)).to(dev)
    return (imgs, torch.from_numpy(masks).to(dev), verts,
            torch.ones(verts.shape[:2], dtype=torch.bool, device=dev), faces,
            torch.ones(faces.shape[:2], dtype=torch.bool, device=dev))


def _scene_fit_cfg(s, iters=50):
    from regen3d_tpu_torch.pipeline.pose_fit import FitConfig

    return FitConfig(image_hw=(s, s), sigma=1e-5, max_iterations=iters,
                     early_stop_min_iters=iters, record_history=False,
                     face_chunk=128, point_chunk=1024, object_chunk=2)


def phase_scene(results, runs=1):
    import dataclasses

    import torch

    from regen3d_tpu_torch import kernels
    from regen3d_tpu_torch.models.vggt import VGGT, VGGTConfig, init_flax_style_
    from regen3d_tpu_torch.pipeline.scene_step import scene_step

    # agreement on a small config: kernels on the card (bf16) against the
    # plain versions on the CPU (f32), same weights and inputs. Heads of 64
    # (trunk) and 128 (camera head) reach both kernel head dims.
    small = VGGTConfig(image_size=70, width=256, depth=2, num_heads=4,
                       backbone_depth=2, num_register_tokens=1,
                       camera_iterations=2, camera_trunk_depth=1,
                       dpt_features=32, dpt_out_channels=(32, 32, 64, 64))
    cpu_model = VGGT(dataclasses.replace(small, dtype=torch.float32),
                     device="cpu")
    init_flax_style_(cpu_model, torch.Generator().manual_seed(1))
    gpu_model = VGGT(small)
    gpu_model.load_state_dict(cpu_model.state_dict())
    args = _scene_inputs(small, "cuda", k=2, seed=1)
    fit_small = _scene_fit_cfg(small.image_size, iters=3)
    with torch.no_grad():
        out_g = gpu_model(args[0][None])
        out_c = cpu_model(args[0][None].cpu())
    errs = {}
    for key in ("depth", "depth_conf", "pose_enc"):
        ref = out_c[key]
        errs[key] = float((out_g[key].float().cpu() - ref).abs().max()
                          / ref.abs().max())
    res_g = scene_step(gpu_model, *args, fit_small, num_points=256)
    res_c = scene_step(cpu_model, *(a.cpu() for a in args), fit_small,
                       num_points=256)
    depth_err = float((res_g.depth.cpu() - res_c.depth).abs().max()
                      / res_c.depth.abs().max())
    log(f"small VGGT, card bf16 kernels vs CPU f32 plain: max error / max "
        f"|ref| {errs}, scene_step depth {depth_err:.3e} (tol 5e-2: bf16 "
        f"weights and activations through 4 attention layers)")
    if not (max(errs.values()) < 5e-2 and depth_err < 5e-2):
        raise AssertionError("small VGGT on the card disagrees with the CPU")
    del cpu_model, gpu_model

    cfg = VGGTConfig()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model = VGGT(cfg)
    init_flax_style_(model, gen)
    model.eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"VGGT-1B config: {n_params / 1e9:.3f} B params, built and "
        f"initialised in {time.perf_counter() - t0:.1f} s")
    args = _scene_inputs(cfg, "cuda")
    fit_cfg = _scene_fit_cfg(cfg.image_size)
    # every run is the main path: counts go to 0 before the first and are
    # read after the last
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    ts = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = scene_step(model, *args, fit_cfg, num_points=1024)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    counts = dict(kernels.LAUNCHES)
    k = args[1].shape[0]
    checks = {
        "verts_world": (res.verts_world, (k, 512, 3)),
        "losses": (res.losses, (k,)),
        "depth": (res.depth, (cfg.image_size, cfg.image_size)),
        "points": (res.points, (k, 1024, 3)),
    }
    for name, (t, shape) in checks.items():
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"scene_step {name}: shape {tuple(t.shape)} "
                                 f"or non-finite values")
    if counts["flash_fwd"] == 0:
        raise AssertionError("scene_step did not launch the flash kernel")
    first = ts[0]
    ts.sort()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(args[0][None])
        torch.cuda.synchronize()
        t_vggt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"scene_step VGGT-1B 518² x2 frames + 8 objects x 50 fit iters @ "
        f"518² (object_chunk=2): first {first:.2f} s, median of {runs} "
        f"{ts[len(ts) // 2]:.2f} s {[round(t, 3) for t in ts]}; VGGT forward "
        f"alone {t_vggt:.3f} s; peak {peak:.1f} GiB; valid points "
        f"{int(res.points_valid.sum())}; launches {counts}")
    results["scene_launches"] = counts
    results["scene_sec"] = ts[len(ts) // 2]


def _room_image(h=960, w=1280, seed=0):
    """A synthetic room: wall, floor band and 8 coloured boxes, uint8; and
    the 8 boxes in pixels (x0, y0, x1, y1)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    img = np.empty((h, w, 3), np.uint8)
    img[:] = (205, 200, 190)
    img[int(0.62 * h):] = (120, 95, 70)
    boxes = []
    for i in range(8):
        x0 = 40 + 155 * i
        y0 = int(0.35 * h) + 40 * (i % 3)
        x1, y1 = x0 + 110, y0 + 160 + 30 * (i % 2)
        img[y0:y1, x0:x1] = rng.integers(20, 235, 3)
        boxes.append((x0, y0, x1, y1))
    noise = rng.integers(-6, 7, img.shape)
    return np.clip(img.astype(np.int16) + noise, 0, 255).astype(np.uint8), boxes


class FixedDetector:
    """Returns the same detections for any image: the detector model is not
    ported yet, so phase 1 gets its boxes from here."""

    def __init__(self, boxes):
        self.boxes = boxes

    def detect(self, image, labels, threshold):
        from regen3d_tpu_torch.pipeline.detection import (
            BoundingBox,
            DetectionResult,
        )

        return [DetectionResult(score=0.9 - 0.01 * i, label=labels[i % len(labels)],
                                box=BoundingBox(*map(float, b)))
                for i, b in enumerate(self.boxes)]


def phase_sam(results, runs=3):
    import dataclasses

    import numpy as np
    import torch

    from regen3d_tpu_torch import kernels
    from regen3d_tpu_torch.models.sam import SAM, SamConfig, init_flax_style_
    from regen3d_tpu_torch.pipeline.phase1_segmentation import (
        detect_and_segment,
    )

    # agreement on a small config: kernels on the card (bf16) against the
    # plain versions on the CPU (f32), same weights (rel-pos tables drawn
    # non-zero) and inputs. Grid 32 = 1024 tokens takes the grid-bias kernel
    # in the global block at the default gate, with heads of 80 as in SAM-H;
    # the windowed block takes the einsum path; prompt_dim 256 gives the
    # decoder its head dims 32 and 16.
    small = SamConfig(image_size=512, width=160, depth=2, num_heads=2,
                      window=14, global_blocks=(1,), prompt_dim=256)
    cpu_model = SAM(dataclasses.replace(small, dtype=torch.float32),
                    device="cpu")
    init_flax_style_(cpu_model, torch.Generator().manual_seed(2))
    gpu_model = SAM(small)
    gpu_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.default_rng(3)
    s = small.image_size
    img = torch.from_numpy(rng.random((1, s, s, 3)).astype(np.float32))
    n = 4
    pts = torch.from_numpy(rng.random((n, 4, 2)).astype(np.float32))
    labs = torch.tensor([[1, -1, -1, -1], [1, 0, -1, -1], [-1] * 4,
                         [1, 1, 1, 0]], dtype=torch.float32)
    lo = rng.random((n, 2)) * 0.5
    boxes = torch.from_numpy(np.stack([lo, lo + 0.2 + 0.3 * rng.random((n, 2))],
                                      1).astype(np.float32))
    kernels.reset_counts()
    with torch.no_grad():
        emb_c = cpu_model.encode(img)
        m_c, iou_c = cpu_model.decode(emb_c.expand(n, -1, -1, -1), pts, labs,
                                      boxes)
        emb_g = gpu_model.encode(img.cuda())
        m_g, iou_g = gpu_model.decode(emb_g.expand(n, -1, -1, -1), pts.cuda(),
                                      labs.cuda(), boxes.cuda())
    torch.cuda.synchronize()
    small_counts = dict(kernels.LAUNCHES)
    errs = {}
    for key, got, ref in (("embedding", emb_g, emb_c), ("masks", m_g, m_c),
                          ("iou", iou_g, iou_c)):
        errs[key] = float((got.float().cpu() - ref).abs().max()
                          / ref.abs().max())
    log(f"small SAM, card bf16 kernels vs CPU f32 plain: max error / max "
        f"|ref| {errs} (tol 5e-2: bf16 weights and activations); launches "
        f"{small_counts}")
    if not max(errs.values()) < 5e-2:
        raise AssertionError("small SAM on the card disagrees with the CPU")
    if small_counts["flash_gb_fwd"] != 1 or small_counts["flash_fwd"] == 0:
        raise AssertionError("small SAM did not take both attention kernels")
    del cpu_model, gpu_model

    cfg = SamConfig()
    t0 = time.perf_counter()
    model = SAM(cfg)
    init_flax_style_(model, torch.Generator(device="cuda").manual_seed(0))
    model.eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"SAM-H config: {n_params / 1e6:.1f} M params, built and initialised "
        f"in {time.perf_counter() - t0:.1f} s")

    # the encoder and decoder wrapped to count encodes and time both on the
    # card's clock; each decode's logits are kept for the finiteness check
    seen = {"encode_s": [], "decode_s": [], "decodes": []}
    encode, decode = model.encode, model.decode

    def timed(fn, key):
        def call(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            seen[key].append(time.perf_counter() - t)
            return out
        return call

    def kept_decode(*args):
        out = timed(decode, "decode_s")(*args)
        seen["decodes"].append(out)
        return out

    model.encode, model.decode = timed(encode, "encode_s"), kept_decode
    image, boxes_px = _room_image()
    detector = FixedDetector(boxes_px)
    pcfg = {"labels": ["chair", "table", "sofa", "lamp"], "threshold": 0.25,
            "iou_threshold": 0.5, "use_points": True,
            "point_method": "max_distance", "points_per_object": 1,
            "scale_bounding_boxes": 1.01, "seed": 1234567}
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    ts = []
    for _ in range(runs):
        seen["decodes"].clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dets = detect_and_segment(pcfg, image, sam=model, detector=detector)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
        if len(dets) != len(boxes_px):
            raise AssertionError(f"phase 1 kept {len(dets)} of "
                                 f"{len(boxes_px)} detections (empty masks)")
        for d in dets:
            if d.mask.shape != image.shape[:2] or not d.mask.any():
                raise AssertionError("phase 1 returned an empty mask")
        if len(seen["decodes"]) != 2 or not all(
                bool(torch.isfinite(t).all()) for out in seen["decodes"]
                for t in out):
            raise AssertionError("phase 1 decodes: not two passes, or "
                                 "non-finite logits")
    counts = dict(kernels.LAUNCHES)
    model.encode, model.decode = encode, decode
    n_enc = len(seen["encode_s"])
    if n_enc != runs:
        raise AssertionError(f"{n_enc} encodes in {runs} calls")
    if counts["flash_gb_fwd"] != len(cfg.global_blocks) * n_enc or \
            counts["flash_fwd"] == 0:
        raise AssertionError(f"phase 1 launches {counts}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    med = lambda xs: sorted(xs)[len(xs) // 2]
    areas = [int(d.mask.sum()) for d in dets]
    log(f"phase 1 SAM-H 1024² (32 blocks, width 1280) on a 960x1280 image, "
        f"8 boxes, 2 decoder passes: detect_and_segment median of {runs} "
        f"{med(ts):.3f} s {[round(t, 4) for t in ts]}; encode median "
        f"{1e3 * med(seen['encode_s']):.2f} ms "
        f"{[round(1e3 * t, 2) for t in seen['encode_s']]}; decode per pass "
        f"median {1e3 * med(seen['decode_s']):.2f} ms "
        f"{[round(1e3 * t, 2) for t in seen['decode_s']]}; peak {peak:.2f} "
        f"GiB; mask areas {areas}; launches {counts}")
    results["sam_launches"] = counts
    results["phase1_sec"] = med(ts)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from regen3d_tpu_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: the port is not here ({e})", file=sys.stderr)
        return 3

    phase_device(kernels)
    results = {}
    phase_kernels(results)
    phase_scene(results)
    phase_fit(results)
    phase_sam(results)

    summary = []
    for name, meta in KERNELS.items():
        r = results[name]
        launches = sum(results[path].get(name, 0) for path in
                       ("scene_launches", "fit_launches", "sam_launches"))
        if launches == 0:
            raise AssertionError(f"{name} was never launched by the main path")
        summary.append(dict(name=name, **meta, launches=launches,
                            max_abs_err=r["max_abs_err"],
                            tolerance=r["tolerance"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"],
                            library_ms=r["library_ms"]))
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
