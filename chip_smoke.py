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
   (bytes over 3.35 TB/s or operations over the peak rate of their type).
   The tensor-core forward kernel at every main-path flash shape and the
   grid-bias forward at SAM-H's 64 × 64 key grid (timed) and at the small
   SAM's 32 × 32 and a 48 × 48 one (checked): within a bound from its bf16
   rounding of p, no worse than twice SDPA's error, bit for bit the same
   on a second launch, no register spills in any instance (ptxas); the
   forward's D = 512 kernel at the SD VAE's shapes (timed beside SDPA,
   with the SDPA backends that take D = 512) and D = 4 at the tiny SD
   UNet's, bit for bit the D = 8 instance on zero-padded inputs; then
   the four backward kernels (flash dq and dkv at DiT-base's self and
   cross shapes and a ragged-query shape, timed, and at the other head dims,
   checked; the grid-bias pair at SAM-H's global blocks, timed, and at the
   small SAM's 32 × 32 key grid and a 48 × 48 one, checked) with a
   non-zero upstream gradient, beside SDPA's backward and its errors, two
   launches of each kernel compared bit for bit; the silhouette pair at
   the phase-6 batch (timed, and split into its rows without faces, its
   busy rows and its busiest row), at the same tile inputs with σ = 1e-4's
   constants (timed; almost nothing culled) and at random slivers at K =
   40 and 1000 (checked), each within alpha atol 1e-5 and 2e-5·Σ|terms|
   of dc, two launches bit-identical, with its binned, live (z > Z_CUT)
   and kept (the cull's) pixel-face pairs; no live pair in a culled block;
   ptxas reports no spills and no stack frame for either kernel;
3. scene_step at the full VGGT-1B width and depth (random weights from a
   seed), 2 frames and 8 objects, 5 fit iterations (scene_step_5it),
   checked finite and,
   on a small config, against the same step on the CPU's plain versions;
4. phase 4 (pipeline/phase4_camera.py): a small VGGT through
   run_vggt_inference on the card against the CPU, plain and with FastVGGT
   merging (the CPU replaying the card's merge choices); the oracle phase
   4 (export_reconstruction of a synthetic frame, then phase 5 on each
   device); a small shifted-views bundle adjustment on the card against
   the CPU; then phase_scene's VGGT-1B through phase4_camera.run on a
   960×1280 input and empty room (padded to 1280², resized to 518²),
   plain, with use_ba and with token_merge_ratio 0.5, each timed by stage
   and gated on the artifact contract (every file finite, frame 0's
   camera R_fix, the COLMAP text read back, the points kept) and the flash
   kernel's launches; the flash kernel at the merged global length against
   its plain version;
5. fit_poses at phase 6's default configuration (1024², 32-px tiles, 128
   faces per tile, edge rasterizer, 2048 faces and 4096 points per object):
   5 iterations against the plain edge path, then 50 of its 300
   iterations on the kernels (the bus phase below runs all 300), then one
   iteration's wall time, device time and launches from fits of 5 and 10
   iterations under torch.profiler, with the ten device operations with the
   most time; then a small fit on the binned SoftRas silhouette and the
   top-k point-mesh loss on the card against the CPU and twice bit for bit,
   with two planted faults that must break its limits;
6. phases 5, 6, 7, 8 and 9 through the port's orchestrator
   (run_phases(cfg, [5, 6, 7, 8, 9]) with the defaults but write_fit_gifs
   off) on a synthetic room's output bus built with the port's writers:
   960×1280 findings of 8 objects (~20k faces each, 5 on the floor) and
   the floor, one 518² VGGT frame, the empty room's cloud and image, the
   input image, a synthetic HDRI and a GT scene; the fit at
   1024 × 1344 on the silhouette kernels, which are first held to their
   plain versions at that batch (with a 5-iteration fit on the kernels
   against the plain edge path, the same fit twice bit for bit, a probe
   of the former atomic accumulations and one iteration's time with them
   and with the fixed order, and a fit-GIF frame on the card against the
   CPU); every artifact written, every loss finite and below its initial
   value, each object's pose error against the truth printed beside a fit
   without the silhouette term; phase 7 (60,000 samples, a 128³ Poisson
   background baked from the empty room, ICP) and phase 9 (the 15 metrics)
   gated on their artifacts and finite metrics, with their stage times,
   ICP's ms per iteration (and its device time) and the bake's time and
   memory; phase 8 (the software renderer at render_resolution 576, the
   default 768 cut for the time limit, the HDRI world) gated on its renders, the scene dump and cam1's coverage,
   with its stage times and each view's z-buffer path (kmax, K), time and
   coverage, and the binned z-buffer at cam1's K = kmax against the dense
   one bit for bit; phase 9 reads phase 8's render; then phases 5 and 6,
   and 7, 8 and 9, on a small bus on the card against the CPU, two card
   runs of its phase 6 writing the same GLBs bit for bit, its phase 8 with
   the point-cloud and GT renders: hits identical, linear images within
   1e-4, PNGs within one level; then LPIPS (seeded init) timed at
   960×1280, after a small pair on the card against the CPU;
7. phase 2 (the offline inpainter and prepare_for_3d on the bus's
   findings, timed; 8 prepped RGBA images and the empty room), then
   phase 3 (phase_assets) on the committed checkpoint: the generator on
   the card against the CPU on the first 2 objects (condition tokens,
   4 Euler steps, a 32³ dense and a 64³ two-level decode; max and mean
   errors); then phase3_assets.run at the defaults (50
   steps, guidance 5, the two-level 256³ decode) on phase 2's prepped
   image of 1 of the bus's 8 objects, timed by stage and gated on a
   GLB per object with colours in [0, 1] (a mesh, or the placeholder only
   where the committed generator gives that image and noise no surface
   on the card and in f32 and bf16 on the CPU), at least one mesh, and
   the flash launches the attentions count; a second generate_sdf_batch from the same seed bit for bit; the
   flash kernel at phase 3's three shapes (the DiT's guided batch, the
   encoder's and trunk's self-attention, a decoder query chunk), timed
   beside SDPA and kept out of the forward sum; then phase 3's texture
   paths (phase_texture) on that object's mesh, decimated to 25,000
   faces (the reference's 50,000 cut for the time limit): texgen.texture_mesh at TexGenConfig() (SDUNetConfig.multiview(6),
   SDVAEConfig(), 512², 15 steps) and texture_mesh_pbr (multiview(12),
   ESRGANConfig.x4plus() on the albedo atlas), random weights from a seed,
   timed by stage (geometry renders, VAE encode, DDIM, decode, bakes,
   ESRGAN) and gated on finite latents, the atlases and 483 flash
   launches each, after one UNet step, one VAE decode and one ESRGAN tile
   on the card against the CPU's f32; phase3_assets.run on the object with
   use_multiview_texgen, with use_hunyuan21 too and with
   bake_texture_atlas (10 steps, 128³, remeshed), gated on the GLBs' UVs
   and textures and 32 D = 4 launches, and the atlas bake on the card
   against the CPU; every flash shape of those five runs then held
   against the plain version (the full-width ones timed beside SDPA);
8. phase 1: a small SAM on the card (bf16, kernels) against the same
   weights on the CPU (f32, plain versions), then detect_and_segment with
   SAM-H at full size (1024², 32 blocks, width 1280, random weights from a
   seed) on a 960×1280 synthetic room with 8 boxes from a fixed detector and
   both decoder passes: one encode per call, every mask finite and
   non-empty; then (phase_segment) the flash forward at the detector's,
   the saliency net's (head dim 96 in its stem and dec8, the decode's
   single key) shapes against its plain version under fwd_error's bound,
   bit for bit twice, timed beside SDPA, the D = 96 instance's ptxas
   report without spills; a small detector,
   saliency net and Depth-Anything on the card against the CPU;
   run_phases(cfg, [1, 2]) on the bus's 960×1280 input without models
   (the k-means proposer, its labels on the card against the CPU's, the
   findings and the depth prior, phase 2 on every finding); and
   phase1_segmentation.run at full width (SAM-H, DetectorConfig(), the
   SaliencyConfig() net's points, Depth-Anything-V2-Small for depth.png;
   random weights from seeds; the threshold lowered, and printed, only if
   no box passes 0.25), timed by stage (detect, encode, decode ×2,
   points with the saliency calls, export, depth) and gated on every
   finding's five PNGs, depth.png, one encode and the launches (4
   grid-bias, 16 + 14 + 10 a saliency call + 12 flash), every flash shape
   of the run held against the plain version (those not timed above,
   after it); then the checkpoint layer (phase_checkpoints): which of
   tensorstore, safetensors and PIL the machine has, an orbax-shaped
   directory and a JPEG refused naming the absent one; DetectorConfig(),
   SaliencyConfig(), Depth-Anything-V2-Small, MattingUNet(base=32) and
   LPIPS (random weights from seeds) written as the port's checkpoint
   directories and run through detector_checkpoint, saliency_checkpoint,
   depth_anything_checkpoint and matting_checkpoint (run_phases(cfg,
   [1, 2])) and lpips_checkpoint (phase 9), the findings, depth.png,
   prepped RGBA and metrics byte for byte those of the same models passed
   in (prepare_for_3d's with the net for phase 2), the saliency key's
   points through SAM-H; the matting net's alpha on the 960×1280 input on
   the card against the CPU's f32 and its flash shape (1, 4, 4096, 4096,
   32) timed; then VGGT-1B (through a bf16 .pt and load_torch_file, and
   phase 4 with each model byte for byte), SAM-H, DUSt3R at 512's widths,
   DiTConfig.base() and its MIDI variant, Depth-Anything-V2-Small and
   LPIPS through the upstream key layouts (the port's inverse map, then
   conversion.load_upstream into a fresh module): every tensor equal, one
   forward bit for bit, parameter counts, unmapped keys and load seconds;
9. the alternates and baselines (phase_alternates): the flash forward's
   D = 8 instances in ptxas's report; a small DUSt3R (heads of 16) on the
   card against the CPU, and the aligner on exact synthetic pairs on the
   card (poses recovered within 0.05); DUSt3R at
   DUSt3R_ViTLarge_BaseDecoder_512_linear's widths (Dust3rConfig(), 512²,
   random weights, the heads given a pinhole pattern) through
   phase4_dust3r.run on the bus's input and empty room (the pair viewer)
   and run_from_model on three frames (the 300-iteration aligner), timed
   by stage and gated on the artifacts and 72 flash launches a forward,
   the pairwise forward timed and split by device operation, its flash
   shapes held against the plain version; -p 10 and -p 11 through
   run_phases on the bus's input without a generator (the tiny one, 48³),
   timed by stage and gated on the scene GLBs, the stage directories and
   DPA's fit on the silhouette kernels (61 forward, 60 backward launches);
   every D = 8 shape of those runs bit for bit the D = 16 instance on
   zero-padded inputs and under fwd_error's bound, timed beside SDPA; then
   both baselines with a DiTConfig.base() generator passed in (MIDI with
   cross_instance, in box mode on 4 of the bus's objects; 64³);
10. DiT training: a small DiT's flow-matching step on the card (bf16
   compute, f32 parameters, kernels) against the CPU (f32, plain versions),
   loss and three gradients, with the AdaLN-Zero leaves drawn non-zero;
   then DiTConfig.base() (random weights from a seed) trained for 30 steps
   of train_step at B = 8 (512 × 64 latents, 257 condition tokens): every
   loss and gradient finite, every attention's gradient non-zero, 32
   launches per step of each flash kernel, and the loss on a fixed batch
   falls; the host's and the device's time for each call of a step (loss,
   backward, AdamW); then sample() at base (4 steps, guidance 5, B = 6);
11. SAM's encoder gradient: a small SAM's VJP on the card against the CPU,
   then SAM-H's at full size (every gradient finite, the global blocks'
   rel-pos gradients non-zero, each grid-bias backward kernel launched 4
   times), and one more SAM-H VJP under torch.profiler, split into its ten
   device operations with the most time;
12. the distillation trainers (phase_distill, run after phase 1's last
   switches, before the alternates): one step of each micro trainer on the
   card (bf16 compute, f32 weights) against the CPU's f32; the detector,
   matting, saliency and depth runners through the CLI's functions at
   their scripts' defaults and the shape runner at DistillConfig.small()'s
   widths cut to 256 shapes and 100 + 100 steps, at once, each in a
   process of its own (its launch counts read there), each gated on a
   falling loss and finite
   values, with s a step, flash launches a step by head dim, and the
   held-out metric against its fallback (reported); then phase 1 from the
   detector and saliency checkpoints they wrote (heads of 24 and 12)
   through run_phases(cfg, [1]) and with SAM-H's saliency points, every
   flash shape of those runs held against the plain version. The kernels'
   D = 12 and 24 instances are held in step 2: bit for bit the width-16
   and 32 instances on zero-padded inputs (forward, dq, dk, dv), then the
   plain version's bounds; so are the backward's D = 4 and 8 (the matting
   net's heads at --base 4 and 8), and the matting trainer takes one step
   at --base 8 on the card against the CPU and through its runner;
13. the parallel layer (phase_parallel) at world size 1: a NCCL process
   group of one rank (a file store under build/parallel/), a (1, 1)
   make_mesh, and the four programs at full width, each bit for bit its
   unsharded run: the DiTConfig.base() train step (phase_dit's weights,
   batch and fixed draws) through shard_params and train_step_sharded,
   fit_poses_sharded on the bus's phase-6 batch (phase_bus's 5-iteration
   fit), VGGT-1B through shard_params, and scene_step over the mesh
   (against phase_scene's run); run_fleet over three scenes with phases
   [1, 2] (its thread pool), one scene's input missing: the two good
   scenes write their findings and phase 2's images, the bad one fails
   alone with its FileNotFoundError and no CUDA error.

Launch counts are zeroed just before each main-path phase and read just
after it; the launches that compare a kernel with its plain version are not
counted. The line before the last is the per-kernel JSON summary; the last
line is {"ok": true, "device": {...}}. Any failure exits non-zero without it.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# (B, H, Sq, Sk, D): VGGT-1B's backbone, frame and global blocks and camera
# trunk; SAM-H's mask decoder at 8 boxes (token self-attention, token →
# image, image → token); DiT-base's self- and cross-attention in train_step
# (B = 8) and in sample's guided batch (2 × 6 objects)
FLASH_SHAPES = [(2, 16, 1370, 1370, 64), (2, 16, 1374, 1374, 64),
                (1, 16, 2748, 2748, 64), (1, 16, 2, 2, 128),
                (8, 8, 11, 11, 32), (8, 8, 11, 4096, 16),
                (8, 8, 4096, 11, 16),
                (8, 16, 512, 512, 64), (8, 16, 512, 257, 64),
                (12, 16, 512, 512, 64), (12, 16, 512, 257, 64)]
# SAM-H's global blocks: (B, H, S, D) with a 64 × 64 key grid
GB_SHAPE, GB_GRID = (1, 16, 4096, 80), (64, 64)
# the grid-bias backward pair's other grids, checked (untimed): the small
# SAM's global block (32 × 32, two key-grid rows per 64-key tile, the
# dbias kernel's shared-slab policy) and a kw that does not divide 64
GB_BWD_CHECKS = [((2, 2, 1024, 80), (32, 32)), ((1, 2, 2304, 80), (48, 48))]
# (B, H, Sq, Sk, D) of the backward kernels: DiT-base's self- and
# cross-attention at B = 8 (257 keys is a ragged tail) and a ragged-query
# shape (1374 = 21·64 + 30) for the dkv kernel's masking
BWD_SHAPES = [(8, 16, 512, 512, 64), (8, 16, 512, 257, 64),
              (2, 16, 1374, 1374, 64)]
# the backward kernels' other head dims, ragged in Sq or Sk: held to the
# same bound, timed but kept out of the sums, so those compare across PRs
BWD_CHECK_SHAPES = [(8, 8, 11, 4096, 16), (8, 8, 4096, 11, 16),
                    (2, 8, 300, 300, 32), (1, 16, 700, 700, 128)]
# the flash forward's texture-path widths, (B, H, Sq, Sk, D): the SD VAE's
# mid-block attention at SDVAEConfig() on 512² images, one head of 512 over
# the 64² latent grid (the reference encode; the geometry encode and the
# decode of the 6-view ring; those of the 12-view PBR ring); the CLI's tiny
# SD UNet (heads of 4) at texgen_resolution 64, 6 views: the 32² level's
# self- and cross-attention (lh² + 1 = 1025 keys) and the 16² mid block's
D512_SHAPES = [(1, 1, 4096, 4096, 512), (6, 1, 4096, 4096, 512),
               (12, 1, 4096, 4096, 512)]
D4_SHAPES = [(6, 2, 1024, 1024, 4), (6, 2, 1024, 1025, 4),
             (6, 4, 256, 256, 4), (6, 4, 256, 1025, 4)]
# the distilled detector's and saliency net's head dims (distill_config,
# small_config), (B, H, Sq, Sk, D) at the runners' batch of 8: the saliency
# stem at 96² (stride 4: 576 tokens, 2 heads of 48), the detector's patches
# at 128² (64 tokens, 4 heads of 96), its text tower over the 18 labels (16
# bytes, 4 heads of 48). D = 12 and 24 compute at width 16 and 32 inside
# the kernels; each is held bit for bit against that instance on
# zero-padded inputs, then under the plain version's bound
DISTILL_SHAPES = [(8, 2, 576, 576, 24), (8, 4, 64, 64, 24),
                  (18, 4, 16, 16, 12)]
# the backward's D = 4 and 8: the matting net's attention (4 heads of
# `base` over the 32² level) at the runner's 128² and batch 16, at --base 4
# and 8; each bit for bit the width-16 instance on zero-padded inputs
MATTING_BWD_SHAPES = [(16, 4, 1024, 1024, 8), (16, 4, 1024, 1024, 4)]
KERNELS = {
    "flash_fwd": dict(route="cuda", source="regen3d_tpu_torch/csrc/flash_fwd.cu",
                      replaces="regen3d_tpu/ops/attention.py:46"),
    "flash_bwd_dq": dict(route="cuda",
                         source="regen3d_tpu_torch/csrc/flash_bwd.cu",
                         replaces="regen3d_tpu/ops/attention.py:178"),
    "flash_bwd_dkv": dict(route="cuda",
                          source="regen3d_tpu_torch/csrc/flash_bwd.cu",
                          replaces="regen3d_tpu/ops/attention.py:203"),
    "flash_gb_fwd": dict(route="cuda",
                         source="regen3d_tpu_torch/csrc/flash_fwd.cu",
                         replaces="regen3d_tpu/ops/attention.py:355"),
    "flash_gb_bwd_dq": dict(route="cuda",
                            source="regen3d_tpu_torch/csrc/flash_bwd.cu",
                            replaces="regen3d_tpu/ops/attention.py:396"),
    "flash_gb_bwd_dkv": dict(route="cuda",
                             source="regen3d_tpu_torch/csrc/flash_bwd.cu",
                             replaces="regen3d_tpu/ops/attention.py:437"),
    "silhouette_fwd": dict(route="cuda",
                           source="regen3d_tpu_torch/csrc/silhouette.cu",
                           replaces="regen3d_tpu/ops/pallas_rasterize.py:64"),
    "silhouette_bwd": dict(route="cuda",
                           source="regen3d_tpu_torch/csrc/silhouette.cu",
                           replaces="regen3d_tpu/ops/pallas_rasterize.py:85"),
}
# the launch counts of each main-path run, summed into the kernels line
MAIN_PATHS = ("scene_launches", "phase4_launches", "phase4_ba_launches",
              "phase4_merge_launches", "fit_launches", "bus_launches",
              "phase3_launches", "sam_launches", "phase12_launches",
              "phase1_launches", "dust3r_launches", "dust3r3_launches",
              "midi_cli_launches", "dpa_cli_launches", "midi_full_launches",
              "dpa_full_launches", "dit_launches", "dit_sample_launches",
              "sam_grad_launches", "checkpoint_launches", "matting_launches",
              "texture_rgb_launches", "texture_pbr_launches",
              "texture_cli_texgen_launches", "texture_cli_texgen_pbr_launches",
              "texture_cli_atlas_launches", "flux_launches",
              "x4_upscale_launches", "flux_upscale_launches",
              "cli_upscale_launches", "editor_launches",
              "distill_launches", "distill_phase1_launches",
              "distill_phase1_sam_launches", "parallel_launches")
# the spin before each timed run: ~10 ms at the H100's 1.98 GHz boost clock
SPIN_CYCLES = 20_000_000
# H100 SXM peaks (NVIDIA's data sheet, dense, at the 700-W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12}
# f32 operations per live (pixel, valid face) pair in the silhouette kernels:
# about 20 for the three edge lines, the min, z and the sums, plus the
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


def attention_bwd_work(b, h, sq, sk, d, bias_cols=0):
    """(operations, bytes) of the two backward kernels, by kernel: dq does
    6·Sq·Sk·D operations per (batch·head) (s, dp and ds·k), dkv 8·Sq·Sk·D
    (s, dp, dsᵀ·q and pᵀ·g). Each reads q, k, v and g in bf16 and lse and
    delta in f32 once, and the bias factors (f32) for the grid-bias pair;
    dq writes dq (and the f32 bias gradients), dkv writes dk and dv."""
    bh = b * h
    reads = 2 * bh * (2 * sq + 2 * sk) * d + 8 * bh * sq \
        + 4 * bh * sq * bias_cols
    return {"dq": (6 * bh * sq * sk * d,
                   reads + 2 * bh * sq * d + 4 * bh * sq * bias_cols),
            "dkv": (8 * bh * sq * sk * d, reads + 4 * bh * sk * d)}


def bwd_error(got, ref, terms, name):
    """(max abs error, max |ref|) of a flash backward output (dq, dk or dv)
    against its f32 plain version; raises unless, elementwise,
    err ≤ 2⁻⁸·|ref| + 2⁻⁸·terms + 1e-5·max|ref|, where ``terms`` is the
    element's Σ|terms| (ops.attention.flash_bwd_abs_terms_reference). The
    kernels round p and scale·ds to bf16 once before the second products
    (ds·k, dsᵀ·q, pᵀ·g), as SDPA's backward does: each term moves by at most
    2⁻⁸ of its magnitude (bf16's unit roundoff), so the sum by at most
    2⁻⁸·Σ|terms|. Over hundreds of terms the signs cancel and half of that
    would do, but over SAM's decoder's 11 prompt tokens one term can carry
    the sum, and a model of the rounding reaches 1.3× of 2⁻⁹·Σ|terms| there.
    The output is rounded to bf16 once, 2⁻⁸·|ref|; the f32 sums in another
    order and the exp's last bits stay under 1e-5 of the largest |ref|. A
    dropped 64-row tile or a scale applied twice moves an element by many
    times the bound."""
    ref_max = float(ref.abs().max())
    err = (got.float() - ref).abs()
    tol = 2.0 ** -8 * (ref.abs() + terms) + 1e-5 * ref_max
    if not bool((err <= tol).all()):
        raise AssertionError(f"{name}: error {float(err.max()):.3e} over its "
                             f"bound, {float((err / tol).max()):.2f}× at "
                             f"worst (max |ref| {ref_max:.3e})")
    return float(err.max()), ref_max


def gb_bwd_error(got, ref, name, terms=None):
    """(max abs error, max |ref|) of a grid-bias gradient against its f32
    plain version; raises over the bound. dq, dk and dv, with ``terms``
    their Σ|terms| (ops.attention.grid_bias_bwd_abs_terms_reference), take
    bwd_error's bound: the tensor-core pair rounds p and scale·ds to bf16
    once before the second products, as the flash pair does. The f32 bias
    gradients (``terms`` None) are sums of the unrounded f32 ds over a
    key-grid row or column, in another order than the plain version's and
    with the exp's last bits: 2e-4·max|ref|. A bias gradient moved by one
    grid row fails that by orders of magnitude."""
    if terms is not None:
        return bwd_error(got, ref, terms, name)
    ref_max = float(ref.abs().max())
    err = (got.float() - ref).abs()
    tol = 2e-4 * ref_max
    if not bool((err <= tol).all()):
        raise AssertionError(f"{name}: error {float(err.max()):.3e} over its "
                             f"bound, {float(err.max()) / tol:.2f}× at worst "
                             f"(max |ref| {ref_max:.3e})")
    return float(err.max()), ref_max


def device_top(fn, n):
    """(total ms, [(ms, name, launches)] of the n largest, launches, the same
    list by operator) of the device time in one call of ``fn`` under
    torch.profiler. The first list is by kernel (or copy) name, names cut to
    80 characters after "void " and "at::native::"; launches counts every
    kernel and copy. The by-operator list ranks the CPU-side operations
    (aten::mul, ...) by their self device time, the time of the kernels
    each launched itself."""
    import torch
    from torch.autograd import DeviceType

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    rows, ops = [], []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us <= 0:
            continue
        if getattr(e, "device_type", None) == DeviceType.CPU:
            ops.append((us / 1e3, e.key[:80], e.count))
        else:
            name = e.key.replace("void ", "").replace("at::native::", "")
            rows.append((us / 1e3, name[:80], e.count))
    rows.sort(reverse=True)
    ops.sort(reverse=True)
    return (sum(r[0] for r in rows), rows[:n], sum(r[2] for r in rows),
            ops[:n])


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps=10, warmup=2):
    """Median device ms of ``fn()`` over ``reps`` runs timed by CUDA events.
    Before each run the stream spins for ~10 ms (``torch.cuda._sleep``), so
    the host queues fn's launches before the first event fires and the time
    is the device's, without the host's gaps between launches: without
    the spin, SDPA's backward through autograd (sub-millisecond, several
    launches) read 0.7 to 2.3 ms over three shapes on three H100 machines
    while the hand-written kernels moved by 3%."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def phase_device(kernels, results):
    """The card, the build, and ptxas's report on every kernel instance
    (results["ptxas"][instance]: registers, stack frame and spill bytes)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"device: {smi}")
    t0 = time.perf_counter()
    built = kernels.load_all()
    log(f"build: {time.perf_counter() - t0:.1f} s wall for "
        f"{sorted(built) or 'nothing (up to date)'}")
    from regen3d_tpu_torch.ops import marching_cubes

    t0 = time.perf_counter()
    marching_cubes.load()
    log(f"build: marching tetrahedra ({marching_cubes.lib_path().relative_to(ROOT)}, "
        f"g++) in {time.perf_counter() - t0:.1f} s")
    ptx = results.setdefault("ptxas", {})
    for name, text in kernels.BUILD_LOG.items():
        fn = ""   # the kernel instance ptxas is reporting on
        for line in text.splitlines():
            m = re.search(r"entry function '.*?([A-Za-z_]+_kernel)"
                          r"(I(?:L[bi]\d+E)+E)?", line)
            if m:
                fn = m.group(1) + ptxas_args(m.group(2))
            elif "registers" in line or "spill" in line:
                log(f"  ptxas {name} {fn}: {line.strip()}")
                info = ptx.setdefault(fn, {})
                for key, pat in (("registers", r"Used (\d+) registers"),
                                 ("stack", r"(\d+) bytes stack frame"),
                                 ("spill_stores", r"(\d+) bytes spill stores"),
                                 ("spill_loads", r"(\d+) bytes spill loads")):
                    found = re.search(pat, line)
                    if found:
                        info[key] = int(found.group(1))
    spills = [fn for fn, info in ptx.items()
              if fn.startswith(("fwd_kernel", "fwd_wide_kernel",
                                "silhouette"))
              and info.get("spill_stores", 0) + info.get("spill_loads", 0)]
    if spills:
        raise AssertionError(f"kernels that spill registers: {spills}")
    stacks = [fn for fn, info in ptx.items()
              if fn.startswith("silhouette") and info.get("stack", 0)]
    if stacks:
        raise AssertionError(f"silhouette kernels with a stack frame: {stacks}")
    return smi


def ptxas_args(mangled):
    """'<64, 0, false>' from a mangled template argument list such as
    'ILi64ELi0ELb0EE' (int and bool arguments); '' for none."""
    if not mangled:
        return ""
    args = [("true" if v == "1" else "false") if t == "b" else v
            for t, v in re.findall(r"L([bi])(\d+)E", mangled)]
    return f"<{', '.join(args)}>"


def phase_kernels(results):
    """Each kernel against its plain version at the main paths' shapes."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    tol = ("o: elementwise 2^-8*(|o_ref| + sum|terms|) + 2e-3 (p rounded to "
           "bf16 once before p*v, o once), max error at most 2x SDPA's "
           "against the same plain version; lse: 1e-4; two launches "
           "bit-identical")
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0)
    work = [0, 0]   # operations and bytes over all shapes
    worst = dict(o=0.0, lse=0.0)
    for shape in FLASH_SHAPES:
        r = fwd_case(shape, gen)
        for key in tot:
            tot[key] += r["ms"][key]
        work[0] += r["work"][0]
        work[1] += r["work"][1]
        worst["o"] = max(worst["o"], r["err"])
        worst["lse"] = max(worst["lse"], r["err_lse"])
    t_b, by = bound(*work, "bf16")
    results["flash_fwd"] = dict(
        max_abs_err=worst["o"], max_abs_err_lse=worst["lse"], tolerance=tol,
        bound_ms=t_b, bound_by=by,
        timed=f"sum over the {len(FLASH_SHAPES)} main-path shapes "
              f"(B, H, Sq, Sk, D) {FLASH_SHAPES}", **tot)

    # grid-bias flash at SAM-H's global blocks (timed) and at the other key
    # grids (checked), non-zero bias factors of the size SAM's rel-pos
    # tables give; SDPA gets the (S, S) bias in bf16, built beforehand
    r = fwd_case(GB_SHAPE[:3] + GB_SHAPE[2:], gen, GB_GRID)
    errs = dict(o=r["err"], lse=r["err_lse"])
    for shape, grid in GB_BWD_CHECKS:
        c = fwd_case(shape[:3] + shape[2:], gen, grid, timed=False)
        errs["o"] = max(errs["o"], c["err"])
        errs["lse"] = max(errs["lse"], c["err_lse"])
    results["flash_gb_fwd"] = dict(
        max_abs_err=errs["o"], max_abs_err_lse=errs["lse"], tolerance=tol,
        bound_ms=r["bound"][0], bound_by=r["bound"][1],
        library="F.scaled_dot_product_attention with the (S, S) bf16 bias "
                "built beforehand (untimed)",
        timed=f"timed at {GB_SHAPE} grid {GB_GRID}; errors also over "
              f"{GB_BWD_CHECKS}", **r["ms"])

    phase_wide_and_tiny(results, gen)
    distill_fwd_kernels(results, gen)
    phase_silhouette(results, gen)


def distill_fwd_kernels(results, gen):
    """The forward at D = 12 and 24 (DISTILL_SHAPES): bit for bit the width
    16 and 32 instances on zero-padded inputs, under fwd_error's bound,
    timed beside SDPA; the three instances in ptxas's report without spills
    (phase_device fails on any forward spill). Kept out of the 11-shape
    sum, under flash_fwd.distill_shapes."""
    rows = []
    for shape in DISTILL_SHAPES:
        d = shape[-1]
        r = padded_check(shape, gen, -(-d // 16) * 16)
        rows.append(dict(shape=shape, err=r["err"], err_lse=r["err_lse"],
                         sdpa_err=r["sdpa_err"], bound_ms=r["bound"][0],
                         bound_by=r["bound"][1], **r["ms"]))
    # D = 24 has no split instance (csrc/flash_fwd.cu's launch_plain)
    ptx = {f"D{d} {k}": results["ptxas"].get(f"fwd_kernel<{d}, 0, {s}>")
           for d, k, s in ((12, "unsplit", "false"), (12, "split", "true"),
                           (24, "unsplit", "false"))}
    log(f"ptxas, the D = 12 and 24 forward instances: {ptx}")
    if not all(ptx.values()):
        raise AssertionError(f"the D = 12 and 24 forward instances: {ptx}")
    f = results["flash_fwd"]
    for r in rows:
        f["max_abs_err"] = max(f["max_abs_err"], r["err"])
        f["max_abs_err_lse"] = max(f["max_abs_err_lse"], r["err_lse"])
    f["distill_shapes"], f["distill_ptxas"] = rows, ptx


def sdpa_backends_at(q):
    """The SDPA backends that take (q, q, q), each tried alone."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    took = []
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([be]):
                F.scaled_dot_product_attention(q, q, q)
            took.append(be.name)
        except RuntimeError:
            pass
    return took


def phase_wide_and_tiny(results, gen):
    """The flash forward's texture-path widths: D = 512 (the SD VAE's one
    head over the 64² latent grid: the reference encode, the 6 geometry
    encodes and decodes, the PBR ring's 12) against its plain version under
    fwd_error's bound, timed beside SDPA and the bound, with the SDPA
    backends that take D = 512 alone; D = 4 (the CLI's tiny SD UNet at
    texgen_resolution 64) bit for bit the D = 8 instance on zero-padded
    inputs and under the same bound. Both kept out of the 11-shape sum."""
    import warnings

    import torch

    rows = []
    for shape in D512_SHAPES:
        r = fwd_case(shape, gen)
        rows.append(dict(shape=shape, err=r["err"], err_lse=r["err_lse"],
                         sdpa_err=r["sdpa_err"], bound_ms=r["bound"][0],
                         bound_by=r["bound"][1], **r["ms"]))
    q = torch.randn((1, 1, 4096, 512), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        backends = sdpa_backends_at(q)
    log(f"SDPA at D = 512: the backends that take it alone {backends} "
        f"(SDPA picks the first it can)")
    tiny = []
    for shape in D4_SHAPES:
        r = padded_check(shape, gen, 8)
        tiny.append(dict(shape=shape, err=r["err"], err_lse=r["err_lse"],
                         bound_ms=r["bound"][0], bound_by=r["bound"][1],
                         **r["ms"]))
    log(f"flash_fwd D = 4, bit for bit the D = 8 instance on zero-padded "
        f"inputs: {[t['shape'] for t in tiny]}")
    ptx = {k: results["ptxas"].get(f"fwd_kernel<4, 0, {s}>")
           for k, s in (("unsplit", "false"), ("split", "true"))}
    log(f"ptxas, the D = 4 forward instances: {ptx}")
    if not all(ptx.values()):
        raise AssertionError(f"the D = 4 forward instances: {ptx}")
    f = results["flash_fwd"]
    for r in rows + tiny:
        f["max_abs_err"] = max(f["max_abs_err"], r["err"])
        f["max_abs_err_lse"] = max(f["max_abs_err_lse"], r["err_lse"])
    f["d512_shapes"], f["d512_sdpa_backends"], f["d4_shapes"] = \
        rows, backends, tiny
    f["d4_ptxas"] = ptx


def sil_pairs(sk, nvalid, co, va, uv, inv_sigma, ndc):
    """The (pixel, face) pairs of one batch of tile inputs: "binned", every
    valid face's 1024 pixels; "live", those with z > Z_CUT, the only ones
    whose term is not exactly 0 in f32; "kept", those in the (face, pixel
    block) pairs the kernels evaluate (silhouette_cull_plain); the longest
    chains of work, "block_faces" (the most faces kept in one pixel block)
    and "row_pairs" (the most pairs kept in one row, at row "busiest").
    Raises if a live pair lies in a culled block."""
    import torch

    k = va.shape[1]
    keep = sk.silhouette_cull_plain(nvalid, co, va, uv, inv_sigma, ndc)
    block = sk.pixel_blocks(co.device)
    pu, pv = sk._base_pix(ndc, co.device)
    rows = torch.nonzero(nvalid > 0).flatten()
    live = lost = 0
    for s in range(0, rows.numel(), 64):
        r = rows[s:s + 64]
        e = sk._edges(co[r], uv[r % uv.shape[0]], pu, pv)
        d = torch.minimum(e[:, :k], torch.minimum(e[:, k:2 * k], e[:, 2 * k:]))
        on = (d * d.abs() * inv_sigma > sk.Z_CUT) & (va[r][:, :, None] != 0)
        live += int(on.sum())
        lost += int((on & ~keep[r][:, :, block]).sum())
    if lost:
        raise AssertionError(f"silhouette cull: {lost} live pairs in culled "
                             f"blocks")
    per_row = keep.sum((1, 2))
    return dict(binned=int((va != 0).sum()) * sk.P, live=live,
                kept=int(keep.sum()) * sk.CULL_BLOCK ** 2,
                block_faces=int(keep.sum(1).max()),
                row_pairs=int(per_row.max()) * sk.CULL_BLOCK ** 2,
                busiest=int(per_row.argmax()))


def sil_split(sk, nvalid, co, va, uv, g, consts, busiest):
    """Device ms of each kernel (fwd, bwd) on parts of one batch: its rows
    without faces alone (nvalid zeroed), its busy rows alone (compacted),
    its busiest row alone; and of torch's zero_ on tensors of acc's and
    dc's size, the zero fill's yardstick."""
    import torch

    def part(r):
        return (nvalid[r].contiguous(), co[r].contiguous(),
                va[r].contiguous(), uv[r % uv.shape[0]].contiguous(),
                g[r].contiguous())

    rows = torch.nonzero(nvalid > 0).flatten()
    parts = {"empty": (torch.zeros_like(nvalid), co, va, uv, g),
             "busy": part(rows),
             "busiest": part(torch.tensor([busiest], device=co.device))}
    out = {}
    for name, (nv, c, v, u, gg) in parts.items():
        out[name] = (
            cuda_ms(lambda: sk.silhouette_tiles_fwd(nv, c, v, u, *consts)),
            cuda_ms(lambda: sk.silhouette_tiles_bwd(nv, c, v, u, gg,
                                                    *consts)))
    za = torch.empty(nvalid.numel(), sk.P, device=co.device)
    zd = torch.empty_like(co)
    out["zero_"] = (cuda_ms(za.zero_), cuda_ms(zd.zero_))
    return out


def sil_case(sk, what, nvalid, co, va, uv, consts, gen, timed):
    """Both silhouette kernels at one batch of tile inputs against their
    plain versions, a second launch of each compared bit for bit; the pair
    counts, the bounds and, if ``timed``, the times."""
    import torch

    acc_k = sk.silhouette_tiles_fwd(nvalid, co, va, uv, *consts)
    acc_k2 = sk.silhouette_tiles_fwd(nvalid, co, va, uv, *consts)
    acc_p = sk.silhouette_tiles_fwd_plain(nvalid, co, va, uv, *consts)
    torch.cuda.synchronize()
    if not torch.equal(acc_k, acc_k2):
        raise AssertionError(f"silhouette_fwd {what}: two launches differ")
    # alpha = 1 − exp(acc): f32 sums over ≤128 faces in another order and
    # the transcendentals' last bits → atol 1e-5
    err_a = float((torch.exp(acc_k) - torch.exp(acc_p)).abs().max())
    if err_a > 1e-5:
        raise AssertionError(f"silhouette_fwd {what}: alpha error {err_a:.3e}")
    g = torch.randn(acc_k.shape, generator=gen, device=co.device)
    dc_k = sk.silhouette_tiles_bwd(nvalid, co, va, uv, g, *consts)
    dc_k2 = sk.silhouette_tiles_bwd(nvalid, co, va, uv, g, *consts)
    dc_p = sk.silhouette_tiles_bwd_plain(nvalid, co, va, uv, g, *consts)
    # Σ|terms| of every dc element: with |g| every term of a sum has one sign
    # (pixel offsets and tile origins are ≥ 0), so the plain sums are exact
    # magnitudes.
    dc_abs = sk.silhouette_tiles_bwd_plain(nvalid, co, va, uv, g.abs(),
                                           *consts).abs()
    torch.cuda.synchronize()
    if not torch.equal(dc_k, dc_k2):
        raise AssertionError(f"silhouette_bwd {what}: two launches differ")
    # dc, elementwise: the same argmin routing (edge values are rounded
    # identically) and f32 sums over 1024 pixels in another order, whose
    # error is a few √1024·2^-24 of Σ|terms| → 2e-5·Σ|terms|. A misrouted
    # pixel or a dropped tile-origin fold moves its element by far more.
    diff = (dc_k - dc_p).abs()
    ratio = float((diff / dc_abs.clamp_min(1e-30)).max())
    if not bool((diff <= 2e-5 * dc_abs).all()):
        raise AssertionError(f"silhouette_bwd {what}: dc error {ratio:.3e} of "
                             f"its element's sum of |terms| (tol 2e-5)")
    pairs = sil_pairs(sk, nvalid, co, va, uv, *consts)
    binned, live, kept = pairs["binned"], pairs["live"], pairs["kept"]
    busy = nvalid > 0
    n_busy = int(busy.sum())
    k = va.shape[1]
    # bounds: the operations of the live pairs; the bytes of every row's
    # face count, the busy rows' coefficients and valid flags (and g), and
    # every output. The dense count before: every binned pair, every input.
    ops = {n: SIL_OPS_PER_PAIR[n] * live for n in ("fwd", "bwd")}
    row_in = 4 * n_busy * (9 * k + k)
    nbytes = {"fwd": 4 * nvalid.numel() + row_in + 4 * acc_k.numel(),
              "bwd": 4 * nvalid.numel() + row_in + 4 * n_busy * sk.P
              + 4 * dc_k.numel()}
    all_in = 4 * (nvalid.numel() + co.numel() + va.numel() + uv.numel())
    dense = {"fwd": bound(SIL_OPS_PER_PAIR["fwd"] * binned,
                          all_in + 4 * acc_k.numel(), "f32"),
             "bwd": bound(SIL_OPS_PER_PAIR["bwd"] * binned,
                          all_in + 4 * (g.numel() + dc_k.numel()), "f32")}
    out = dict(err_a=err_a, err_dc=float(diff.max()), ratio=ratio,
               scale=float(dc_p.abs().max()), binned=binned, live=live,
               kept=kept, pairs=pairs, n_busy=n_busy,
               n_rows=nvalid.numel(), k=k,
               bound={n: bound(ops[n], nbytes[n], "f32") for n in ops},
               dense=dense)
    if timed:
        out["ms"] = dict(
            fk=cuda_ms(lambda: sk.silhouette_tiles_fwd(nvalid, co, va, uv,
                                                       *consts)),
            fp=cuda_ms(lambda: sk.silhouette_tiles_fwd_plain(
                nvalid, co, va, uv, *consts), reps=5),
            bk=cuda_ms(lambda: sk.silhouette_tiles_bwd(nvalid, co, va, uv, g,
                                                       *consts)),
            bp=cuda_ms(lambda: sk.silhouette_tiles_bwd_plain(
                nvalid, co, va, uv, g, *consts), reps=5))
        out["split"] = sil_split(sk, nvalid, co, va, uv, g, consts,
                                 pairs["busiest"])
    line = (f"silhouette {what} (K={k}, {n_busy}/{nvalid.numel()} rows "
            f"busy): alpha err {err_a:.3e}, dc err {out['err_dc']:.3e} at "
            f"max |dc| {out['scale']:.3e}, worst {ratio:.3e} of its "
            f"element's sum of |terms|; both bit-identical twice; pairs "
            f"binned {binned:.4e}, live (z > {sk.Z_CUT:g}) {live:.4e} "
            f"({live / max(binned, 1):.3%}), kept by the cull {kept:.4e} "
            f"({kept / max(binned, 1):.3%}), no live pair culled; at most "
            f"{pairs['block_faces']} faces kept in a pixel block and "
            f"{pairs['row_pairs']} pairs in a row; bound fwd "
            f"{out['bound']['fwd'][0]:.4f} ms ({out['bound']['fwd'][1]}), "
            f"bwd {out['bound']['bwd'][0]:.4f} ms "
            f"({out['bound']['bwd'][1]}); dense count fwd "
            f"{dense['fwd'][0]:.4f} ms ({dense['fwd'][1]}), bwd "
            f"{dense['bwd'][0]:.4f} ms ({dense['bwd'][1]})")
    if timed:
        t = out["ms"]
        sp = out["split"]
        line += (f"; fwd kernel {t['fk']:.4f} ms vs plain {t['fp']:.3f} ms, "
                 f"bwd kernel {t['bk']:.4f} ms vs plain {t['bp']:.3f} ms; "
                 f"split (fwd, bwd ms): the rows without faces alone "
                 f"{sp['empty'][0]:.4f}, {sp['empty'][1]:.4f} (torch zero_ "
                 f"of acc, dc {sp['zero_'][0]:.4f}, {sp['zero_'][1]:.4f}); "
                 f"the busy rows alone {sp['busy'][0]:.4f}, "
                 f"{sp['busy'][1]:.4f}; the busiest row alone "
                 f"{sp['busiest'][0]:.4f}, {sp['busiest'][1]:.4f}")
    log(line)
    return out


def sliver_problem(gen, b=4, n=128, size=512, k=40, sigma=5e-7, dev="cuda"):
    """Tile inputs for ``b`` objects of ``n`` random slivers at size² (long,
    thin, with an acute tip whose corner sector reaches far), binned with a
    16-px margin at K = ``k``."""
    import torch

    from regen3d_tpu_torch.ops import silhouette_kernel as sk
    from regen3d_tpu_torch.ops.rasterize import compute_silhouette_bins

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    c = 10 + (size - 20) * rand(b, n, 2)
    ang = 2 * math.pi * rand(b, n)
    length, half = 20 + 60 * rand(b, n, 1), 0.2 + 0.8 * rand(b, n, 1)
    dv = torch.stack([torch.cos(ang), torch.sin(ang)], -1)
    nv = torch.stack([-dv[..., 1], dv[..., 0]], -1)
    tri = torch.stack([c, c + length * dv + half * nv,
                       c + length * dv - half * nv], 2)      # (b, n, 3, 2)
    verts = torch.cat([tri, torch.full_like(tri[..., :1], 2.5)], -1)
    verts = verts.reshape(b, 3 * n, 3)
    faces = torch.arange(3 * n, dtype=torch.int32, device=dev)
    faces = faces.reshape(n, 3)[None].expand(b, n, 3).contiguous()
    bins = compute_silhouette_bins(verts, faces, (size, size), sigma,
                                   tile=32, faces_per_tile=k, margin_px=16.0)
    inputs = sk.edge_tile_inputs(verts, faces, (size, size), sigma,
                                 faces_per_tile=k, bins=bins)
    return inputs, sk.tile_consts((size, size), sigma)


def phase_silhouette(results, gen):
    """The silhouette kernels at four problems: the phase-6 batch at its
    initial pose (timed), the same tile inputs with σ = 1e-4's constants
    (almost nothing culled; timed) and random slivers at K = 40 and 1000
    (checked); ptxas's registers, stack frame and spills of both kernels."""
    import torch

    from regen3d_tpu_torch.ops import silhouette_kernel as sk
    from regen3d_tpu_torch.pipeline.pose_fit import (
        compute_batch_bins,
        pose_transform,
    )

    batch, cam, cfg, gt = phase6_problem()
    init = phase6_init(gt)
    bins = compute_batch_bins(init, batch, cam, cfg)
    with torch.no_grad():
        vs = cam.view_to_screen(cam.world_to_view(pose_transform(init, batch,
                                                                 cfg)))
        co, nvalid, va, uv = sk.edge_tile_inputs(
            vs, batch.faces, cfg.image_hw, cfg.sigma, batch.faces_mask,
            faces_per_tile=cfg.faces_per_tile, bins=bins)
    main = sil_case(sk, f"phase-6 batch ({batch.faces.shape[0]} objects, "
                    f"{cfg.image_hw[0]}², sigma {cfg.sigma:g})", nvalid, co,
                    va, uv, sk.tile_consts(cfg.image_hw, cfg.sigma), gen,
                    timed=True)
    wide = sil_case(sk, "phase-6 tile inputs at sigma 1e-4's constants",
                    nvalid, co, va, uv, sk.tile_consts(cfg.image_hw, 1e-4),
                    gen, timed=True)
    (co_s, nvalid_s, va_s, uv_s), consts_s = sliver_problem(gen)
    sliver = sil_case(sk, "random slivers (4 objects, 512², sigma 5e-7)",
                      nvalid_s, co_s, va_s, uv_s, consts_s, gen, timed=False)
    # K = 1000: over 48 KB of shared memory, several forward face chunks
    # and backward item chunks a row
    (co_l, nvalid_l, va_l, uv_l), consts_l = sliver_problem(
        gen, b=1, n=1024, size=128, k=1000, sigma=1e-5)
    wide_k = sil_case(sk, "random slivers (1 object, 128², sigma 1e-5)",
                      nvalid_l, co_l, va_l, uv_l, consts_l, gen, timed=False)
    ptx = results.get("ptxas", {})
    regs = "; ".join(
        f"{fn}: {info.get('registers')} registers, {info.get('stack')} bytes "
        f"stack frame, {info.get('spill_stores')}/{info.get('spill_loads')} "
        f"bytes spill stores/loads"
        for fn, info in sorted(ptx.items()) if fn.startswith("silhouette")) \
        or "not rebuilt in this run"
    log(f"silhouette ptxas: {regs}")
    cases = (main, wide, sliver, wide_k)
    t = main["ms"]
    tol_dc = "elementwise 2e-5 * sum|terms|; two launches bit-identical"
    checked = ("errors: worst over the phase-6 batch, the same inputs at "
               "sigma 1e-4's constants and random slivers at K = 40 and "
               "1000; times and bound at the phase-6 batch")
    results["silhouette_fwd"] = dict(
        max_abs_err=max(c["err_a"] for c in cases), ms=t["fk"],
        plain_ms=t["fp"], bound_ms=main["bound"]["fwd"][0],
        bound_by=main["bound"]["fwd"][1], library_ms=None,
        tolerance="alpha atol 1e-5; two launches bit-identical",
        timed=checked)
    results["silhouette_bwd"] = dict(
        max_abs_err=max(c["err_dc"] for c in cases),
        max_rel_err=max(c["ratio"] for c in cases), ms=t["bk"],
        plain_ms=t["bp"], bound_ms=main["bound"]["bwd"][0],
        bound_by=main["bound"]["bwd"][1], library_ms=None, tolerance=tol_dc,
        timed=checked)


@contextlib.contextmanager
def recording_flash_shapes():
    """Within the block, every (B, H, Sq, Sk, D) given to the flash forward
    (ops.attention._flash_fwd) is counted in the yielded Counter; the
    function is restored after."""
    from regen3d_tpu_torch.ops import attention as att

    shapes = collections.Counter()
    flash_fwd = att._flash_fwd

    def recorded(q, k, v, scale):
        shapes[(*q.shape[:3], k.shape[2], q.shape[3])] += 1
        return flash_fwd(q, k, v, scale)

    att._flash_fwd = recorded
    try:
        yield shapes
    finally:
        att._flash_fwd = flash_fwd


def fwd_error(o, o_ref, terms, lse, lse_ref, name):
    """(max abs o error, max abs lse error) of a flash forward against its
    f32 plain version; raises unless, elementwise,
    |o − o_ref| ≤ 2⁻⁸·(|o_ref| + terms) + 2e-3, where ``terms`` is the
    element's Σ|terms| = Σ_k p·|v| (ops.attention.attention_abs_terms_reference),
    and |lse − lse_ref| ≤ 1e-4. The kernel rounds p to bf16 once before
    p·v, as SDPA does: each term moves by at most 2⁻⁸ of its magnitude, so o
    by at most 2⁻⁸·Σ|terms|; o is rounded to bf16 once, 2⁻⁸·|o_ref|; 2e-3
    covers the f32 sums in another order. 2⁻⁸·|o_ref| + 2e-3 alone, the
    bound of the f32 CUDA-core kernel, does not admit p's rounding where
    few keys carry o: a model of the rounding exceeds it 1.42× at
    (8, 8, 4096, 11, 16). lse sums the f32 p. A dropped 64-key tile, a
    doubled scale, a missing rescale of o or lse in log₂ moves an element
    by many times the bound."""
    err = (o.float() - o_ref).abs()
    tol = 2.0 ** -8 * (o_ref.abs() + terms) + 2e-3
    err_lse = (lse - lse_ref).abs()
    worst = max(float((err / tol).max()), float(err_lse.max()) / 1e-4)
    if worst > 1:
        raise AssertionError(f"{name}: o error {float(err.max()):.3e}, lse "
                             f"error {float(err_lse.max()):.3e}, over its "
                             f"bound, {worst:.2f}× at worst")
    return float(err.max()), float(err_lse.max())


def fwd_case(shape, gen, grid=None, timed=True):
    """The flash forward kernel at one (B, H, Sq, Sk, D), with the grid
    bias if ``grid`` is a (kh, kw) key grid (Sk = kh·kw, bias factors
    N(0, 0.5²)): o and lse against the f32 plain version under fwd_error's
    bound, o's error at most twice SDPA's against the same plain version
    (SDPA given the (S, S) bias in bf16), a second launch compared bit for
    bit; if ``timed``, the times of the kernel, the plain version and SDPA
    and the least time the card could take, logged with TFLOP/s."""
    import torch
    import torch.nn.functional as F

    from regen3d_tpu_torch.ops import attention as att

    b, h, sq, skv, d = shape
    q = torch.randn((b, h, sq, d), generator=gen, device="cuda")
    k, v = (torch.randn((b, h, skv, d), generator=gen, device="cuda")
            for _ in range(2))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    if grid is None:
        args, mask, what = (q, k, v), None, f"flash_fwd {shape}"
        kernel, plain = att.flash_attention_fwd, att.attention_reference
        terms_fn = att.attention_abs_terms_reference
        ops, nbytes = attention_work(*shape)
    else:
        kh, kw = grid
        bias = [0.5 * torch.randn((b, h, sq, n), generator=gen, device="cuda")
                for n in grid]
        args = (q, k, v, *bias, kw)
        mask = (bias[0][..., :, None] + bias[1][..., None, :]).reshape(
            b, h, sq, skv).to(torch.bfloat16)
        what = f"flash_gb_fwd {shape} grid {grid}"
        kernel, plain = att.flash_attention_grid_bias_fwd, \
            att.grid_bias_reference
        terms_fn = att.grid_bias_abs_terms_reference
        ops, nbytes = attention_work(*shape, kh + kw)
    def up(xs):   # the bf16 tensors in f32, for the plain version
        return tuple(t.float() if isinstance(t, torch.Tensor)
                     and t.dtype == torch.bfloat16 else t for t in xs)

    f32 = up(args)
    with torch.no_grad():
        o, lse = kernel(*args)
        o2, lse2 = kernel(*args)
        o_ref, lse_ref = plain(*f32)
        terms = terms_fn(*f32)
        o_lib = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    torch.cuda.synchronize()
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
        raise AssertionError(f"{what}: two launches on the same inputs differ")
    err, err_lse = fwd_error(o, o_ref, terms, lse, lse_ref, what)
    err_lib = float((o_lib.float() - o_ref).abs().max())
    if err > 2 * err_lib:
        raise AssertionError(f"{what}: o error {err:.3e} over twice SDPA's "
                             f"{err_lib:.3e}")
    out = dict(err=err, err_lse=err_lse, sdpa_err=err_lib, work=(ops, nbytes),
               bound=bound(ops, nbytes, "bf16"))
    # the f32 CUDA-core kernel's bound, which does not admit p's rounding
    # where few keys carry o: its worst ratio, for the record
    old = float(((o.float() - o_ref).abs()
                 / (2.0 ** -8 * o_ref.abs() + 2e-3)).max())
    line = (f"{what}{'' if timed else ' (check only)'}: o err {err:.3e} "
            f"(SDPA's {err_lib:.3e}; {old:.2f}x of 2^-8*|o_ref| + 2e-3), "
            f"lse err {err_lse:.3e}; bit-identical twice")
    del o_ref, lse_ref, terms, o_lib, f32
    if timed:
        with torch.no_grad():
            t_k = cuda_ms(lambda: kernel(*args))
            t_p = cuda_ms(lambda: plain(*up(args)), reps=5)
            t_l = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask))
        out["ms"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l)
        line += (f"; kernel {t_k:.3f} ms ({ops / t_k / 1e9:.1f} TFLOP/s), "
                 f"plain {t_p:.3f} ms, sdpa {t_l:.3f} ms, bound "
                 f"{out['bound'][0]:.4f} ms ({out['bound'][1]})")
    log(line)
    return out


def sdpa_bwd_ms(q, k, v, g, mask=None):
    """Device ms of F.scaled_dot_product_attention's backward (dq, dk and dv
    together) alone, after an untimed forward."""
    import torch
    import torch.nn.functional as F

    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o = F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask)
    return cuda_ms(lambda: torch.autograd.grad(o, (qr, kr, vr), g,
                                               retain_graph=True))


def flash_bwd_case(shape, gen):
    """The flash dq and dkv kernels at one (B, H, Sq, Sk, D) with a non-zero
    upstream gradient: each output against its f32 plain version under
    bwd_error, SDPA's backward's errors against the same plain versions, a
    second launch of each kernel compared bit for bit, and the times of the
    kernels, the plain versions and SDPA's backward."""
    import torch
    import torch.nn.functional as F

    from regen3d_tpu_torch.ops import attention as att

    b, h, sq, skv, d = shape
    q = torch.randn((b, h, sq, d), generator=gen, device="cuda")
    k, v = (torch.randn((b, h, skv, d), generator=gen, device="cuda")
            for _ in range(2))
    g = torch.randn((b, h, sq, d), generator=gen, device="cuda")
    q, k, v, g = (t.to(torch.bfloat16) for t in (q, k, v, g))
    s = d ** -0.5
    with torch.no_grad():
        o, lse = att.flash_attention_fwd(q, k, v)
    delta = (o.float() * g.float()).sum(-1)
    args = (q, k, v, g, lse, delta, s)
    got = (att.flash_bwd_dq(*args),) + att.flash_bwd_dkv(*args)
    again = (att.flash_bwd_dq(*args),) + att.flash_bwd_dkv(*args)
    refs = (att.flash_bwd_dq_reference(*args),) + \
        att.flash_bwd_dkv_reference(*args)
    terms = att.flash_bwd_abs_terms_reference(*args)
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lib = torch.autograd.grad(F.scaled_dot_product_attention(qr, kr, vr),
                              (qr, kr, vr), g)
    torch.cuda.synchronize()
    out = dict(err={}, ref_max={}, sdpa_err={})
    for name, x, x2, ref, term, y in zip(("dq", "dk", "dv"), got, again,
                                         refs, terms, lib):
        kernel = "flash_bwd_dq" if name == "dq" else "flash_bwd_dkv"
        if not torch.equal(x, x2):
            raise AssertionError(f"{kernel} {shape}: two launches on the "
                                 f"same inputs differ in {name}")
        out["err"][name], out["ref_max"][name] = bwd_error(
            x, ref, term, f"{kernel} {shape} {name}")
        out["sdpa_err"][name] = float((y.float() - ref).abs().max())
    del refs, terms, lib, qr, kr, vr
    out["ms"] = dict(
        dq=cuda_ms(lambda: att.flash_bwd_dq(*args)),
        dkv=cuda_ms(lambda: att.flash_bwd_dkv(*args)),
        dq_p=cuda_ms(lambda: att.flash_bwd_dq_reference(*args), reps=5),
        dkv_p=cuda_ms(lambda: att.flash_bwd_dkv_reference(*args), reps=5),
        lib=sdpa_bwd_ms(q, k, v, g))
    return out


def bwd_padded_check(shape, gen, wide):
    """The dq and dkv kernels at ``shape`` (head dim D = 12 or 24) bit for
    bit the width-``wide`` instances on q, k, v and g zero-padded to
    ``wide`` columns, with the same scale 1/√D, lse and delta: dq, dk and
    dv equal the padded outputs' first D columns, whose other columns are
    exactly 0. Each output is written into a buffer with a NaN tail of one
    row, which must come back untouched: no column past D reaches device
    memory past the last row."""
    import torch
    import torch.nn.functional as F

    from regen3d_tpu_torch.ops import attention as att

    b, h, sq, sk, d = shape
    q, g = (torch.randn((b, h, sq, d), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((b, h, sk, d), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    s = d ** -0.5
    with torch.no_grad():
        o, lse = att.flash_attention_fwd(q, k, v)
    delta = (o.float() * g.float()).sum(-1)

    def guarded(n):
        buf = torch.full((b * h * n * d + wide,), float("nan"),
                         dtype=torch.bfloat16, device="cuda")
        return buf, buf[:b * h * n * d].view(b, h, n, d)

    (qbuf, dq), (kbuf, dk), (vbuf, dv) = guarded(sq), guarded(sk), \
        guarded(sk)
    att._launch("flash_bwd", "flash_bwd_dq_bf16", "flash_bwd_dq", q, k, v,
                g, lse, delta, dq, b * h, sq, sk, d, float(s))
    att._launch("flash_bwd", "flash_bwd_dkv_bf16", "flash_bwd_dkv", q, k, v,
                g, lse, delta, dk, dv, b * h, sq, sk, d, float(s))
    pad = lambda t: F.pad(t, (0, wide - d)).contiguous()
    args = (pad(q), pad(k), pad(v), pad(g), lse, delta, s)
    wq = att.flash_bwd_dq(*args)
    wk, wv = att.flash_bwd_dkv(*args)
    torch.cuda.synchronize()
    for name, x, w, buf in (("dq", dq, wq, qbuf), ("dk", dk, wk, kbuf),
                            ("dv", dv, wv, vbuf)):
        if not (torch.equal(x, w[..., :d].contiguous())
                and float(w[..., d:].abs().max()) == 0.0):
            raise AssertionError(f"flash_bwd {name} D = {d} at {shape}: not "
                                 f"bit for bit the D = {wide} instance on "
                                 f"zero-padded inputs")
        if not bool(buf[x.numel():].isnan().all()):
            raise AssertionError(f"flash_bwd {name} D = {d} at {shape}: a "
                                 f"write past the output's last row")
    log(f"flash_bwd D = {d} at {shape}: dq, dk, dv bit for bit the D = "
        f"{wide} instances on zero-padded inputs; no write past the rows")


def gb_bwd_case(shape, grid, gen, timed):
    """The grid-bias dq and dkv kernels at one (B, H, S, D) and (kh, kw) key
    grid, with a non-zero upstream gradient and bias factors of the size
    SAM's rel-pos tables give: dq, dk and dv under bwd_error's bound with
    the grid-bias Σ|terms| and at most twice the error of SDPA's backward
    (given the (S, S) bias in bf16) against the same f32 plain versions, the
    f32 bias gradients under 2e-4·max|ref|, a second launch of each kernel
    compared bit for bit; if ``timed``, the times of the kernels, the plain
    versions and SDPA's backward."""
    import torch
    import torch.nn.functional as F

    from regen3d_tpu_torch.ops import attention as att

    b, h, s, d = shape
    kh, kw = grid
    q, k, v, g = (torch.randn(shape, generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(4))
    bias_h = 0.5 * torch.randn((b, h, s, kh), generator=gen, device="cuda")
    bias_w = 0.5 * torch.randn((b, h, s, kw), generator=gen, device="cuda")
    with torch.no_grad():
        o, lse = att.flash_attention_grid_bias_fwd(q, k, v, bias_h, bias_w,
                                                   kw)
    delta = (o.float() * g.float()).sum(-1)
    args = (q, k, v, bias_h, bias_w, kw, g, lse, delta, d ** -0.5)
    got = att.grid_bias_bwd_dq(*args) + att.grid_bias_bwd_dkv(*args)
    again = att.grid_bias_bwd_dq(*args) + att.grid_bias_bwd_dkv(*args)
    refs = att.grid_bias_bwd_dq_reference(*args) + \
        att.grid_bias_bwd_dkv_reference(*args)
    terms = dict(zip(("dq", "dk", "dv"),
                     att.grid_bias_bwd_abs_terms_reference(*args)))
    mask = (bias_h[..., :, None] + bias_w[..., None, :]).reshape(
        b, h, s, s).to(torch.bfloat16)
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lib = dict(zip(("dq", "dk", "dv"), torch.autograd.grad(
        F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask),
        (qr, kr, vr), g)))
    torch.cuda.synchronize()
    out = dict(err={}, ref_max={}, sdpa_err={})
    for name, x, x2, ref in zip(("dq", "dbias_h", "dbias_w", "dk", "dv"),
                                got, again, refs):
        what = (f"flash_gb_bwd_{'dkv' if name in ('dk', 'dv') else 'dq'} "
                f"{shape} grid {grid} {name}")
        if not torch.equal(x, x2):
            raise AssertionError(f"{what}: two launches on the same inputs "
                                 f"differ")
        out["err"][name], out["ref_max"][name] = gb_bwd_error(
            x, ref, what, terms.get(name))
        if name in lib:
            e_lib = float((lib[name].float() - ref).abs().max())
            out["sdpa_err"][name] = e_lib
            if out["err"][name] > 2 * e_lib:
                raise AssertionError(f"{what}: error {out['err'][name]:.3e} "
                                     f"over twice SDPA backward's "
                                     f"{e_lib:.3e}")
    del refs, terms, lib, qr, kr, vr
    if timed:
        out["ms"] = dict(
            dq=cuda_ms(lambda: att.grid_bias_bwd_dq(*args)),
            dkv=cuda_ms(lambda: att.grid_bias_bwd_dkv(*args)),
            dq_p=cuda_ms(lambda: att.grid_bias_bwd_dq_reference(*args),
                         reps=3),
            dkv_p=cuda_ms(lambda: att.grid_bias_bwd_dkv_reference(*args),
                          reps=3),
            lib=sdpa_bwd_ms(q, k, v, g, mask))
    return out


def phase_bwd_kernels(results):
    """The four backward kernels against their plain versions, with a
    non-zero upstream gradient g: flash dq and dkv at the DiT-base shapes and
    a ragged-query shape (timed, beside the backward of
    F.scaled_dot_product_attention, which computes dq, dk and dv together)
    and at the other head dims (checked), the grid-bias pair at SAM-H's
    global blocks (timed) and at two other key grids (checked)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(4)
    tol = ("elementwise 2^-8*(|ref| + sum|terms|) + 1e-5*max|ref| (p and "
           "scale*ds rounded to bf16 once before the second products, the "
           "output once); each max error at most 2x SDPA backward's against "
           "the same plain version; two launches bit-identical")
    acc = {n: dict(ms=0.0, plain_ms=0.0, ops=0, nbytes=0, err=0.0)
           for n in ("dq", "dkv")}
    lib_ms = 0.0

    def flash_case(shape, timed):
        nonlocal lib_ms
        r = flash_bwd_case(shape, gen)
        work = attention_bwd_work(*shape)
        r["bound"] = {n: bound(*work[n], "bf16") for n in ("dq", "dkv")}
        e, e_lib, t = r["err"], r["sdpa_err"], r["ms"]
        if timed:
            for name in ("dq", "dk", "dv"):
                if e[name] > 2 * e_lib[name]:
                    raise AssertionError(
                        f"flash_bwd {shape} {name}: error {e[name]:.3e} over "
                        f"twice SDPA backward's {e_lib[name]:.3e}")
        work = attention_bwd_work(*shape)
        for n, err in (("dq", e["dq"]), ("dkv", max(e["dk"], e["dv"]))):
            a = acc[n]
            a["err"] = max(a["err"], err)
            if timed:
                a["ms"] += t[n]
                a["plain_ms"] += t[n + "_p"]
                a["ops"] += work[n][0]
                a["nbytes"] += work[n][1]
        if timed:
            lib_ms += t["lib"]
        b_dq, b_dkv = (bound(*work[n], "bf16") for n in ("dq", "dkv"))
        tf = {n: work[n][0] / t[n] / 1e9 for n in ("dq", "dkv")}
        log(f"flash_bwd {shape}{'' if timed else ' (check only)'}: errors "
            f"(max abs; SDPA backward's; max |ref|) "
            + ", ".join(f"{n} {e[n]:.3e}; {e_lib[n]:.3e}; "
                        f"{r['ref_max'][n]:.3e}" for n in ("dq", "dk", "dv"))
            + f"; bit-identical twice; dq kernel {t['dq']:.3f} ms "
            f"({tf['dq']:.1f} TFLOP/s; plain {t['dq_p']:.3f}, bound "
            f"{b_dq[0]:.4f} {b_dq[1]}), dkv kernel {t['dkv']:.3f} ms "
            f"({tf['dkv']:.1f} TFLOP/s; plain {t['dkv_p']:.3f}, bound "
            f"{b_dkv[0]:.4f} {b_dkv[1]}); the two kernels "
            f"{t['dq'] + t['dkv']:.3f} ms against sdpa backward (dq, dk, dv "
            f"together) {t['lib']:.3f} ms")
        return r
    for shape in BWD_SHAPES:
        flash_case(shape, True)

    # the grid-bias pair at SAM-H's global blocks, drawn right after the
    # timed flash shapes, so its inputs do not depend on the check shapes
    gb_tol = ("dq, dk, dv: elementwise 2^-8*(|ref| + sum|terms|) + "
              "1e-5*max|ref| (p and scale*ds rounded to bf16 once before "
              "the second products, the output once), each max error at "
              "most 2x SDPA backward's against the same plain version; "
              "dbias: 2e-4*max|ref| (f32 sums of the unrounded ds); two "
              "launches bit-identical")
    worst = {}

    def gb_case(shape, grid, timed):
        r = gb_bwd_case(shape, grid, gen, timed)
        for n, e in r["err"].items():
            worst[n] = max(worst.get(n, 0.0), e)
        errs = ", ".join(
            f"{n} {e:.3e}"
            + (f"; {r['sdpa_err'][n]:.3e}" if n in r["sdpa_err"] else "")
            + f"; {r['ref_max'][n]:.3e}" for n, e in r["err"].items())
        line = (f"flash_gb_bwd {shape} grid {grid}"
                f"{'' if timed else ' (check only)'}: errors (max abs; "
                f"SDPA backward's; max |ref|) {errs}; bit-identical twice")
        if timed:
            t = r["ms"]
            b, h, s, d = shape
            work = attention_bwd_work(b, h, s, s, d, sum(grid))
            b_dq, b_dkv = (bound(*work[n], "bf16") for n in ("dq", "dkv"))
            tf = {n: work[n][0] / t[n] / 1e9 for n in ("dq", "dkv")}
            line += (f"; dq kernel {t['dq']:.3f} ms ({tf['dq']:.1f} TFLOP/s;"
                     f" plain {t['dq_p']:.3f}, bound {b_dq[0]:.4f} "
                     f"{b_dq[1]}), dkv kernel {t['dkv']:.3f} ms "
                     f"({tf['dkv']:.1f} TFLOP/s; plain {t['dkv_p']:.3f}, "
                     f"bound {b_dkv[0]:.4f} {b_dkv[1]}); the two kernels "
                     f"{t['dq'] + t['dkv']:.3f} ms against sdpa backward "
                     f"with the bf16 bias built beforehand (untimed; dq, dk, "
                     f"dv together, no bias gradient) {t['lib']:.3f} ms")
            r["bound"] = dict(dq=b_dq, dkv=b_dkv)
        log(line)
        return r

    timed = gb_case(GB_SHAPE, GB_GRID, True)
    for shape in BWD_CHECK_SHAPES:
        flash_case(shape, False)
    distill = []
    for shape in DISTILL_SHAPES + MATTING_BWD_SHAPES:
        d = shape[-1]
        bwd_padded_check(shape, gen, -(-d // 16) * 16)
        r = flash_case(shape, False)
        distill.append(dict(shape=shape, err=r["err"],
                            sdpa_err=r["sdpa_err"], bound=r["bound"],
                            **r["ms"]))
    ptx = {f"{k}<{d}>": results["ptxas"].get(f"{k}<{d}>")
           for k in ("bwd_dq_kernel", "bwd_dkv_kernel")
           for d in (4, 8, 12, 24)}
    log(f"ptxas, the D = 4, 8, 12 and 24 backward instances: {ptx}")
    spills = {k: v for k, v in ptx.items() if v and
              v.get("spill_stores", 0) + v.get("spill_loads", 0)}
    if not all(ptx.values()) or spills:
        raise AssertionError(f"the D = 4, 8, 12 and 24 backward instances: "
                             f"{ptx}")
    for shape, grid in GB_BWD_CHECKS:
        gb_case(shape, grid, False)
    for n in ("dq", "dkv"):
        a = acc[n]
        t_b, by = bound(a["ops"], a["nbytes"], "bf16")
        results[f"flash_bwd_{n}"] = dict(
            max_abs_err=a["err"], tolerance=tol, ms=a["ms"],
            plain_ms=a["plain_ms"], bound_ms=t_b, bound_by=by,
            library_ms=lib_ms,
            library="F.scaled_dot_product_attention backward: dq, dk and dv "
                    "together, the same time for both kernels of the pair",
            timed=f"times summed over the {len(BWD_SHAPES)} shapes (B, H, "
                  f"Sq, Sk, D) {BWD_SHAPES}; errors also over "
                  f"{BWD_CHECK_SHAPES}, {DISTILL_SHAPES} and "
                  f"{MATTING_BWD_SHAPES}",
            distill_shapes=[dict(shape=r["shape"], ms=r[n], plain_ms=r[n + "_p"],
                                 library_ms=r["lib"], bound_ms=r["bound"][n][0],
                                 bound_by=r["bound"][n][1],
                                 err={k: v for k, v in r["err"].items()
                                      if (k == "dq") == (n == "dq")})
                            for r in distill],
            distill_ptxas={k: v for k, v in ptx.items()
                           if k.startswith(f"bwd_{n}_")})
    t = timed["ms"]
    lib = ("F.scaled_dot_product_attention backward with the (S, S) bf16 "
           "bias built beforehand: dq, dk and dv together, no bias gradient; "
           "the same time for both kernels of the pair")
    grids = (f"timed at {GB_SHAPE} grid {GB_GRID}; errors also over "
             f"{GB_BWD_CHECKS}")
    for n, outs in (("dq", ("dq", "dbias_h", "dbias_w")),
                    ("dkv", ("dk", "dv"))):
        results[f"flash_gb_bwd_{n}"] = dict(
            max_abs_err=max(worst[o] for o in outs), tolerance=gb_tol,
            ms=t[n], plain_ms=t[n + "_p"], bound_ms=timed["bound"][n][0],
            bound_by=timed["bound"][n][1], library_ms=t["lib"], library=lib,
            timed=grids)


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
def phase6_problem(dev="cuda", size=1024, n_obj=8, n_points=4096,
                   torus=(32, 32)):
    """Phase 6's default fit problem: tori (``torus`` = (major, minor)
    segments) at ground-truth poses, their masks (rendered by the plain
    edge path) and surface samples as targets."""
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
    verts, faces = _torus(*torus)
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


def phase_fit(results, iters_check=5, iters=50):
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
    r_k2 = fit_poses(init, batch, cam, short)     # the same fit again
    torch.cuda.synchronize()
    fit_again = max(float((a - b).abs().max()) for a, b in zip(r_k.params,
                                                               r_k2.params))
    p_err = max(float((a - b).abs().max()) for a, b in zip(r_k.params, r_p.params))
    l_err = float(((r_k.losses - r_p.losses).abs() / r_p.losses.abs()).max())
    log(f"fit {iters_check} iters kernels vs plain: params max err "
        f"{p_err:.3e} (tol 5e-3), losses max rel err {l_err:.3e} (tol 1e-2)")
    if not (p_err <= 5e-3 and l_err <= 1e-2):
        raise AssertionError("kernel fit disagrees with the plain fit")

    # phase_bus runs phase 6's full 300 iterations; here ``iters``
    full = dataclasses.replace(cfg, max_iterations=iters)
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fit_poses(init, batch, cam, full)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    with torch.no_grad():
        l0 = batch_loss(init, batch, cam, cfg)[1]
    d0 = float((init.translation - gt.translation).norm(dim=-1).mean())
    d1 = float((res.params.translation - gt.translation).norm(dim=-1).mean())
    log(f"fit_poses phase-6 default (8 objects, 2048 faces, 4096 points, "
        f"1024², {iters} of its 300 iterations): {res.num_iters} iters in "
        f"{dt:.2f} s "
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
    fit_split(init, batch, cam, cfg)
    fit_leftovers_check()


# the leftovers fit's limits, card against the CPU: between the sound
# fit's reading (params 1.468e-4, losses 2.045e-3 relative on an H100) and
# the subtler planted fault's, pm_topk 1 (1.108e-3, 7.625e-3); the run
# prints pm_topk 4's, which they need not see
LEFTOVER_PARAM_ERR = 5e-4
LEFTOVER_LOSS_ERR = 4e-3


def fit_leftovers_check(iters=5):
    """The fit's binned SoftRas silhouette (use_binned_raster) and top-k
    point-mesh loss (pm_topk = 16) on the card against the CPU: 4 tori of
    128 faces, 512 target points, 128², 64-px tiles of 128 faces,
    ``iters`` iterations from the same inputs (built on the CPU). Params
    within LEFTOVER_PARAM_ERR and the final losses within LEFTOVER_LOSS_ERR
    relative; then the fit again on the card, bit for bit. Two planted
    faults on the card must each break a limit: pm_topk 1 (the other
    candidates dropped) and the binned silhouette at half its tile budget
    (faces_per_tile // 2: bins that drop faces)."""
    import dataclasses

    import torch

    from regen3d_tpu_torch.pipeline import pose_fit
    from regen3d_tpu_torch.pipeline.pose_fit import fit_poses, raster_path

    batch, cam, cfg, gt = phase6_problem("cpu", size=128, n_obj=4,
                                         n_points=512, torus=(8, 8))
    cfg = dataclasses.replace(
        cfg, use_edge_raster=False, use_binned_raster=True, bin_tile=64,
        faces_per_tile=128, pm_topk=16, point_chunk=512,
        max_iterations=iters, early_stop_min_iters=iters)
    init = phase6_init(gt)
    path = raster_path(cfg, batch.faces.shape[1], "cuda")
    if path != "binned":
        raise AssertionError(f"the leftovers fit took the {path} path")
    on = lambda x: type(x)(*(t.cuda() for t in x))
    card = dataclasses.replace(cam, **{f: getattr(cam, f).cuda() for f in
                                       ("R", "T", "focal", "principal")})
    t0 = time.perf_counter()
    r_c = fit_poses(init, batch, cam, cfg)
    t_cpu = time.perf_counter() - t0

    def against_cpu(r):
        p = max(float((a.cpu() - b).abs().max())
                for a, b in zip(r.params, r_c.params))
        l_ = float(((r.losses.cpu() - r_c.losses).abs()
                    / r_c.losses.abs()).max())
        return p, l_

    runs, ts = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs.append(fit_poses(on(init), on(batch), card, cfg))
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    p_err, l_err = against_cpu(runs[0])
    again = (all(torch.equal(a, b) for a, b in zip(runs[0].params,
                                                  runs[1].params))
             and torch.equal(runs[0].losses, runs[1].losses))
    faults = {"pm_topk 1": against_cpu(fit_poses(
        on(init), on(batch), card, dataclasses.replace(cfg, pm_topk=1)))}
    binned = pose_fit.soft_silhouette_binned
    try:
        pose_fit.soft_silhouette_binned = \
            lambda *a, faces_per_tile, **kw: binned(
                *a, faces_per_tile=faces_per_tile // 2, **kw)
        faults["half the tile budget"] = against_cpu(fit_poses(
            on(init), on(batch), card, cfg))
    finally:
        pose_fit.soft_silhouette_binned = binned
    seen = {k: p > LEFTOVER_PARAM_ERR or l_ > LEFTOVER_LOSS_ERR
            for k, (p, l_) in faults.items()}
    mild = against_cpu(fit_poses(on(init), on(batch), card,
                                 dataclasses.replace(cfg, pm_topk=4)))
    log(f"fit leftovers (use_binned_raster, pm_topk 16; 4 tori of 128 faces, "
        f"512 points, 128², {iters} iterations): card vs CPU params "
        f"{p_err:.3e} (tol {LEFTOVER_PARAM_ERR}), losses {l_err:.3e} "
        f"relative (tol {LEFTOVER_LOSS_ERR}); card {ts[0]:.3f} and "
        f"{ts[1]:.3f} s, CPU {t_cpu:.3f} s; the card's two fits bit for bit "
        f"the same: {again}; planted faults on the card (params, losses) "
        + ", ".join(f"{k} ({p:.3e}, {l_:.3e}) seen: {seen[k]}"
                    for k, (p, l_) in faults.items())
        + f"; pm_topk 4, not gated, ({mild[0]:.3e}, {mild[1]:.3e})")
    if not (p_err <= LEFTOVER_PARAM_ERR and l_err <= LEFTOVER_LOSS_ERR
            and again and all(seen.values())):
        raise AssertionError("the binned/top-k fit: card vs CPU, repeat or "
                             "a planted fault unseen")


def fit_split(init, batch, cam, cfg, short=5, quiet=False):
    """Where a phase-6 iteration's time goes: fits of ``short`` and
    2·``short`` iterations, each once on the host's clock and once under
    torch.profiler; the difference over ``short`` iterations is one
    iteration's wall time, device time and launches, without the fit's
    set-up (bins, final loss). The ten device operations with the most time
    are those of the short fit's window. With ``quiet``, nothing is logged
    and the per-iteration {wall, dev, launches} is returned."""
    import dataclasses

    import torch

    from regen3d_tpu_torch.pipeline.pose_fit import fit_poses

    def fit(n):
        c = dataclasses.replace(cfg, max_iterations=n,
                                early_stop_min_iters=n)
        return lambda: fit_poses(init, batch, cam, c)

    wall, dev, launches = {}, {}, {}
    for n in (short, 2 * short):
        fit(n)()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit(n)()
        torch.cuda.synchronize()
        wall[n] = 1e3 * (time.perf_counter() - t0)
        dev[n], top, launches[n], top_ops = device_top(fit(n), 10)
        if n == short:
            top_short, ops_short = top, top_ops
    per = {k: (v[2 * short] - v[short]) / short
           for k, v in (("wall", wall), ("dev", dev), ("launches", launches))}
    if per["dev"] <= 0:
        raise AssertionError("fit split: no device time recorded")
    def listed(rows):
        return "; ".join(f"{name} {ms:.2f} ms ({ms / dev[short]:.1%}, {c}x)"
                         for ms, name, c in rows)

    if quiet:
        return per
    log(f"phase-6 iteration split ({short} vs {2 * short} iterations): "
        f"wall {per['wall']:.2f} ms, device {per['dev']:.2f} ms "
        f"({per['dev'] / per['wall']:.1%} of wall), {per['launches']:.1f} "
        f"launches an iteration; the {short}-iteration fit: wall "
        f"{wall[short]:.1f} ms, device {dev[short]:.2f} ms, "
        f"{launches[short]} launches; its ten device operations with the "
        f"most time: {listed(top_short)}; by the operator that launched "
        f"them: {listed(ops_short)}")


# phase_bus: a synthetic room on the output bus at phase 6's real size. The
# camera sits at the world origin looking down +z (the view frame is the
# world frame: +x left, +y up); the image is 960×1280 at a 1100-px focal,
# the floor the plane y = −1.2, the back wall z = 8.5.
BUS_HW = (960, 1280)
BUS_FOCAL = 1100.0
BUS_VGGT = 518              # one VGGT frame: 518² points
BUS_FLOOR_Y = -1.2
BUS_WALL_Z = 8.5
BUS_GRID = 29               # each box face an n×n quad grid: ~20k faces/object
# label, boxes (lo, hi) in the asset frame, scale, yaw, (x, z) on the floor
# or (x, y, z) on the wall. Every shape is mirror-symmetric in its x (as
# most furniture is) and has no yaw symmetry; every footprint is oblong
# (ROADMAP Queue 3 r); no yaw is on the 45° search grid. The symmetry
# matters: phase 6 fits on-floor objects in a left-handed plane frame, the
# mirror image (ROADMAP Queue 3 s), which a symmetric shape absorbs.
BUS_OBJECTS = [
    ("sofa", [((-1.0, -0.5, -0.45), (1.0, -0.1, 0.45)),
              ((-1.0, -0.1, 0.25), (1.0, 0.35, 0.45)),
              ((-1.0, -0.1, -0.45), (-0.8, 0.15, 0.25)),
              ((0.8, -0.1, -0.45), (1.0, 0.15, 0.25))], 0.9, 2.0, (2.09, 5.0)),
    ("bench", [((-0.9, -0.25, -0.3), (0.9, 0.1, 0.3)),
               ((-0.9, 0.1, 0.2), (0.9, 0.45, 0.3))], 0.8, 1.15, (1.4, 7.0)),
    ("table", [((-0.8, 0.3, -0.45), (0.8, 0.4, 0.45)),
               ((-0.8, -0.5, -0.45), (-0.7, 0.3, 0.45)),
               ((0.7, -0.5, -0.45), (0.8, 0.3, 0.45)),
               ((-0.7, -0.1, 0.35), (0.7, 0.3, 0.45))], 0.7, -0.4, (-0.2, 5.5)),
    ("cabinet", [((-0.4, -0.6, -0.25), (0.4, 0.6, 0.25)),
                 ((-0.4, 0.45, -0.45), (0.4, 0.6, -0.25))], 0.75, -1.0,
     (-1.65, 7.0)),
    ("chair", [((-0.45, -0.5, -0.35), (0.45, -0.05, 0.35)),
               ((-0.45, -0.05, 0.2), (0.45, 0.5, 0.35))], 0.8, 0.3,
     (-1.87, 4.2)),
    ("shelf", [((-0.6, -0.05, -0.2), (0.6, 0.05, 0.2)),
               ((-0.6, -0.35, 0.1), (0.6, -0.05, 0.2)),
               ((-0.3, 0.05, -0.1), (0.3, 0.35, 0.2))], 0.9, -0.3,
     (0.0, 1.5, 7.9)),
    ("picture", [((-0.5, -0.3, 0.0), (0.5, 0.3, 0.2)),
                 ((-0.3, -0.45, -0.15), (0.3, -0.3, 0.2))], 0.8, 0.35,
     (2.8, 1.3, 7.8)),
    ("speaker", [((-0.25, -0.4, -0.15), (0.25, 0.4, 0.15)),
                 ((-0.15, 0.1, -0.3), (0.15, 0.3, -0.15))], 0.9, 0.5,
     (-2.59, 1.2, 7.8)),
]
# the shapes' own mirror: x → −x in the asset frame
BUS_MIRROR = (-1.0, 1.0, 1.0)
# phase 8's render size on the bus: the default 768 cut to 576, which
# takes the dense z-buffer's ~68 s down by ~40%, for the script's time
# limit; 576 × 768 and 576² stay whole 64-pixel tiles, which the binned
# z-buffer against the dense one needs
BUS_RENDER = 576


def _yaw_matrix(yaw):
    """The pipeline's yaw rotation, applied to row vectors as x @ R."""
    import numpy as np

    c, s = np.cos(yaw), np.sin(yaw)
    return np.asarray([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def _grid_box(lo, hi, n):
    """A closed box mesh from lo to hi, each face an n×n grid of quads
    (12·n² faces), welded."""
    import numpy as np

    from regen3d_tpu_torch.utils.meshproc import weld_vertices

    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    g = np.linspace(0.0, 1.0, n + 1)
    a, b = np.meshgrid(g, g, indexing="ij")
    quad = np.arange((n + 1) * (n + 1)).reshape(n + 1, n + 1)
    q0, q1 = quad[:-1, :-1].ravel(), quad[1:, :-1].ravel()
    q2, q3 = quad[1:, 1:].ravel(), quad[:-1, 1:].ravel()
    verts, faces = [], []
    for axis in range(3):
        u, w = [k for k in range(3) if k != axis]
        for side in (0.0, 1.0):
            p = np.empty((a.size, 3))
            p[:, axis] = side
            p[:, u], p[:, w] = a.ravel(), b.ravel()
            f = np.concatenate([np.stack([q0, q1, q2], -1),
                                np.stack([q0, q2, q3], -1)])
            if (side == 1.0) == (axis == 1):     # outward winding
                f = f[:, ::-1]
            faces.append(f + sum(len(v) for v in verts))
            verts.append(lo + p * (hi - lo))
    return weld_vertices(np.concatenate(verts).astype(np.float32),
                         np.concatenate(faces))


def bus_objects(grid=BUS_GRID):
    """Each object's asset submeshes (name, verts, faces) in its asset frame
    and its true pose: (label, submeshes, boxes, scale, yaw, translation).
    Floor objects stand with their lowest point on the floor."""
    import numpy as np

    out = []
    for label, boxes, scale, yaw, where in BUS_OBJECTS:
        subs = [(f"{label}_{i}", *_grid_box(lo, hi, grid))
                for i, (lo, hi) in enumerate(boxes)]
        if len(where) == 2:
            bottom = min(lo[1] for lo, _ in boxes)
            t = np.asarray([where[0], BUS_FLOOR_Y - scale * bottom, where[1]])
        else:
            t = np.asarray(where, np.float64)
        out.append((label, subs, boxes, scale, yaw, t))
    return out


def _bus_rays(h, w, fy, fx, dev):
    """Unit-depth ray directions (z = 1) through the pixel centres of an
    h×w grid spanning the image, (h·w, 3), the P3D-sign pinhole."""
    import torch

    v, u = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float64),
                          torch.arange(w, device=dev, dtype=torch.float64),
                          indexing="ij")
    x = (w / 2.0 - (u + 0.5)) / fx
    y = (h / 2.0 - (v + 0.5)) / fy
    return torch.stack([x, y, torch.ones_like(x)], -1).reshape(-1, 3)


def bus_cast(objs, h, w, dev):
    """The front-most surface along each pixel's ray of an h×w grid over
    the bus image: (depth (h·w,), id (h·w,)) with ids 0..7 the objects, 8
    the floor and 9 the back wall. Exact ray-box slab tests against the
    objects' boxes, in f64."""
    import torch

    f64 = lambda x: torch.as_tensor(x, dtype=torch.float64, device=dev)
    d = _bus_rays(h, w, BUS_FOCAL * h / BUS_HW[0], BUS_FOCAL * w / BUS_HW[1],
                  dev)
    inf = torch.full((d.shape[0],), float("inf"), dtype=torch.float64,
                     device=dev)
    best = torch.where(d[:, 2] > 0, BUS_WALL_Z / d[:, 2], inf)
    ident = torch.full_like(best, 9, dtype=torch.int64)
    lam = torch.where(d[:, 1] < 0, BUS_FLOOR_Y / d[:, 1], inf)
    take = lam < best
    best, ident = torch.where(take, lam, best), torch.where(take, 8, ident)
    for k, (_label, _subs, boxes, scale, yaw, t) in enumerate(objs):
        Rt = f64(_yaw_matrix(yaw)).T
        o = (-f64(t)) @ Rt / scale            # the camera in the asset frame
        dl = d @ Rt / scale
        dl = torch.where(dl.abs() < 1e-12, torch.full_like(dl, 1e-12), dl)
        for lo, hi in boxes:
            t1, t2 = (f64(lo) - o) / dl, (f64(hi) - o) / dl
            near = torch.minimum(t1, t2).max(-1).values
            far = torch.maximum(t1, t2).min(-1).values
            hit = (far >= near) & (near > 0)
            lam = torch.where(hit, near, inf)
            take = lam < best
            best = torch.where(take, lam, best)
            ident = torch.where(take, k, ident)
    return best, ident


def _quad_mesh(origin, du, dv, n=8):
    """A flat n×n grid of quads from ``origin`` along ``du`` and ``dv``."""
    import numpy as np

    a, b = np.meshgrid(np.linspace(0, 1, n + 1), np.linspace(0, 1, n + 1),
                       indexing="ij")
    v = (np.asarray(origin) + a.reshape(-1, 1) * np.asarray(du)
         + b.reshape(-1, 1) * np.asarray(dv))
    q = np.arange((n + 1) ** 2).reshape(n + 1, n + 1)
    f = np.concatenate([np.stack([q[:-1, :-1], q[1:, :-1], q[1:, 1:]], -1),
                        np.stack([q[:-1, :-1], q[1:, 1:], q[:-1, 1:]], -1)])
    return v.astype(np.float32), f.reshape(-1, 3).astype(np.int32)


def bus_images(objs, hw, dev, gen):
    """(input image, empty room) as uint8 (h, w, 3) of the bus's view: each
    pixel coloured by its front-most surface (objects, floor, back wall),
    darkened with depth, with 2 levels of noise; and the input image's
    bus_cast ids (h, w)."""
    import numpy as np

    # bus_cast's ids: the objects 0..7, the floor 8, the back wall 9
    palette = np.concatenate([gen.integers(30, 220, (8, 3)),
                              [[125, 105, 85], [205, 198, 188]]])
    out = []
    for scene in (objs, []):
        lam, ident = bus_cast(scene, hw[0], hw[1], dev)
        ident = ident.cpu().numpy()
        shade = np.clip(1.0 - 0.04 * lam.cpu().numpy(), 0.5, 1.0)[:, None]
        img = palette[ident] * shade + gen.normal(0, 2, (ident.size, 3))
        out.append(np.clip(img, 0, 255).astype(np.uint8).reshape(*hw, 3))
        if scene:
            ids = ident.reshape(hw)
    return (*out, ids)


def bus_gt_scene(path, objs):
    """The GT scene GLB: every object's asset submeshes at its true pose,
    the floor and the back wall."""
    import numpy as np

    from regen3d_tpu_torch.utils.glb import MeshData, SceneData, save_glb

    meshes = [MeshData(name=f"gt_{name}", vertices=(
        (v * scale) @ _yaw_matrix(yaw) + t).astype(np.float32), faces=f)
        for _label, subs, _boxes, scale, yaw, t in objs
        for name, v, f in subs]
    span = (9.0, 0.0, 0.0)
    for name, (v, f) in (
            ("floor", _quad_mesh((-4.5, BUS_FLOOR_Y, 1.0), span,
                                 (0.0, 0.0, BUS_WALL_Z - 1.0))),
            ("wall", _quad_mesh((-4.5, BUS_FLOOR_Y, BUS_WALL_Z), span,
                                (0.0, 2.5 - BUS_FLOOR_Y, 0.0)))):
        meshes.append(MeshData(name=name, vertices=v, faces=f))
    save_glb(str(path), SceneData(meshes=meshes))


def build_bus(root, dev, hw=BUS_HW, vggt=BUS_VGGT, grid=BUS_GRID,
              room_points=20000, empty_hw=None):
    """Write the synthetic room's inputs under root with the port's
    writers: for phases 5 and 6 camera.npz, the 960×1280 findings (8
    objects and the floor: the input image's pixels on white, as phase 1
    writes them, named by finding_stem), scene_vggt.ply
    (one 518² frame of front-most points with depth noise),
    points_emptyRoom.ply (``room_points`` on the floor and as many on the
    back wall, raw VGGT frame) and one asset GLB per object (a submesh per
    box); for phases 7, 8 and 9 empty_room.png (at ``empty_hw``, by
    default the findings' size), root/input.png (the view with the
    objects), root/gt_scene.glb (the true object meshes, the floor and the
    back wall) and root/sky.hdr (bus_sky, written with the port's
    save_hdr). Phase 9 reads phase 8's render. Returns {stem: (label,
    submeshes, scale, yaw, t)}."""
    import os

    import numpy as np
    import torch

    from regen3d_tpu_torch.artifacts import Artifacts, finding_stem
    from regen3d_tpu_torch.camera import save_camera_npz
    from regen3d_tpu_torch.config import default_config
    from regen3d_tpu_torch.transforms.conventions import (
        blender_to_p3d,
        p3d_to_blender,
    )
    from regen3d_tpu_torch.utils.glb import MeshData, SceneData, save_glb
    from regen3d_tpu_torch.utils.image import save_hdr, save_image
    from regen3d_tpu_torch.utils.ply import save_ply

    art = Artifacts(default_config(str(root / "output")))
    h, w = hw
    focal = BUS_FOCAL * h / BUS_HW[0]
    save_camera_npz(art.camera_npz, p3d_to_blender(np.eye(3), np.zeros(3)),
                    focal, (w, h))
    objs = bus_objects(grid)
    gen = np.random.default_rng(0)

    # the VGGT frame: front-most points, 1 mm of depth noise per metre
    lam, _ = bus_cast(objs, vggt, vggt, dev)
    rays = _bus_rays(vggt, vggt, focal * vggt / h, focal * vggt / w, dev)
    lam = lam.cpu().numpy() * (1.0 + 1e-3 * gen.standard_normal(lam.shape[0]))
    world = rays.cpu().numpy() * lam[:, None]
    R, _ = blender_to_p3d(np.eye(4))          # scene_vggt.ply's frame
    store = world.copy()
    store[:, 1] *= -1
    save_ply(art.scene_cloud_ply, (store @ R).astype(np.float32))
    # the empty room in the raw VGGT frame: world = diag(2, −2, −2)·raw
    n = room_points
    fx, fz = gen.uniform(-4.5, 4.5, n), gen.uniform(1.0, BUS_WALL_Z, n)
    wx, wy = gen.uniform(-4.5, 4.5, n), gen.uniform(BUS_FLOOR_Y, 2.5, n)
    room = np.concatenate([
        np.stack([fx, np.full_like(fx, BUS_FLOOR_Y), fz], -1),
        np.stack([wx, wy, np.full_like(wx, BUS_WALL_Z)], -1)])
    save_ply(art.points_empty_ply, (room / [2.0, -2.0, -2.0]).astype(np.float32))

    # the findings, as phase 1 writes them: the input image's pixels whose
    # front-most surface is the object, on white (no pixel of the image is
    # near white, so phase 5's mask is exactly the object's)
    image, empty, ident = bus_images(objs, hw, dev, gen)
    os.makedirs(art.findings_fullsize, exist_ok=True)
    truth = {}
    for k, label in enumerate([o[0] for o in objs] + ["floor"]):
        mask = ident == k
        ys, xs = np.nonzero(mask)
        stem = finding_stem(label, (round(xs.mean()), round(ys.mean())))
        img = np.full((h, w, 3), 255, np.uint8)
        img[mask] = image[mask]
        save_image(os.path.join(art.findings_fullsize, f"{stem}.png"), img)
        if k < len(objs):
            _label, subs, _boxes, scale, yaw, t = objs[k]
            save_glb(art.asset_glb(stem), SceneData(meshes=[
                MeshData(name=name, vertices=v, faces=f)
                for name, v, f in subs]))
            truth[stem] = (label, subs, scale, yaw, t)
    save_image(str(root / "input.png"), image)
    if empty_hw is not None:
        _, empty, _ = bus_images(objs, empty_hw, dev, gen)
    save_image(art.empty_room, empty)
    bus_gt_scene(root / "gt_scene.glb", objs)
    save_hdr(str(root / "sky.hdr"), bus_sky())
    return truth


def bus_sky(h=256, w=512):
    """A synthetic equirect HDRI (h × w, linear): a sky from a bright
    horizon to a deeper zenith above, a darker ground below, brighter
    towards one longitude."""
    import numpy as np

    v = (np.arange(h) + 0.5)[:, None] / h             # 0 zenith, 1 nadir
    u = (np.arange(w) + 0.5)[None, :] / w
    sky = np.stack([0.5 + 0.7 * v, 0.7 + 0.6 * v, 1.4 + 0.4 * v], -1)
    ground = np.broadcast_to(np.asarray([0.35, 0.3, 0.25]), (h, 1, 3))
    img = np.where(v[..., None] < 0.5, sky, ground)
    return (img * (1.0 + 0.3 * np.cos(2 * np.pi * u))[..., None]).astype(
        np.float32)


def bus_pose_errors(glb_path, truth):
    """(translation error m, rotation error °) of a fitted GLB against the
    true pose: the distance between the centroids of its vertices and of
    the asset's vertices at the true pose, and the angle of the rotation
    that best maps the one set onto the other (Kabsch; vertices correspond
    one to one, submeshes matched by name), the lesser over the shape and
    its mirror image (BUS_MIRROR), whose surfaces are the same."""
    import numpy as np

    from regen3d_tpu_torch.utils.glb import load_glb

    _label, subs, scale, yaw, t = truth
    got = {m.name: m.vertices for m in load_glb(glb_path).meshes}
    fit = np.concatenate([got[name] for name, _v, _f in subs]).astype(np.float64)
    a = fit - fit.mean(0)
    errs = []
    # the true pose, and the true pose of the shape's mirror image (the
    # same surface, its vertices swapped with their mirror partners)
    for mirror in ((1.0, 1.0, 1.0), BUS_MIRROR):
        ref = np.concatenate([(v * mirror * scale) @ _yaw_matrix(yaw) + t
                              for _name, v, _f in subs])
        b = ref - ref.mean(0)
        u, _s, vt = np.linalg.svd(a.T @ b)
        d = np.sign(np.linalg.det(u @ vt))
        rot = u @ np.diag([1.0, 1.0, d]) @ vt
        angle = np.degrees(np.arccos(np.clip((np.trace(rot) - 1) / 2, -1, 1)))
        errs.append((float(np.linalg.norm(fit.mean(0) - ref.mean(0))),
                     float(angle)))
    return min(errs, key=lambda e: e[1])


class _StageLog:
    """Context manager: the last "stage breakdown" record a phase module
    logs, its args: phase 6's (floor/cam, prep, fit, export, gif/debug s,
    objects), phase 7's (intrinsics, combine, backproject, background,
    align s), phase 8's (load, cam1, cam2, debug s)."""

    def __init__(self, phase=6):
        self.name = {6: "regen3d_tpu_torch.pipeline.phase6_pose",
                     7: "regen3d_tpu_torch.pipeline.phase7_assemble",
                     8: "regen3d_tpu_torch.pipeline.phase8_render"}[phase]
        self.prefix = f"phase{phase}: stage breakdown"

    def __enter__(self):
        import logging

        self.args = None
        outer = self

        class Handler(logging.Handler):
            def emit(self, record):
                if str(record.msg).startswith(outer.prefix):
                    outer.args = record.args

        self.logger = logging.getLogger(self.name)
        self.level = self.logger.level
        self.handler = Handler()
        self.logger.addHandler(self.handler)
        self.logger.setLevel(logging.INFO)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)


class _CallSpy:
    """Stands in for a function and records each call's wall seconds (the
    device synchronized at both ends), peak device bytes, arguments and
    result; the function itself is unchanged."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kwargs):
        import torch

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        torch.cuda.synchronize()
        self.calls.append(dict(s=time.perf_counter() - t0, args=args,
                               kwargs=kwargs, out=out,
                               peak=torch.cuda.max_memory_allocated()))
        return out


def _bus_phases(cfg, spy, phases=(5, 6), spies=None, spy8=None):
    """run_phases(cfg, phases) on the card with phase 6's fit recorded by
    ``spy``, for phases 7 and 9 ICP and the bake by ``spies``, and phase
    8's z-buffer (rasterize_hard_auto, one call a view) by ``spy8`` (each a
    _CallSpy); returns ({phase: s}, phase 6's stage breakdown, phase 7's,
    phase 8's)."""
    import torch

    from regen3d_tpu_torch import orchestrator
    from regen3d_tpu_torch.pipeline import (
        phase6_pose,
        phase7_assemble,
        phase8_render,
        texture,
    )

    saved = (phase6_pose.fit_poses, phase7_assemble.iterative_closest_point,
             texture.bake_vertex_colors, phase8_render.rasterize_hard_auto)
    phase6_pose.fit_poses = spy
    if spies is not None:
        (phase7_assemble.iterative_closest_point,
         texture.bake_vertex_colors) = spies
    if spy8 is not None:
        phase8_render.rasterize_hard_auto = spy8
    try:
        with _StageLog(6) as stages6, _StageLog(7) as stages7, \
                _StageLog(8) as stages8:
            timings = orchestrator.run_phases(cfg, list(phases), device="cuda")
            torch.cuda.synchronize()
    finally:
        (phase6_pose.fit_poses, phase7_assemble.iterative_closest_point,
         texture.bake_vertex_colors, phase8_render.rasterize_hard_auto) = saved
    return timings, stages6.args, stages7.args, stages8.args


def bus_frame_check(batch, fit_cfg, cam, flat, n_obj=4):
    """One fit-GIF frame batch (_write_gifs' renderer, 160 px high) of the
    first ``n_obj`` objects on the card against the CPU (whose path the
    tests hold to the JAX package): Phong colours
    within 1e-3, face ids equal except where two faces lie at the same
    depth within f32 rounding (1e-5 relative). Returns (colour error,
    pixels with another face id, pixels covered)."""
    import dataclasses

    import torch

    from regen3d_tpu_torch.pipeline.phase6_pose import render_fit_frame

    sub = batch._replace(**{f: getattr(batch, f)[:n_obj] for f in batch._fields
                            if f not in ("bbox_lo", "bbox_hi")})
    h = 160
    w = int(round(cam.image_size[1] * h / cam.image_size[0]))
    gcam = cam.rescaled(h, w)
    img_g, frag_g = render_fit_frame(flat[:n_obj], sub, fit_cfg, gcam)
    cam_c = dataclasses.replace(gcam, **{f: getattr(gcam, f).cpu()
                                         for f in ("R", "T", "focal",
                                                   "principal")})
    img_c, frag_c = render_fit_frame(flat[:n_obj].cpu(),
                                     type(sub)(*(x.cpu() for x in sub)),
                                     fit_cfg, cam_c)
    err = float((img_g.cpu() - img_c).abs().max())
    other = frag_g.face_idx.cpu() != frag_c.face_idx
    zg, zc = frag_g.depth.cpu()[other], frag_c.depth[other]
    ties = bool(((zg - zc).abs() <= 1e-5 * zc.abs()).all())
    covered = int((frag_c.face_idx >= 0).sum())
    if not (err <= 1e-3 and ties and covered > 0):
        raise AssertionError(
            f"fit frame: card vs CPU colour error {err:.3e} (tol 1e-3), "
            f"{int(other.sum())} pixels with another face, z-ties only: {ties}")
    return err, int(other.sum()), covered


def _glb_vertices(path):
    """A GLB's vertices, submeshes in name order."""
    import numpy as np

    from regen3d_tpu_torch.utils.glb import load_glb

    meshes = sorted(load_glb(str(path)).meshes, key=lambda m: m.name)
    return np.concatenate([m.vertices for m in meshes])


def bus_small_check():
    """Phases 5 and 6 on a small bus (240×320 findings, a 160² VGGT frame,
    boxes of 6×6-quad faces; 96 × 128 renders, 128 faces, 5 iterations,
    masks eroded by 1 px) on the card against the CPU, whose path the CPU
    tests hold to the JAX package; RANSAC takes the same draw on both.
    Returns (largest share of cloud points found on one device only, least
    |cos| between two normals of one point, share of points whose normals
    agree within 1e-5, largest fitted-vertex difference over its
    tolerance, largest fitted-vertex difference between two card runs of
    phase 6 on the same phase-5 outputs). Points project through the camera in another rounding
    (cuBLAS fuses the products), and neighbours whose distances tie within
    rounding rank either way: the clouds may differ by a few points and a
    normal where its neighbourhood does. The fits may differ by one Adam
    step of lr on the translation and on the yaw parameter (× 8), as
    against the JAX package (ROADMAP Queue 3 g)."""
    import shutil

    import numpy as np
    import torch

    from regen3d_tpu_torch import orchestrator
    from regen3d_tpu_torch.config import default_config
    from regen3d_tpu_torch.pipeline import phase6_pose
    from regen3d_tpu_torch.utils.ply import load_ply

    root = ROOT / "build" / "bus_small"
    shutil.rmtree(root, ignore_errors=True)
    truth = build_bus(root / "bus", "cpu", hw=(240, 320), vggt=160, grid=6,
                      room_points=4000, empty_hw=(120, 160))
    over = dict(write_fit_gifs=False, image_size_DR=96, fit_max_faces=128,
                fit_max_points=512, max_iterations=5,
                early_stop_min_iterations=5, mask_shrink_pixels=1,
                mask_shrink_iterations=1)
    devs = ("cuda", "cpu")
    cfgs = {}
    for d in devs:
        shutil.copytree(root / "bus", root / d)
        cfgs[d] = default_config(str(root / d / "output"), **over)
        orchestrator.run_phases(cfgs[d], [5], device=d)
    clouds = root / "cpu" / "output" / "pointclouds"
    floor = [f for f in clouds.iterdir() if f.name.startswith("floor")][0]
    n_floor = len(load_ply(str(floor)).vertices)
    gen = torch.Generator().manual_seed(int(cfgs["cpu"]["seed"]))
    idx = torch.randint(0, n_floor, (2000, 3), generator=gen)
    lr = float(cfgs["cpu"]["learning_rate"])
    only, cos_min, agree, worst = 0.0, 1.0, 1.0, 0.0
    for stem in list(truth) + [floor.stem]:
        p = {d: load_ply(str(root / d / "output" / "pointclouds"
                             / "normals" / f"{stem}_normals.ply"))
             for d in devs}
        rows = {d: {tuple(v): i for i, v in enumerate(p[d].vertices)}
                for d in devs}
        both = sorted(set(rows["cuda"]) & set(rows["cpu"]))
        only = max(only, 1.0 - len(both) / max(len(rows["cpu"]), 1))
        ng = p["cuda"].normals[[rows["cuda"][v] for v in both]]
        nc = p["cpu"].normals[[rows["cpu"][v] for v in both]]
        cos = np.abs((ng * nc).sum(-1))
        cos_min = min(cos_min, float(cos.min()))
        agree = min(agree, float((np.abs(ng - nc).max(-1) <= 1e-5).mean()))
    # phase 6 a second time on the card from the same phase-5 outputs
    shutil.copytree(root / "cuda", root / "cuda2")
    cfgs["cuda2"] = default_config(str(root / "cuda2" / "output"), **over)
    for d, dev in (("cuda", "cuda"), ("cpu", "cpu"), ("cuda2", "cuda")):
        phase6_pose.run(cfgs[d], device=dev, ransac_idx=idx.to(dev))
    again = max(float(np.abs(
        _glb_vertices(root / "cuda" / "output" / "glb" / f"{stem}.glb")
        - _glb_vertices(root / "cuda2" / "output" / "glb" / f"{stem}.glb")
    ).max()) for stem in truth)
    same = [(root / "cuda" / "output" / "glb" / f"{stem}.glb").read_bytes()
            == (root / "cuda2" / "output" / "glb" / f"{stem}.glb").read_bytes()
            for stem in truth]
    if not all(same):
        raise AssertionError(f"small bus: two card runs of phase 6 wrote "
                             f"other GLBs for {same.count(False)} objects "
                             f"({again:.3e} apart)")
    for stem in truth:
        vg, vc = (_glb_vertices(root / d / "output" / "glb" / f"{stem}.glb")
                  for d in devs)
        r = np.linalg.norm(vc - vc.mean(0), axis=-1).max()
        tol = 2 * lr * (1 + 8.0 * r)
        worst = max(worst, float(np.abs(vg - vc).max()) / tol)
    if not (only <= 0.005 and agree >= 0.98 and worst <= 1.0):
        raise AssertionError(
            f"small bus, card vs CPU: {only:.3%} of a cloud on one device "
            f"only (tol 0.5%), {agree:.3%} of normals within 1e-5 (tol "
            f"98%), fitted vertices at {worst:.2f} of one Adam step")
    return (only, cos_min, agree, worst, again), bus79_small(root)


def icp_grid_check(n_side=16, iters=30):
    """ICP on the card against the CPU on clouds whose nearest neighbours
    are unambiguous (tests/test_torch_eval_ops.py's construction at n_side³
    points: a jittered grid of spacing 0.1 and the same points turned 3°,
    scaled 1.02 and moved 0.01, with 1 mm of noise, so each point's partner
    is 10× closer than any other point), ``iters`` iterations with and
    without scale: R, t, s and the aligned cloud within 1e-5. Returns the
    largest difference."""
    import numpy as np
    import torch

    from regen3d_tpu_torch.ops.icp import iterative_closest_point

    gen = np.random.default_rng(0)
    n = n_side ** 3
    g = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"), -1)
    src = (g.reshape(-1, 3) * 0.1 + gen.uniform(-0.01, 0.01, (n, 3)))
    a = np.radians(3.0)
    rot = np.asarray([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]])
    dst = (src @ rot * 1.02 + [0.01, -0.005, 0.008]
           + gen.normal(size=src.shape) * 1e-3)
    worst = 0.0
    for scale in (False, True):
        res = {d: iterative_closest_point(
            torch.tensor(src, dtype=torch.float32, device=d),
            torch.tensor(dst, dtype=torch.float32, device=d),
            max_iterations=iters, estimate_scale=scale,
            relative_rmse_thr=-1.0) for d in ("cuda", "cpu")}
        for f in ("R", "t", "s", "aligned"):
            worst = max(worst, float((getattr(res["cuda"], f).cpu()
                                      - getattr(res["cpu"], f)).abs().max()))
    if worst > 1e-5:
        raise AssertionError(f"ICP on the card vs the CPU, unambiguous "
                             f"neighbours: {worst:.2e} (tol 1e-5)")
    return worst


def bus79_small(root):
    """Phases 7 and 9 on the small bus's CPU phase-6 outputs, once on the
    card and once on the CPU (4,096 samples, a 32³ Poisson grid baked from
    a 120×160 empty room, 30 ICP iterations), both sampling from the same
    CPU draws. Phase 7: the combined GLB and the backprojected PLY
    identical; ground_aligned.glb within a Chamfer distance of 1e-3 of a
    Poisson cell, 95% of its vertices within 1e-4 of a cell of the CPU's
    with colours within 1e-4; the GT points within 1e-5; the ICP-aligned
    prediction and the ICP transform within 1e-4: the card's cuBLAS rounds
    the distance expansion otherwise than the CPU, so correspondences at
    near-ties go either way (ROADMAP Queue 3 u), which icp_grid_check
    excludes to hold ICP itself to 1e-5. Phase 9 on both reads the CPU's
    background mesh and pred/GT points: its ten cloud metrics and PSNR
    within 1e-5 relative, SSIM 1e-4 (Queue 3 x). The three
    scene-incl-background metrics sample and run ICP again, so they take
    the aligned prediction's bound: a mean or RMS nearest-neighbour
    distance moves by at most the largest point displacement, so the
    Chamfer distance and the RMSE within 1e-4 absolute, and the F-score
    within 1e-3 relative (a point of 4,096 crossing τ moves it by 2.4e-4).
    Between phases 7 and 9, phase 8 on both devices from the CPU's phase-7
    outputs (bus8_small); phase 9 on both reads the CPU's render.
    A faulty ICP on the CPU (icp_fault_readings) must move the aligned
    prediction, the transform, the scene Chamfer distance and the RMSE past
    their limits when it stops after one step or transposes its rotation;
    its F-score reading and that of a dropped last step are printed only.
    Returns its worst numbers and the fault readings."""
    import shutil

    import numpy as np
    from scipy.spatial import cKDTree

    from regen3d_tpu_torch import orchestrator
    from regen3d_tpu_torch.artifacts import Artifacts
    from regen3d_tpu_torch.config import default_config
    from regen3d_tpu_torch.transforms.conventions import vggt_raw_to_world
    from regen3d_tpu_torch.utils.glb import load_glb
    from regen3d_tpu_torch.utils.ply import load_ply

    devs = ("cuda", "cpu")
    cfg, art = {}, {}
    for d in devs:
        r = root / f"{d}79"
        shutil.copytree(root / "cpu", r)
        cfg[d] = default_config(str(r / "output"), write_fit_gifs=False,
                                num_samples=4096,
                                background_poisson_resolution=32,
                                icp_max_iterations=30,
                                GT_scene=str(r / "gt_scene.glb"),
                                input_image=str(r / "input.png"),
                                hdri_path=str(r / "sky.hdr"),
                                render_resolution=96,
                                render_pointclouds=True, render_GT=True)
        art[d] = Artifacts(cfg[d])
        orchestrator.run_phases(cfg[d], [7], device=d)
    card = root / "cuda79" / "card"
    card.mkdir()
    for name in ("ground_aligned_glb", "pred_points_ply", "gt_points_ply"):
        shutil.copyfile(getattr(art["cuda"], name),
                        card / Path(getattr(art["cuda"], name)).name)
        shutil.copyfile(getattr(art["cpu"], name), getattr(art["cuda"], name))
    p8, bad8 = bus8_small(cfg, art, devs)
    shutil.copyfile(art["cpu"].predicted_image, art["cuda"].predicted_image)
    for d in devs:
        orchestrator.run_phases(cfg[d], [9], device=d)

    bad = list(bad8)
    for name in ("combined_scene_glb", "combined_scene_bp_ply"):
        a, b = (Path(getattr(art[d], name)).read_bytes() for d in devs)
        if a != b:
            bad.append(f"{name} differs")
    (mg,) = load_glb(str(card / "ground_aligned.glb")).meshes
    (mc,) = load_glb(art["cpu"].ground_aligned_glb).meshes
    pts = vggt_raw_to_world(load_ply(art["cpu"].points_empty_ply).vertices,
                            float(cfg["cpu"]["vggt_scene_scale"]))
    cell = float(np.ptp(pts, 0).max()) * 1.2 / 31    # the Poisson cell
    d_gc, i_gc = cKDTree(mc.vertices).query(mg.vertices)
    d_cg, _ = cKDTree(mg.vertices).query(mc.vertices)
    chamfer = 0.5 * (d_gc.mean() + d_cg.mean()) / cell
    near = d_gc <= 1e-4 * cell
    colour = (float(np.abs(mg.vertex_colors[near]
                           - mc.vertex_colors[i_gc[near]]).max())
              if mg.vertex_colors is not None and near.any() else np.inf)
    if not (chamfer <= 1e-3 and near.mean() >= 0.95 and colour <= 1e-4):
        bad.append(f"background: Chamfer {chamfer:.2e} of a cell, "
                   f"{near.mean():.2%} matched, colour {colour:.2e}")
    gt_err, pred_err = (float(np.abs(
        load_ply(str(card / Path(getattr(art["cpu"], name)).name)).vertices
        - load_ply(getattr(art["cpu"], name)).vertices).max())
        for name in ("gt_points_ply", "pred_points_ply"))
    xg, xc = (np.load(Path(art[d].pred_points_ply).parent
                      / "icp_transform.npz") for d in devs)
    icp_err = max(float(np.abs(xg[k] - xc[k]).max()) for k in xc.files)
    if not (gt_err <= 1e-5 and pred_err <= 1e-4 and icp_err <= 1e-4):
        bad.append(f"GT points {gt_err:.2e} (tol 1e-5), aligned prediction "
                   f"{pred_err:.2e}, ICP transform {icp_err:.2e} (tol 1e-4)")
    grid_err = icp_grid_check()
    mg9, mc9 = (json.loads(next(Path(art[d].eval_dir).glob(
        "*/metrics.json")).read_text()) for d in devs)
    absolute = ("scene_chamfer_incl_bg", "scene_icp_rmse_incl_bg")
    rel = {k: abs(mg9[k] - mc9[k]) / (1.0 if k in absolute
                                      else max(abs(mc9[k]), 1e-9))
           for k in mc9}
    tol = {k: 1e-4 if k in absolute or k == "ssim"
           else 1e-3 if k == "scene_fscore_incl_bg" else 1e-5 for k in mc9}
    over = {k: f"{rel[k]:.2e}" for k in mc9 if rel[k] > tol[k]}
    if sorted(mg9) != sorted(mc9) or over:
        bad.append(f"metrics: keys {sorted(mg9) == sorted(mc9)}, over their "
                   f"tolerance {over}")
    faults = icp_fault_readings(cfg["cpu"])
    limits = dict(pred=1e-4, icp=1e-4, chamfer=1e-4, rmse=1e-4)
    for k, lim in limits.items():
        least = min(faults[f][k] for f in ("one step", "R transposed"))
        if not least > lim:
            bad.append(f"a faulty ICP moves {k} by {least:.2e}, within its "
                       f"limit {lim:.0e}")
    if bad:
        raise AssertionError("small bus phases 7 and 9, card vs CPU: "
                             + "; ".join(bad))
    return dict(chamfer=chamfer, colour=colour, gt=gt_err, pred=pred_err,
                icp=icp_err, icp_grid=grid_err, metrics=rel, faults=faults,
                phase8=p8)


def bus8_small(cfg, art, devs):
    """Phase 8 on the small bus on each device from the same inputs (the
    CPU's phase-7 outputs; 96 × 128 and 96² renders, the point-cloud and
    GT renders on, the bus's HDRI): each render_view call (cam1, cam2 and
    the GT scene from both) with the hit mask identical and the linear
    image within 1e-4 (relative above 1), and every PNG within one level.
    Returns ({hit pixels, linear error, PNG levels, renders, the views'
    paths}, the gates that failed)."""
    import os

    import numpy as np

    from regen3d_tpu_torch import orchestrator
    from regen3d_tpu_torch.pipeline import phase8_render as p8
    from regen3d_tpu_torch.utils.image import read_png

    views, paths = {}, []
    real, real_auto = p8.render_view, p8.rasterize_hard_auto

    def auto(vs, faces, hw, *a, **kw):
        from regen3d_tpu_torch.ops.rasterize import hard_raster_path

        if vs.is_cuda:
            paths.append(hard_raster_path(vs, faces, hw).path)
        return real_auto(vs, faces, hw, *a, **kw)

    for d in devs:
        spy = _CallSpy(real)
        p8.render_view, p8.rasterize_hard_auto = spy, auto
        try:
            orchestrator.run_phases(cfg[d], [8], device=d)
        finally:
            p8.render_view, p8.rasterize_hard_auto = real, real_auto
        views[d] = [c["out"] for c in spy.calls]
    bad = []
    if len(views["cuda"]) != 4 or len(views["cpu"]) != 4:
        bad.append(f"render_view calls {[len(v) for v in views.values()]}, "
                   f"4 wanted")
    hits = sum(int((g[1] != c[1]).sum())
               for g, c in zip(views["cuda"], views["cpu"]))
    lin = max(float((np.abs(g[0] - c[0]) / np.maximum(np.abs(c[0]), 1.0))
                    .max()) for g, c in zip(views["cuda"], views["cpu"]))
    names = sorted(os.listdir(art["cpu"].rendering_dir))
    level = max(int(np.abs(
        read_png(os.path.join(art["cuda"].rendering_dir, n))[0].astype(int)
        - read_png(os.path.join(art["cpu"].rendering_dir, n))[0].astype(int)
    ).max()) for n in names)
    if not (hits == 0 and lin <= 1e-4 and level <= 1 and len(names) == 11
            and names == sorted(os.listdir(art["cuda"].rendering_dir))):
        bad.append(f"phase 8 card vs CPU: {hits} hit pixels differ, linear "
                   f"{lin:.2e} (tol 1e-4), PNGs {level} levels (tol 1), "
                   f"{len(names)} renders")
    return dict(hits=hits, linear=lin, level=level, renders=len(names),
                paths=paths), bad


def icp_fault_readings(cfg):
    """How far a faulty ICP moves what bus79_small holds to its limits, on
    the CPU from ``cfg``'s sound phase-7 outputs (the small bus's): ICP
    stopped after its first step, its rotation transposed at every step (a
    row/column mix-up), and its last step dropped. For each fault, as
    bus79_small measures card against CPU: the aligned prediction's and the
    ICP transform's largest difference from the sound run's, the scene
    Chamfer distance's and RMSE's absolute and the scene F-score's relative
    difference. Overwrites the phase-7 outputs; returns {fault: {reading:
    value}}."""
    import numpy as np

    from regen3d_tpu_torch.artifacts import Artifacts
    from regen3d_tpu_torch.ops import icp
    from regen3d_tpu_torch.pipeline import phase7_assemble
    from regen3d_tpu_torch.utils.ply import load_ply

    art = Artifacts(cfg)
    xfile = Path(art.pred_points_ply).parent / "icp_transform.npz"
    pred0 = load_ply(art.pred_points_ply).vertices
    x0 = dict(np.load(xfile))
    m0 = phase7_assemble.scene_vs_gt_metrics(cfg, device="cpu")
    real, real_umeyama = phase7_assemble.iterative_closest_point, icp.umeyama

    def transposed(*args, **kwargs):
        R, t, s = real_umeyama(*args, **kwargs)
        return R.T, t, s

    def steps(k):
        def run(src, dst, **kwargs):
            n = k if k > 0 else real(src, dst, **kwargs).num_iters + k
            return real(src, dst, **{**kwargs, "max_iterations": n})
        return run

    faults = {"one step": (steps(1), real_umeyama),
              "R transposed": (real, transposed),
              "last step dropped": (steps(-1), real_umeyama)}
    out = {}
    for name, (fn, um) in faults.items():
        phase7_assemble.iterative_closest_point, icp.umeyama = fn, um
        try:
            phase7_assemble.align_and_export(cfg, device="cpu")
            m = phase7_assemble.scene_vs_gt_metrics(cfg, device="cpu")
        finally:
            phase7_assemble.iterative_closest_point = real
            icp.umeyama = real_umeyama
        x = np.load(xfile)
        out[name] = dict(
            pred=float(np.abs(load_ply(art.pred_points_ply).vertices
                              - pred0).max()),
            icp=max(float(np.abs(x[k] - x0[k]).max()) for k in x0),
            chamfer=abs(m["scene_chamfer_incl_bg"]
                        - m0["scene_chamfer_incl_bg"]),
            rmse=abs(m["scene_icp_rmse_incl_bg"]
                     - m0["scene_icp_rmse_incl_bg"]),
            fscore=abs(m["scene_fscore_incl_bg"] - m0["scene_fscore_incl_bg"])
            / max(abs(m0["scene_fscore_incl_bg"]), 1e-9))
    return out


EVAL_KEYS = {"chamfer_p3d", "chamfer_pcu", "hausdorff", "fscore",
             "precision_tau", "recall_tau", "precision_001", "recall_001",
             "volume_iou_bbox", "wasserstein", "scene_chamfer_incl_bg",
             "scene_fscore_incl_bg", "scene_icp_rmse_incl_bg", "psnr", "ssim"}


def bus79_main(main, spies, stages7, timings):
    """Phases 7 and 9 of the counted bus run (``main`` its root; ``spies``
    the ICP and bake _CallSpy): prints one line and returns the gates that
    failed. Beside the run: two Poisson solves of the room's points are
    bit for bit the same (the splat is deterministic), a 20-iteration
    ICP at the run's clouds is split into wall and device time, and the
    alignment's ICP runs again at its own inputs (printed: whether it
    repeats bit for bit). ICP's
    initial alignment is the one it starts from (centroids matched, scale
    1); its RMSE there is the nearest-neighbour RMSE of the shifted
    prediction."""
    import numpy as np
    import torch

    from regen3d_tpu_torch.artifacts import Artifacts
    from regen3d_tpu_torch.config import default_config
    from regen3d_tpu_torch.ops import full_f32
    from regen3d_tpu_torch.ops.icp import iterative_closest_point
    from regen3d_tpu_torch.ops.knn import nn_distances
    from regen3d_tpu_torch.ops.poisson import poisson_indicator
    from regen3d_tpu_torch.transforms.conventions import vggt_raw_to_world
    from regen3d_tpu_torch.utils.glb import load_glb
    from regen3d_tpu_torch.utils.ply import load_ply

    art = Artifacts(default_config(str(main / "output")))
    icp, bake = spies
    bad = []
    exists = lambda p: Path(p).exists()
    combined = (load_glb(art.combined_scene_glb).meshes
                if exists(art.combined_scene_glb) else [])
    objects = {m.name.split("/")[0] for m in combined}
    if len(objects) != 8 or not exists(art.combined_scene_bp_ply):
        bad.append(f"{len(objects)} objects in combined_scene.glb, "
                   f"combined_scene_bp.ply there: "
                   f"{exists(art.combined_scene_bp_ply)}")
    bg = (load_glb(art.ground_aligned_glb).meshes[0]
          if exists(art.ground_aligned_glb) else None)
    if (bg is None or len(bg.faces) == 0 or bg.vertex_colors is None
            or len(bake.calls) != 1):
        bad.append("ground_aligned.glb missing, empty or not baked")
    rows = [len(load_ply(p).vertices) if exists(p) else 0
            for p in (art.pred_points_ply, art.gt_points_ply)]
    transform = Path(art.pred_points_ply).parent / "icp_transform.npz"
    if rows != [60000, 60000] or not transform.exists():
        bad.append(f"pred/gt points {rows}, icp_transform.npz there: "
                   f"{transform.exists()}")
    if len(icp.calls) != 2:
        bad.append(f"{len(icp.calls)} ICP calls, 2 wanted")
        return bad
    src, dst = icp.calls[0]["args"][:2]
    with torch.no_grad(), full_f32():
        d0, _ = nn_distances(src - src.mean(0) + dst.mean(0), dst)
    rmse0 = float(d0.mean().sqrt())
    rmse = float(icp.calls[0]["out"].rmse)
    if not (np.isfinite(rmse) and rmse <= rmse0):
        bad.append(f"ICP rmse {rmse:.5f} against {rmse0:.5f} initially")
    found = sorted(Path(art.eval_dir).glob("*/metrics.json"))
    metrics = json.loads(found[-1].read_text()) if found else {}
    if set(metrics) != EVAL_KEYS or not all(np.isfinite(v)
                                            for v in metrics.values()):
        bad.append(f"metrics.json keys {sorted(metrics)}")

    # the Poisson splat sorts instead of adding atomically: two solves on
    # the room's points (random unit normals) are bit for bit the same
    gen = torch.Generator(device="cuda").manual_seed(5)
    room = torch.as_tensor(vggt_raw_to_world(
        load_ply(art.points_empty_ply).vertices, 2.0), dtype=torch.float32,
        device="cuda")
    nrm = torch.randn(room.shape, generator=gen, device="cuda")
    nrm = nrm / nrm.norm(dim=-1, keepdim=True)
    chi = [poisson_indicator(room, nrm, 128)[0] for _ in range(2)]
    if not torch.equal(chi[0], chi[1]):
        bad.append("two Poisson solves differ")

    # 20 iterations at the same clouds: wall time against device time
    run20 = lambda: iterative_closest_point(src, dst, max_iterations=20,
                                            relative_rmse_thr=-1.0)
    run20()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run20()
    torch.cuda.synchronize()
    wall20 = 1e3 * (time.perf_counter() - t0) / 20
    dev20 = device_top(run20, 0)[0] / 20
    # the alignment's ICP again at its own inputs and knobs
    first = icp.calls[0]["out"]
    again = iterative_closest_point(*icp.calls[0]["args"],
                                    **icp.calls[0]["kwargs"])
    stable = again.num_iters == first.num_iters and all(
        torch.equal(getattr(again, f), getattr(first, f))
        for f in ("R", "t", "s", "rmse", "aligned"))
    i_s, c_s, b_s, bg_s, a_s = stages7 or (float("nan"),) * 5
    per = "; ".join(
        f"{what} {c['out'].num_iters} iterations in {c['s']:.3f} s, "
        f"{1e3 * c['s'] / max(c['out'].num_iters, 1):.2f} ms an iteration, "
        f"rmse {float(c['out'].rmse):.5f}"
        for what, c in zip(("align", "scene incl. background"), icp.calls))
    b = bake.calls[0] if bake.calls else dict(s=float("nan"), peak=0)
    log(f"bus phases 7 and 9 (60,000 samples, Poisson 128³, ICP ≤ 200 "
        f"iterations): phase 7 {timings[7]:.2f} s (intrinsics {i_s:.3f}, "
        f"combine {c_s:.3f}, backproject {b_s:.3f}, background {bg_s:.3f}, "
        f"align {a_s:.3f} s), phase 9 {timings[9]:.2f} s; ICP: {per}; "
        f"initial rmse {rmse0:.5f}; the alignment's ICP again: "
        f"{again.num_iters} iterations, bit for bit the same: {stable}; "
        f"20 ICP iterations at {src.shape[0]} × "
        f"{dst.shape[0]} points: {wall20:.2f} ms wall, {dev20:.2f} ms device "
        f"an iteration; background mesh {len(bg.vertices) if bg else 0} "
        f"vertices, {len(bg.faces) if bg else 0} faces, its bake "
        f"{b['s']:.3f} s at peak {b['peak'] / 2**30:.2f} GiB; metrics "
        + ", ".join(f"{k} {metrics[k]:.5g}" for k in sorted(metrics)))
    return bad


def bus8_main(main, spy8, stages8, timings):
    """Phase 8 of the counted bus run (``main`` its root; ``spy8`` the
    _CallSpy on its z-buffer, one call a view): prints one line and returns
    the gates that failed. The three renders and temp/blender_scene.npz
    must be written and cam1 must cover at least 30% of its pixels; for
    each view the line gives the path the dispatcher chose
    (hard_raster_path: dense or binned, kmax, K), the faces, the z-buffer's
    seconds and the hit fraction."""
    from regen3d_tpu_torch.artifacts import Artifacts
    from regen3d_tpu_torch.config import default_config
    from regen3d_tpu_torch.ops.rasterize import hard_raster_path

    art = Artifacts(default_config(str(main / "output")))
    bad = []
    want = [Path(art.rendering_dir) / n for n in (
        "render_cam1.png", "render_cam1_white_bg.png", "render_cam2.png")]
    want.append(Path(art.temp) / "blender_scene.npz")
    missing = [str(p) for p in want if not p.exists()]
    if missing:
        bad.append(f"missing {missing}")
    if len(spy8.calls) != 2:
        bad.append(f"{len(spy8.calls)} z-buffer calls, 2 wanted")
        return bad
    views = []
    for tag, call in zip(("cam1", "cam2"), spy8.calls):
        vs, faces, hw = call["args"][:3]
        path = hard_raster_path(vs, faces, hw)
        hit = float((call["out"].face_idx >= 0).float().mean())
        views.append((tag, hw, faces.shape[1], path, call["s"], hit,
                      call["peak"]))
    if views[0][5] < 0.3:
        bad.append(f"cam1 covers {views[0][5]:.1%} of its pixels (≥ 30%)")
    load, cam1, cam2, debug = stages8 or (float("nan"),) * 4
    log(f"bus phase 8 (render_resolution {BUS_RENDER}, the bus's HDRI): "
        f"phase 8 "
        f"{timings[8]:.2f} s (load {load:.3f}, cam1 {cam1:.3f}, cam2 "
        f"{cam2:.3f}, debug {debug:.3f} s); "
        + "; ".join(f"{tag} {hw[0]}×{hw[1]}, {nf} faces: {p.path} (kmax "
                    f"{p.kmax}, K {p.k}), z-buffer {s:.3f} s at peak "
                    f"{peak / 2**30:.2f} GiB, hit {hit:.1%}"
                    for tag, hw, nf, p, s, hit, peak in views))
    return bad


def binned_dense_check(call):
    """At one phase-8 view's inputs (``call``, the _CallSpy record of its
    rasterize_hard_auto): rasterize_hard_binned with K = the view's
    max_faces_per_tile, whatever bucket the dispatcher chose, against the
    dense rasterize_hard (the recorded call's output where it ran dense,
    else a dense run, chunk 512), face ids, depth and barycentrics bit for
    bit; both times printed. Returns the gates that failed."""
    import torch

    from regen3d_tpu_torch.ops.rasterize import (
        hard_raster_path,
        max_faces_per_tile,
        rasterize_hard,
        rasterize_hard_binned,
    )

    vs, faces, hw = call["args"][:3]
    path = hard_raster_path(vs, faces, hw)
    if path.path == "dense":
        dense, t_dense = call["out"], call["s"]
    else:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dense = rasterize_hard(vs, faces, hw, chunk=512)
        torch.cuda.synchronize()
        t_dense = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k = int(max_faces_per_tile(vs, faces, hw).max())
    binned = rasterize_hard_binned(vs, faces, hw, faces_per_tile=k)
    torch.cuda.synchronize()
    t_binned = time.perf_counter() - t0
    same = {f: torch.equal(getattr(binned, f), getattr(dense, f))
            for f in ("face_idx", "depth", "bary")}
    other = int((binned.face_idx != dense.face_idx).sum())
    log(f"binned vs dense at cam1 ({hw[0]}×{hw[1]}, {faces.shape[1]} faces): "
        f"binned at K = kmax = {k} {t_binned:.3f} s (with the overlap "
        f"count), dense ({'the run' if path.path == 'dense' else 'run here'})"
        f" {t_dense:.3f} s; bit for bit the same: {same}, {other} pixels "
        f"with another face")
    return [] if all(same.values()) else [f"binned vs dense: {same}, "
                                          f"{other} pixels differ"]


@contextlib.contextmanager
def _atomic_scatters():
    """The fit's accumulations as they were before they took a fixed order:
    ``index_add`` in the point-to-mesh and kNN backwards and plain
    advanced indexing (whose backward is an accumulating ``index_put_``)
    in gather_faces and gather_rows. For fit_determinism only."""
    from regen3d_tpu_torch.ops import knn, point_mesh, rasterize

    saved = (point_mesh.scatter_add_rows, knn.scatter_add_rows,
             rasterize.take_rows)

    def index_add(base, idx, src):
        return base.index_add(0, idx.long(), src)

    def index(x, idx):
        return x[idx.long()]

    point_mesh.scatter_add_rows = knn.scatter_add_rows = index_add
    rasterize.take_rows = index
    try:
        yield
    finally:
        (point_mesh.scatter_add_rows, knn.scatter_add_rows,
         rasterize.take_rows) = saved


def fit_determinism(init, batch, cam, short):
    """Which accumulation made phase 6's fit differ between runs (ROADMAP
    Queue 3 z), and what the fixed order costs: the 5-iteration bus fit
    twice with the former atomic accumulations (_atomic_scatters), twice
    more with them under torch.use_deterministic_algorithms (set for this
    probe only, warn_only), each pair's largest parameter difference; then
    one iteration's wall and device time (fit_split, fits of 3 and 6
    iterations) with the former and with the fixed-order accumulations.
    Returns the line to print."""
    import warnings

    import torch

    from regen3d_tpu_torch.pipeline.pose_fit import fit_poses

    t0 = time.perf_counter()

    def pair():
        a, b = (fit_poses(init, batch, cam, short) for _ in range(2))
        torch.cuda.synchronize()
        return max(float((x - y).abs().max()) for x, y in zip(a.params,
                                                               b.params))

    with _atomic_scatters():
        atomic = pair()
        saved = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                flagged = pair()
        finally:
            torch.use_deterministic_algorithms(saved)
        before = fit_split(init, batch, cam, short, short=3, quiet=True)
    after = fit_split(init, batch, cam, short, short=3, quiet=True)
    return (f"determinism probe, two 5-iteration fits with the former "
            f"index_add/index_put accumulations {atomic:.3e} apart, with "
            f"them under use_deterministic_algorithms {flagged:.3e} apart; "
            f"one iteration (fit_split) before the fixed order: wall "
            f"{before['wall']:.2f} ms, device {before['dev']:.2f} ms, "
            f"{before['launches']:.1f} launches; after: wall "
            f"{after['wall']:.2f} ms, device {after['dev']:.2f} ms, "
            f"{after['launches']:.1f} launches (the probe "
            f"{time.perf_counter() - t0:.1f} s)")


def phase_bus(results):
    """Phases 5, 6, 7 and 9 through the port's orchestrator on a synthetic
    room's output bus at phase 6's real size (960×1280 findings → 1024 × 1344
    renders, 8 objects of ~20k faces decimated to 2,048, 4,096 target
    points, 300 iterations). First a run with 0 iterations gives the fit's
    batch, initial poses and initial losses; at that batch the silhouette
    kernels are held to their plain versions (one call, timed), a
    5-iteration fit on the kernels to one on the plain edge path, and one
    GIF frame batch rendered on the card to the CPU's. Then the counted run
    with the defaults: every artifact written, every loss finite and below
    its initial value. Beside it the pose errors against the true poses,
    initial and fitted, and those of a fit without the silhouette term
    (silhoutte_loss 0), which are reported, not gated: phase 6's default
    objective does not reduce them for every object (PERF.md §6).
    The counted run goes on through phases 7 and 9 (run_phases(cfg, [5, 6,
    7, 9])) with the GT scene and the images build_bus writes: phase 7's
    stage times, ICP's iterations and ms per iteration, the bake's time and
    peak memory, the background mesh's size and phase 9's metrics are
    printed; the run must write every artifact (8 objects combined, the
    background baked, 60,000 pred and GT points, the ICP transform), end ICP
    no worse than its initial alignment and give the 15 metrics, all
    finite; the silhouette kernels launch 301 and 300 times. Beside it one
    20-iteration ICP at the same clouds under torch.profiler (its device
    time against its wall time: the host's read of the stopping test each
    iteration). The 5-iteration fit run twice must repeat bit for bit
    (ROADMAP Queue 3 z), beside fit_determinism's probe of the former
    atomic accumulations; printed, phase 5's outputs of the 0-iteration
    and the counted run (same inputs) compared byte for byte. Last, phases
    5 and 6 and then 7 and 9 on a small bus on the card against the CPU
    (bus_small_check), whose phase 6 run twice on the card must write the
    same GLBs bit for bit."""
    import dataclasses
    import shutil

    import torch

    from regen3d_tpu_torch import kernels
    from regen3d_tpu_torch.config import default_config
    from regen3d_tpu_torch.ops import silhouette_kernel as sk
    from regen3d_tpu_torch.pipeline import (
        phase6_pose,
        phase7_assemble,
        phase8_render,
        texture,
    )
    from regen3d_tpu_torch.pipeline.pose_fit import (
        compute_batch_bins,
        fit_poses,
        pose_transform,
        raster_path,
    )

    root = ROOT / "build" / "bus"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    truth = build_bus(root / "bus", "cuda")
    t_build = time.perf_counter() - t0
    for run in ("init", "main", "no_sil"):
        shutil.copytree(root / "bus", root / run)

    def errors(run):
        return {s: bus_pose_errors(str(root / run / "output" / "glb"
                                       / f"{s}.glb"), t)
                for s, t in truth.items()}

    # the fit's batch, initial poses and losses: 0 iterations
    spy = _CallSpy(phase6_pose.fit_poses)
    _bus_phases(default_config(str(root / "init" / "output"),
                               write_fit_gifs=False, max_iterations=0,
                               early_stop_min_iterations=0), spy)
    (init, batch, cam, cfg), res0 = (spy.calls[-1]["args"],
                                     spy.calls[-1]["out"])
    n_faces = batch.faces.shape[1]
    path = raster_path(cfg, n_faces, "cuda")
    if cfg.image_hw != (1024, 1344) or path != "edge_kernel":
        raise AssertionError(f"bus fit at {cfg.image_hw} took the {path} path")
    before = errors("init")

    # the kernels at this batch: one call against the plain versions
    gen = torch.Generator(device="cuda").manual_seed(9)
    bins = compute_batch_bins(init, batch, cam, cfg)
    with torch.no_grad():
        vs = cam.view_to_screen(cam.world_to_view(pose_transform(init, batch,
                                                                 cfg)))
        co, nvalid, va, uv = sk.edge_tile_inputs(
            vs, batch.faces, cfg.image_hw, cfg.sigma, batch.faces_mask,
            faces_per_tile=cfg.faces_per_tile, bins=bins)
    sil = sil_case(sk, f"bus batch ({batch.faces.shape[0]} objects, "
                   f"{cfg.image_hw[0]}×{cfg.image_hw[1]}, sigma {cfg.sigma:g})",
                   nvalid, co, va, uv, sk.tile_consts(cfg.image_hw, cfg.sigma),
                   gen, timed=True)
    # 5 iterations on the kernels against the plain edge path (phase_fit's
    # tolerances: one Adam step on params, 1e-2 relative on losses)
    short = dataclasses.replace(cfg, max_iterations=5, early_stop_min_iters=5)
    plain = dataclasses.replace(short, use_pallas_raster=False)
    r_k = fit_poses(init, batch, cam, short)
    r_p = fit_poses(init, batch, cam, plain)
    r_k2 = fit_poses(init, batch, cam, short)     # the same fit again
    torch.cuda.synchronize()
    fit_again = max(float((a - b).abs().max()) for a, b in zip(r_k.params,
                                                               r_k2.params))
    if not (all(torch.equal(a, b) for a, b in zip(r_k.params, r_k2.params))
            and torch.equal(r_k.losses, r_k2.losses)):
        raise AssertionError(f"bus fit, 5 iterations: two runs differ "
                             f"({fit_again:.3e} in the params)")
    probe = fit_determinism(init, batch, cam, short)
    # phase_parallel holds fit_poses_sharded to this fit
    results["bus_fit"] = dict(args=(init, batch, cam, short), ref=r_k)
    p_err = max(float((a - b).abs().max()) for a, b in zip(r_k.params,
                                                           r_p.params))
    l_err = float(((r_k.losses - r_p.losses).abs() / r_p.losses.abs()).max())
    if not (p_err <= 5e-3 and l_err <= 1e-2):
        raise AssertionError(f"bus fit, 5 iterations: kernels vs plain params "
                             f"{p_err:.3e} (tol 5e-3), losses {l_err:.3e} "
                             f"(tol 1e-2)")
    flat = torch.cat([init.translation, init.yaw[:, None], init.rot_aa,
                      init.log_scale[:, None]], -1)
    f_err, f_other, f_cov = bus_frame_check(batch, cfg, cam, flat)

    # the counted run: phases 5, 6, 7, 8 and 9 with the defaults
    spy = _CallSpy(phase6_pose.fit_poses)
    spies = (_CallSpy(phase7_assemble.iterative_closest_point),
             _CallSpy(texture.bake_vertex_colors))
    spy8 = _CallSpy(phase8_render.rasterize_hard_auto)
    main = root / "main"
    kernels.reset_counts()
    torch.cuda.synchronize()
    timings, stages, stages7, stages8 = _bus_phases(default_config(
        str(main / "output"), write_fit_gifs=False,
        render_resolution=BUS_RENDER, GT_scene=str(main / "gt_scene.glb"),
        input_image=str(main / "input.png"),
        hdri_path=str(main / "sky.hdr")), spy, (5, 6, 7, 8, 9), spies, spy8)
    counts = dict(kernels.LAUNCHES)
    res = spy.calls[-1]["out"]
    floor = int(spy.calls[-1]["args"][1].on_floor.sum())
    out = root / "main" / "output"
    missing = [p for s in truth for p in (
        out / "glb" / f"{s}.glb", out / "pointclouds" / f"{s}.ply",
        out / "pointclouds" / "normals" / f"{s}_normals.ply",
        out / "masks" / f"{s}.png")] + [
        root / "main" / "tmp" / "debug" / n
        for n in ("FLOOR.ply", "FLOOR_RESIDUALS.ply", "PLANE_SAMPLED.ply")]
    missing = [str(p) for p in missing if not p.exists()]
    after = errors("main")
    # phase 5 ran on the same bus for the 0-iteration run and this one
    p5_same = all(
        (root / "init" / "output" / "pointclouds" / sub / n).read_bytes()
        == (out / "pointclouds" / sub / n).read_bytes()
        for s in truth for sub, n in (("", f"{s}.ply"),
                                      ("normals", f"{s}_normals.ply")))
    # the same fit without the silhouette term, for comparison
    nosil = _CallSpy(phase6_pose.fit_poses)
    _bus_phases(default_config(str(root / "no_sil" / "output"),
                               write_fit_gifs=False, silhoutte_loss=0.0), nosil)
    third = errors("no_sil")
    p79 = bus79_main(main, spies, stages7, timings)
    p8 = bus8_main(main, spy8, stages8, timings)
    p8 += binned_dense_check(spy8.calls[0])
    del spy8
    small, small79 = bus_small_check()

    t_floor, t_prep, t_fit, t_export, _t_gif, _b = stages
    ms_iter = 1e3 * t_fit / max(res.num_iters, 1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    errs = "; ".join(
        f"{s}: {before[s][0]:.3f} → {after[s][0]:.3f} ({third[s][0]:.3f}) m, "
        f"{before[s][1]:.1f} → {after[s][1]:.1f} ({third[s][1]:.1f})°"
        for s in truth)
    losses = ", ".join(f"{float(a):.4f} → {float(b):.4f}"
                       for a, b in zip(res0.losses, res.losses))
    t = sil["ms"]
    log(f"bus (phases 5 and 6 through the orchestrator, {len(truth)} objects, "
        f"{floor} on the floor, {cfg.image_hw[0]}×{cfg.image_hw[1]} "
        f"{path}; bus built in {t_build:.1f} s): phase 5 "
        f"{timings[5]:.2f} s, phase 6 {timings[6]:.2f} s (floor/cam "
        f"{t_floor:.2f}, prep {t_prep:.2f}, fit {t_fit:.2f}, export "
        f"{t_export:.2f} s), {res.num_iters} iterations, {ms_iter:.1f} ms an "
        f"iteration; losses initial → fitted: {losses}; pose error "
        f"(translation, rotation) initial → fitted (without the silhouette "
        f"term, {nosil.calls[-1]['out'].num_iters} iterations): {errs}; "
        f"5 iterations kernels vs plain: params {p_err:.3e}, losses "
        f"{l_err:.3e}, the same 5 iterations again bit for bit; {probe}; "
        f"phase 5's clouds and normals in two runs bit for bit the same: "
        f"{p5_same}; fit frame card vs CPU: colour {f_err:.3e}, {f_other} "
        f"of {f_cov} covered pixels at z-ties; small bus card vs CPU: "
        f"{small[0]:.3%} of a cloud on one device only, normals |cos| ≥ "
        f"{small[1]:.6f}, {small[2]:.2%} within 1e-5, fitted vertices at "
        f"{small[3]:.2f} of one Adam step, two card runs of phase 6 "
        f"bit for bit the same GLBs; phases 7 and 9 card vs CPU: "
        f"background Chamfer {small79['chamfer']:.2e} of a cell, colour "
        f"{small79['colour']:.2e}, GT points {small79['gt']:.2e}, aligned "
        f"prediction {small79['pred']:.2e}, ICP transform "
        f"{small79['icp']:.2e} (unambiguous neighbours "
        f"{small79['icp_grid']:.2e}), metrics relative (the scene "
        f"Chamfer distance and RMSE absolute) "
        + ", ".join(f"{k} {v:.1e}" for k, v in sorted(small79['metrics']
                                                      .items()))
        + f"; phase 8 card vs CPU (96 × 128, point-cloud and GT renders, "
        f"HDRI): {small79['phase8']['hits']} hit pixels differ, linear "
        f"{small79['phase8']['linear']:.2e}, PNGs within "
        f"{small79['phase8']['level']} levels over "
        f"{small79['phase8']['renders']} renders, z-buffer paths "
        f"{small79['phase8']['paths']}"
        + "; a faulty ICP on the CPU moves them by: "
        + "; ".join(f"{f}: " + ", ".join(f"{k} {v:.2e}" for k, v in r.items())
                    for f, r in small79["faults"].items())
        + "; silhouette at "
        f"{cfg.image_hw[0]}×{cfg.image_hw[1]}: fwd {t['fk']:.4f} ms (bound "
        f"{sil['bound']['fwd'][0]:.4f}, {sil['bound']['fwd'][1]}; plain "
        f"{t['fp']:.3f}), bwd {t['bk']:.4f} ms (bound "
        f"{sil['bound']['bwd'][0]:.4f}, {sil['bound']['bwd'][1]}; plain "
        f"{t['bp']:.3f}); launches {counts}; {smi}")
    if missing:
        raise AssertionError(f"bus: missing artifacts {missing}")
    if counts["silhouette_fwd"] != 301 or counts["silhouette_bwd"] != 300:
        raise AssertionError(f"the bus run launched the silhouette kernels "
                             f"{counts['silhouette_fwd']} and "
                             f"{counts['silhouette_bwd']} times, not 301 and "
                             f"300")
    if p79:
        raise AssertionError("bus phases 7 and 9: " + "; ".join(p79))
    if p8:
        raise AssertionError("bus phase 8: " + "; ".join(p8))
    if not (bool(torch.isfinite(res.losses).all())
            and bool((res.losses < res0.losses).all())):
        raise AssertionError("bus: a fit loss is not finite or did not fall")
    if floor < 3:
        raise AssertionError(f"bus: {floor} objects on the floor, 3 wanted")
    results["bus_launches"] = counts


# phase_texture: phase 3's texture paths at full width on one of the
# meshes phase_assets wrote, decimated to the reference's
# remesh_target_num_faces (its 256³ meshes have ~3.3 M faces), cut to
# half of its 50,000 faces (the dense z-buffer renders and bakes, ~73% of
# the texture runs, go with the faces) for the script's time limit; a
# 1,000-face decimation for the atlas on the card against the CPU, whose
# plain z-buffer tests every pixel against every face (2,000 took 12.1 s)
TEXTURE_FACES = 25_000
TEXTURE_CHECK_FACES = 1_000
# the CLI runs (one object, the tiny texture model at the JAX CLI's
# texgen_resolution 64, 4 steps): the generator at 10 steps and a 128³
# decode, remeshed to the default 50,000 faces
TEXTURE_CLI = dict(num_inf_steps_hy=10, octree_resolution_hy=128,
                   steps_hy21=10, octree_resolution_hy21=128, remesh=True)
# the card (bf16, kernels) against the CPU's f32 plain versions, of max
# |f32|: one UNet step (1 view, 64² latents, 4,097 cross-attention keys)
# and one VAE decode (a 32² latent), within phase 3's bf16 limits (ROADMAP
# Queue 3 af): max 5e-2, mean 1.5e-2. RealESRGAN ×4 on one 64² tile in
# f32: cuDNN's TF32 products (the card's default; 10-bit mantissas through
# 23 RRDB blocks: an H100 read a max of 3.1e-2 and a mean of 1.5e-4) within
# a max of 5e-2 and a mean of 1e-3 of max |f32|; IEEE f32 (TF32 off for
# the check) within a max of 1e-4
TEXTURE_MAX_ERR, TEXTURE_MEAN_ERR = 5e-2, 1.5e-2
ESRGAN_TF32_ERR, ESRGAN_TF32_MEAN, ESRGAN_F32_ERR = 5e-2, 1e-3, 1e-4
# launches of the flash forward a texture_mesh call makes: 32 a UNet
# forward (16 spatial transformers of SDUNetConfig.multiview, each a self-
# and a cross-attention) over the steps, and the VAE's 3 (the reference
# encode, the geometry encode, the decode)
TEXGEN_UNET_LAUNCHES, TEXGEN_VAE_LAUNCHES = 32, 3


def _rel_errors(got, ref):
    """(max, mean) |got − ref| over max |ref|, in f32 on the CPU."""
    got, ref = got.float().cpu(), ref.float().cpu()
    scale = float(ref.abs().max())
    d = (got - ref).abs()
    return float(d.max()) / scale, float(d.mean()) / scale


def texture_card_vs_cpu(model, vae, esr, gen):
    """One UNet step, one VAE decode and one RealESRGAN tile on the card
    against the same weights in f32 on the CPU (the card's bf16 weights
    widened). Returns {check: (max, mean)} and the ESRGAN's IEEE f32 pair."""
    import dataclasses

    import torch

    from regen3d_tpu_torch.models import esrgan as es
    from regen3d_tpu_torch.models.sd_vae import SDAutoencoderKL
    from regen3d_tpu_torch.pipeline import texgen as tg

    def cpu_copy(m, make):
        c = make().eval()
        c.load_state_dict({k: v.float().cpu()
                           for k, v in m.state_dict().items()})
        return c

    out = {}
    lh = 64
    g = torch.Generator(device="cuda").manual_seed(11)
    lat, geom = (torch.randn((1, lh, lh, 4), generator=g, device="cuda")
                 for _ in range(2))
    ref = torch.randn((lh, lh, 4), generator=g, device="cuda")
    cams = torch.randn((1, 13), generator=g, device="cuda")
    f32 = dataclasses.replace(model.unet_cfg, dtype=torch.float32)
    cpu = cpu_copy(model, lambda: tg.MultiviewTexGen(f32, device="cpu"))
    with torch.no_grad():
        card = model(lat, 731.0, ref, torch.zeros(1, dtype=torch.long,
                                                  device="cuda"), geom, cams)
        want = cpu(lat.cpu(), 731.0, ref.cpu(), torch.zeros(1, dtype=torch.long),
                   geom.cpu(), cams.cpu())
    out["unet step"] = _rel_errors(card, want)
    z = torch.randn((1, 32, 32, 4), generator=g, device="cuda")
    vcpu = cpu_copy(vae, lambda: SDAutoencoderKL(dataclasses.replace(
        vae.cfg, dtype=torch.float32), device="cpu"))
    with torch.no_grad():
        out["vae decode"] = _rel_errors(vae.decode(z), vcpu.decode(z.cpu()))
    tile = torch.rand((64, 64, 3), generator=g, device="cuda").cpu().numpy()
    ecpu = cpu_copy(esr, lambda: es.RRDBNet(esr.cfg, device="cpu"))
    want = torch.from_numpy(es.upscale_x4(ecpu, tile))
    out["esrgan tile (tf32)"] = _rel_errors(
        torch.from_numpy(es.upscale_x4(esr, tile)), want)
    saved = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = False
        ieee = _rel_errors(torch.from_numpy(es.upscale_x4(esr, tile)), want)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    return out, ieee


def texture_stage_spies():
    """_CallSpy on each stage texgen.texture_mesh(_pbr) calls through the
    module's names; returns ({name: spy}, a function that restores them)."""
    from regen3d_tpu_torch.pipeline import texgen as tg

    names = ("render_geometry_maps", "vae_encode", "ddim_sample",
             "vae_decode", "bake_texture_atlas", "upscale_x4")
    saved = {n: getattr(tg, n) for n in names}
    spies = {n: _CallSpy(f) for n, f in saved.items()}
    for n in names:
        setattr(tg, n, spies[n])

    def restore():
        for n, f in saved.items():
            setattr(tg, n, f)
    return spies, restore


def texture_full_run(fn, *args, **kwargs):
    """One texgen call on the card with its stages spied, the launches
    counted from 0 and the flash shapes recorded; returns (result,
    seconds, {stage: s}, launches, peak GiB, the DDIM latents, Counter of
    flash shapes)."""
    import torch

    from regen3d_tpu_torch import kernels

    spies, restore = texture_stage_spies()
    try:
        kernels.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recording_flash_shapes() as shapes:
            out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(kernels.LAUNCHES)
    finally:
        restore()
    s = lambda n: sum(c["s"] for c in spies[n].calls)
    stages = {"geometry renders": s("render_geometry_maps"),
              "VAE encode": s("vae_encode"), "DDIM": s("ddim_sample"),
              "decode": s("vae_decode"),
              f"bake x{len(spies['bake_texture_atlas'].calls)}":
                  s("bake_texture_atlas"),
              "ESRGAN": s("upscale_x4")}
    peak = max(c["peak"] for sp in spies.values() for c in sp.calls) / 2 ** 30
    lat = spies["ddim_sample"].calls[0]["out"]
    return out, dt, stages, counts, peak, lat, shapes


def texture_cli(root, stem, png, knob_cfg, dev="cuda"):
    """phase3_assets.run on one prepped object under ``knob_cfg`` with the
    flash shapes recorded; returns (the GLB's mesh, seconds, launches,
    Counter of flash shapes)."""
    import shutil

    import torch

    from regen3d_tpu_torch import kernels
    from regen3d_tpu_torch.artifacts import Artifacts
    from regen3d_tpu_torch.config import default_config
    from regen3d_tpu_torch.pipeline import phase3_assets as p3
    from regen3d_tpu_torch.utils.glb import load_glb

    shutil.rmtree(root, ignore_errors=True)
    cfg = default_config(str(root / "output"), **TEXTURE_CLI, **knob_cfg)
    art = Artifacts(cfg)
    Path(art.prepped_dir).mkdir(parents=True)
    shutil.copy(png, Path(art.prepped_dir) / f"{stem}.png")
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording_flash_shapes() as shapes:
        done = p3.run(cfg, device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    if done != [stem]:
        raise AssertionError(f"phase 3 CLI {knob_cfg}: wrote {done}")
    return load_glb(art.asset_glb(stem)).meshes[0], dt, counts, shapes


def phase_texture(results):
    """Phase 3's texture paths at full width on the card: texgen.texture_mesh
    with init_texgen(TexGenConfig()) (SDUNetConfig.multiview(6),
    SDVAEConfig(), 512², 15 steps; random weights from a seed) on one of
    phase_assets' meshes decimated to TEXTURE_FACES, then texture_mesh_pbr
    (multiview(12)) with a random-init ESRGANConfig.x4plus(), each timed
    by stage and gated on finite latents, the atlas and the launches; one
    UNet step, one VAE decode and one ESRGAN tile against the CPU's f32
    (texture_card_vs_cpu); then phase3_assets.run on one object with
    use_multiview_texgen, with use_hunyuan21 too, and with
    bake_texture_atlas (TEXTURE_CLI), gated on the GLBs' UVs and textures
    and the tiny UNet's D = 4 launches, and the CLI's atlas bake on the
    card against the CPU on a TEXTURE_CHECK_FACES decimation; then every
    flash shape of the five runs not held in phase_kernels against the
    plain version (fwd_case; D = 4 through padded_check), the full-width
    ones (D ≥ 64) timed beside SDPA."""
    import os

    import numpy as np
    import torch

    from regen3d_tpu_torch.artifacts import Artifacts
    from regen3d_tpu_torch.config import default_config
    from regen3d_tpu_torch.models import esrgan as es
    from regen3d_tpu_torch.models.sd_unet import SDUNetConfig
    from regen3d_tpu_torch.pipeline import phase3_assets as p3
    from regen3d_tpu_torch.pipeline import texgen as tg
    from regen3d_tpu_torch.utils.glb import load_glb
    from regen3d_tpu_torch.utils.image import decode_png, read_png
    from regen3d_tpu_torch.utils.meshproc import decimate_vertex_clustering

    t_phase = time.perf_counter()
    art = Artifacts(default_config(str(ROOT / "build" / "assets" / "output")))
    stem = art.list_assets()[0]
    png = os.path.join(art.prepped_dir, f"{stem}.png")
    mesh = load_glb(art.asset_glb(stem)).meshes[0]
    t0 = time.perf_counter()
    verts, faces = decimate_vertex_clustering(mesh.vertices, mesh.faces,
                                              TEXTURE_FACES)
    log(f"texture: {stem}'s phase-3 mesh, {len(mesh.faces)} faces, "
        f"decimated to {len(faces)} in {time.perf_counter() - t0:.2f} s")
    rgba = read_png(png)[0]
    ref = rgba[..., :3]

    gen = torch.Generator(device="cuda").manual_seed(21)
    t0 = time.perf_counter()
    cfg = tg.TexGenConfig()
    model, vae = tg.init_texgen(cfg, gen)
    esr = es.RRDBNet(es.ESRGANConfig.x4plus(), device="cuda").eval()
    es.init_flax_style_(esr, gen)
    n_par = lambda m: sum(p.numel() for p in m.parameters()) / 1e6
    log(f"texgen at full width (random weights from a seed, built in "
        f"{time.perf_counter() - t0:.1f} s): UNet {n_par(model):.1f} M, "
        f"VAE {n_par(vae):.1f} M, ESRGAN x4plus {n_par(esr):.1f} M params")

    t0 = time.perf_counter()
    checks, ieee = texture_card_vs_cpu(model, vae, esr, gen)
    log(f"texture card vs CPU f32 ({time.perf_counter() - t0:.1f} s), "
        f"(max, mean) / max |f32|: "
        f"{ {k: f'{a:.3e}/{m:.3e}' for k, (a, m) in checks.items()} }; "
        f"ESRGAN with TF32 off {ieee[0]:.3e}/{ieee[1]:.3e} (tol: UNet and "
        f"VAE {TEXTURE_MAX_ERR}/{TEXTURE_MEAN_ERR}, ESRGAN TF32 "
        f"{ESRGAN_TF32_ERR}/{ESRGAN_TF32_MEAN}, IEEE f32 {ESRGAN_F32_ERR})")
    bad = [k for k in ("unet step", "vae decode")
           if checks[k][0] > TEXTURE_MAX_ERR or checks[k][1] > TEXTURE_MEAN_ERR]
    if checks["esrgan tile (tf32)"][0] > ESRGAN_TF32_ERR \
            or checks["esrgan tile (tf32)"][1] > ESRGAN_TF32_MEAN \
            or ieee[0] > ESRGAN_F32_ERR:
        bad.append("esrgan")
    if bad:
        raise AssertionError(f"texture card vs CPU: {bad} over the limits")

    expected = cfg.steps * TEXGEN_UNET_LAUNCHES + TEXGEN_VAE_LAUNCHES
    runs = {}
    run_shapes = collections.Counter()   # the five runs' flash shapes
    for name, fn, kw in (
            ("rgb", tg.texture_mesh, {}),
            ("pbr", tg.texture_mesh_pbr, {"esrgan": esr})):
        if name == "pbr":
            model = vae = None
            torch.cuda.empty_cache()
            model, vae = tg.init_texgen(
                cfg, gen, SDUNetConfig.multiview(2 * cfg.num_views))
        out, dt, stages, counts, peak, lat, shapes = texture_full_run(
            fn, verts, faces, ref, cfg, model, vae, generator=gen, **kw)
        run_shapes.update(shapes)
        atlases = [decode_png(b)[0] for b in out[3:]]
        runs[name] = dict(s=dt, stages=stages, launches=counts, peak=peak,
                          atlas=[a.shape for a in atlases])
        log(f"texture_{name} (TexGenConfig(): {cfg.num_views} views, "
            f"{cfg.resolution}², {cfg.steps} steps; {len(faces)} faces, "
            f"8 texels a face): {dt:.2f} s; by stage (s) "
            f"{ {k: round(v, 3) for k, v in stages.items()} }; atlases "
            f"{runs[name]['atlas']}; peak {peak:.2f} GiB; flash launches "
            f"{counts['flash_fwd']} (expected {expected})")
        gates = []
        if not bool(torch.isfinite(lat).all()):
            gates.append("latents not finite")
        if counts["flash_fwd"] != expected:
            gates.append(f"{counts['flash_fwd']} flash launches")
        if len(out[1]) != len(faces) or len(out[2]) != 3 * len(faces):
            gates.append("mesh or UVs")
        if any(a.std() == 0 for a in atlases[:1]) \
                or (name == "pbr" and atlases[0].shape[0]
                    != 4 * atlases[1].shape[0]):
            gates.append(f"atlases {[a.shape for a in atlases]}")
        if gates:
            raise AssertionError(f"texture_{name}: {gates}")
        results[f"texture_{name}_launches"] = counts
    del model, vae, esr
    torch.cuda.empty_cache()

    cli = {}
    for name, knobs in (("texgen", dict(use_multiview_texgen=True)),
                        ("texgen_pbr", dict(use_multiview_texgen=True,
                                            use_hunyuan21=True)),
                        ("atlas", dict(bake_texture_atlas=True))):
        m, dt, counts, shapes = texture_cli(ROOT / "build" / "texture" / name,
                                            stem, png, knobs)
        run_shapes.update(shapes)
        by_d = collections.Counter()
        for shape, n in shapes.items():
            by_d[shape[-1]] += n
        cli[name] = m
        results[f"texture_cli_{name}_launches"] = counts
        gates = []
        if m.uvs is None or not m.texture_png or m.vertex_colors is not None:
            gates.append("no UVs or texture")
        if name == "texgen_pbr" and not m.mr_texture_png:
            gates.append("no metallic-roughness texture")
        if name != "atlas" and by_d.get(4, 0) != 4 * 8:
            gates.append(f"D = 4 launches {by_d.get(4, 0)}")
        log(f"phase 3 CLI with {knobs} (one object, {TEXTURE_CLI}): "
            f"{dt:.2f} s, {len(m.faces)} faces, texture "
            f"{decode_png(m.texture_png)[0].shape}"
            + (f", MR {decode_png(m.mr_texture_png)[0].shape}"
               if m.mr_texture_png else "")
            + f"; flash launches by head dim {dict(by_d)}")
        if gates:
            raise AssertionError(f"phase 3 CLI {name}: {gates}")

    # the CLI's atlas bake on the card against the CPU
    v2, f2 = decimate_vertex_clustering(verts, faces, TEXTURE_CHECK_FACES)
    img = rgba.astype(np.float32) / 255.0
    cfg_a = default_config(str(ROOT / "build" / "texture" / "check"),
                           bake_texture_atlas=True)
    t0 = time.perf_counter()
    card = p3._textured_mesh(cfg_a, stem, v2, f2, img, "cuda")
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = p3._textured_mesh(cfg_a, stem, v2, f2, img, "cpu")
    t_cpu = time.perf_counter() - t0
    a, b = (decode_png(m.texture_png)[0].astype(int) for m in (card, cpu))
    d = np.abs(a - b).max(-1)
    differ, far = float((d > 0).mean()), float((d > 1).mean())
    same_uv = bool(np.array_equal(card.uvs, cpu.uvs)
                   and np.array_equal(card.faces, cpu.faces))
    log(f"bake_texture_atlas card vs CPU ({len(f2)} faces, the object image "
        f"{img.shape[:2]}): atlas {a.shape}, {differ:.4%} of texels differ, "
        f"{far:.4%} by more than one level, at most {int(d.max())} (tol: "
        f"at most one level, on under 1% of texels; the card's renders "
        f"are the CPU's pixel for pixel, Queue 3 ag), UVs and faces equal "
        f"{same_uv}; card "
        f"{t_card:.2f} s, CPU {t_cpu:.2f} s")
    if d.max() > 1 or differ >= 0.01 or not same_uv or a.shape != b.shape:
        raise AssertionError("bake_texture_atlas: card and CPU differ")
    results["texture"] = dict(runs=runs, checks=checks, esrgan_ieee=ieee,
                              atlas_differ=differ, atlas_far=far)

    # every flash shape of the five runs against the plain version, but
    # those phase_kernels held; the full-width ones timed beside SDPA
    gen_t = torch.Generator(device="cuda").manual_seed(17)
    held = []
    for shape in sorted(set(run_shapes).difference(D512_SHAPES + D4_SHAPES)):
        r = (padded_check(shape, gen_t, 8) if shape[-1] == 4
             else fwd_case(shape, gen_t, timed=shape[-1] >= 64))
        held.append(dict(shape=shape, launches=run_shapes[shape],
                         err=r["err"], err_lse=r["err_lse"],
                         sdpa_err=r["sdpa_err"], bound_ms=r["bound"][0],
                         bound_by=r["bound"][1], **r.get("ms", {})))
    f = results["flash_fwd"]
    for r in held:
        f["max_abs_err"] = max(f["max_abs_err"], r["err"])
        f["max_abs_err_lse"] = max(f["max_abs_err_lse"], r["err_lse"])
    f["texture_shapes"] = held
    log(f"flash_fwd at the texture runs' shapes (launches over the five "
        f"runs {dict(sorted(run_shapes.items()))}), held against the plain "
        f"version after the runs: {held}")
    log(f"phase_texture: {time.perf_counter() - t_phase:.1f} s")


def phase_lpips(results):
    """LPIPS, the port's AlexNet trunk and five heads at the flax-style init
    from a seed: a small pair (2 × 64 × 80) on the card against the CPU
    within 1e-4 relative, then one 960×1280 pair (phase 9's input size) on
    the card: CUDA-event ms (median of 10 after warm-up) and peak memory."""
    import torch

    from regen3d_tpu_torch.models.lpips import LPIPS, init_flax_style_, make_lpips_fn

    fns = {}
    for d in ("cuda", "cpu"):
        model = LPIPS(device=d)
        init_flax_style_(model, torch.Generator().manual_seed(0))
        fns[d] = make_lpips_fn(model)
    gen = torch.Generator().manual_seed(1)
    a = torch.rand((2, 64, 80, 3), generator=gen)
    b = (a + 0.1 * torch.randn(a.shape, generator=gen)).clamp(0, 1)
    y_cpu = float(fns["cpu"](a, b))
    y_card = float(fns["cuda"](a.cuda(), b.cuda()))
    rel = abs(y_card - y_cpu) / abs(y_cpu)
    big_a = torch.rand((960, 1280, 3), generator=gen).cuda()
    big_b = (big_a + 0.1 * torch.randn(big_a.shape, generator=gen).cuda()
             ).clamp(0, 1)
    torch.cuda.reset_peak_memory_stats()
    y_big = float(fns["cuda"](big_a, big_b))
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = cuda_ms(lambda: fns["cuda"](big_a, big_b))
    log(f"lpips (seeded init): 960×1280 on the card {ms:.3f} ms, peak "
        f"{peak:.2f} GiB, value {y_big:.5f}; small pair card {y_card:.7f} "
        f"vs CPU {y_cpu:.7f}, {rel:.2e} relative (tol 1e-4)")
    if not (rel <= 1e-4 and math.isfinite(y_big)):
        raise AssertionError(f"lpips: card vs CPU {rel:.2e} (tol 1e-4), "
                             f"960×1280 value {y_big}")
    results["lpips_ms"] = ms


# phase 3 runs on the first of the bus's 8 objects (by name): at 8 it took
# 378 s on an H100, 302 s of it the vertex-colour bake (3.3-6.6 M faces an
# object, every pixel of a 256² view against every face) and 68 s marching
# and the clean-up, all on the host or the plain rasterizer, 115 s at 4 and
# 83.9 s at 2 (PERF.md §6); 1 leaves room for phase_texture, which textures
# its mesh, in the time limit
ASSET_OBJECTS = 1
# phase_assets: phase 3 on the committed checkpoint. The flash shapes its
# run gives the kernel, (B, H, Sq, Sk, D) at D = 32 over ASSET_OBJECTS
# objects: the DiT's self- and cross-attention over the guided batch (2 × n
# objects, 64 latent tokens and 64 image tokens); the condition encoder's
# and the decoder trunk's self-attention (n objects, 64 tokens); a decoder
# query chunk (8,192 points over the 64 latent tokens). Held and timed
# beside the 11-shape forward sum, not in it, so the sum compares across
# PRs.
PHASE3_FLASH_SHAPES = [(2 * ASSET_OBJECTS, 8, 64, 64, 32),
                       (ASSET_OBJECTS, 8, 64, 64, 32),
                       (ASSET_OBJECTS, 8, 8192, 64, 32)]
# the card against the CPU on the first 2 objects' prepped images: 4 Euler
# steps, the dense decode at 32³, the two-level decode at 64³ refining 256
# of its 4,096 coarse cells
ASSET_CHECK_OBJECTS = 2
ASSET_CHECK = dict(steps=4, dense=32, res=64, refine=256)
# its limits on each stage's error against the CPU's f32, / max |f32|: the
# max error within phase_scene's 5e-2 on the condition tokens and latents,
# and within 8e-2 on the SDF stages, where bf16 alone departs further (the
# bf16 LayerNorm output before the f32 sdf_out: an H100 read 6.0e-2,
# 6.7e-2 and 5.2e-2 on the dense, coarse and fine stages, the CPU's own
# bf16 5.2e-2, 5.7e-2 and 5.0e-2); the mean error within 1.5e-2 (the SDF
# stages read 1.0-1.2e-2 on an H100 and in the CPU's bf16 alike) and within
# ASSET_MEAN_OVER_BF16 times the CPU's own bf16 mean error on the same
# input (the card read at most 1.04 times it). A query at the wrong point
# must read over the mean limit.
ASSET_MAX_ERR = dict(cond=5e-2, lat=5e-2, dense=8e-2, coarse=8e-2, fine=8e-2)
ASSET_MEAN_ERR = 1.5e-2
ASSET_MEAN_OVER_BF16 = 1.25


def asset_phase2(bus, cfg, n):
    """Phase 2 through run_phases(cfg, [2]) on the bus's findings (copied
    into cfg's output root; ``input_image`` the bus's input): the offline
    inpainter and prepare_for_3d on the host. Each of the 8 objects must get
    a 512² RGBA prepped image with a cut-out alpha (the floor is skipped, as
    phase 2 skips it) and the empty room must be written; then every
    prepped image but the first ``n`` objects' by name is set aside under
    prepped_aside/, so phase 3 runs on ``n``. Returns (the ``n`` stems,
    phase 2's seconds, the gates that failed)."""
    import os
    import shutil

    import numpy as np

    from regen3d_tpu_torch import orchestrator
    from regen3d_tpu_torch.artifacts import Artifacts, parse_finding_stem
    from regen3d_tpu_torch.config import default_config
    from regen3d_tpu_torch.utils.image import read_png

    src = Artifacts(default_config(str(bus / "output")))
    art = Artifacts(cfg)
    shutil.copytree(src.findings_fullsize, art.findings_fullsize)
    t0 = time.perf_counter()
    orchestrator.run_phases(cfg, [2], device="cuda")
    dt = time.perf_counter() - t0
    objects = [stem for stem in art.list_findings()
               if parse_finding_stem(stem)[0] != "floor"]
    prepped = sorted(f[:-4] for f in os.listdir(art.prepped_dir))
    bad = []
    if prepped != sorted(objects) or len(objects) != 8 \
            or not os.path.exists(art.empty_room):
        bad.append(f"phase 2 prepped {prepped} for {objects}, empty room "
                   f"there: {os.path.exists(art.empty_room)}")
    for stem in prepped:
        img, mode = read_png(os.path.join(art.prepped_dir, f"{stem}.png"))
        a = img[..., -1]
        if not (mode == "RGBA" and img.shape == (512, 512, 4)
                and 0.01 < float(np.mean(a > 0)) < 0.99):
            bad.append(f"{stem}: {mode} {img.shape}, alpha > 0 on "
                       f"{float(np.mean(a > 0)):.1%}")
    aside = Path(art.prepped_dir).parent / "prepped_aside"
    aside.mkdir()
    for stem in objects[n:]:
        shutil.move(os.path.join(art.prepped_dir, f"{stem}.png"),
                    aside / f"{stem}.png")
    return objects[:n], dt, bad


def asset_card_vs_cpu(imgs, dev="cuda"):
    """The committed generator on ``dev`` (bf16, the flash kernel) and on
    the CPU in bf16 and in f32 (the plain versions), the CPU's stages each
    given the card's input to it: condition tokens from the same images,
    ASSET_CHECK's Euler steps at guidance 5 from the same N(0, 1) latents (a
    numpy seed), the dense and the two-level decode of the card's latents,
    refined cells compared where the card and the f32 run both chose them
    (on the coarse volume's scale). Returns ({stage: the card's (max, mean)
    error against f32 / max |f32|}, the same for the CPU's bf16, the cells
    chosen by both per object, the mean error of the card's dense volume
    point-reflected, as a query mapped to -p would give it)."""
    import numpy as np
    import torch

    from regen3d_tpu_torch.models import shapevae as sv
    from regen3d_tpu_torch.models.dit import sample
    from regen3d_tpu_torch.pipeline import phase3_assets as p3
    from regen3d_tpu_torch.pipeline.shape_distill import (
        build_generator,
        load_params,
    )

    c = ASSET_CHECK
    cfg, params = load_params(p3.default_shape_checkpoint())
    lat0 = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (imgs.shape[0], cfg.dit.latent_tokens,
         cfg.dit.latent_dim)).astype(np.float32))
    out = {}
    with torch.no_grad():
        for run, d, dt in (("card", dev, torch.bfloat16),
                           ("bf16", "cpu", torch.bfloat16),
                           ("f32", "cpu", torch.float32)):
            g = build_generator(cfg.with_dtype(dt), params["cond"],
                                params["dit"], params["dec"], device=d)
            card = out.get("card", {})
            given = lambda key, v: card.get(key, v).to(d)
            cond = g.cond(imgs.to(d))
            lat = sample(g.dit, given("cond", cond), num_steps=c["steps"],
                         guidance_scale=5.0, latents=lat0.to(d))
            dense = sv.decode_grid(g.decoder, given("lat", lat),
                                   resolution=c["dense"], chunk=8192)
            # decode_grid gives a batch of one without its batch axis
            dense = dense.reshape(imgs.shape[0], *dense.shape[-3:])
            hier = sv.decode_grid_hierarchical(
                g.decoder, given("lat", lat), resolution=c["res"],
                chunk=8192, refine_cells=c["refine"])
            out[run] = dict(zip(("cond", "lat", "dense", "coarse", "cells",
                                 "fine"),
                                (t.cpu() for t in (cond, lat, dense, *hier))))
    ref = out["f32"]

    def errors(got):
        d = {k: ((got[k].float() - ref[k]).abs(), ref[k].abs().max())
             for k in ("cond", "lat", "dense", "coarse")}
        fine, common = [], []
        for i in range(imgs.shape[0]):
            both, ig, ir = np.intersect1d(got["cells"][i].numpy(),
                                          ref["cells"][i].numpy(),
                                          return_indices=True)
            common.append(len(both))
            fine.append((got["fine"][i][ig].float()
                         - ref["fine"][i][ir]).abs().flatten())
        d["fine"] = (torch.cat(fine), ref["coarse"].abs().max())
        e = {k: (float(a.max() / m), float(a.mean() / m))
             for k, (a, m) in d.items()}
        return e, common

    card, common = errors(out["card"])
    # a query at the wrong point: the card's dense volume at -p
    fault = float((out["card"]["dense"].float().flip(1, 2, 3)
                   - ref["dense"]).abs().mean() / ref["dense"].abs().max())
    return card, errors(out["bf16"])[0], common, fault


def asset_run(cfg, n_obj, dev="cuda"):
    """phase3_assets.run(cfg) on ``dev`` with every stage recorded by a
    _CallSpy; returns (the generator it loaded, {stage: s}, the spies, total
    s, launches)."""
    import torch

    from regen3d_tpu_torch import kernels
    from regen3d_tpu_torch.models import shapevae as sv
    from regen3d_tpu_torch.pipeline import phase3_assets as p3

    names = ("load_default_generator", "load_image_rgba", "resize_bilinear",
             "dit_sample", "decode_grid_hierarchical", "assemble_volume",
             "marching_tetrahedra", "extract_and_clean",
             "vertex_colors_from_image", "save_glb")
    saved = {n: getattr(p3, n) for n in names}
    spies = {n: _CallSpy(f) for n, f in saved.items()}
    spies["chunks"] = _CallSpy(sv._eval_point_chunks)
    spies["cond"] = _CallSpy(p3.CondEncoder.forward)
    forward = p3.CondEncoder.forward
    try:
        for n in names:
            setattr(p3, n, spies[n])
        sv._eval_point_chunks = spies["chunks"]
        p3.CondEncoder.forward = lambda self, img: spies["cond"](self, img)
        kernels.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = p3.run(cfg, device=dev)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = dict(kernels.LAUNCHES)
    finally:
        for n, f in saved.items():
            setattr(p3, n, f)
        sv._eval_point_chunks = spies["chunks"].fn
        p3.CondEncoder.forward = forward
    s = lambda n: sum(call["s"] for call in spies[n].calls)
    chunks = [call["s"] for call in spies["chunks"].calls]
    stages = {
        "checkpoint load": s("load_default_generator"),
        # run resizes the n_obj condition images before the bake's shrinks
        "image load and resize": s("load_image_rgba") + sum(
            call["s"] for call in spies["resize_bilinear"].calls[:n_obj]),
        "condition encoder": s("cond"),
        "sampler": s("dit_sample"),
        "coarse decode": chunks[0],
        "fine decode": chunks[1],
        "trunk and cell ranking": s("decode_grid_hierarchical") - sum(chunks),
        "copy to host and assemble_volume": s("assemble_volume"),
        "marching": s("marching_tetrahedra"),
        "clean and largest component": s("extract_and_clean")
        - s("marching_tetrahedra"),
        "vertex colours": s("vertex_colors_from_image"),
        "GLB write": s("save_glb"),
    }
    gen = spies["load_default_generator"].calls[0]["out"]
    return gen, done, stages, spies, total, counts


# how far the port's bf16 chain may put an object's minimum SDF from the
# JAX package's, given the same image and noise: the bound
# tests/test_torch_phase28.py::test_bus_picture_generator_matches_jax holds
# them to on the bus's prepped picture
JAX_MIN_SDF_ERR = 2e-3


def generator_empty(cfg, spies, name, dev="cuda"):
    """Whether an object's placeholder GLB is what the committed generator
    gives that image and noise, and not a fault of the card: the run's
    volume for it has no sign change (phase 3 writes the 8-vertex
    placeholder for an empty level set); the run's noise, drawn again from
    its seed, gives the run's latents bit for bit from the run's condition
    tokens; and the CPU's plain chain from the run's resized image and that
    noise (condition encoder, the run's Euler steps and guidance, the
    two-level decode at the run's resolution) in f32 and in the
    checkpoint's bf16 has no zero crossing either, the bf16 one (the JAX
    package's dtype) with its minimum |SDF| over JAX_MIN_SDF_ERR, so that
    the JAX package's chain from that noise has none. Returns (verdict,
    {run: (min, max) SDF}, the latents' max error against the CPU's f32 /
    max |f32| for the card and the CPU's bf16, whether the noise replayed,
    the sha256 of the prepped image's pixels)."""
    import hashlib
    import os

    import torch

    from regen3d_tpu_torch.artifacts import Artifacts
    from regen3d_tpu_torch.utils.image import read_png

    from regen3d_tpu_torch.models import shapevae as sv
    from regen3d_tpu_torch.models.dit import sample
    from regen3d_tpu_torch.pipeline import phase3_assets as p3
    from regen3d_tpu_torch.pipeline.shape_distill import (
        build_generator,
        load_params,
    )

    names = [os.path.basename(c["args"][0])[:-4]
             for c in spies["load_image_rgba"].calls]
    i = names.index(name)
    kw = spies["dit_sample"].calls[0]["kwargs"]
    dec = spies["decode_grid_hierarchical"].calls[0]["kwargs"]
    cond = spies["cond"].calls[0]["out"]
    lat = spies["dit_sample"].calls[0]["out"]
    noise = torch.randn(lat.shape, generator=torch.Generator(
        device=dev).manual_seed(int(cfg.get("seed", 1234567))), device=dev)
    gen = spies["load_default_generator"].calls[0]["out"]
    with torch.no_grad():
        replay = sample(gen.dit, cond, num_steps=kw["num_steps"],
                        guidance_scale=kw["guidance_scale"], latents=noise)
    same_noise = bool(torch.equal(replay, lat))
    img = spies["resize_bilinear"].calls[i]["out"].float().cpu()
    ckpt, params = load_params(p3.default_shape_checkpoint())
    sdf = {"card": spies["assemble_volume"].calls[0]["out"][i]}
    lats = {}
    for run, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        g = build_generator(ckpt.with_dtype(dt), params["cond"],
                            params["dit"], params["dec"], device="cpu")
        with torch.no_grad():
            lats[run] = sample(g.dit, g.cond(img), num_steps=kw["num_steps"],
                               guidance_scale=kw["guidance_scale"],
                               latents=noise[i:i + 1].cpu())
            sdf[run] = sv.assemble_volume(*sv.decode_grid_hierarchical(
                g.decoder, lats[run], resolution=dec["resolution"],
                chunk=dec["chunk"]), dec["resolution"])[0]
    ranges = {k: (float(v.min()), float(v.max())) for k, v in sdf.items()}
    ref = lats["f32"][0]
    lat_err = {k: float((v.float().cpu() - ref).abs().max()
                        / ref.abs().max())
               for k, v in (("card", lat[i]), ("bf16", lats["bf16"][0]))}
    sign = ranges["card"][0] > 0
    one_sign = lambda lo, hi, margin=0.0: (lo > margin if sign
                                           else hi < -margin)
    verdict = (same_noise and all(one_sign(*r) for r in ranges.values())
               and one_sign(*ranges["bf16"], JAX_MIN_SDF_ERR))
    pixels = read_png(os.path.join(Artifacts(cfg).prepped_dir,
                                   f"{name}.png"))[0]
    return (verdict, ranges, lat_err, same_noise,
            hashlib.sha256(pixels.tobytes()).hexdigest())


def asset_gates(cfg, stems, gen, done, spies, counts):
    """The run's failed gates: a GLB per object, each mesh finite and more
    than the placeholder's 8 vertices (over 24), colours in [0, 1], the
    latents' shape, and the flash kernel launched once per attention call:
    the condition encoder's blocks, two per DiT block and step, the
    decoder's trunk blocks and one per query chunk. Each mesh's size is
    printed. A placeholder passes only where generator_empty shows that
    the committed generator gives that image and the run's noise no zero
    crossing, on the card and on the CPU in f32 and in bf16 (the bf16
    chain's minimum |SDF| over the margin by which a CPU test holds it to
    the JAX package's), and at least one object must mesh."""
    import numpy as np

    from regen3d_tpu_torch.artifacts import Artifacts
    from regen3d_tpu_torch.utils.glb import load_glb

    art = Artifacts(cfg)
    bad = []
    if done != sorted(stems) or art.list_assets() != sorted(stems):
        bad.append(f"assets {art.list_assets()} for {sorted(stems)}")
    meshed = 0
    for name in art.list_assets():
        m = load_glb(art.asset_glb(name)).meshes[0]
        col = m.vertex_colors
        log(f"  {name}: {len(m.vertices)} vertices, {len(m.faces)} faces")
        colours_ok = (col is not None and 0 <= col.min() and col.max() <= 1
                      and np.isfinite(m.vertices).all())
        if len(m.vertices) > 24 and colours_ok:
            meshed += 1
            continue
        empty, ranges, lat_err, same_noise, sha = generator_empty(
            cfg, spies, name)
        log(f"  {name}: the placeholder; its prepped pixels' sha256 {sha}; "
            f"the run's noise drawn again gives "
            f"its latents bit for bit: {same_noise}; SDF (min, max) "
            + ", ".join(f"{k} [{lo:.5f}, {hi:.5f}]"
                        for k, (lo, hi) in ranges.items())
            + f" (the CPU's chains from the run's image and noise); latents "
            f"max error / max |f32|: {lat_err}; no zero crossing in any, "
            f"the bf16 chain's over {JAX_MIN_SDF_ERR} from 0: {empty}")
        if not (empty and colours_ok and len(m.vertices) == 8):
            bad.append(f"{name}: {len(m.vertices)} vertices, colours "
                       f"{None if col is None else (col.min(), col.max())}, "
                       f"SDF {ranges}, the noise replayed: {same_noise}")
    if meshed == 0:
        bad.append("no object meshed")
    kw = spies["decode_grid_hierarchical"].calls[0]["kwargs"]
    c = kw["resolution"] // 4
    points = (c ** 3, min(8 * c * c, c ** 3) * 4 ** 3)
    steps = spies["dit_sample"].calls[0]["kwargs"]["num_steps"]
    expected = (gen.cond.depth + 2 * steps * gen.dit_cfg.depth
                + gen.vae_cfg.dec_depth
                + sum(-(-p // kw["chunk"]) for p in points))
    if counts["flash_fwd"] != expected:
        bad.append(f"{counts['flash_fwd']} flash launches, {expected} "
                   f"expected")
    lat = spies["dit_sample"].calls[0]["out"]
    if tuple(lat.shape) != (len(stems), gen.dit_cfg.latent_tokens,
                            gen.dit_cfg.latent_dim):
        bad.append(f"latents {tuple(lat.shape)}")
    return bad, expected


def asset_repeat(cfg, gen, spies, dev="cuda"):
    """generate_sdf_batch again on the run's resized images from the run's
    seed: bit for bit the run's volumes. If the run's generation took over
    10 s, two calls at 128³ from one seed are compared instead. Returns
    (resolution, s, the same)."""
    import numpy as np
    import torch

    n_obj = len(spies["load_image_rgba"].calls)
    imgs = torch.stack([call["out"][0] for call in
                        spies["resize_bilinear"].calls[:n_obj]])
    kw = spies["decode_grid_hierarchical"].calls[0]["kwargs"]
    steps = spies["dit_sample"].calls[0]["kwargs"]["num_steps"]
    guidance = spies["dit_sample"].calls[0]["kwargs"]["guidance_scale"]
    t_gen = sum(call["s"] for n in ("cond", "dit_sample",
                                    "decode_grid_hierarchical")
                for call in spies[n].calls)
    res = kw["resolution"] if t_gen <= 10 else 128
    seed = int(cfg.get("seed", 1234567))
    run = lambda: gen.generate_sdf_batch(
        torch.Generator(device=dev).manual_seed(seed), imgs, steps, guidance,
        res, kw["chunk"])
    first = (spies["assemble_volume"].calls[0]["out"]
             if res == kw["resolution"] else run())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = run()
    dt = time.perf_counter() - t0
    return res, dt, bool(np.array_equal(again, first))


def phase_assets(results):
    """Phase 2, then phase 3 on the committed checkpoint
    (checkpoints/shape_distilled.npz: a condition encoder of width 256 and
    depth 2 on 64² RGBA, a shape DiT of width 256 and depth 6 on 64 × 16
    latents, an SDF decoder of width 256 with 4 trunk blocks). Phase 2 on
    phase_bus's findings (asset_phase2) writes the prepped images phase 3
    reads. First asset_card_vs_cpu on the ones phase 3 takes: each
    stage's max and mean error against the CPU's f32 within ASSET_MAX_ERR,
    ASSET_MEAN_ERR and ASSET_MEAN_OVER_BF16 times the CPU's bf16 error,
    and the dense volume at -p over ASSET_MEAN_ERR. Then
    phase3_assets.run at the defaults (50 Euler steps, guidance 5, the
    two-level 256³ decode in chunks of 16000 → 8192) on the prepped images
    of the first ASSET_OBJECTS of phase_bus's objects, every stage
    timed (asset_run) and gated (asset_gates); a second generate_sdf_batch
    from the same seed gives the run's volumes bit for bit (asset_repeat);
    last, the flash kernel at phase 3's three shapes against its plain
    version, timed beside SDPA (PHASE3_FLASH_SHAPES)."""
    import os
    import shutil

    import numpy as np
    import torch

    from regen3d_tpu_torch.artifacts import Artifacts
    from regen3d_tpu_torch.config import default_config
    from regen3d_tpu_torch.models.layers import resize_bilinear
    from regen3d_tpu_torch.utils.image import load_image_rgba

    root = ROOT / "build" / "assets"
    shutil.rmtree(root, ignore_errors=True)
    bus = ROOT / "build" / "bus" / "bus"
    cfg = default_config(str(root / "output"),
                         input_image=str(bus / "input.png"))
    art = Artifacts(cfg)
    stems, t_p2, bad = asset_phase2(bus, cfg, ASSET_OBJECTS)
    aside = str(Path(art.prepped_dir).parent / "prepped_aside")
    log(f"phase 2 (run_phases(cfg, [2]) on the bus's 9 findings, offline "
        f"inpainter, host): {t_p2:.2f} s; prepped 8 objects and the empty "
        f"room; phase 3 takes {stems}")
    if bad:
        raise AssertionError(f"phase 2: {bad}")

    # the check keeps the 2 objects it held before phase 3's run went to 1
    checked = sorted(f[:-4] for d in (art.prepped_dir, aside)
                     for f in os.listdir(d))[:ASSET_CHECK_OBJECTS]
    small = torch.cat([resize_bilinear(torch.from_numpy(load_image_rgba(
        os.path.join(art.prepped_dir if s in stems else aside, f"{s}.png"))
        .astype(np.float32) / 255.0)[None], (64, 64)) for s in checked])
    t0 = time.perf_counter()
    card, bf16, common, fault = asset_card_vs_cpu(small)
    c = ASSET_CHECK
    fmt = lambda e: {k: f"{a:.3e}/{m:.3e}" for k, (a, m) in e.items()}
    log(f"phase 3 generator against the CPU's f32 plain versions, each stage "
        f"given the card's input, max/mean error / max |f32|: the card (bf16, "
        f"kernels) {fmt(card)}, the CPU's bf16 {fmt(bf16)} (tol: max "
        f"{ASSET_MAX_ERR}, mean {ASSET_MEAN_ERR} and "
        f"{ASSET_MEAN_OVER_BF16}x the CPU's bf16); {c['steps']} steps, "
        f"dense {c['dense']}³, two-level {c['res']}³ with {c['refine']} "
        f"cells refined, {common} chosen by the card and f32 alike; the "
        f"dense volume at -p, mean {fault:.3e}; "
        f"{time.perf_counter() - t0:.1f} s")
    over = {k: e for k, e in card.items()
            if e[0] > ASSET_MAX_ERR[k] or e[1] > ASSET_MEAN_ERR
            or e[1] > ASSET_MEAN_OVER_BF16 * bf16[k][1]}
    if over or fault <= ASSET_MEAN_ERR:
        raise AssertionError(f"phase 3 generator: card vs CPU f32 {over}, "
                             f"the volume at -p {fault:.3e}")

    gen, done, stages, spies, total, counts = asset_run(cfg, len(stems))
    # each spied call records its own peak
    peak = max(call["peak"] for spy in spies.values()
               for call in spy.calls) / 2 ** 30
    results["phase3_launches"] = counts
    log(f"phase 3 (phase3_assets.run at the defaults, {len(stems)} objects):"
        f" {total:.2f} s; " + ", ".join(f"{k} {v:.3f}"
                                        for k, v in stages.items())
        + f" s; peak {peak:.2f} GiB; launches {counts}")
    bad, expected = asset_gates(cfg, stems, gen, done, spies, counts)
    if bad:
        raise AssertionError(f"phase 3: {bad}")
    log(f"phase 3: {counts['flash_fwd']} flash launches, as counted "
        f"({expected})")

    res, dt, same = asset_repeat(cfg, gen, spies)
    log(f"phase 3 repeat: generate_sdf_batch at {res}³ from the same seed "
        f"in {dt:.3f} s, the same volumes bit for bit: {same}")
    if not same:
        raise AssertionError("phase 3: a second generate_sdf_batch from the "
                             "same seed gave other volumes")
    del spies

    gen_t = torch.Generator(device="cuda").manual_seed(5)
    shapes = []
    for shape in PHASE3_FLASH_SHAPES:
        r = fwd_case(shape, gen_t)
        results["flash_fwd"]["max_abs_err"] = max(
            results["flash_fwd"]["max_abs_err"], r["err"])
        shapes.append(dict(shape=shape, err=r["err"], bound_ms=r["bound"][0],
                           bound_by=r["bound"][1], **r["ms"]))
    results["flash_fwd"]["phase3_shapes"] = shapes


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


# phase_scene's fit iterations: 5, not bench.py's 50, so the script keeps
# its time with phase 8 on the bus and phase 3's texture paths; its time
# is scene_step_5it, which does not compare with the 10-iteration
# scene_step_10it or the 50-iteration scene_step of earlier runs
SCENE_ITERS = 5


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
    del gpu_model

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
    # SCENE_ITERS of bench.py's 50 fit iterations: scene_step_{SCENE_ITERS}it
    fit_cfg = _scene_fit_cfg(cfg.image_size, iters=SCENE_ITERS)
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
        dev_vggt = device_top(lambda: model(args[0][None]), 0)[0]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"scene_step_{SCENE_ITERS}it VGGT-1B 518² x2 frames + 8 objects x "
        f"{SCENE_ITERS} fit iters @ 518² (object_chunk=2): first "
        f"{first:.2f} s, median of {runs} "
        f"{ts[len(ts) // 2]:.2f} s {[round(t, 3) for t in ts]}; VGGT forward "
        f"alone {t_vggt:.3f} s ({dev_vggt:.2f} ms of device time under "
        f"torch.profiler, one more call); peak {peak:.1f} GiB; valid points "
        f"{int(res.points_valid.sum())}; launches {counts}")
    results["scene_launches"] = counts
    results["scene_sec"] = ts[len(ts) // 2]
    # phase_parallel holds the scene step over a mesh to this run
    results["scene_ref"] = res
    # phase_camera drives phase 4 with these two models, then drops them
    results["vggt_models"] = dict(small=cpu_model, full=model)


def _camera_pngs(root):
    """Two small PNGs for the small VGGT: a 48×64 one (its pad rows are
    masked) and a 56×56 one, noise over smooth colour ramps."""
    import numpy as np

    from regen3d_tpu_torch.utils.image import save_image

    rng = np.random.default_rng(5)
    paths = []
    for name, (h, w) in (("wide.png", (48, 64)), ("square.png", (56, 56))):
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([xx * 255 / w, yy * 255 / h, (xx + yy) * 127 / (h + w)],
                       -1) + rng.normal(0, 20, (h, w, 3))
        paths.append(str(root / name))
        save_image(paths[-1], np.clip(img, 0, 255).astype(np.uint8))
    return tuple(paths)


@contextlib.contextmanager
def _merge_decisions(record=None, replay=None):
    """FastVGGT merging with its decisions recorded (``record``, a list
    that gains each call's (best, kept_idx, merged_idx) on the CPU) or
    replayed (``replay``, such a list, consumed in order): the merge itself
    is computed as models/vggt._merge_global_tokens computes it, from the
    decisions given. For camera_small_check only."""
    import torch

    from regen3d_tpu_torch.models import vggt

    orig = vggt._merge_global_tokens

    def recorded(g, f, n_tok, n_special, r):
        compact, info = orig(g, f, n_tok, n_special, r)
        record.append(tuple(t.cpu() for t in info))
        return compact, info

    def replayed(g, f, n_tok, n_special, r):
        best, kept_idx, merged_idx = (t.to(g.device) for t in replay.pop(0))
        d = g.shape[-1]
        src = g[n_tok:].reshape(f - 1, n_tok, d)
        src_patch = src[:, n_special:].reshape(-1, d)
        mask = torch.zeros(src_patch.shape[0], dtype=g.dtype, device=g.device)
        mask[merged_idx] = 1.0
        onehot = (best[:, None] == torch.arange(n_tok, device=g.device)).to(
            g.dtype) * mask[:, None]
        dst = (g[:n_tok] + onehot.T @ src_patch) / (1.0 + onehot.sum(0))[:, None]
        compact = torch.cat([dst, src[:, :n_special].reshape(-1, d),
                             src_patch[kept_idx]], 0)
        return compact, (best, kept_idx, merged_idx)

    vggt._merge_global_tokens = recorded if replay is None else replayed
    try:
        yield
    finally:
        vggt._merge_global_tokens = orig


def camera_small_check(cpu_model, root):
    """run_vggt_inference with phase_scene's small VGGT (the same weights)
    on the card (bf16, kernels) against the CPU (f32, plain versions), on
    a non-square and a square PNG at the model's 70², conf_thres_value 1.0
    and a cap of 2,000 points that bites: the same number of points kept;
    points, R, t, fx and fy within phase_scene's bound (5e-2 of max |ref|,
    from bf16). Then with token_merge_ratio 0.5: which tokens merge is a
    discrete choice over similarities the card rounds to bf16, so the CPU
    replays the card's choices (_merge_decisions) and is held to the same
    bound, and the share of the card's merged tokens the CPU would have
    chosen itself is printed. Returns ({ratio: (largest error, points
    kept)}, that share)."""
    import dataclasses

    import torch

    from regen3d_tpu_torch.config import default_config
    from regen3d_tpu_torch.models.vggt import VGGT
    from regen3d_tpu_torch.pipeline import phase4_camera

    paths = _camera_pngs(root)
    cfg = default_config(str(root / "output"), conf_thres_value=1.0,
                         max_points_for_colmap=2000)
    small = dataclasses.replace(cpu_model.cfg, dtype=torch.bfloat16)
    res = small.image_size
    errs, share = {}, None
    for ratio in (0.0, 0.5):
        c_model = VGGT(dataclasses.replace(cpu_model.cfg,
                                           token_merge_ratio=ratio),
                       device="cpu")
        c_model.load_state_dict(cpu_model.state_dict())
        g_model = VGGT(dataclasses.replace(small, token_merge_ratio=ratio))
        g_model.load_state_dict(cpu_model.state_dict())
        card, own = [], []
        with _merge_decisions(record=card):
            got = phase4_camera.run_vggt_inference(cfg, g_model, paths, res,
                                                   device="cuda")
        if ratio > 0:
            with _merge_decisions(record=own):
                phase4_camera.run_vggt_inference(cfg, c_model, paths, res,
                                                 device="cpu")
            share = sum(len(set(a[2].tolist()) & set(b[2].tolist()))
                        for a, b in zip(card, own)) / sum(
                len(a[2]) for a in card)
        with _merge_decisions(replay=list(card)):
            want = phase4_camera.run_vggt_inference(cfg, c_model, paths, res,
                                                    device="cpu")
        worst = {}
        for name, w in want.items():
            g = got[name]
            if len(g["points"]) != len(w["points"]):
                raise AssertionError(
                    f"small phase 4 (merge {ratio}): {name} kept "
                    f"{len(g['points'])} points on the card, "
                    f"{len(w['points'])} on the CPU")
            for key in ("points", "R", "t", "fx", "fy"):
                ref = torch.as_tensor(w[key], dtype=torch.float64)
                e = float((torch.as_tensor(g[key], dtype=torch.float64)
                           - ref).abs().max() / ref.abs().max())
                worst[key] = max(worst.get(key, 0.0), e)
        errs[ratio] = (worst, {n: len(w["points"]) for n, w in want.items()})
        if max(worst.values()) >= 5e-2:
            raise AssertionError(f"small phase 4 (merge {ratio}), card vs "
                                 f"CPU: {worst} of max |ref| (tol 5e-2)")
    return errs, share


def camera_oracle_check(root):
    """The verify skill's oracle phase 4 through the port: a small bus's
    view points (build_bus, 240×320) written by export_reconstruction as
    one synthetic frame (raw = diag(−1, −1, 1)·view / vggt_scene_scale,
    identity camera, the bus's focal), then phase 5 on the card and on the
    CPU (masks eroded by 1 px, as bus_small_check's): every object's cloud the same on both, at most 0.5% of a cloud on
    one device only (bus_small_check's rule: projection and neighbour
    ties round otherwise on the card). Returns that share and the points
    exported."""
    import shutil

    import numpy as np

    from regen3d_tpu_torch import orchestrator
    from regen3d_tpu_torch.artifacts import Artifacts
    from regen3d_tpu_torch.config import default_config
    from regen3d_tpu_torch.pipeline.phase4_camera import export_reconstruction
    from regen3d_tpu_torch.pipeline.phase5_extract import scene_cloud_to_world
    from regen3d_tpu_torch.utils.ply import load_ply

    hw = (240, 320)
    truth = build_bus(root / "bus", "cpu", hw=hw, vggt=160, grid=6,
                      room_points=4000, empty_hw=(120, 160))
    art = Artifacts(default_config(str(root / "bus" / "output")))
    view = scene_cloud_to_world(
        load_ply(art.scene_cloud_ply).vertices.astype(np.float64))
    cfg = default_config(str(root / "bus" / "output"))
    scale = float(cfg["vggt_scene_scale"])
    focal = BUS_FOCAL * hw[0] / BUS_HW[0]
    export_reconstruction(cfg, {"input.png": dict(
        points=view * [-1.0, -1.0, 1.0] / scale, R=np.eye(3),
        t=np.zeros(3), fx=focal, fy=focal, cx=hw[1] / 2.0, cy=hw[0] / 2.0,
        width=hw[1], height=hw[0])})
    for d in ("cuda", "cpu"):
        shutil.copytree(root / "bus", root / d)
        orchestrator.run_phases(default_config(
            str(root / d / "output"), mask_shrink_pixels=1,
            mask_shrink_iterations=1), [5], device=d)
    only = 0.0
    for stem in truth:
        rows = [{tuple(v) for v in load_ply(str(
            root / d / "output" / "pointclouds" / f"{stem}.ply")).vertices}
            for d in ("cuda", "cpu")]
        if not rows[1]:
            raise AssertionError(f"oracle phase 4: no cloud for {stem}")
        only = max(only, len(rows[0] ^ rows[1]) / len(rows[1]))
    if only > 0.005:
        raise AssertionError(f"oracle phase 4 then phase 5, card vs CPU: "
                             f"{only:.3%} of a cloud on one device only "
                             f"(tol 0.5%)")
    return only, len(view)


def ba_small_check():
    """joint_bundle_adjust on a small shifted-views problem (a textured
    plane seen twice, the second view shifted 4 px; tracks from the CPU's
    predict_tracks) on the card against the CPU: the RMSE within 1e-3 px.
    Returns the two RMSEs."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from regen3d_tpu_torch.ops.bundle_adjust import joint_bundle_adjust
    from regen3d_tpu_torch.ops.tracks import predict_tracks

    rng = np.random.default_rng(4)
    base = torch.from_numpy(rng.random((1, 3, 12, 12)).astype(np.float32))
    img = F.interpolate(base, size=(96, 96), mode="bilinear",
                        align_corners=False)[0].permute(1, 2, 0)
    imgs = torch.stack([img, torch.roll(img, 4, dims=1)])
    tr = predict_tracks(imgs, num_points=48)
    xy, vis = tr.xy.numpy(), tr.vis.numpy()
    f = 120.0
    pp = np.tile(np.asarray([[48.0, 48.0]], np.float32), (2, 1))
    pts0 = np.stack([(xy[0, :, 0] - 48.0) / f * 2.0,
                     (xy[0, :, 1] - 48.0) / f * 2.0,
                     np.full(len(xy[0]), 2.0)], -1).astype(np.float32)
    d = xy[1] - xy[0]
    med = np.median(d[vis[1] > 0.9], axis=0)
    w = ((vis > 0.9) & (np.abs(d - med).max(-1) < 2.0)[None]).astype(np.float32)
    args = (pts0, xy, w, np.tile(np.eye(3, dtype=np.float32), (2, 1, 1)),
            np.zeros((2, 3), np.float32), np.full((2,), f, np.float32), pp)
    rmse = {}
    for dev in ("cuda", "cpu"):
        res = joint_bundle_adjust(*(torch.as_tensor(a, device=dev)
                                    for a in args), max_iterations=40,
                                  refine_focal=False)
        rmse[dev] = float(res.rmse_px)
    if not (abs(rmse["cuda"] - rmse["cpu"]) <= 1e-3 and rmse["cpu"] < 0.5):
        raise AssertionError(f"shifted-views BA, card vs CPU: RMSE {rmse}")
    return rmse


def _phase4_run(cfg, model):
    """phase4_camera.run(cfg, model) on the card with its stages timed by
    _CallSpy: (load and preprocess s, forward s, unprojection, filter and
    the BA if on s, export s, total s, launches, the frames exported, the
    model's output, the preprocessed inputs)."""
    import torch

    from regen3d_tpu_torch import kernels
    from regen3d_tpu_torch.pipeline import phase4_camera

    prep = _CallSpy(phase4_camera.preprocess_square)
    export = _CallSpy(phase4_camera.export_reconstruction)
    fwd = _CallSpy(model)
    saved = (phase4_camera.preprocess_square,
             phase4_camera.export_reconstruction)
    phase4_camera.preprocess_square = prep
    phase4_camera.export_reconstruction = export
    try:
        kernels.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        phase4_camera.run(cfg, model=fwd, device="cuda")
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = dict(kernels.LAUNCHES)
    finally:
        (phase4_camera.preprocess_square,
         phase4_camera.export_reconstruction) = saved
    t_prep = sum(c["s"] for c in prep.calls)
    t_fwd = fwd.calls[0]["s"]
    t_export = export.calls[0]["s"]
    return dict(prep=t_prep, fwd=t_fwd, export=t_export,
                unproject=total - t_prep - t_fwd - t_export, total=total,
                launches=counts, frames=export.calls[0]["args"][1],
                out=fwd.calls[0]["out"], inputs=[c["out"] for c in prep.calls])


def camera_artifact_check(cfg, run):
    """Phase 4's artifact contract on one run's output: every file present
    and finite; frame 0's camera.npz extrinsic R_fix and a zero translation
    (within 1e-6: the rebase multiplies VGGT's f32 rotation by its own
    transpose in f64, which is the identity only to the rotation's
    orthogonality); ColmapReconstruction.read gives back the cameras,
    images and points within the text's precision; the points kept equal
    the confident, unpadded pixels, capped at max_points_for_colmap."""
    import os

    import numpy as np

    from regen3d_tpu_torch.artifacts import Artifacts
    from regen3d_tpu_torch.transforms.conventions import R_FIX_CV2BLENDER
    from regen3d_tpu_torch.utils.colmapio import ColmapReconstruction
    from regen3d_tpu_torch.utils.ply import load_ply

    art = Artifacts(cfg)
    sparse = art.colmap_sparse
    plys = [os.path.join(sparse, n) for n in (
        "points.ply", "points_emptyRoom_pre.ply", "points_emptyRoom.ply",
        "points_emptyRoom_aligned.ply")] + [art.scene_cloud_ply]
    for p in plys:
        v = load_ply(p).vertices
        if not (len(v) and np.isfinite(v).all()):
            raise AssertionError(f"phase 4: {p} empty or not finite")
    for p in (art.camera_npz, art.camera_empty_npz):
        with np.load(p) as z:
            if not all(np.isfinite(z[k]).all() for k in z.files):
                raise AssertionError(f"phase 4: {p} not finite")
    with np.load(art.camera_npz) as z:
        ext = z["extrinsic"]
    e_rot = float(np.abs(ext[:3, :3] - R_FIX_CV2BLENDER).max())
    e_t = float(np.abs(ext[:3, 3]).max())
    if not (e_rot <= 1e-6 and e_t <= 1e-6):
        raise AssertionError(f"phase 4: frame 0's extrinsic is R_fix within "
                             f"{e_rot:.2e} and t within {e_t:.2e} (tol 1e-6)")
    rec = ColmapReconstruction.read(sparse)
    frames = run["frames"]
    names = list(frames)
    if [im.name for im in rec.images.values()] != names:
        raise AssertionError("phase 4: images.txt names differ")
    R0 = np.asarray(frames[names[0]]["R"], np.float64)
    t0 = np.asarray(frames[names[0]]["t"], np.float64)
    pts, e_cam, e_pose = [], 0.0, 0.0
    for i, name in enumerate(names):
        fr = frames[name]
        want = np.asarray([fr["fx"], fr["fy"], fr["cx"], fr["cy"]])
        e_cam = max(e_cam, float(np.abs(rec.cameras[i + 1].params - want).max()
                                 / np.abs(want).max()))
        R = np.asarray(fr["R"], np.float64) @ R0.T
        t = np.asarray(fr["t"], np.float64) - R @ t0
        got = rec.images[i + 1].cam_from_world()
        e_pose = max(e_pose, float(np.abs(got[:, :3] - R).max()),
                     float(np.abs(got[:, 3] - t).max()
                           / max(np.abs(t).max(), 1.0)))
        pts.append((np.asarray(fr["points"], np.float64) @ R0.T + t0)
                   .astype(np.float32))
    pts = np.concatenate(pts).astype(np.float64)
    e_pts = float((np.abs(rec.points - pts)
                   / np.maximum(np.abs(pts), 1e-30)).max())
    if not (e_cam <= 1e-9 and e_pose <= 1e-6 and e_pts <= 1e-7
            and len(rec.points) == len(pts)):
        raise AssertionError(f"phase 4: COLMAP text read back: cameras "
                             f"{e_cam:.2e} (tol 1e-9), poses {e_pose:.2e} "
                             f"(tol 1e-6), points {e_pts:.2e} (tol 1e-7)")
    thr = float(cfg.get("conf_thres_value", 1.0))
    cap = int(cfg.get("max_points_for_colmap", 10_000_000))
    conf = run["out"]["depth_conf"][0].cpu().numpy()
    kept = []
    for i, name in enumerate(names):
        n = int(((conf[i] >= thr) & run["inputs"][i][1]).sum())
        kept.append((len(frames[name]["points"]), min(n, cap)))
    if any(a != b for a, b in kept):
        raise AssertionError(f"phase 4: points kept {kept} (exported, "
                             f"confident unpadded pixels capped)")
    return dict(rot=e_rot, t=e_t, cam=e_cam, pose=e_pose, pts=e_pts,
                kept=[a for a, _ in kept])


def phase_camera(results):
    """Phase 4 of the port (pipeline/phase4_camera.py) on the card. First
    the small checks: phase_scene's small VGGT through run_vggt_inference
    on the card against the CPU, plain and with token_merge_ratio 0.5
    (camera_small_check); the oracle phase 4 (export_reconstruction, then
    phase 5 on each device; camera_oracle_check); a small shifted-views
    joint BA on the card against the CPU (ba_small_check). Then
    phase_scene's VGGT-1B through phase4_camera.run on the bus's 960×1280
    input and empty-room images (padded to 1280², resized to 518²) into a
    fresh output root: its stages timed (load and preprocess, forward,
    unprojection and filter, export), the artifact contract gated
    (camera_artifact_check), the flash kernel's launches counted
    (phase4_launches). The same with use_ba (2,048 query tracks, two passes
    of 25 Gauss-Newton iterations): camera 0's translation bit for bit the
    plain run's, its rotation and focal within 1e-6 (the BA's so3_exp ∘
    so3_log and exp ∘ log round them), a finite RMSE and cameras. Then
    with token_merge_ratio 0.5 (the same weights): times, launches, finite
    artifacts, the forward alone timed plain and merged, and the flash
    kernel at the compact global length held against its plain version
    (fwd_case, fwd_error's bound)."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from regen3d_tpu_torch.config import default_config
    from regen3d_tpu_torch.utils.image import save_image

    from regen3d_tpu_torch.artifacts import Artifacts

    t_phase = time.perf_counter()
    models = results.pop("vggt_models")
    root = ROOT / "build" / "camera"
    shutil.rmtree(root, ignore_errors=True)
    (root / "small").mkdir(parents=True)
    small, share = camera_small_check(models["small"], root / "small")
    oracle, n_oracle = camera_oracle_check(root / "oracle")
    ba_small = ba_small_check()

    model = models["full"]
    with torch.no_grad():    # warm-up, untimed and uncounted
        model(torch.rand((1, 2, 518, 518, 3), device="cuda"))
    objs = bus_objects()
    image, empty, _ = bus_images(objs, BUS_HW, "cuda",
                                 np.random.default_rng(0))
    runs, arts = {}, {}
    for name, over in (("plain", {}), ("ba", dict(use_ba=True)),
                       ("merge", {})):
        r = root / name
        cfg = default_config(str(r / "output"), input_image=str(r / "input.png"),
                             **over)
        save_image(str(r / "input.png"), image)
        save_image(Artifacts(cfg).empty_room, empty)
        agg = model.aggregator
        if name == "merge":
            agg.cfg = dataclasses.replace(agg.cfg, token_merge_ratio=0.5)
        try:
            runs[name] = _phase4_run(cfg, model)
        finally:
            agg.cfg = dataclasses.replace(agg.cfg, token_merge_ratio=0.0)
        arts[name] = camera_artifact_check(cfg, runs[name])
        if runs[name]["launches"]["flash_fwd"] == 0:
            raise AssertionError(f"phase 4 ({name}) did not launch the flash "
                                 f"kernel")
    fr_p = runs["plain"]["frames"]["input.png"]
    fr_b = runs["ba"]["frames"]["input.png"]
    e_r0 = float(np.abs(fr_b["R"] - fr_p["R"]).max())
    e_f0 = max(abs(fr_b[k] / fr_p[k] - 1.0) for k in ("fx", "fy"))
    rmse = fr_b.get("ba_rmse_px", float("nan"))
    ba_cams = np.concatenate([np.ravel(f[k]) for f in
                              runs["ba"]["frames"].values()
                              for k in ("R", "t", "fx", "fy")])
    if not (np.array_equal(fr_b["t"], fr_p["t"]) and e_r0 <= 1e-6
            and e_f0 <= 1e-6 and np.isfinite(rmse)
            and np.isfinite(ba_cams).all()):
        raise AssertionError(
            f"phase 4 with use_ba: camera 0's t equal {np.array_equal(fr_b['t'], fr_p['t'])}, "
            f"R within {e_r0:.2e}, focal within {e_f0:.2e} (tol 1e-6), "
            f"RMSE {rmse}, cameras finite {np.isfinite(ba_cams).all()}")
    # the forward alone, plain and merged: host-clock median of 5 calls
    agg = model.aggregator
    x = torch.rand((1, 2, 518, 518, 3), device="cuda")
    fwd_s = {}
    for ratio in (0.0, 0.5):
        agg.cfg = dataclasses.replace(agg.cfg, token_merge_ratio=ratio)
        ts = []
        with torch.no_grad():
            for _ in range(6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model(x)
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t0)
        fwd_s[ratio] = sorted(ts[1:])[2]
    agg.cfg = dataclasses.replace(agg.cfg, token_merge_ratio=0.0)
    # the flash kernel at the merged compact global length
    c = model.cfg
    n_tok = 1 + c.num_register_tokens + c.grid * c.grid
    r = int(0.5 * (n_tok - 1 - c.num_register_tokens))
    gen = torch.Generator(device="cuda").manual_seed(11)
    compact = fwd_case((1, c.num_heads, 2 * n_tok - r, 2 * n_tok - r,
                        c.width // c.num_heads), gen, timed=False)
    results["flash_fwd"]["max_abs_err"] = max(
        results["flash_fwd"]["max_abs_err"], compact["err"])
    results["phase4_launches"] = runs["plain"]["launches"]
    results["phase4_ba_launches"] = runs["ba"]["launches"]
    results["phase4_merge_launches"] = runs["merge"]["launches"]

    def stages(x):
        return (f"load and preprocess {x['prep']:.3f} s, forward "
                f"{x['fwd']:.3f} s, unprojection and filter"
                f"{' and BA' if x is runs['ba'] else ''} {x['unproject']:.3f}"
                f" s, export {x['export']:.3f} s, total {x['total']:.3f} s, "
                f"flash launches {x['launches']['flash_fwd']}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    a = arts["plain"]
    def worst(e):
        return ", ".join(f"{k} {v:.3e}" for k, v in e.items())
    log(f"phase 4, small VGGT card vs CPU, of max |ref| (tol 5e-2): "
        f"{worst(small[0.0][0])} (points kept {small[0.0][1]}); merged 0.5, "
        f"the CPU on the card's merge choices: {worst(small[0.5][0])}, "
        f"{share:.1%} of the card's merged tokens the CPU's own choice; "
        f"oracle phase 4 ({n_oracle} points exported) then "
        f"phase 5, card vs CPU: {oracle:.3%} of a cloud on one device only; "
        f"shifted-views BA RMSE card {ba_small['cuda']:.6f} px, CPU "
        f"{ba_small['cpu']:.6f} px")
    log(f"phase 4 VGGT-1B 518² x2 frames (960×1280 input and empty room): "
        f"{stages(runs['plain'])}; points kept {a['kept']}; frame 0's "
        f"extrinsic R_fix within {a['rot']:.2e}, t {a['t']:.2e}; COLMAP read "
        f"back: cameras {a['cam']:.2e}, poses {a['pose']:.2e}, points "
        f"{a['pts']:.2e}; {smi}")
    log(f"phase 4 with use_ba (2048 query tracks, 2 x 25 GN iterations): "
        f"{stages(runs['ba'])}; RMSE {rmse:.4f} px, tracks used "
        f"{fr_b.get('ba_n_tracks_used')}; camera 0: t bit for bit, R "
        f"{e_r0:.2e}, focal {e_f0:.2e}")
    log(f"phase 4 with token_merge_ratio 0.5 (global length {2 * n_tok} -> "
        f"{2 * n_tok - r}): {stages(runs['merge'])}; points kept "
        f"{arts['merge']['kept']}; flash at the compact length: o err "
        f"{compact['err']:.3e} (SDPA's {compact['sdpa_err']:.3e}); the "
        f"forward alone, median of 5 after a warm-up: plain "
        f"{fwd_s[0.0]:.4f} s, merged {fwd_s[0.5]:.4f} s")
    log(f"phase_camera: {time.perf_counter() - t_phase:.1f} s")
    del models, model
    torch.cuda.empty_cache()


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
            seen[key + "_args"] = args
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
    with torch.no_grad():
        dev_enc = device_top(lambda: encode(*seen["encode_s_args"]), 0)[0]
    med = lambda xs: sorted(xs)[len(xs) // 2]
    areas = [int(d.mask.sum()) for d in dets]
    log(f"phase 1 SAM-H 1024² (32 blocks, width 1280) on a 960x1280 image, "
        f"8 boxes, 2 decoder passes: detect_and_segment median of {runs} "
        f"{med(ts):.3f} s {[round(t, 4) for t in ts]}; encode median "
        f"{1e3 * med(seen['encode_s']):.2f} ms "
        f"{[round(1e3 * t, 2) for t in seen['encode_s']]} ({dev_enc:.2f} ms of "
        f"device time under torch.profiler, one more encode); decode per pass "
        f"median {1e3 * med(seen['decode_s']):.2f} ms "
        f"{[round(1e3 * t, 2) for t in seen['decode_s']]}; peak {peak:.2f} "
        f"GiB; mask areas {areas}; launches {counts}")
    results["sam_launches"] = counts
    results["phase1_sec"] = med(ts)
    return model




def phase1_flash_shapes(n_labels):
    """(B, H, Sq, Sk, D) of the flash forward in phase1_segmentation.run at
    full width, for ``n_labels`` labels: the detector's image tower (2,304
    patches, 8 heads of 64) and text tower (a row per label, 24 bytes, 4
    heads of 64); the saliency net's T2T stem blocks (stride 4 and 8; the
    second shape is dec8's too) at head dim 96, its encoder (196 patches
    and the saliency token, 6 heads of 64) and its decode (196 patches
    against the saliency token alone). Timed beside SDPA, kept out of the
    forward sum; the run's other shapes (Depth-Anything's trunk, SAM-H's
    decoder) are held after it, untimed."""
    return [(1, 8, 2304, 2304, 64), (n_labels, 4, 24, 24, 64),
            (1, 2, 3136, 3136, 96), (1, 2, 784, 784, 96),
            (1, 6, 197, 197, 64), (1, 6, 196, 1, 64)]

# phase 1's small models on the card (bf16) against the CPU (f32): the
# error of each output over its largest |value| (bf16 weights and
# activations over a few layers)
PHASE1_SMALL_TOL = 5e-2


def phase1_small_check(gen_seed=7):
    """A small detector (heads of 64, text heads of 32), saliency net
    (width 384: stem heads of 96, encoder heads of 64, the single-key
    decode) and Depth-Anything (heads of 64) on the card in bf16 against
    the same weights on the CPU in f32; returns the errors over max |ref|
    and the card's launches."""
    import dataclasses

    import numpy as np
    import torch

    from regen3d_tpu_torch import kernels
    from regen3d_tpu_torch.models import depth_anything as da
    from regen3d_tpu_torch.models import detector as det
    from regen3d_tpu_torch.models import saliency as sal

    cases = [
        ("detector", det.OpenVocabDetector, det.init_flax_style_,
         det.DetectorConfig(image_size=128, width=128, depth=2, num_heads=2,
                            text_width=128, text_depth=1, text_len=24,
                            embed_dim=64), 128),
        ("saliency", sal.SaliencyTransformer, sal.init_flax_style_,
         sal.SaliencyConfig(image_size=64, width=384, depth=1, num_heads=6),
         64),
        ("depth_anything", da.DepthAnything, da.init_flax_style_,
         da.DepthAnythingConfig(image_size=112, width=128, depth=4,
                                num_heads=2, out_idx=(0, 1, 2, 3),
                                features=16, out_channels=(8, 16, 32, 64)),
         112)]
    rng = np.random.default_rng(gen_seed)
    tokens = torch.from_numpy(det.tokenize_bytes(
        ["chair", "table", "lamp"], 24)).long()
    errs, kernels_seen = {}, {}
    for name, cls, init, cfg, size in cases:
        cpu = cls(dataclasses.replace(cfg, dtype=torch.float32), device="cpu")
        init(cpu, torch.Generator().manual_seed(gen_seed))
        card = cls(cfg)
        card.load_state_dict(cpu.state_dict())
        img = torch.from_numpy(rng.random((1, size, size, 3)).astype(np.float32))
        kernels.reset_counts()
        with torch.no_grad():
            if name == "detector":
                ref = cpu(img, tokens)
                got = card(img.cuda(), tokens.cuda())
            else:
                ref, got = (cpu(img),), (card(img.cuda()),)
        torch.cuda.synchronize()
        kernels_seen[name] = kernels.LAUNCHES["flash_fwd"]
        errs[name] = max(float((g.float().cpu() - r).abs().max()
                               / r.abs().max()) for g, r in zip(got, ref))
    log(f"phase 1 small models, card bf16 kernels vs CPU f32 plain: max "
        f"error / max |ref| {errs} (tol {PHASE1_SMALL_TOL}); flash launches "
        f"{kernels_seen}")
    if not max(errs.values()) < PHASE1_SMALL_TOL or min(
            kernels_seen.values()) == 0:
        raise AssertionError("phase 1's small models on the card disagree "
                             "with the CPU or took no flash kernel")
    return errs


def phase1_finding_gates(cfg, stems):
    """The phase-1 artifact contract: five PNGs a finding (fullSize and
    cropped RGB, the outline and bbox prompts at the input's size, the
    layout canvas) and depth.png; returns the failures."""
    import os

    from regen3d_tpu_torch.artifacts import Artifacts
    from regen3d_tpu_torch.utils.image import load_image_rgb, read_png

    art = Artifacts(cfg)
    h, w = load_image_rgb(cfg.path("input_image")).shape[:2]
    bad = []
    for stem in stems:
        for d, shape in ((art.findings_fullsize, (h, w, 3)),
                         (art.findings_cropped, None),
                         (art.banana_outline, (h, w, 3)),
                         (art.banana_bbox, (h, w, 3)),
                         (art.banana_layouts, (h + 40, 2 * w + 30, 3))):
            path = os.path.join(d, f"{stem}.png")
            if not os.path.exists(path):
                bad.append(f"missing {path}")
                continue
            img = read_png(path)[0]
            if (shape and img.shape != shape) or img.ndim != 3:
                bad.append(f"{path}: {img.shape}")
    if not os.path.exists(art.depth_scene) or \
            read_png(art.depth_scene)[0].shape[:2] != (h, w):
        bad.append("depth.png missing or not the input's size")
    return bad


def phase1_weightless(results):
    """run_phases(cfg, [1, 2]) on the bus's 960×1280 input through the
    port's orchestrator: phase 1 without models (k-means on ~20,000
    pixels on the host, every pixel labelled on the card, the findings,
    the depth prior), then phase 2 on its findings. Gated on the artifact
    contract and on phase 2 preparing every finding; the card's labels
    against the CPU's on the same fit."""
    import os
    import shutil

    import torch

    from regen3d_tpu_torch import kernels, orchestrator
    from regen3d_tpu_torch.artifacts import Artifacts
    from regen3d_tpu_torch.config import default_config
    from regen3d_tpu_torch.ops import kmeans
    from regen3d_tpu_torch.pipeline.phase1_segmentation import (
        proposal_features,
    )
    from regen3d_tpu_torch.utils.image import load_image_rgb

    root = ROOT / "build" / "phase1" / "p12"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    shutil.copy(ROOT / "build" / "bus" / "bus" / "input.png",
                root / "input.png")
    cfg = default_config(str(root / "output"),
                         input_image=str(root / "input.png"))
    kernels.reset_counts()
    timings = orchestrator.run_phases(cfg, [1, 2], device="cuda")
    results["phase12_launches"] = dict(kernels.LAUNCHES)
    art = Artifacts(cfg)
    stems = art.list_findings()
    prepped = sorted(f[:-4] for f in os.listdir(art.prepped_dir))
    bad = phase1_finding_gates(cfg, stems)
    if len(stems) < 4 or prepped != sorted(stems) or \
            not os.path.exists(art.empty_room):
        bad.append(f"phase 1 wrote {stems}, phase 2 prepped {prepped}")
    # the card's labelling against the CPU's, on one fit
    feats, sub = proposal_features(load_image_rgb(cfg.path("input_image")))
    t0 = time.perf_counter()
    fit = kmeans.kmeans_fit(sub, max(6, len(cfg["labels"])), int(cfg["seed"]))
    t_fit = time.perf_counter() - t0
    x = torch.from_numpy(feats)
    xg = x.cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = kmeans.kmeans_predict(xg, fit.centers)
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    agree = float((card.cpu() == kmeans.kmeans_predict(x, fit.centers))
                  .double().mean())
    if agree < 0.999:
        bad.append(f"k-means labels: card and CPU agree on {agree:.6f}")
    log(f"phase 1 + 2 through run_phases on the bus's 960x1280 input "
        f"(k-means proposer): phase 1 {timings[1]:.3f} s, phase 2 "
        f"{timings[2]:.3f} s; {len(stems)} findings, {len(prepped)} "
        f"prepped; k-means fit {t_fit:.3f} s on the host ({fit.n_iter} "
        f"iterations, run {fit.best_init} of 4), predict {1e3 * t_pred:.2f} "
        f"ms on the card, labels card vs CPU {agree:.7f}")
    if bad:
        raise AssertionError("phase 1 + 2: " + "; ".join(bad))
    results["phase12_sec"] = timings


def phase_segment(results, sam):
    """Phase 1 beyond detect_and_segment: the flash forward at the
    detector's and saliency net's shapes (phase1_flash_shapes: head dim 96
    and the decode's single key among them) against the plain version; the small
    detector, saliency net and Depth-Anything on the card against the
    CPU; run_phases(cfg, [1, 2]) weightless (phase1_weightless); then
    phase1_segmentation.run at full width on the bus's input: SAM-H (from
    phase_sam), DetectorConfig() (768², width 512, depth 12), the saliency
    net at SaliencyConfig() for point_method saliency, and
    Depth-Anything-V2-Small for depth.png, random weights from seeds,
    timed by stage and gated on the artifact contract and the launches,
    and every flash shape the run gave the kernel held against the plain
    version."""
    import shutil

    import torch

    from regen3d_tpu_torch import kernels
    from regen3d_tpu_torch.config import default_config
    from regen3d_tpu_torch.models import depth_anything as da
    from regen3d_tpu_torch.models import detector as det
    from regen3d_tpu_torch.models import saliency as sal
    from regen3d_tpu_torch.pipeline import depth as depth_mod
    from regen3d_tpu_torch.pipeline import phase1_segmentation as p1
    from regen3d_tpu_torch.pipeline.saliency_distill import SaliencyModel

    t_phase = time.perf_counter()
    info = results["ptxas"].get("fwd_kernel<96, 0, false>")
    log(f"ptxas fwd_kernel<96, 0, false>: {info}")
    if not info or info.get("spill_stores", 0) + info.get("spill_loads", 0):
        raise AssertionError(f"the D = 96 forward instance: {info}")
    gen = torch.Generator(device="cuda").manual_seed(96)
    timed_shapes = phase1_flash_shapes(len(default_config("")["labels"]))
    d96 = {}
    for shape in timed_shapes:
        d96[shape] = fwd_case(shape, gen)
    results["flash_fwd_phase1"] = {
        str(k): dict(ms=v["ms"], bound_ms=v["bound"][0], err=v["err"])
        for k, v in d96.items()}
    results["phase1_small"] = phase1_small_check()
    phase1_weightless(results)

    t0 = time.perf_counter()
    detector = det.OpenVocabDetector(det.DetectorConfig())
    det.init_flax_style_(detector, torch.Generator(device="cuda").manual_seed(1))
    net = sal.SaliencyTransformer(sal.SaliencyConfig())
    sal.init_flax_style_(net, torch.Generator(device="cuda").manual_seed(2))
    depth_model = da.DepthAnything(da.DepthAnythingConfig.small())
    da.init_flax_style_(depth_model,
                        torch.Generator(device="cuda").manual_seed(3))
    saliency = SaliencyModel(net)
    torch.cuda.synchronize()
    n_par = {name: sum(p.numel() for p in m.parameters()) / 1e6
             for name, m in (("detector", detector), ("saliency", net),
                             ("depth_anything", depth_model))}
    log(f"phase 1 models at full width (random weights from seeds), M "
        f"params {n_par}, built in {time.perf_counter() - t0:.1f} s")

    # every stage timed on the host's clock around a synchronize
    stages = {k: [] for k in ("detect", "encode", "decode", "points",
                              "saliency", "export", "depth")}

    def timed(fn, key):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            stages[key].append(time.perf_counter() - t)
            return out
        return call

    patches = [(detector, "detect"), (sam, "encode"), (sam, "decode"),
               (saliency, "saliency"), (p1, "generate_points"),
               (p1, "export_findings"), (depth_mod, "run")]
    keys = ["detect", "encode", "decode", "saliency", "points", "export",
            "depth"]
    saved = [getattr(obj, attr) for obj, attr in patches]
    for (obj, attr), key, fn in zip(patches, keys, saved):
        setattr(obj, attr, timed(fn, key))
    root = ROOT / "build" / "phase1" / "run"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    shutil.copy(ROOT / "build" / "bus" / "bus" / "input.png",
                root / "input.png")
    over = dict(input_image=str(root / "input.png"), use_points=True,
                point_method="saliency", points_per_object=1)
    # the (B, H, Sq, Sk, D) the run gives the flash forward: run_shapes
    try:
        for threshold in (0.25, 0.1, 0.02):
            cfg = default_config(str(root / "output"), threshold=threshold,
                                 **over)
            for v in stages.values():
                v.clear()
            kernels.reset_counts()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with recording_flash_shapes() as run_shapes:
                stems = p1.run(cfg, sam=sam, detector=detector,
                               saliency_model=saliency,
                               depth_model=depth_model)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            if stems:
                break
            log(f"phase 1 run: the random detector passed no box at "
                f"threshold {threshold}; lowering it")
    finally:
        for (obj, attr), fn in zip(patches, saved):
            setattr(obj, attr, fn)
    counts = dict(kernels.LAUNCHES)
    results["phase1_launches"] = counts
    n_sal = len(stages["saliency"])
    want_flash = (detector.cfg.depth + detector.cfg.text_depth + 14
                  + 10 * n_sal + depth_model.cfg.depth)
    bad = phase1_finding_gates(cfg, stems)
    if len(stems) == 0 or counts["flash_gb_fwd"] != len(sam.cfg.global_blocks) \
            or counts["flash_fwd"] != want_flash or len(stages["encode"]) != 1 \
            or len(stages["decode"]) != 2 or n_sal != len(stems):
        bad.append(f"{len(stems)} findings, {n_sal} saliency calls, "
                   f"{len(stages['encode'])} encodes, "
                   f"{len(stages['decode'])} decodes, launches {counts} "
                   f"(flash_fwd {want_flash} expected)")
    missing = set(timed_shapes).difference(run_shapes)
    if missing:
        bad.append(f"flash shapes held above but not run: {sorted(missing)} "
                   f"(the run's: {sorted(run_shapes)})")
    if bad:
        raise AssertionError("phase 1 run: " + "; ".join(bad[:10]))
    # every other shape of the run held against the plain version, untimed
    rest = sorted(set(run_shapes).difference(timed_shapes))
    for shape in rest:
        fwd_case(shape, gen, timed=False)
    log(f"phase 1 run: flash forward shapes {sorted(run_shapes)}; held "
        f"above and timed {timed_shapes}, held after the run {rest}")
    sums = {k: round(sum(v), 4) for k, v in stages.items()}
    log(f"phase 1 run at full width on the bus's 960x1280 input "
        f"(threshold {threshold}): {total:.3f} s for {len(stems)} findings; "
        f"by stage (s) {sums}, decode passes "
        f"{[round(t, 4) for t in stages['decode']]}, saliency calls "
        f"{n_sal} (once per detection, on the whole image; points includes "
        f"them); peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
        f"launches {counts}")
    results["phase1_run"] = dict(total=total, stages=sums, findings=len(stems),
                                 threshold=threshold)
    log(f"phase_segment: {time.perf_counter() - t_phase:.1f} s")
    del detector, net, depth_model, saliency
    torch.cuda.empty_cache()


def _dit_draws(b, shape, gen, dev):
    """(t, ε, drop) for flow_matching_loss from a CPU generator, on ``dev``:
    the same draws on both sides of a comparison."""
    import torch

    t = torch.rand(b, generator=gen)
    eps = torch.randn(shape, generator=gen)
    drop = torch.rand(b, generator=gen) < 0.1
    drop[0] = True                       # the condition masking is exercised
    return t.to(dev), eps.to(dev), drop.to(dev)


def phase_dit(results, steps=30, batch=8, cond_len=257):
    """The flow-matching DiT training step: a small config on the card
    (bf16 compute, f32 parameters, kernels) against the same step on the CPU
    (f32, plain versions), then DiTConfig.base() trained for ``steps`` steps
    on B = 8 latent sets, then sample() at base."""
    import dataclasses

    import torch

    from regen3d_tpu_torch import kernels
    from regen3d_tpu_torch.models.dit import (
        DiTConfig,
        ShapeDiT,
        draw_zero_init_leaves_,
        flow_matching_loss,
        init_flax_style_,
        sample,
    )
    from regen3d_tpu_torch.parallel.train import init_state, train_step

    # agreement on a small config. The AdaLN-Zero leaves (adaLN, adaLN_out,
    # x_out) are drawn non-zero: at flax's init the gradient stops at x_out
    # and every attention's upstream gradient is exactly 0.
    small = DiTConfig(latent_tokens=64, latent_dim=16, width=256, depth=2,
                      num_heads=4, cond_dim=128)
    cpu_model = ShapeDiT(dataclasses.replace(small, dtype=torch.float32),
                         device="cpu")
    gen = torch.Generator().manual_seed(5)
    init_flax_style_(cpu_model, gen)
    draw_zero_init_leaves_(cpu_model, gen)
    gpu_model = ShapeDiT(small)
    gpu_model.load_state_dict(cpu_model.state_dict())
    x0 = torch.randn(4, small.latent_tokens, small.latent_dim, generator=gen)
    cond = torch.randn(4, 33, small.cond_dim, generator=gen)
    draws = _dit_draws(4, x0.shape, gen, "cpu")
    watched = ("block0.attn.q.weight", "block0.cross.k.weight",
               "block0.attn.q_norm.weight")
    out = {}
    for name, model, dev in (("cpu", cpu_model, "cpu"),
                             ("gpu", gpu_model, "cuda")):
        loss = flow_matching_loss(model, x0.to(dev), cond.to(dev), None,
                                  draws=tuple(d.to(dev) for d in draws))
        loss.backward()
        params = dict(model.named_parameters())
        out[name] = (float(loss.detach()), {w: params[w].grad.float().cpu()
                                   for w in watched})
    errs = {"loss": abs(out["gpu"][0] - out["cpu"][0]) / abs(out["cpu"][0])}
    for w in watched:
        ref = out["cpu"][1][w]
        errs[w] = float((out["gpu"][1][w] - ref).abs().max() / ref.abs().max())
    log(f"small DiT step, card bf16 kernels vs CPU f32 plain: loss "
        f"{out['gpu'][0]:.5f} vs {out['cpu'][0]:.5f}; max error / max |ref| "
        f"{ {k: f'{v:.3e}' for k, v in errs.items()} } (tol 5e-2: bf16 "
        f"activations through 2 blocks)")
    if not max(errs.values()) < 5e-2:
        raise AssertionError("small DiT step on the card disagrees with the "
                             "CPU")
    del cpu_model, gpu_model

    cfg = DiTConfig.base()
    t0 = time.perf_counter()
    model = ShapeDiT(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    opt = init_state(model, gen)
    draw_zero_init_leaves_(model, gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"DiT-base config: {n_params / 1e9:.3f} B params (f32), built and "
        f"initialised in {time.perf_counter() - t0:.1f} s")
    x0 = torch.randn((batch, cfg.latent_tokens, cfg.latent_dim),
                     generator=gen, device="cuda")
    cond = torch.randn((batch, cond_len, cfg.cond_dim), generator=gen,
                       device="cuda").to(torch.bfloat16)
    fixed = _dit_draws(batch, x0.shape, torch.Generator().manual_seed(7),
                       "cuda")

    def fixed_loss():
        with torch.no_grad():
            return float(flow_matching_loss(model, x0, cond, None,
                                            draws=fixed))

    loss0 = fixed_loss()
    attn = [f"block{i}.{a}.{p}.weight" for i in range(cfg.depth)
            for a in ("attn", "cross") for p in ("q", "k", "v", "proj")]
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    ts, losses = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = train_step(model, opt, x0, cond, gen)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
        losses.append(loss)
        params = dict(model.named_parameters())
        finite = torch.stack([p.grad.isfinite().all()
                              for p in params.values()]).all()
        nonzero = torch.stack([params[n].grad.abs().amax() > 0
                               for n in attn]).all()
        if not bool(finite & nonzero):
            raise AssertionError("DiT-base step: a gradient is non-finite or "
                                 "an attention's gradient is zero")
    counts = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(x) for x in losses]
    loss1 = fixed_loss()
    per_step = {n: counts[n] / steps for n in ("flash_fwd", "flash_bwd_dq",
                                               "flash_bwd_dkv")}
    med = sorted(ts)[len(ts) // 2]
    log(f"DiT-base train_step x{steps} (B={batch}, {cfg.latent_tokens}x"
        f"{cfg.latent_dim} latents, {cond_len} cond tokens, f32 params, bf16 "
        f"compute, AdamW): median {med:.4f} s/step (first {ts[0]:.3f} s, "
        f"range {min(ts):.4f}-{max(ts):.4f}); peak {peak:.2f} GiB; "
        f"fixed-batch loss {loss0:.5f} -> {loss1:.5f}; step losses "
        f"{[round(x, 4) for x in losses[:3]]} ... "
        f"{[round(x, 4) for x in losses[-3:]]}; launches per step {per_step}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("DiT-base: non-finite loss")
    if any(v != 2 * cfg.depth for v in per_step.values()):
        raise AssertionError(f"DiT-base launches per step {per_step}, "
                             f"expected {2 * cfg.depth} each")
    if not loss1 < loss0:
        raise AssertionError("DiT-base: the fixed-batch loss did not fall")
    results["dit_launches"] = counts
    results["dit_step_sec"] = med

    # where a step's time goes: each of its three calls (the loss forward,
    # the backward, AdamW's update) and the whole step behind a ~0.5-s
    # stream spin, which lets the host queue a call's work before the device
    # reaches it. The host's seconds to return (0.5 s or more: the call
    # waited for the device) and the device's seconds from the spin's end to
    # the call's last launch (its busy time, unless the host waited inside
    # the call and left gaps); median of 3.
    def behind_spin(fn):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        torch.cuda._sleep(50 * SPIN_CYCLES)
        a.record()
        t0 = time.perf_counter()
        fn()
        host = time.perf_counter() - t0
        b.record()
        b.synchronize()
        return host, a.elapsed_time(b) / 1e3

    split = {}
    for _ in range(3):
        opt.zero_grad(set_to_none=True)
        box = {}
        for name, fn in (
                ("loss", lambda: box.update(loss=flow_matching_loss(
                    model, x0, cond, gen))),
                ("backward", lambda: box["loss"].backward()),
                ("adamw", opt.step),
                ("step", lambda: train_step(model, opt, x0, cond, gen))):
            split.setdefault(name, []).append(behind_spin(fn))
    split = {n: tuple(sorted(x[i] for x in v)[1] for i in (0, 1))
             for n, v in split.items()}
    busy = sum(split[n][1] for n in ("loss", "backward", "adamw"))
    log("DiT-base train_step behind a 0.5-s spin, (host s to return, device "
        "s) median of 3: " + ", ".join(f"{n} ({h:.4f}, {d:.4f})"
                                       for n, (h, d) in split.items())
        + f"; the three calls keep the device busy {busy:.4f} s, "
        f"{busy / med:.1%} of the {med:.4f}-s median step")

    # sample at base: 4 Euler steps, guidance 5 (one 2B-batch forward each)
    n_obj = 6
    cond_s = torch.randn((n_obj, cond_len, cfg.cond_dim), generator=gen,
                         device="cuda").to(torch.bfloat16)
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lat = sample(model, cond_s, num_steps=4, guidance_scale=5.0,
                 generator=gen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    dev_sample = device_top(lambda: sample(model, cond_s, num_steps=4,
                                           guidance_scale=5.0,
                                           generator=gen), 0)[0]
    log(f"DiT-base sample: 4 steps, guidance 5.0, B={n_obj}, {cond_len} cond "
        f"tokens: {dt:.3f} s ({dev_sample:.2f} ms of device time under "
        f"torch.profiler, one more call); latents {tuple(lat.shape)}; "
        f"launches {counts}")
    if tuple(lat.shape) != (n_obj, cfg.latent_tokens, cfg.latent_dim) or \
            not bool(lat.isfinite().all()):
        raise AssertionError("DiT-base sample: wrong shape or non-finite")
    if counts["flash_fwd"] != 4 * 2 * cfg.depth:
        raise AssertionError(f"DiT-base sample launches {counts}")
    results["dit_sample_launches"] = counts


def phase_sam_grad(results):
    """The gradient of SAM's image encoder: a small SAM on the card (bf16,
    kernels) against the CPU (f32, plain versions), then SAM-H at full
    size. Each is the VJP of the embedding with a N(0, 1) cotangent drawn
    from a seed: Σ emb² would be constant through the neck's last LayerNorm
    at flax's init (unit scale, zero bias), its gradient rounding noise."""
    import dataclasses

    import numpy as np
    import torch

    from regen3d_tpu_torch import kernels
    from regen3d_tpu_torch.models.sam import SAM, SamConfig, init_flax_style_

    # phase 5's small config: grid 32 = 1024 tokens takes the grid-bias kernel
    # in the global block (heads of 80), the windowed block the einsum path;
    # the rel-pos tables are drawn non-zero by init_flax_style_
    small = SamConfig(image_size=512, width=160, depth=2, num_heads=2,
                      window=14, global_blocks=(1,), prompt_dim=256)
    cpu_model = SAM(dataclasses.replace(small, dtype=torch.float32),
                    device="cpu")
    init_flax_style_(cpu_model, torch.Generator().manual_seed(8))
    gpu_model = SAM(small)
    gpu_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.default_rng(9)
    g = small.grid
    img = torch.from_numpy(rng.random(
        (1, small.image_size, small.image_size, 3)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(1, g, g, small.prompt_dim))
                           .astype(np.float32))
    watched = ("attn.rel_pos_h", "attn.rel_pos_w", "attn.qkv.weight")
    grads = {}
    kernels.reset_counts()
    for name, model, dev in (("cpu", cpu_model, "cpu"),
                             ("gpu", gpu_model, "cuda")):
        blk = model.image_encoder.block1
        ps = [blk.get_parameter(w) for w in watched]
        emb = model.encode(img.to(dev))
        grads[name] = [t.float().cpu() for t in torch.autograd.grad(
            (emb.float() * cot.to(dev)).sum(), ps)]
    small_counts = dict(kernels.LAUNCHES)
    errs = {w: float((g - r).abs().max() / r.abs().max())
            for w, g, r in zip(watched, grads["gpu"], grads["cpu"])}
    log(f"small SAM encoder VJP with a N(0, 1) cotangent, card bf16 kernels "
        f"vs CPU f32 plain, global block: max error / max |ref| "
        f"{ {k: f'{v:.3e}' for k, v in errs.items()} } (tol 5e-2); "
        f"launches {small_counts}")
    if not max(errs.values()) < 5e-2:
        raise AssertionError("small SAM encoder gradient on the card "
                             "disagrees with the CPU")
    if small_counts["flash_gb_bwd_dq"] != 1 or \
            small_counts["flash_gb_bwd_dkv"] != 1:
        raise AssertionError("small SAM gradient did not take the grid-bias "
                             "backward kernels")
    del cpu_model, gpu_model

    cfg = SamConfig()
    model = SAM(cfg)
    init_flax_style_(model, torch.Generator(device="cuda").manual_seed(10))
    model.eval()
    enc_params = list(model.image_encoder.parameters())
    gen = torch.Generator(device="cuda").manual_seed(11)
    img = torch.rand((1, cfg.image_size, cfg.image_size, 3), generator=gen,
                     device="cuda")
    cot = torch.randn((1, cfg.grid, cfg.grid, cfg.prompt_dim), generator=gen,
                      device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    t0 = time.perf_counter()
    emb = model.encode(img)
    grads = torch.autograd.grad((emb.float() * cot).sum(), enc_params)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finite = bool(torch.stack([g.isfinite().all() for g in grads]).all())
    named = dict(zip((n for n, _ in model.image_encoder.named_parameters()),
                     grads))
    rel = [float(named[f"block{i}.attn.rel_pos_{a}"].abs().max())
           for i in cfg.global_blocks for a in "hw"]
    log(f"SAM-H encoder gradient (1024², 32 blocks, {len(enc_params)} "
        f"parameter tensors): forward + backward {dt:.3f} s; peak "
        f"{peak:.2f} GiB; gradients finite {finite}; global blocks' rel-pos "
        f"gradient max |.| {[f'{x:.3e}' for x in rel]}; launches {counts}")
    if not finite or min(rel) <= 0:
        raise AssertionError("SAM-H encoder gradient: non-finite, or a global "
                             "block's rel-pos gradient is zero")
    n_glob = len(cfg.global_blocks)
    if counts["flash_gb_bwd_dq"] != n_glob or \
            counts["flash_gb_bwd_dkv"] != n_glob:
        raise AssertionError(f"SAM-H encoder gradient launches {counts}")
    results["sam_grad_launches"] = counts
    results["sam_grad_sec"] = dt

    # where the VJP's device time goes: one more call under torch.profiler
    # (after the counts were read), its ten device operations with the most
    # self time
    def vjp():
        emb = model.encode(img)
        torch.autograd.grad((emb.float() * cot).sum(), enc_params)

    total, top = device_top(vjp, 10)[:2]
    split = "; ".join(f"{name} {ms:.2f} ms ({ms / total:.1%}, {c}x)"
                      for ms, name, c in top) if total > 0 else \
        "no device time recorded"
    log(f"SAM-H encoder gradient under torch.profiler: {total:.2f} ms of "
        f"device time; the ten operations with the most: {split}")


# the small DUSt3R of phase_alternates' card-vs-CPU check: heads of 16 in
# the encoder and both decoders (the tiny one's decoders have heads of 12,
# which no kernel instance takes)
DUST3R_SMALL = dict(patch=8, enc_width=64, enc_depth=2, enc_heads=4,
                    dec_width=64, dec_depth=2, dec_heads=4)
DUST3R_SMALL_TOL = 5e-2
# one DUSt3R forward: an encoder block's attention and each decoder block's
# self- and cross-attention in both decoders (24 + 12·2·2)
DUST3R_FLASH_PER_FORWARD = 72
# caps of phase_alternates' baseline runs, whose random-init generators
# give volumes that marching turns into meshes of any size: the octree
# resolution of the CLI runs (the tiny generator) and of the full-width
# ones, and MIDI's instances at full width (box mode, the bus's first 4
# objects)
ALT_OCTREE_CLI = 48
ALT_OCTREE_FULL = 64
ALT_MIDI_BOXES = 4


def synthetic_pairs(n, h, w, f, seed):
    """tests/test_dust3r.py's scene: random poses (rotations of 0.1 rad,
    translations of 0.3), a bumpy surface 2 in front of each camera; the
    exact pairwise pointmaps of every ordered pair at confidence 8.
    Returns (cam→world 4×4 per view, own-frame pointmaps, pairs, pred)."""
    import numpy as np
    import torch

    from regen3d_tpu_torch.pipeline.phase4_dust3r import make_pairs
    from regen3d_tpu_torch.transforms.rotations import so3_exp

    rng = np.random.default_rng(seed)
    c2ws = [np.eye(4)]
    for _ in range(1, n):
        M = np.eye(4)
        M[:3, :3] = so3_exp(torch.tensor(rng.normal(0, 0.1, 3),
                                         dtype=torch.float32)).numpy()
        M[:3, 3] = rng.normal(0, 0.3, 3)
        c2ws.append(M)
    vv, uu = np.mgrid[0:h, 0:w].astype(np.float64)
    own = []
    for k in range(n):
        depth = 2.0 + 0.3 * np.sin(uu / w * 3 + k) * np.cos(vv / h * 2)
        own.append(np.stack([(uu + 0.5 - w / 2) / f * depth,
                             (vv + 0.5 - h / 2) / f * depth, depth], -1))
    pairs = make_pairs(n)
    pts1, pts2 = [], []
    for (i, j) in pairs:
        w2c_i = np.linalg.inv(c2ws[i])
        world_j = own[j] @ c2ws[j][:3, :3].T + c2ws[j][:3, 3]
        pts1.append(own[i])
        pts2.append(world_j @ w2c_i[:3, :3].T + w2c_i[:3, 3])
    e = len(pairs)
    pred = {"pts3d1": np.stack(pts1).astype(np.float32),
            "pts3d2": np.stack(pts2).astype(np.float32),
            "conf1": np.full((e, h, w), 8.0, np.float32),
            "conf2": np.full((e, h, w), 8.0, np.float32)}
    return c2ws, own, pairs, pred


def dust3r_small_checks():
    """A small DUSt3R (DUST3R_SMALL) on the card in bf16 against the same
    weights on the CPU in f32, every output's error over max |ref| under
    DUST3R_SMALL_TOL; then global_align on the card on exact synthetic
    pairs (3 views, 150 iterations): the poses and depths recovered within
    tests/test_dust3r.py's 0.05. Returns the errors and the card's
    launches."""
    import dataclasses

    import numpy as np
    import torch

    from regen3d_tpu_torch import kernels
    from regen3d_tpu_torch.models import dust3r as d3
    from regen3d_tpu_torch.pipeline import phase4_dust3r as p4d

    cfg = d3.Dust3rConfig(**DUST3R_SMALL)
    cpu = d3.AsymmetricCroCo3DStereo(dataclasses.replace(
        cfg, dtype=torch.float32), device="cpu")
    d3.init_flax_style_(cpu, torch.Generator().manual_seed(11))
    card = d3.AsymmetricCroCo3DStereo(cfg)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(11)
    imgs = [torch.from_numpy(rng.random((2, 64, 64, 3)).astype(np.float32))
            for _ in range(2)]
    kernels.reset_counts()
    with torch.no_grad():
        ref = cpu(*imgs)
        got = card(*(x.cuda() for x in imgs))
    torch.cuda.synchronize()
    launches = kernels.LAUNCHES["flash_fwd"]
    errs = {k: float((got[k].float().cpu() - ref[k]).abs().max()
                     / ref[k].abs().max()) for k in ref}
    log(f"DUSt3R small (heads of 16), card bf16 kernels vs CPU f32 plain: "
        f"max error / max |ref| {errs} (tol {DUST3R_SMALL_TOL}); flash "
        f"launches {launches}")
    want = cfg.enc_depth + 4 * cfg.dec_depth
    if max(errs.values()) > DUST3R_SMALL_TOL or launches != want:
        raise AssertionError("the small DUSt3R on the card disagrees with "
                             "the CPU or took other launches")

    c2ws, own, pairs, pred = synthetic_pairs(3, 12, 16, 24.0, seed=4)
    t0 = time.perf_counter()
    scene = p4d.global_align(pred, pairs, 3, niter=150, device="cuda")
    dt = time.perf_counter() - t0
    pose_err = max(float(np.abs(scene["c2w"][k][:3]
                                - (np.linalg.inv(c2ws[0]) @ c2ws[k])[:3]).max())
                   for k in range(3))
    depth_err = float(np.abs(scene["depth"][0] / own[0][..., 2] - 1).max())
    log(f"DUSt3R aligner on the card on exact synthetic pairs (3 views, 150 "
        f"iterations, {dt:.2f} s): pose error {pose_err:.2e}, depth relative "
        f"error {depth_err:.2e} (tol 0.05)")
    if not (pose_err <= 0.05 and depth_err <= 0.05
            and np.isfinite(scene["losses"]).all()):
        raise AssertionError("the aligner on the card did not recover the "
                             "synthetic poses")
    return errs


def _timed_patches(stages, patches):
    """Wrap each (object, attribute, stage) so that every call's seconds,
    from a synchronize to a synchronize, land in stages[stage]; returns
    the saved originals for _restore."""
    import torch

    saved = []
    for obj, attr, key in patches:
        fn = getattr(obj, attr)
        saved.append((obj, attr, fn))

        def call(*args, _fn=fn, _key=key, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = _fn(*args, **kw)
            torch.cuda.synchronize()
            stages.setdefault(_key, []).append(time.perf_counter() - t)
            return out
        setattr(obj, attr, call)
    return saved


def _restore(saved):
    for obj, attr, fn in saved:
        setattr(obj, attr, fn)


# dust3r_pinhole_heads_'s pattern: the heads' kernels scaled by
# PINHOLE_SCALE; each patch's pixels on rays spread by PINHOLE_SPREAD about
# the axis at raw depth PINHOLE_DEPTH (a point ~3.5 in front of the camera),
# raw confidence PINHOLE_CONF
PINHOLE_SPREAD, PINHOLE_DEPTH, PINHOLE_CONF, PINHOLE_SCALE = 0.5, 1.5, 2.0, 0.05


def dust3r_pinhole_heads_(model):
    """Give a random-init DUSt3R's heads a pinhole pattern (the PINHOLE_
    constants). A random head puts about half the pixels behind the camera
    and leaves x/z and y/z uncorrelated with the pixel, so the Weiszfeld
    focal (Σ w·uv·pp / Σ w·pp²) is ~0/0 and the aligner starts from
    log(NaN); the tokens still reach the outputs through the scaled
    kernels."""
    import torch

    p = model.cfg.patch
    off = (torch.arange(p, dtype=torch.float32) + 0.5 - p / 2) / p \
        * PINHOLE_SPREAD
    bias = torch.stack([off[None, :].expand(p, p), off[:, None].expand(p, p),
                        torch.full((p, p), PINHOLE_DEPTH),
                        torch.full((p, p), PINHOLE_CONF)], -1).reshape(-1)
    with torch.no_grad():
        for head in (model.head1, model.head2):
            head.proj.weight.mul_(PINHOLE_SCALE)
            head.proj.bias.copy_(bias)


def dust3r_artifact_gates(cfg, names):
    """The DUSt3R phase 4's artifacts: scene.glb, camera.npz (finite, 4 × 4
    extrinsic), scene_vggt.ply and the COLMAP text; returns the
    failures."""
    import os

    import numpy as np

    from regen3d_tpu_torch.artifacts import Artifacts
    from regen3d_tpu_torch.utils.colmapio import ColmapReconstruction
    from regen3d_tpu_torch.utils.ply import load_ply

    art = Artifacts(cfg)
    bad = []
    for path in (os.path.join(art.pre3d_dir, "scene.glb"), art.camera_npz,
                 art.scene_cloud_ply, art.points_ply):
        if not os.path.exists(path):
            bad.append(f"missing {path}")
    if bad:
        return bad
    cam = np.load(art.camera_npz)
    if cam["extrinsic"].shape != (4, 4) or not all(
            np.isfinite(cam[k]).all() for k in cam.files):
        bad.append(f"camera.npz {dict(cam)}")
    pts = load_ply(art.scene_cloud_ply).vertices
    if len(pts) == 0 or not np.isfinite(pts).all():
        bad.append(f"scene_vggt.ply: {pts.shape}")
    rec = ColmapReconstruction.read(art.colmap_sparse)
    if len(rec.images) != len(names):
        bad.append(f"COLMAP images {len(rec.images)} for {names}")
    return bad


def dust3r_full(results, gen_t):
    """DUSt3R at naver/DUSt3R_ViTLarge_BaseDecoder_512_linear's widths
    (Dust3rConfig(): ViT-L encoder 1024 × 24, 16 heads; decoders 768 × 12,
    12 heads; 512², bf16, random weights from a seed, the heads given a
    pinhole pattern by dust3r_pinhole_heads_): phase4_dust3r.run on
    the bus's input and empty room (the pair viewer), then run_from_model
    on three frames (the input, the empty room, the input mirrored: the
    300-iteration aligner), each timed by stage and gated on the artifacts
    and 72 flash launches; then the pairwise forward of the three frames
    timed and split into its device operations, and every flash shape of
    the runs held against the plain version."""
    import os
    import shutil

    import torch

    from regen3d_tpu_torch import kernels
    from regen3d_tpu_torch.artifacts import Artifacts
    from regen3d_tpu_torch.config import default_config
    from regen3d_tpu_torch.models import dust3r as d3
    from regen3d_tpu_torch.pipeline import phase4_dust3r as p4d
    from regen3d_tpu_torch.utils.image import load_image_rgb, save_image

    t0 = time.perf_counter()
    model = d3.AsymmetricCroCo3DStereo(d3.Dust3rConfig())
    d3.init_flax_style_(model, torch.Generator(device="cuda").manual_seed(21))
    dust3r_pinhole_heads_(model)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"DUSt3R ViT-L/16 + base decoder (random weights from a seed): "
        f"{n_par / 1e6:.1f} M params, {n_bytes / 2 ** 30:.2f} GiB, built in "
        f"{time.perf_counter() - t0:.1f} s")

    bus = ROOT / "build" / "bus" / "bus"
    root = ROOT / "build" / "alt" / "dust3r"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cfg = default_config(str(root / "output"), Use_VGGT=False,
                         image_size=512, input_image=str(bus / "input.png"))
    art = Artifacts(cfg)
    os.makedirs(os.path.dirname(art.empty_room), exist_ok=True)
    shutil.copy(Artifacts(default_config(str(bus / "output"))).empty_room,
                art.empty_room)
    third = root / "mirrored.png"
    save_image(str(third), load_image_rgb(str(bus / "input.png"),
                                          max_side=None)[:, ::-1].copy())
    frames = (str(bus / "input.png"), art.empty_room, str(third))
    cfg3 = default_config(str(root / "three"), Use_VGGT=False,
                          image_size=512, input_image=frames[0])
    runs = {}
    with recording_flash_shapes() as shapes:
        for name, call in (
                ("run", lambda: p4d.run(cfg, model=model)),
                ("three", lambda: p4d.run_from_model(cfg3, model, frames))):
            stages = {}
            saved = _timed_patches(stages, [
                (p4d, "load_images", "load"),
                (p4d, "run_pairwise", "pairwise"),
                (p4d, "pair_viewer", "align"),
                (p4d, "global_align", "align"),
                (p4d, "export_dust3r_scene", "export")])
            kernels.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                call()
            finally:
                _restore(saved)
            torch.cuda.synchronize()
            runs[name] = dict(total=time.perf_counter() - t0,
                              stages={k: round(sum(v), 4)
                                      for k, v in stages.items()},
                              launches=dict(kernels.LAUNCHES))
    results["dust3r_launches"] = runs["run"]["launches"]
    results["dust3r3_launches"] = runs["three"]["launches"]
    bad = dust3r_artifact_gates(cfg, ["input.png", "empty_room.png"])
    bad += dust3r_artifact_gates(cfg3, ["input.png", "empty_room.png",
                                        "mirrored.png"])
    for name, r in runs.items():
        if r["launches"]["flash_fwd"] != DUST3R_FLASH_PER_FORWARD:
            bad.append(f"{name}: flash launches {r['launches']}")
    what = {"run": "input + empty room, the pair viewer",
            "three": "three frames, the 300-iteration aligner"}
    for name, r in runs.items():
        log(f"DUSt3R phase 4 ({what[name]}): {r['total']:.3f} s; by stage "
            f"(s) {r['stages']}; launches {r['launches']}")
    if bad:
        raise AssertionError("DUSt3R phase 4: " + "; ".join(bad))

    images = p4d.load_images(frames, 512, "cuda")
    pairs = p4d.make_pairs(3)
    t_fwd = cuda_ms(lambda: p4d.run_pairwise(model, images, pairs), reps=5)
    total, top = device_top(lambda: p4d.run_pairwise(model, images, pairs),
                            8)[:2]
    flash_ms = sum(ms for ms, name, _ in top if "fwd_kernel" in name)
    split = "; ".join(f"{name} {ms:.2f} ms ({ms / total:.1%}, {c}x)"
                      for ms, name, c in top) if total > 0 else \
        "no device time recorded"
    log(f"DUSt3R pairwise forward, 3 frames (6 pairs, 12 images through the "
        f"encoder) at 512²: {t_fwd:.3f} ms (CUDA events, median of 5); under "
        f"torch.profiler {total:.2f} ms of device time, the flash kernel "
        f"{flash_ms:.2f} ms of it; the eight operations with the most: "
        f"{split}")
    results["dust3r_forward"] = dict(ms=t_fwd, device_ms=total,
                                     flash_ms=flash_ms)
    held = []
    for shape in sorted(shapes):
        r = fwd_case(shape, gen_t, timed=shape[0] in (6, 12))
        held.append(dict(shape=shape, err=r["err"], **r.get("ms", {}),
                         bound_ms=r["bound"][0]))
    results["flash_fwd_dust3r"] = held
    del model, images
    torch.cuda.empty_cache()


def padded_check(shape, gen_t, wide):
    """The forward at ``shape`` (head dim D) bit for bit the instance of
    width ``wide`` on q, k and v zero-padded to ``wide`` columns (o's first
    D columns and lse; the padded o's other columns exactly 0), with the
    same scale 1/√D; then fwd_case's bound against the plain version, timed
    beside SDPA. D = 8 and D = 4 compute at width 16 inside the kernel."""
    import torch
    import torch.nn.functional as F

    from regen3d_tpu_torch.ops import attention as att

    b, h, sq, sk, d = shape
    q = torch.randn((b, h, sq, d), generator=gen_t, device="cuda")
    k, v = (torch.randn((b, h, sk, d), generator=gen_t, device="cuda")
            for _ in range(2))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    pad = lambda t: F.pad(t, (0, wide - d)).contiguous()
    with torch.no_grad():
        o, lse = att.flash_attention_fwd(q, k, v)
        ow, lsew = att.flash_attention_fwd(pad(q), pad(k), pad(v),
                                           scale=1.0 / d ** 0.5)
    torch.cuda.synchronize()
    same = (torch.equal(o, ow[..., :d].contiguous())
            and torch.equal(lse, lsew)
            and float(ow[..., d:].abs().max()) == 0.0)
    if not same:
        raise AssertionError(f"flash_fwd D = {d} at {shape}: not bit for "
                             f"bit the D = {wide} instance on zero-padded "
                             f"inputs")
    return fwd_case(shape, gen_t)


def baselines_run(name, run, results, spies=()):
    """One baseline run on the card with its stages timed and the flash
    forward's shapes recorded; returns (seconds, stages, launches,
    shapes)."""
    import torch

    from regen3d_tpu_torch import kernels
    from regen3d_tpu_torch.pipeline import baseline_dpa, baseline_midi
    from regen3d_tpu_torch.pipeline.phase3_assets import AssetGenerator

    stages = {}
    saved = _timed_patches(stages, [
        (baseline_midi, "detect_and_segment", "detect"),
        (baseline_dpa, "detect_and_segment", "detect"),
        (AssetGenerator, "generate_sdf_batch", "generate"),
        (baseline_midi, "layout_meshes", "mesh+layout"),
        (baseline_dpa, "inpaint_objects", "inpaint"),
        (baseline_dpa, "extract_and_clean", "mesh"),
        (baseline_dpa, "estimate_depth", "depth"),
        (baseline_dpa, "fit_poses", "fit"),
        *spies])
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with recording_flash_shapes() as shapes:
            out = run()
    finally:
        _restore(saved)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    results[f"{name}_launches"] = launches
    return out, total, {k: round(sum(v), 4) for k, v in stages.items()}, \
        launches, shapes


def baseline_gates(midi_glb, dpa_glb, cfg):
    """The baselines' artifact contract: the MIDI scene GLB (meshes in
    front of the camera, finite) with segmentation.png, every DPA stage
    directory filled and its registered scene finite; returns (failures,
    faces per object of each)."""
    import os

    import numpy as np

    from regen3d_tpu_torch.pipeline.baseline_dpa import STAGES
    from regen3d_tpu_torch.utils.glb import load_glb

    bad, faces = [], {}
    if midi_glb is not None:
        m = load_glb(midi_glb).meshes
        faces["midi"] = [len(x.faces) for x in m]
        if not m or not all(np.isfinite(x.vertices).all()
                            and x.vertices[:, 2].min() > 0 for x in m):
            bad.append(f"MIDI scene {midi_glb}: {faces['midi']}")
        if not os.path.exists(os.path.join(cfg.path("midi_output"),
                                           "segmentation.png")):
            bad.append("MIDI segmentation.png missing")
    if dpa_glb is not None:
        m = load_glb(dpa_glb).meshes
        faces["dpa"] = [len(x.faces) for x in m]
        if not m or not all(np.isfinite(x.vertices).all() for x in m):
            bad.append(f"DPA scene {dpa_glb}: {faces['dpa']}")
        for stage in STAGES:
            if not os.listdir(os.path.join(cfg.path("dpa_output"), stage)):
                bad.append(f"DPA stage {stage} empty")
    return bad, faces


def phase_alternates(results):
    """Phase 4 under Use_VGGT: false and the MIDI and DPA baselines (-p 10,
    -p 11): the small DUSt3R and the aligner on the card (dust3r_small_
    checks); DUSt3R at full width (dust3r_full); both baselines through
    the port's orchestrator on the bus's 960×1280 input with no generator
    (the random-init tiny one: its condition encoder's heads of 8 run the
    flash forward's D = 8 instance), octree_resolution_hy capped at
    ALT_OCTREE_CLI; each D = 8 shape the runs gave the kernel held bit for
    bit against D = 16 on zero-padded inputs and under fwd_error's bound,
    timed beside SDPA; then both with a full-width random-init generator
    passed in (DiTConfig.base(), cross_instance for MIDI; MIDI in box mode
    on ALT_MIDI_BOXES of the bus's objects; octree_resolution_hy capped at
    ALT_OCTREE_FULL); after them, every other flash shape of the four runs
    held against the plain version (fwd_case), the full-width ones timed.
    Each run timed by stage and gated on its artifacts; DPA's raster path
    and silhouette launches printed and gated."""
    import os
    import shutil

    import torch

    from regen3d_tpu_torch import orchestrator
    from regen3d_tpu_torch.artifacts import Artifacts
    from regen3d_tpu_torch.config import default_config
    from regen3d_tpu_torch.pipeline import baseline_dpa, baseline_midi
    from regen3d_tpu_torch.pipeline import pose_fit
    from regen3d_tpu_torch.pipeline.phase3_assets import AssetGenerator
    from regen3d_tpu_torch.utils.image import mask_bbox, mask_from_finding

    t_phase = time.perf_counter()
    info = {k: results["ptxas"].get(f"fwd_kernel<8, 0, {s}>")
            for k, s in (("unsplit", "false"), ("split", "true"))}
    log(f"ptxas, the D = 8 forward instances: {info}")
    if not all(info.values()):
        raise AssertionError(f"the D = 8 forward instances: {info}")
    results["d8_ptxas"] = info
    gen_t = torch.Generator(device="cuda").manual_seed(8)
    results["dust3r_small"] = dust3r_small_checks()
    dust3r_full(results, gen_t)

    bus = ROOT / "build" / "bus" / "bus"
    root = ROOT / "build" / "alt" / "cli"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    shutil.copy(bus / "input.png", root / "input.png")
    cfg = default_config(str(root / "output"),
                         input_image=str(root / "input.png"),
                         octree_resolution_hy=ALT_OCTREE_CLI)
    fit_info = {}

    def fit_spy(init, batch, cam, fit_cfg, _fit=baseline_dpa.fit_poses):
        fit_info["path"] = pose_fit.raster_path(fit_cfg, batch.faces.shape[1],
                                                "cuda")
        fit_info["objects"] = int(batch.faces.shape[0])
        return _fit(init, batch, cam, fit_cfg)

    runs = {}
    run_shapes = set()   # every flash shape of the four baseline runs
    for phase, name in ((10, "midi_cli"), (11, "dpa_cli")):
        saved_fit = baseline_dpa.fit_poses
        baseline_dpa.fit_poses = fit_spy
        try:
            _, total, stages, launches, shapes = baselines_run(
                name, lambda: orchestrator.run_phases(cfg, [phase],
                                                      device="cuda"), results)
        finally:
            baseline_dpa.fit_poses = saved_fit
        runs[name] = dict(total=total, stages=stages, launches=launches)
        run_shapes.update(shapes)
        if not any(s[-1] == 8 for s in shapes):
            raise AssertionError(f"{name}: no D = 8 flash shape in {shapes}")
    bad, faces = baseline_gates(
        cfg.path("glb_scene_path_midi"),
        os.path.join(cfg.path("dpa_output"), "final_registration",
                     "scene.glb"), cfg)
    dpa = runs["dpa_cli"]["launches"]
    iters = int(cfg["dpa_iterations"])
    if fit_info.get("path") != "edge_kernel" or \
            dpa["silhouette_fwd"] != iters + 1 or \
            dpa["silhouette_bwd"] != iters:
        bad.append(f"DPA fit: {fit_info}, launches {dpa}")
    for name, r in runs.items():
        log(f"{name} (run_phases, no generator: the tiny one; octree "
            f"{ALT_OCTREE_CLI}): {r['total']:.3f} s; by stage (s) "
            f"{r['stages']}; launches {r['launches']}")
    log(f"baselines from the CLI: faces per object {faces}; DPA fit "
        f"{fit_info}, silhouette launches {dpa['silhouette_fwd']} forward, "
        f"{dpa['silhouette_bwd']} backward")
    if bad:
        raise AssertionError("baselines from the CLI: " + "; ".join(bad))
    d8 = []
    for shape in sorted(s for s in run_shapes if s[-1] == 8):
        r = padded_check(shape, gen_t, 16)
        d8.append(dict(shape=shape, err=r["err"], err_lse=r["err_lse"],
                       sdpa_err=r["sdpa_err"], bound_ms=r["bound"][0],
                       bound_by=r["bound"][1], **r["ms"]))
    results["flash_fwd_d8"] = d8
    log(f"flash_fwd D = 8 at the baselines' shapes, bit for bit the D = 16 "
        f"instance on zero-padded inputs: {d8}")

    # full width: a generator passed in
    root = ROOT / "build" / "alt" / "full"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    shutil.copy(bus / "input.png", root / "input.png")
    bus_art = Artifacts(default_config(str(bus / "output")))
    boxes = [mask_bbox(mask_from_finding(os.path.join(
        bus_art.findings_fullsize, f"{s}.png")))
        for s in bus_art.list_findings(full_size=True)
        if not s.startswith("floor")][:ALT_MIDI_BOXES]
    (root / "input.boxes.txt").write_text(
        "".join(f"{x0} {y0} {x1} {y1}\n" for x0, y0, x1, y1 in boxes))
    cfg = default_config(str(root / "output"),
                         input_image=str(root / "input.png"), seg_mode="box",
                         octree_resolution_hy=ALT_OCTREE_FULL)
    full = {}
    for name, module, cross in (("midi_full", baseline_midi, True),
                                ("dpa_full", baseline_dpa, False)):
        t0 = time.perf_counter()
        gen = AssetGenerator.random_init(
            torch.Generator(device="cuda").manual_seed(31), tiny=False,
            cross_instance=cross, device="cuda")
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        out, total, stages, launches, shapes = baselines_run(
            name, lambda: module.run(cfg, generator=gen), results)
        full[name] = out
        run_shapes.update(shapes)
        log(f"{name} (DiTConfig.base(){', cross_instance' if cross else ''}"
            f", random weights from a seed, built in {t_build:.1f} s; octree "
            f"{ALT_OCTREE_FULL}"
            f"{f', box mode on {len(boxes)} objects' if cross else ''}): "
            f"{total:.3f} s; by stage (s) {stages}; flash shapes "
            f"{sorted(shapes)}; launches {launches}")
        if launches["flash_fwd"] == 0:
            raise AssertionError(f"{name}: no flash launch")
        del gen
        torch.cuda.empty_cache()
    bad, faces = baseline_gates(full["midi_full"], full["dpa_full"], cfg)
    log(f"baselines at full width: faces per object {faces}")
    if bad or len(faces["midi"]) != len(boxes):
        raise AssertionError(f"baselines at full width: {bad}, {faces}")
    # every other shape of the four runs against the plain version; the
    # full-width generators' (head dims 64 and 96) timed beside SDPA
    held = []
    for shape in sorted(s for s in run_shapes if s[-1] != 8):
        r = fwd_case(shape, gen_t, timed=shape[-1] >= 64)
        held.append(dict(shape=shape, err=r["err"], err_lse=r["err_lse"],
                         sdpa_err=r["sdpa_err"], bound_ms=r["bound"][0],
                         bound_by=r["bound"][1], **r.get("ms", {})))
    results["flash_fwd_baselines"] = held
    log(f"flash_fwd at the baselines' other shapes, held against the plain "
        f"version after the runs: {held}")
    log(f"phase_alternates: {time.perf_counter() - t_phase:.1f} s")


# phase_checkpoints: the checkpoint layer at full width. The matting net
# runs at 256², so its lowest level attends over 64² = 4,096 positions with
# 4 heads of 32 (base 32 × 4 channels)
MATTING_FLASH_SHAPE = (1, 4, 4096, 4096, 32)
# the matting net on the card (bf16, kernels) against the same weights on
# the CPU (f32, plain versions), on a 960×1280 picture, the alphas' 8-bit
# levels apart: the mean within MATTING_MEAN_OVER_BF16 and the max within
# MATTING_MAX_OVER_BF16 times the CPU's own bf16's (the zero-initialised
# kernels drawn from N(0, 0.1²), so the alpha spreads over (0, 1) and bf16
# rounding moves steep sigmoids by up to 20 levels: a first H100 run read
# a max of 20 and a mean of 0.59)
MATTING_MEAN_OVER_BF16 = 1.25
MATTING_MAX_OVER_BF16 = 2.0
# the families phase_checkpoints round-trips through the upstream layout
UPSTREAM_FAMILIES = ("vggt", "sam", "dust3r", "dit", "midi",
                     "depth_anything", "lpips")


def _same_files(a, b, skip=()):
    """The files under a and b but those under a directory named in
    ``skip``: (the same relative paths in both, the paths whose bytes
    differ)."""
    def files(root):
        return sorted(p.relative_to(root) for p in Path(root).rglob("*")
                      if p.is_file() and not set(p.relative_to(root).parts)
                      & set(skip))
    fa, fb = files(a), files(b)
    differ = [str(p) for p in fa if p in fb
              and (Path(a) / p).read_bytes() != (Path(b) / p).read_bytes()]
    return fa == fb and len(fa) > 0, differ


def ckpt_packages(root):
    """Which of tensorstore, safetensors and PIL the machine has; where
    tensorstore is absent an orbax-shaped directory (manifest.ocdbt) must
    raise ImportError naming it, where PIL is absent a JPEG given to
    load_image_rgb likewise. Returns (presence, failures)."""
    import importlib.util

    from regen3d_tpu_torch.models.weights import load_checkpoint
    from regen3d_tpu_torch.utils.image import load_image_rgb

    have = {m: importlib.util.find_spec(m) is not None
            for m in ("tensorstore", "safetensors", "PIL")}
    bad = []
    if not have["tensorstore"]:
        d = root / "orbax_shaped"
        d.mkdir(parents=True)
        (d / "manifest.ocdbt").write_bytes(b"")
        (d / "_METADATA").write_text('{"tree_metadata": {}}')
        try:
            load_checkpoint(str(d))
            bad.append("an orbax directory loaded without tensorstore")
        except ImportError as e:
            if "tensorstore" not in str(e):
                bad.append(f"orbax without tensorstore: {e}")
    if not have["PIL"]:
        jpg = root / "photo.jpg"
        jpg.write_bytes(b"\xff\xd8\xff\xe0\x00\x10JFIF\x00" + bytes(16))
        try:
            load_image_rgb(str(jpg))
            bad.append("a JPEG loaded without PIL")
        except ImportError as e:
            if "PIL" not in str(e) or "JPEG" not in str(e):
                bad.append(f"JPEG without PIL: {e}")
    return have, bad


def ckpt_models(dev="cuda"):
    """The config keys' models at full width, random weights from seeds:
    DetectorConfig() (seed 1), SaliencyConfig() (2), Depth-Anything-V2-Small
    (3), MattingUNet(base=32) (4, its zero-initialised kernels drawn from
    N(0, 0.1²)) and LPIPS (5; its init draws on the host)."""
    import torch

    from regen3d_tpu_torch.models import depth_anything as da
    from regen3d_tpu_torch.models import detector as det
    from regen3d_tpu_torch.models import lpips
    from regen3d_tpu_torch.models import saliency as sal
    from regen3d_tpu_torch.models import unet

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    m = dict(detector=det.OpenVocabDetector(det.DetectorConfig(), device=dev),
             saliency=sal.SaliencyTransformer(sal.SaliencyConfig(),
                                              device=dev),
             depth=da.DepthAnything(da.DepthAnythingConfig.small(),
                                    device=dev),
             matting=unet.MattingUNet(base=32, device=dev),
             lpips=lpips.LPIPS(device=dev))
    det.init_flax_style_(m["detector"], gen(1))
    sal.init_flax_style_(m["saliency"], gen(2))
    da.init_flax_style_(m["depth"], gen(3))
    unet.init_flax_style_(m["matting"], gen(4))
    unet.draw_zero_init_leaves_(m["matting"], gen(4), std=0.1)
    lpips.init_flax_style_(m["lpips"], torch.Generator().manual_seed(5))
    return m


def ckpt_config_keys(results, sam, models, root, dev="cuda"):
    """The five config keys at full width from the port's directories,
    against the same models passed in directly: phase 1 (run, detector,
    saliency net, Depth-Anything) then phase 2 (matting) through
    run_phases(cfg, [1, 2]), the findings and depth.png byte for byte the
    direct run's, every prepped RGBA byte for byte prepare_for_3d's with
    the model; the saliency key's points through detect_and_segment with
    SAM-H, masks equal; phase 9 with lpips_checkpoint, every metric equal.
    Returns (stems, threshold, timings)."""
    import os
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from regen3d_tpu_torch import kernels, orchestrator
    from regen3d_tpu_torch.artifacts import Artifacts
    from regen3d_tpu_torch.config import default_config
    from regen3d_tpu_torch.models.lpips import make_lpips_fn
    from regen3d_tpu_torch.pipeline import phase1_segmentation as p1
    from regen3d_tpu_torch.pipeline import phase9_eval
    from regen3d_tpu_torch.pipeline.depth_distill import save_depth_checkpoint
    from regen3d_tpu_torch.pipeline.detector_distill import (
        save_detector_checkpoint,
    )
    from regen3d_tpu_torch.pipeline.matting import MattingModel
    from regen3d_tpu_torch.pipeline.phase2_inpaint import prepare_for_3d
    from regen3d_tpu_torch.pipeline.saliency_distill import (
        SaliencyModel,
        save_saliency_checkpoint,
    )
    from regen3d_tpu_torch.models.weights import save_model
    from regen3d_tpu_torch.utils.image import load_image_rgb, save_image

    ck = root / "ckpt"
    keys = dict(detector_checkpoint=str(ck / "detector"),
                saliency_checkpoint=str(ck / "saliency"),
                depth_anything_checkpoint=str(ck / "depth"),
                matting_checkpoint=str(ck / "matting"))
    t0 = time.perf_counter()
    save_detector_checkpoint(keys["detector_checkpoint"], models["detector"])
    save_saliency_checkpoint(keys["saliency_checkpoint"], models["saliency"])
    save_depth_checkpoint(keys["depth_anything_checkpoint"], models["depth"])
    MattingModel(models["matting"]).save(keys["matting_checkpoint"])
    save_model(str(ck / "lpips"), models["lpips"])
    t_save = time.perf_counter() - t0
    bus_input = ROOT / "build" / "bus" / "bus" / "input.png"
    roots = {n: root / n for n in ("direct", "keys")}
    for r in roots.values():
        r.mkdir(parents=True)
        shutil.copy(bus_input, r / "input.png")
    over = dict(use_points=True, point_method="saliency", points_per_object=1,
                matting_base=32, eval_scene_incl_background=False)
    saliency = SaliencyModel(models["saliency"])
    t0 = time.perf_counter()
    for threshold in (0.25, 0.1, 0.02):
        shutil.rmtree(roots["direct"] / "output", ignore_errors=True)
        cfg_d = default_config(str(roots["direct"] / "output"),
                               input_image=str(roots["direct"] / "input.png"),
                               threshold=threshold, **over)
        stems = p1.run(cfg_d, detector=models["detector"],
                       saliency_model=saliency, depth_model=models["depth"],
                       device=dev)
        if stems:
            break
    t_direct = time.perf_counter() - t0
    cfg_k = default_config(str(roots["keys"] / "output"),
                           input_image=str(roots["keys"] / "input.png"),
                           threshold=threshold, **over, **keys)
    kernels.reset_counts()
    timings = orchestrator.run_phases(cfg_k, [1, 2], device=dev)
    results["checkpoint_launches"] = dict(kernels.LAUNCHES)
    bad = []
    art_d, art_k = Artifacts(cfg_d), Artifacts(cfg_k)
    phase2_dirs = (os.path.basename(art_k.inpaint_dir),
                   os.path.basename(art_k.prepped_dir))
    same, differ = _same_files(art_d.findings, art_k.findings,
                               skip=phase2_dirs)
    if not stems or not same or differ:
        bad.append(f"phase 1 from the keys: {len(stems)} findings, the same "
                   f"file list {same}, bytes differ in {differ[:5]}")
    stems_k = art_k.list_findings()
    matting = MattingModel(models["matting"])
    prepped = sorted(f[:-4] for f in os.listdir(art_k.prepped_dir))
    if prepped != sorted(stems_k):
        bad.append(f"phase 2 prepped {prepped} of {stems_k}")
    def prep(stem):     # in threads, as phase 2 runs it
        out = root / "prep" / f"{stem}.png"
        prepare_for_3d(os.path.join(art_k.inpaint_dir, f"{stem}.png"),
                       str(out), size=512, matting=matting)
        return out.read_bytes() == Path(art_k.prepped_dir,
                                        f"{stem}.png").read_bytes()

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=8) as pool:
        same_prep = dict(zip(prepped, pool.map(prep, prepped)))
    t_prep = time.perf_counter() - t0
    if not all(same_prep.values()):
        bad.append(f"phase 2: the prepped RGBA not prepare_for_3d's with the "
                   f"model: {[s for s, ok in same_prep.items() if not ok]}")
    # the saliency key's effect: SAM-H's second pass on its points
    image = load_image_rgb(str(roots["keys"] / "input.png"))
    cfg_s = default_config(str(root / "sal"), threshold=threshold,
                           saliency_checkpoint=keys["saliency_checkpoint"],
                           **over)
    got = p1.detect_and_segment(cfg_s, image, sam=sam,
                                detector=models["detector"])
    want = p1.detect_and_segment(cfg_s, image, sam=sam,
                                 detector=models["detector"],
                                 saliency_model=saliency)
    if len(got) != len(want) or not got or any(
            not np.array_equal(g.mask, w.mask) for g, w in zip(got, want)):
        bad.append(f"saliency_checkpoint: {len(got)} masks against "
                   f"{len(want)} with the model passed in, or some differ")
    # phase 9: the bus's input against a render with noise
    rng = np.random.default_rng(9)
    render = np.clip(image.astype(int) + rng.integers(-20, 21, image.shape),
                     0, 255).astype(np.uint8)
    save_image(art_k.predicted_image, render)
    m_keys = phase9_eval.run(cfg_k.with_overrides(
        lpips_checkpoint=str(ck / "lpips")), device=dev)
    m_direct = phase9_eval.run(cfg_k, lpips_fn=make_lpips_fn(models["lpips"]),
                               device=dev)
    if m_keys != m_direct or "lpips" not in m_keys:
        bad.append(f"phase 9 with lpips_checkpoint {m_keys}, with the model "
                   f"{m_direct}")
    log(f"checkpoint keys at full width (the port's directories, written in "
        f"{t_save:.2f} s): run_phases(cfg, [1, 2]) phase 1 "
        f"{timings[1]:.3f} s, phase 2 {timings[2]:.3f} s against the direct "
        f"phase 1 {t_direct:.3f} s (threshold {threshold}); "
        f"{len(stems)} findings, depth.png and the findings byte for byte, "
        f"{len(prepped)} prepped RGBA byte for byte prepare_for_3d's with "
        f"the net ({t_prep:.3f} s); saliency points on SAM-H: {len(got)} "
        f"masks equal; phase 9 lpips {m_keys.get('lpips')} equal; launches "
        f"{results['checkpoint_launches']}")
    if bad:
        raise AssertionError("checkpoint keys: " + "; ".join(bad[:8]))
    return stems, threshold


def _upstream_family(name, dev="cuda"):
    """(source module at full width with random weights from a seed, a
    function that makes a fresh one, the forward's inputs, the
    forward)."""
    import dataclasses

    import torch

    from regen3d_tpu_torch.models import conversion

    g = torch.Generator(device=dev).manual_seed(
        UPSTREAM_FAMILIES.index(name) + 20)
    gc = torch.Generator().manual_seed(7)

    def rand(*shape):
        return torch.rand(shape, generator=gc).to(dev)

    if name == "vggt":
        from regen3d_tpu_torch.models import vggt as m
        build = lambda: m.VGGT(m.VGGTConfig(), device=dev)
        init, args = m.init_flax_style_, (rand(1, 2, 518, 518, 3),)
        fwd = lambda mod, x: mod(x)
    elif name == "sam":
        from regen3d_tpu_torch.models import sam as m
        build = lambda: m.SAM(m.SamConfig(), device=dev)
        init = m.init_flax_style_
        args = (rand(1, 1024, 1024, 3), rand(1, 2, 2),
                torch.ones((1, 2), device=dev),
                torch.tensor([[[0.2, 0.2], [0.7, 0.8]]], device=dev))

        def fwd(mod, img, pts, labs, box):
            emb = mod.encode(img)
            return (emb, *mod.decode(emb, pts, labs, box))
    elif name == "dust3r":
        from regen3d_tpu_torch.models import dust3r as m
        build = lambda: m.AsymmetricCroCo3DStereo(m.Dust3rConfig(), device=dev)
        init, args = m.init_flax_style_, (rand(1, 512, 512, 3),
                                          rand(1, 512, 512, 3))
        fwd = lambda mod, a, b: mod(a, b)
    elif name in ("dit", "midi"):
        from regen3d_tpu_torch.models import dit as m
        c = dataclasses.replace(m.DiTConfig.base(),
                                cross_instance=name == "midi")
        build = lambda: m.ShapeDiT(c, device=dev)

        def init(mod, gen):
            m.init_flax_style_(mod, gen)
            m.draw_zero_init_leaves_(mod, gen)
        b = 4 if name == "midi" else 2
        args = (torch.randn((b, c.latent_tokens, c.latent_dim),
                            generator=gc).to(dev), rand(b),
                torch.randn((b, 257, c.cond_dim), generator=gc).to(dev))
        fwd = lambda mod, x, t, cond: mod(x, t, cond)
    elif name == "depth_anything":
        from regen3d_tpu_torch.models import depth_anything as m
        build = lambda: m.DepthAnything(m.DepthAnythingConfig.small(),
                                        device=dev)
        init, args = m.init_flax_style_, (rand(1, 518, 518, 3),)
        fwd = lambda mod, x: mod(x)
    else:
        from regen3d_tpu_torch.models import lpips as m
        build = lambda: m.LPIPS(device=dev)
        init, args = m.init_flax_style_, (rand(1, 256, 256, 3),
                                          rand(1, 256, 256, 3))
        fwd = lambda mod, a, b: mod(a, b)
    src = build()
    init(src, torch.Generator().manual_seed(25) if name == "lpips" else g)
    return src, build, args, fwd


def _outputs_equal(a, b):
    import torch

    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_outputs_equal(a[k], b[k])
                                              for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(_outputs_equal, a, b))
    return torch.equal(a, b)


def ckpt_upstream(results, root, dev="cuda"):
    """Each of UPSTREAM_FAMILIES at full width: the source module (random
    weights from a seed) → its flax tree → the upstream layout by the
    port's inverse map → load_upstream into a fresh module, every tensor
    torch.equal and one forward bit for bit the source's; VGGT-1B through
    a torch.save'd .pt of bf16 tensors (deleted after) and load_torch_file,
    then phase4_camera.run with each, the artifacts byte for byte. The .pt
    holds bf16 tensors where bf16 holds the values exactly (the model's
    bf16 weights; load_torch_file widens them to f32) and f32 elsewhere."""
    import shutil

    import numpy as np
    import torch

    from regen3d_tpu_torch.config import default_config
    from regen3d_tpu_torch.artifacts import Artifacts
    from regen3d_tpu_torch.models import conversion
    from regen3d_tpu_torch.models.from_jax import tree_from_model
    from regen3d_tpu_torch.models.weights import load_torch_file
    from regen3d_tpu_torch.pipeline import phase4_camera
    from regen3d_tpu_torch.utils.image import save_image

    bad, rows = [], {}
    for name in UPSTREAM_FAMILIES:
        fam = conversion.FAMILIES[name]
        src, build, args, fwd = _upstream_family(name, dev)
        n_par = sum(p.numel() for p in src.parameters())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = conversion.upstream_state(
            name, tree_from_model(src, fam.conv_transpose))
        t_out = time.perf_counter() - t0
        if name == "vggt":
            d = root / "vggt_pt"
            d.mkdir(parents=True)
            path = d / "model.pt"
            # bf16 where that is exact (the bf16 weights), f32 elsewhere
            pt = {}
            for k, v in state.items():
                t = torch.from_numpy(v)
                b = t.to(torch.bfloat16)
                pt[k] = b if torch.equal(b.float(), t) else t
            torch.save(pt, path)
            n_bf16 = f"{sum(t.dtype == torch.bfloat16 for t in pt.values())}" \
                f"/{len(pt)}"
            del pt
            size = path.stat().st_size
            del state
            t0 = time.perf_counter()
            state = load_torch_file(str(path))
            t_file = time.perf_counter() - t0
            shutil.rmtree(d)
        rules = fam.rules()     # the keys no rule matches
        unmapped = [k for k in state
                    if not any(re.match(r[0], k) for r in rules)]
        fresh = build()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        conversion.load_upstream(name, state, fresh)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        del state
        sa, sb = src.state_dict(), fresh.state_dict()
        equal = sorted(sa) == sorted(sb) and all(torch.equal(sa[k], sb[k])
                                                 for k in sa)
        with torch.no_grad():
            same_fwd = _outputs_equal(fwd(src, *args), fwd(fresh, *args))
        rows[name] = dict(params_M=round(n_par / 1e6, 3),
                          unmapped=len(unmapped), load_s=round(t_load, 3),
                          to_upstream_s=round(t_out, 3))
        if name == "vggt":
            rows[name].update(pt_GB=round(size / 1e9, 3),
                              pt_read_s=round(t_file, 3),
                              pt_bf16_tensors=n_bf16)
            objs = bus_objects()
            image, empty, _ = bus_images(objs, BUS_HW, dev,
                                         np.random.default_rng(0))
            for which, model in (("source", src), ("loaded", fresh)):
                r = root / "phase4" / which
                cfg = default_config(str(r / "output"),
                                     input_image=str(r / "input.png"))
                save_image(str(r / "input.png"), image)
                save_image(Artifacts(cfg).empty_room, empty)
                phase4_camera.run(cfg, model=model, device=dev)
            same4, differ4 = _same_files(root / "phase4" / "source",
                                         root / "phase4" / "loaded")
            rows[name]["phase4_bytes_equal"] = same4 and not differ4
            if not (same4 and not differ4):
                bad.append(f"vggt: phase 4's artifacts differ: {differ4[:5]}")
        if not (equal and same_fwd and not unmapped):
            bad.append(f"{name}: tensors equal {equal}, forward bit for bit "
                       f"{same_fwd}, unmapped {unmapped[:5]}")
        del src, fresh, sa, sb
        torch.cuda.empty_cache()
    log(f"upstream layouts at full width, through the port's inverse map and "
        f"load_upstream (VGGT-1B through a .pt and load_torch_file, then "
        f"phase4_camera.run with each): {json.dumps(rows)}")
    if bad:
        raise AssertionError("upstream layouts: " + "; ".join(bad))
    results["upstream"] = rows


def ckpt_matting(results, model, dev="cuda"):
    """MattingModel.alpha on the bus's 960×1280 input on the card (bf16,
    the flash kernel) against the same weights on the CPU (f32, plain
    versions): the alphas' levels apart within MATTING_MEAN_OVER_BF16 and
    MATTING_MAX_OVER_BF16 times the CPU's own bf16's, the flash launches
    of one alpha
    (4: down2_0_attn, mid_attn, up2_0_attn, up2_1_attn), and the flash
    kernel at MATTING_FLASH_SHAPE against its plain version, timed beside
    SDPA."""
    import numpy as np
    import torch

    from regen3d_tpu_torch import kernels
    from regen3d_tpu_torch.models.unet import MattingUNet
    from regen3d_tpu_torch.pipeline.matting import MattingModel
    from regen3d_tpu_torch.utils.image import load_image_rgb

    image = load_image_rgb(str(ROOT / "build" / "bus" / "bus" / "input.png"))
    cpu = {dt: MattingUNet(base=32, dtype=dt, device="cpu")
           for dt in (torch.float32, torch.bfloat16)}
    for m in cpu.values():
        m.load_state_dict(model.state_dict())
    card = MattingModel(model)
    card.alpha(image)           # warm-up, uncounted
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a_card = card.alpha(image)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    results["matting_launches"] = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    a_cpu = MattingModel(cpu[torch.float32]).alpha(image)
    t_cpu = time.perf_counter() - t0
    levels = np.abs(a_card - a_cpu) * 255
    own = np.abs(MattingModel(cpu[torch.bfloat16]).alpha(image) - a_cpu) * 255
    gen = torch.Generator(device="cuda").manual_seed(32)
    r = fwd_case(MATTING_FLASH_SHAPE, gen)
    results["flash_fwd"]["max_abs_err"] = max(
        results["flash_fwd"]["max_abs_err"], r["err"])
    results["flash_fwd"]["matting_shape"] = dict(
        shape=MATTING_FLASH_SHAPE, err=r["err"], bound_ms=r["bound"][0],
        bound_by=r["bound"][1], launches=results["matting_launches"][
            "flash_fwd"], **r["ms"])
    log(f"matting (MattingUNet base 32, 256², seeded init) on the 960x1280 "
        f"input: card {t_card:.3f} s, CPU f32 {t_cpu:.3f} s; alpha levels "
        f"from the CPU's f32: the card max {levels.max():.2f}, mean "
        f"{levels.mean():.4f}, the CPU's bf16 max {own.max():.2f}, mean "
        f"{own.mean():.4f} (tol {MATTING_MAX_OVER_BF16}x, "
        f"{MATTING_MEAN_OVER_BF16}x); alpha in "
        f"[{a_card.min():.3f}, {a_card.max():.3f}], {float((a_card > 0.5).mean()):.3f} "
        f"above 0.5; launches {results['matting_launches']}")
    if not (levels.max() <= MATTING_MAX_OVER_BF16 * own.max()
            and levels.mean() <= MATTING_MEAN_OVER_BF16 * own.mean()
            and results["matting_launches"]["flash_fwd"] == 4):
        raise AssertionError("matting: card vs CPU or launches over limits")


def phase_checkpoints(results, sam):
    """The checkpoint layer on the card (regen3d_tpu_torch/models/weights.py,
    conversion.py and the config keys' loaders): which of tensorstore,
    safetensors and PIL this machine has, and the refusals where one is
    absent (ckpt_packages); the five config keys at full width from the
    port's directories against the same models passed in
    (ckpt_config_keys); the upstream layouts at full width
    (ckpt_upstream); phase 2's matting net on the card against the CPU
    (ckpt_matting)."""
    import shutil

    import torch

    t_phase = time.perf_counter()
    root = ROOT / "build" / "checkpoints"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    have, bad = ckpt_packages(root)
    log(f"checkpoint packages on this machine: {have}; the refusals where "
        f"one is absent: {bad or 'as expected'}")
    if bad:
        raise AssertionError("; ".join(bad))
    models = ckpt_models()
    ckpt_config_keys(results, sam, models, root)
    ckpt_matting(results, models["matting"])
    del models
    torch.cuda.empty_cache()
    ckpt_upstream(results, root)
    shutil.rmtree(root / "ckpt", ignore_errors=True)
    log(f"phase_checkpoints: {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 1's two last switches: the upscalers and the mask editor
# ---------------------------------------------------------------------------

# FLUX.1-dev's transformer on a 1024² image's latent: 4,096 image tokens of
# 64 (16-channel latents packed 2×2) and 512 T5 tokens of 4,096; the
# config's num_inference_steps through dit.sample at guidance 1.0
FLUX_TOKENS, FLUX_TEXT, FLUX_STEPS = 4096, 512, 50
# the SD-x4 upscaler on a 256² crop (→ 1024², a 128² latent) and the FLUX
# upscaler's recipe on a 128² crop (→ 512², 1,024 tokens of 16)
X4_CROP, FLUX_UP_CROP = 256, 128
# flash launches: 57 a FLUX forward (one joint attention a block); 11 an
# x4 UNet forward (4 down, 1 mid, 6 up) and 1 the VAE decode; 32 a fused
# guided DiT step (16 blocks, self and cross) and 2 the SD VAE (encode,
# decode); 7 a SAM decode (the two-way transformer's 2 × 3 and the final
# token → image), 4 grid-bias an encode (SAM-H's global blocks)
FLUX_LAUNCHES, X4_UNET_LAUNCHES, SAM_DECODE_LAUNCHES = 57, 11, 7
# the card (bf16, kernels) against the CPU's f32 plain versions, of max
# |f32|, within phase 3's bf16 limits (ROADMAP Queue 3 af)
UE_MAX_ERR, UE_MEAN_ERR = 5e-2, 1.5e-2
# the tiny x4 pair's uint8 upscale (4 guided steps from one noise) on the
# card against the CPU's f32, in levels (max, mean): an H100 read (1, 0.12)
X4_TINY_LEVELS = (8, 1.0)


class _WithPooled:
    """A FluxTransformer that dit.sample drives with a pooled vector: the
    sampler calls model(x, t, cond) and reads model.cfg."""

    def __init__(self, model, pooled):
        self.model, self.pooled, self.cfg = model, pooled, model.cfg

    def __call__(self, x, t, cond):
        return self.model(x, t, cond, pooled=self.pooled)


def _card_and_cpu(cls, cfg, init, seed):
    """(the module on the card in cfg's dtype, the same weights in f32 on
    the CPU), initialised on the CPU from ``seed``."""
    import dataclasses

    import torch

    cpu = cls(dataclasses.replace(cfg, dtype=torch.float32), device="cpu")
    init(cpu, torch.Generator().manual_seed(seed))
    card = cls(cfg)
    card.load_state_dict(cpu.state_dict())
    return card.eval(), cpu.eval()


def upscale_small_checks():
    """The tiny FLUX, the tiny x4 upscaler pair and a small SAM's editing
    session on the card (bf16, kernels) against the same weights on the
    CPU (f32, plain versions). Returns the errors."""
    import numpy as np
    import torch

    from regen3d_tpu_torch.models import flux as fl
    from regen3d_tpu_torch.models import unet as un
    from regen3d_tpu_torch.models import vae as va
    from regen3d_tpu_torch.models.sam import SAM, SamConfig, init_flax_style_
    from regen3d_tpu_torch.pipeline import interactive
    from regen3d_tpu_torch.pipeline.upscale import Upscaler

    out = {}
    card, cpu = _card_and_cpu(fl.FluxTransformer, fl.FluxConfig.tiny(),
                              fl.init_flax_style_, 31)
    g = torch.Generator().manual_seed(32)
    x, cond = torch.randn((2, 16, 8), generator=g), torch.randn(
        (2, 8, 32), generator=g)
    t, pooled = torch.rand(2, generator=g), torch.randn((2, 16), generator=g)
    with torch.no_grad():
        out["flux tiny"] = _rel_errors(
            card(x.cuda(), t.cuda(), cond.cuda(), pooled=pooled.cuda()),
            cpu(x, t, cond, pooled=pooled))

    unet, unet_c = _card_and_cpu(un.UNet, un.UNetConfig.tiny(),
                                 un.init_flax_style_, 33)
    un.draw_zero_init_leaves_(unet_c, torch.Generator().manual_seed(34))
    unet.load_state_dict(unet_c.state_dict())
    vae, vae_c = _card_and_cpu(va.AutoencoderKL, va.VAEConfig.tiny(),
                               un.init_flax_style_, 35)
    un.draw_zero_init_leaves_(vae_c, torch.Generator().manual_seed(36))
    vae.load_state_dict(vae_c.state_dict())
    rng = np.random.default_rng(37)
    crop = rng.integers(0, 256, (32, 32, 3), np.uint8)
    noise = torch.randn((1, 16, 16, 4), generator=g)
    cfg = {"num_inference_steps": 4, "guidance_scale": 5.0}
    a = Upscaler(unet, vae).upscale(crop, cfg, noise=noise)
    b = Upscaler(unet_c, vae_c).upscale(crop, cfg, noise=noise)
    d = np.abs(a.astype(int) - b.astype(int))
    out["x4 tiny levels"] = (int(d.max()), float(d.mean()))

    small = SamConfig(image_size=512, width=160, depth=2, num_heads=2,
                      window=14, global_blocks=(1,), prompt_dim=256)
    sam, sam_c = _card_and_cpu(SAM, small, init_flax_style_, 38)
    img = rng.integers(0, 256, (240, 320, 3), np.uint8)
    verbs = [lambda s: s.new_from_box("box", 40, 30, 200, 170),
             lambda s: s.add_point(0, 120, 90, True),
             lambda s: s.add_point(0, 60, 160, False)]
    runs = {}
    resize = interactive.resize_bilinear
    try:
        for name, model in (("card", sam), ("cpu", sam_c)):
            logits, masks = [], []

            def recorded(t, hw):
                r = resize(t, hw)
                logits.append(r[0, ..., 0].float().cpu())
                return r

            interactive.resize_bilinear = recorded
            session = interactive.EditSession(img, sam=model)
            for verb in verbs:
                verb(session)
                masks.append(session.masks[0].mask)
            runs[name] = (masks, logits[1:])     # [0]: the encode's input
    finally:
        interactive.resize_bilinear = resize
    worst, share = 0.0, 0.0
    for m_card, m_cpu, lg in zip(runs["card"][0], runs["cpu"][0],
                                 runs["card"][1]):
        off = m_card != m_cpu
        share = max(share, float(off.mean()))
        if off.any():
            worst = max(worst, float(lg[torch.from_numpy(off)].abs().max())
                        / float(lg.abs().max()))
    out["sam session"] = (worst, share)
    return out


def _meta_flux_keys():
    """FLUX.1-dev's upstream key set on the ``meta`` device: the rule table
    of the ``flux`` family maps every key of the layout the inverse builds
    from FluxTransformer(FluxConfig()), to the module's shapes, with no
    tensor allocated (meta parameters, zero-stride upstream arrays).
    Returns (keys, double blocks, single blocks, failures)."""
    import numpy as np

    from regen3d_tpu_torch.models import conversion
    from regen3d_tpu_torch.models.flux import FluxConfig, FluxTransformer
    from regen3d_tpu_torch.models.from_jax import tree_from_model
    from regen3d_tpu_torch.models.weights import (
        convert_state_dict,
        flatten_tree,
        verify_tree_shapes,
    )

    fam = conversion.FAMILIES["flux"]
    tree = tree_from_model(FluxTransformer(FluxConfig(), device="meta"))
    state = {}
    for path, leaf in flatten_tree(tree).items():
        key, _ = fam.invert(path[1:], np.zeros((1,) * leaf.ndim, np.float32))
        # a zero-stride view of the upstream shape: nothing allocated
        state[key] = np.broadcast_to(np.float32(0), tuple(leaf.shape)[::-1])
    unmapped = []
    conv = convert_state_dict(state, fam.rules(), strict=True,
                              unmapped_out=unmapped)
    bad = verify_tree_shapes(conv, tree) + unmapped
    blocks = lambda p: len({k.split(".")[1] for k in state
                            if k.startswith(p + ".")})
    return (len(state), blocks("transformer_blocks"),
            blocks("single_transformer_blocks"), bad)


def flux_full(results, gen):
    """FluxTransformer(FluxConfig()) from a seed (flax's f32 parameters,
    bf16 compute) through dit.sample at guidance 1.0 over FLUX_STEPS on a
    1024² image's latent; returns the flash shapes it gave."""
    import torch

    from regen3d_tpu_torch import kernels
    from regen3d_tpu_torch.models import dit
    from regen3d_tpu_torch.models.flux import (
        FluxConfig,
        FluxTransformer,
        init_flax_style_,
    )

    t0 = time.perf_counter()
    n_keys, n_double, n_single, bad = _meta_flux_keys()
    log(f"flux upstream layout on meta ({time.perf_counter() - t0:.1f} s): "
        f"{n_keys} keys, {n_double} double and {n_single} single blocks, "
        f"failures {bad[:5]}")
    if bad or (n_double, n_single) != (19, 38):
        raise AssertionError("flux: the upstream key set and the rule table "
                             "disagree")

    cfg = FluxConfig()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = FluxTransformer(cfg).eval()
    init_flax_style_(model, gen)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in model.parameters())
    log(f"FLUX.1-dev transformer (FluxConfig(): {cfg.double_depth} double, "
        f"{cfg.single_depth} single blocks, width {cfg.width}, "
        f"{cfg.num_heads} heads of {cfg.head_dim}): {n_par / 1e9:.3f} B "
        f"params in f32 ({4 * n_par / 1e9:.1f} GB), built and initialised "
        f"in {time.perf_counter() - t0:.1f} s")
    lat = torch.randn((1, FLUX_TOKENS, cfg.in_channels), generator=gen,
                      device="cuda")
    cond = torch.randn((1, FLUX_TEXT, cfg.cond_dim), generator=gen,
                       device="cuda")
    pooled = torch.randn((1, cfg.pooled_dim), generator=gen, device="cuda")
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording_flash_shapes() as shapes:
        out = dit.sample(_WithPooled(model, pooled), cond,
                         num_steps=FLUX_STEPS, guidance_scale=1.0,
                         latents=lat)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tt = torch.full((1,), 0.5, device="cuda")
    with torch.no_grad():
        dev_ms, top, n_kern, ops = device_top(
            lambda: model(lat, tt, cond, pooled=pooled), 8)
    log(f"flux_{FLUX_STEPS}step (dit.sample, guidance 1.0, {FLUX_TOKENS} "
        f"image + {FLUX_TEXT} text tokens): {dt:.2f} s, "
        f"{dt / FLUX_STEPS:.4f} s a step; one step {dev_ms:.2f} ms of device "
        f"time in {n_kern} launches, top kernels "
        f"{[(round(m, 2), n, c) for m, n, c in top]}, top operators "
        f"{[(round(m, 2), n, c) for m, n, c in ops]}; peak {peak:.2f} GiB; "
        f"launches {counts}")
    gates = []
    if out.shape != lat.shape or not bool(torch.isfinite(out).all()):
        gates.append(f"output {tuple(out.shape)} not finite")
    if counts["flash_fwd"] != FLUX_LAUNCHES * FLUX_STEPS:
        gates.append(f"{counts['flash_fwd']} flash launches")
    if gates:
        raise AssertionError(f"flux_{FLUX_STEPS}step: {gates}")
    results["flux_launches"] = counts
    results["flux"] = dict(s=dt, s_per_step=dt / FLUX_STEPS,
                           step_device_ms=dev_ms, peak_gib=peak,
                           params=n_par)
    return shapes


def x4_full(results, gen, crop):
    """Upscaler(UNet(UNetConfig()), AutoencoderKL(VAEConfig())) from a seed
    on a crop, at the config's 50 steps and guidance 5.0; returns the flash
    shapes."""
    import torch

    from regen3d_tpu_torch import kernels
    from regen3d_tpu_torch.models import unet as un
    from regen3d_tpu_torch.models import vae as va
    from regen3d_tpu_torch.pipeline import upscale

    unet = un.UNet(un.UNetConfig()).eval()
    un.init_flax_style_(unet, gen)
    un.draw_zero_init_leaves_(unet, gen)
    vae = va.AutoencoderKL(va.VAEConfig()).eval()
    un.init_flax_style_(vae, gen)
    un.draw_zero_init_leaves_(vae, gen)
    n_par = lambda m: sum(p.numel() for p in m.parameters()) / 1e6
    spies = {"DDIM": _CallSpy(un.ddim_sample)}
    decode = vae.decode
    spies["decode"] = _CallSpy(decode)
    vae.decode = spies["decode"]
    saved = un.ddim_sample
    un.ddim_sample = spies["DDIM"]
    cfg = {"num_inference_steps": 50, "guidance_scale": 5.0, "seed": 41}
    try:
        kernels.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recording_flash_shapes() as shapes:
            out = upscale.Upscaler(unet, vae).upscale(crop, cfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        un.ddim_sample, vae.decode = saved, decode
    counts = dict(kernels.LAUNCHES)
    stages = {k: round(s.calls[0]["s"], 3) for k, s in spies.items()}
    peak = max(s.calls[0]["peak"] for s in spies.values()) / 2 ** 30
    expected = 2 * 50 * X4_UNET_LAUNCHES + 1
    h, w = crop.shape[:2]
    # one UNet forward at the DDIM's shapes: its wall and device time
    z = torch.randn((1, h // 2, w // 2, 4), generator=gen, device="cuda")
    c = torch.randn((1, h // 2, w // 2, 3), generator=gen, device="cuda")
    tt = torch.full((1,), 500.0, device="cuda")
    with torch.no_grad():
        fwd_s = _CallSpy(unet)
        for _ in range(3):
            fwd_s(z, tt, c)
        dev_ms, top, n_kern, ops = device_top(lambda: unet(z, tt, c), 6)
    fwd_ms = 1e3 * sorted(x["s"] for x in fwd_s.calls)[1]
    log(f"SD-x4 upscaler (UNetConfig() {n_par(unet):.1f} M, VAEConfig() "
        f"{n_par(vae):.1f} M params, random weights from a seed) on a "
        f"{h}x{w} crop, 50 steps, guidance 5: {dt:.2f} s; by stage (s) "
        f"{stages}; peak {peak:.2f} GiB; output {out.shape} {out.dtype}; "
        f"launches {counts} (expected {expected}); one UNet forward "
        f"{fwd_ms:.2f} ms wall, {dev_ms:.2f} ms of device time in {n_kern} "
        f"launches, top kernels {[(round(m, 2), n, k) for m, n, k in top]}, "
        f"top operators {[(round(m, 2), n, k) for m, n, k in ops]}")
    gates = []
    if out.shape != (4 * h, 4 * w, 3) or out.dtype.name != "uint8" \
            or out.std() == 0:
        gates.append(f"output {out.shape} {out.dtype}")
    if counts["flash_fwd"] != expected:
        gates.append(f"{counts['flash_fwd']} flash launches")
    if gates:
        raise AssertionError(f"SD-x4 upscaler: {gates}")
    results["x4_upscale_launches"] = counts
    results["x4_upscale"] = dict(s=dt, stages=stages, peak_gib=peak,
                                 unet_fwd_ms=fwd_ms, unet_fwd_device_ms=dev_ms)
    return shapes


def flux_upscaler_full(results, gen, crop):
    """FluxUpscaler with a ShapeDiT at DiTConfig()'s widths sized to the
    crop's tokens and SDAutoencoderKL(SDVAEConfig()), at the config's 50
    steps and guidance 5.0; returns the flash shapes."""
    import dataclasses

    import torch

    from regen3d_tpu_torch import kernels
    from regen3d_tpu_torch.models import dit, sd_unet, sd_vae
    from regen3d_tpu_torch.pipeline import upscale

    side = crop.shape[0] * 4 // 8 // 2
    dcfg = dataclasses.replace(dit.DiTConfig(), latent_tokens=side * side,
                               latent_dim=16, cond_dim=16)
    model = dit.ShapeDiT(dcfg).eval()
    dit.init_flax_style_(model, gen)
    dit.draw_zero_init_leaves_(model, gen)
    vae = sd_vae.SDAutoencoderKL(sd_vae.SDVAEConfig()).eval()
    sd_unet.init_flax_style_(vae, gen)
    cfg = {"num_inference_steps": 50, "guidance_scale": 5.0, "seed": 42}
    kernels.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording_flash_shapes() as shapes:
        out = upscale.FluxUpscaler(model, vae).upscale(crop, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    expected = 50 * 2 * dcfg.depth + 2
    log(f"FluxUpscaler (ShapeDiT at DiTConfig()'s widths, {side * side} "
        f"tokens of 16; SDVAEConfig()) on a {crop.shape[0]}² crop, 50 steps, "
        f"guidance 5: {dt:.2f} s; peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; output "
        f"{out.shape}; launches {counts} (expected {expected})")
    if out.shape != (4 * crop.shape[0], 4 * crop.shape[1], 3) \
            or counts["flash_fwd"] != expected:
        raise AssertionError("FluxUpscaler: output or launches")
    results["flux_upscale_launches"] = counts
    results["flux_upscale"] = dict(s=dt)
    return shapes


def cli_upscale(results, root):
    """run_phases(cfg, [1]) with use_banana: false on the bus's input
    (weightless: k-means, the findings, the depth prior, LANCZOS ×4 then
    512²). Returns the stems."""
    import shutil

    from regen3d_tpu_torch import kernels, orchestrator
    from regen3d_tpu_torch.artifacts import Artifacts
    from regen3d_tpu_torch.config import default_config
    from regen3d_tpu_torch.utils.image import read_png

    shutil.copy(ROOT / "build" / "bus" / "bus" / "input.png",
                root / "input.png")
    cfg = default_config(str(root / "output"),
                         input_image=str(root / "input.png"),
                         use_banana=False)
    kernels.reset_counts()
    timings = orchestrator.run_phases(cfg, [1], device="cuda")
    results["cli_upscale_launches"] = dict(kernels.LAUNCHES)
    art = Artifacts(cfg)
    stems = art.list_findings()
    up = root / "output" / "findings" / "upscaled" / "cropped"
    shapes = {p.stem: read_png(str(p))[0].shape for p in up.glob("*.png")}
    bad = phase1_finding_gates(cfg, stems)
    if sorted(shapes) != sorted(stems) or len(stems) < 4 or any(
            s != (512, 512, 3) for s in shapes.values()):
        bad.append(f"upscaled {shapes} for findings {stems}")
    log(f"-p 1 with use_banana: false through run_phases on the bus's input "
        f"(weightless): {timings[1]:.3f} s, {len(stems)} findings, "
        f"{len(shapes)} 512² upscales")
    if bad:
        raise AssertionError("-p 1 use_banana false: " + "; ".join(bad))
    results["cli_upscale_sec"] = timings[1]
    return cfg, stems


EDITOR_VERBS = [
    {"op": "new_from_box", "label": "rug", "x0": 300, "y0": 700,
     "x1": 900, "y1": 940},
    {"op": "add_point", "idx": -1, "x": 600, "y": 820, "positive": True},
    {"op": "add_point", "idx": -1, "x": 320, "y": 720, "positive": False},
    {"op": "merge", "i": 0, "j": -1},
    {"op": "resolve_overlaps"},
    {"op": "relabel", "idx": 0, "label": "sofa"},
]


def editor_full(results, sam, root):
    """phase1_segmentation.run with SAM-H and interactive_edit on a free
    editor_port: a client thread drives EDITOR_VERBS and Finish over HTTP,
    checking every reply; gated on the exported findings, two encodes (the
    detection's and the session's one) and the launches. Returns the
    flash shapes."""
    import json
    import shutil
    import socket
    import threading
    import urllib.error
    import urllib.request

    import torch

    from regen3d_tpu_torch import kernels
    from regen3d_tpu_torch.config import default_config
    from regen3d_tpu_torch.pipeline import phase1_segmentation

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    shutil.copy(ROOT / "build" / "bus" / "bus" / "input.png",
                root / "input.png")
    cfg = default_config(str(root / "output"),
                         input_image=str(root / "input.png"),
                         interactive_edit=True, editor_port=port)
    replies, n_masks = [], []

    def post(body):
        rq = urllib.request.Request(
            f"http://127.0.0.1:{port}/op", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        t = time.perf_counter()
        try:
            with urllib.request.urlopen(rq, timeout=300) as r:
                code, reply = r.status, r.read()
        except urllib.error.HTTPError as e:
            code, reply = e.code, e.read()
        replies.append((body["op"], code, json.loads(reply),
                        round(time.perf_counter() - t, 4)))

    def client():
        t_end = time.monotonic() + 300
        while True:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/state", timeout=10) as r:
                    n_masks.append(len(json.loads(r.read())["masks"]))
                break
            except OSError:
                if time.monotonic() > t_end:
                    return
                time.sleep(0.1)
        for verb in EDITOR_VERBS:
            # -1: the mask the box made
            post({k: n_masks[0] if v == -1 else v for k, v in verb.items()})
        post({"op": "finish"})

    encodes = []
    encode = sam.encode
    sam.encode = lambda img: encodes.append(1) or encode(img)
    thread = threading.Thread(target=client, daemon=True)
    thread.start()
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with recording_flash_shapes() as shapes:
            stems = phase1_segmentation.run(cfg, sam=sam)
    finally:
        sam.encode = encode
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    thread.join(timeout=60)
    counts = dict(kernels.LAUNCHES)
    decoding = sum(v["op"] in ("new_from_box", "add_point")
                   for v in EDITOR_VERBS)
    expected = SAM_DECODE_LAUNCHES * (1 + decoding)
    log(f"phase 1 run with SAM-H and interactive_edit on the bus's input: "
        f"{dt:.2f} s; {n_masks} masks at the start; replies (verb, status, "
        f"reply, s) {replies}; findings {stems}; {len(encodes)} encodes; "
        f"launches {counts} (flash expected {expected}: one decode pass of "
        f"the detections and {decoding} in the session; grid-bias 4 an "
        f"encode)")
    bad = [r for r in replies[:-1] if r[1:3] != (200, {"ok": True})]
    if not replies or replies[-1][1:3] != (200, {"done": True}) \
            or len(replies) != len(EDITOR_VERBS) + 1:
        bad.append("no finish")
    bad += phase1_finding_gates(cfg, stems)
    if not any(st.startswith("sofa") for st in stems) or len(encodes) != 2:
        bad.append(f"findings {stems}, {len(encodes)} encodes")
    if counts["flash_fwd"] != expected or counts["flash_gb_fwd"] != 8:
        bad.append(f"launches {counts}")
    if bad:
        raise AssertionError(f"phase 1 editor: {bad}")
    results["editor_launches"] = counts
    results["editor"] = dict(s=dt, replies=replies)
    return shapes


def phase_upscale_edit(results, sam):
    """Phase 1's two last switches on the card: the small checks
    (upscale_small_checks), FLUX.1-dev's transformer at FluxConfig()
    through dit.sample (flux_full), the SD-x4 upscaler at UNetConfig() and
    VAEConfig() (x4_full) and the FLUX upscaler's recipe (flux_upscaler_
    full) on crops of a bus finding, -p 1 with use_banana: false
    (cli_upscale), and phase 1's run with SAM-H behind the HTTP editor
    (editor_full); then every flash shape of those runs not held before
    against the plain version, the full-width ones timed beside SDPA."""
    import shutil

    import torch

    from regen3d_tpu_torch.artifacts import Artifacts
    from regen3d_tpu_torch.pipeline.upscale import square_pad
    from regen3d_tpu_torch.utils.image import read_png, resize_pil

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    checks = upscale_small_checks()
    log(f"upscalers and editor, card vs CPU f32 ({time.perf_counter() - t0:.1f}"
        f" s): tiny FLUX (max, mean) / max |f32| {checks['flux tiny']} (tol "
        f"{UE_MAX_ERR}/{UE_MEAN_ERR}); tiny x4 pair, uint8 levels (max, "
        f"mean) {checks['x4 tiny levels']} (tol {X4_TINY_LEVELS}); small "
        f"SAM session, the differing pixels' largest |logit| / max |logit| and their share "
        f"{checks['sam session']} (tol {UE_MAX_ERR}, 1%)")
    a, m = checks["flux tiny"]
    if a > UE_MAX_ERR or m > UE_MEAN_ERR \
            or checks["x4 tiny levels"][0] > X4_TINY_LEVELS[0] \
            or checks["x4 tiny levels"][1] > X4_TINY_LEVELS[1] \
            or checks["sam session"][0] > UE_MAX_ERR \
            or checks["sam session"][1] > 0.01:
        raise AssertionError(f"upscalers and editor on the card: {checks}")

    gen = torch.Generator(device="cuda").manual_seed(40)
    shapes = collections.Counter()
    shapes.update(flux_full(results, gen))
    torch.cuda.empty_cache()
    root = ROOT / "build" / "upscale"
    shutil.rmtree(root, ignore_errors=True)
    (root / "cli").mkdir(parents=True)
    cfg, stems = cli_upscale(results, root / "cli")
    art = Artifacts(cfg)
    finding = square_pad(read_png(f"{art.findings_cropped}/{stems[0]}.png")[0])
    crops = {n: resize_pil(finding, (n, n), "lanczos")
             for n in (X4_CROP, FLUX_UP_CROP)}
    shapes.update(x4_full(results, gen, crops[X4_CROP]))
    torch.cuda.empty_cache()
    shapes.update(flux_upscaler_full(results, gen, crops[FLUX_UP_CROP]))
    torch.cuda.empty_cache()
    (root / "editor").mkdir()
    shapes.update(editor_full(results, sam, root / "editor"))
    results["upscale_edit_checks"] = checks

    gen_t = torch.Generator(device="cuda").manual_seed(43)
    held = []
    for shape in sorted(set(shapes).difference(FLASH_SHAPES + D512_SHAPES)):
        r = fwd_case(shape, gen_t, timed=shape[2] >= 256)
        held.append(dict(shape=shape, launches=shapes[shape], err=r["err"],
                         err_lse=r["err_lse"], sdpa_err=r["sdpa_err"],
                         bound_ms=r["bound"][0], bound_by=r["bound"][1],
                         **r.get("ms", {})))
        torch.cuda.empty_cache()
    f = results["flash_fwd"]
    for r in held:
        f["max_abs_err"] = max(f["max_abs_err"], r["err"])
        f["max_abs_err_lse"] = max(f["max_abs_err_lse"], r["err_lse"])
    f["upscale_edit_shapes"] = held
    log(f"flash_fwd at the upscalers' and editor's shapes (launches "
        f"{dict(sorted(shapes.items()))}), held against the plain version "
        f"after the runs: {held}")
    log(f"phase_upscale_edit: {time.perf_counter() - t_phase:.1f} s")

# ---------------------------------------------------------------------------
# the distillation trainers (phase_distill)

# the four small runners at their scripts' defaults (full width)
DISTILL_RUNS = ("detector", "matting", "saliency", "depth")
# the shape runner at DistillConfig.small()'s widths, cut: 256 of 2048
# shapes, 100 of 3000 autoencoder and 100 of 5000 flow steps, eval on 4
# of 16 shapes
SHAPE_CUT = dict(n_shapes=256, vae_steps=100, flow_steps=100, batch=32,
                 seg=25, eval_shapes=4, eval_steps=25, eval_resolution=64)
# card (bf16 compute, f32 weights) against the CPU's f32 after one
# training step from the same weights and batch (ROADMAP Queue 3 af's
# rule): loss within 5e-2 relative; gradients and updated weights by the
# mean error over the CPU's largest |value|, 1.5e-2
DISTILL_LOSS_ERR = 5e-2
DISTILL_MEAN_ERR = 1.5e-2


@contextlib.contextmanager
def counting_flash_instances():
    """Within the block, the launches of the flash forward, dq and dkv
    wrappers by (kernel, head dim) in the yielded Counter; the wrappers are
    restored after."""
    from regen3d_tpu_torch.ops import attention as att

    counts = collections.Counter()
    saved = (att._flash_fwd, att.flash_bwd_dq, att.flash_bwd_dkv)

    def wrap(fn, name):
        def counted(q, *args):
            counts[(name, q.shape[-1])] += 1
            return fn(q, *args)
        return counted

    att._flash_fwd = wrap(saved[0], "fwd")
    att.flash_bwd_dq = wrap(saved[1], "dq")
    att.flash_bwd_dkv = wrap(saved[2], "dkv")
    try:
        yield counts
    finally:
        att._flash_fwd, att.flash_bwd_dq, att.flash_bwd_dkv = saved


def distill_child(kind, root):
    """The body of one distill run's process (distill_runs): the runner
    through the CLI's function at its script's defaults (the shape runner
    cut, SHAPE_CUT, then eval_generator on 4 held-out shapes), its launch
    counts zeroed at its start and read at its end, its spans, peak memory
    and flash launches by (kernel, D), written as root/<kind>.json. The
    detector and saliency nets are written to root/<kind>_unsaved where the
    runner refused to save them, for phase 1."""
    import numpy as np
    import torch

    from regen3d_tpu_torch import distill, kernels
    from regen3d_tpu_torch.utils import profiling

    root = Path(root)
    kernels.reset_counts()
    profiling.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with counting_flash_instances() as inst:
        if kind == "shape":
            from regen3d_tpu_torch.pipeline import shape_distill as sd

            c = SHAPE_CUT
            gen, out = sd.distill_shape(
                sd.DistillConfig.small(), n_shapes=c["n_shapes"],
                vae_steps=c["vae_steps"], flow_steps=c["flow_steps"],
                batch=c["batch"], seg=c["seg"], log_every=0)
            out["train_s"] = time.perf_counter() - t0
            out["eval"] = sd.eval_generator(
                gen, np.random.default_rng(10_000),
                n_shapes=c["eval_shapes"], num_steps=c["eval_steps"],
                resolution=c["eval_resolution"])
            out["finite"] = all(bool(torch.isfinite(p).all()) for m in (
                gen.cond, gen.dit, gen.decoder) for p in m.parameters())
        else:
            out = distill.RUNNERS[kind](distill.parse(
                [kind, "--out", str(root / kind)]))
            net = out.pop("model")
            out["losses"] = np.asarray(out["losses"]).tolist()
            out["finite"] = all(bool(torch.isfinite(p).all())
                                for p in net.parameters())
            if kind in ("detector", "saliency") and not out["saved"]:
                from regen3d_tpu_torch.pipeline import (
                    detector_distill,
                    saliency_distill,
                )

                save = (detector_distill.save_detector_checkpoint
                        if kind == "detector"
                        else saliency_distill.save_saliency_checkpoint)
                save(str(root / f"{kind}_unsaved"), net)
    torch.cuda.synchronize()
    out.update(
        wall_s=time.perf_counter() - t0,
        launches=dict(kernels.LAUNCHES),
        flash=[[k, d, n] for (k, d), n in sorted(inst.items())],
        host_spans={n: tot for n, _, tot, _ in profiling.span_summary()},
        device_spans={n: mean for n, _, _, mean in
                      profiling.device_span_summary()},
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    (root / f"{kind}.json").write_text(json.dumps(out))


def distill_runs(results, root):
    """The four small runners at their scripts' defaults and the cut shape
    runner, at once, each in a process of its own (distill_child; the
    runners are bound by the host, which one interpreter cannot share
    among them; their batches are drawn in worker processes of their own;
    the card is idle most of each step). Per runner: s a step (host spans;
    CUDA-event device spans, idle time included), the flash launches a step
    by (kernel, D) (the held-out eval's forwards included), the first- and
    last-20 mean loss, the held-out metric against the fallback (reported,
    not gated), its peak memory. Gated on falling losses and finite losses
    and weights. The launch counts are each process's over its run, summed
    into results["distill_launches"]."""
    import numpy as np

    kinds = DISTILL_RUNS + ("shape",)
    procs = {}
    t0 = time.perf_counter()
    try:
        for kind in kinds:
            code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
                    f"import chip_smoke; chip_smoke.distill_child("
                    f"{kind!r}, {str(root)!r})")
            procs[kind] = subprocess.Popen(
                [sys.executable, "-c", code], cwd=str(ROOT),
                stdout=open(root / f"{kind}.log", "w"),
                stderr=subprocess.STDOUT)
        codes = {k: p.wait(timeout=900) for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    if any(codes.values()):
        tails = {k: (root / f"{k}.log").read_text()[-1500:]
                 for k, c in codes.items() if c}
        raise AssertionError(f"distill runs failed: {codes} {tails}")
    outs = {k: json.loads((root / f"{k}.json").read_text()) for k in kinds}
    total = collections.Counter()
    for out in outs.values():
        total.update(out["launches"])
    results["distill_launches"] = dict(total)

    def per_step(out, steps):
        return {f"{k}:D{d}": round(n / steps, 2) for k, d, n in out["flash"]}

    rows = {}
    for kind in DISTILL_RUNS:
        out = outs[kind]
        host, dev = out["host_spans"], out["device_spans"]
        losses = np.asarray(out["losses"])
        steps = len(losses)
        first, last = float(losses[:20].mean()), float(losses[-20:].mean())
        rows[kind] = dict(
            steps=steps, wall_s=out["wall_s"],
            host_s_per_step=(host[f"{kind}.step"] + host[f"{kind}.data"])
            / steps, host_data_wait_s_per_step=host[f"{kind}.data"] / steps,
            device_s_per_step=dev.get(f"{kind}.step"),
            train_s=host[f"distill.{kind}.train"],
            eval_s=host[f"distill.{kind}.eval"], peak_gib=out["peak_gib"],
            flash_launches_per_step=per_step(out, steps),
            loss_first20=first, loss_last20=last, metric=out["metric"],
            net=out["net"], fallback=out["fallback"],
            beats_fallback=bool(out["beats"]), saved=bool(out["saved"]))
        log(f"distill {kind}: {rows[kind]}")
        if not (np.isfinite(losses).all() and out["finite"]):
            raise AssertionError(f"distill {kind}: a loss or weight not "
                                 f"finite")
        if not last < first:
            raise AssertionError(f"distill {kind}: the loss did not fall "
                                 f"({first:.4f} → {last:.4f})")
    out = outs["shape"]
    host, dev = out["host_spans"], out["device_spans"]
    c = SHAPE_CUT
    rows["shape"] = dict(
        cut=c, host_s_per_step={k: (host[f"{k}.step"] + host[f"{k}.data"])
                                / c[f"{k}_steps"] for k in ("vae", "flow")},
        device_s_per_step={k: dev.get(f"{k}.step") for k in ("vae", "flow")},
        flash_launches_per_step=per_step(out, c["vae_steps"]
                                         + c["flow_steps"]),
        **{k: v for k, v in out.items() if k not in (
            "launches", "flash", "host_spans", "device_spans")})
    log(f"distill shape (cut): {rows['shape']}")
    vals = [out[k] for k in ("vae_loss_final", "flow_loss_final")] + \
        list(out["eval"].values())
    if not (out["finite"] and all(np.isfinite(v) for v in vals)):
        raise AssertionError(f"distill shape: not finite {out}")
    if not (out["vae_loss_final"] < out["vae_loss_first"]
            and out["flow_loss_final"] < out["flow_loss_first"]):
        raise AssertionError(f"distill shape: a loss did not fall {out}")
    log(f"distill runs at once, five processes: {wall:.1f} s; launches "
        f"{results['distill_launches']}")
    return rows, dict(wall_s=wall)


def distill_card_vs_cpu():
    """One training step of each micro trainer on the card (bf16 compute,
    f32 weights: the trainers' layout) and on the CPU (f32), from the same
    weights and batch: the losses, every gradient and the updated weights,
    under DISTILL_LOSS_ERR and DISTILL_MEAN_ERR. The detector and saliency
    net at distill_config(32) / small_config(32) run D = 24 and 12 on the
    card, forward and backward, and the matting net at base 8 D = 8."""
    import dataclasses

    import numpy as np
    import torch

    from regen3d_tpu_torch.models import depth_anything as mda
    from regen3d_tpu_torch.models import detector as mdet
    from regen3d_tpu_torch.models import dit as mdit
    from regen3d_tpu_torch.models import saliency as msal
    from regen3d_tpu_torch.models import unet as munet
    from regen3d_tpu_torch.parallel import train as tr
    from regen3d_tpu_torch.pipeline import depth_distill as dd
    from regen3d_tpu_torch.pipeline import detector_distill as det
    from regen3d_tpu_torch.pipeline import matting as mat
    from regen3d_tpu_torch.pipeline import saliency_distill as sal
    from regen3d_tpu_torch.pipeline import shape_distill as sh
    from regen3d_tpu_torch.pipeline.phase3_assets import init_flax_style_

    f32, bf16 = torch.float32, torch.bfloat16
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(det.tokenize_bytes(det.VOCAB, 16)).long()
    micro = sh.DistillConfig.micro()

    def models(dev, dt):
        """{name: (modules, loss(modules, batch))} computing in ``dt``."""
        dcfg = dataclasses.replace(det.distill_config(32), dtype=dt)
        scfg = dataclasses.replace(sal.small_config(32), dtype=dt)
        acfg = dataclasses.replace(dd.micro_config(28), dtype=dt)
        m = micro.with_dtype(dt)
        kw = dict(device=dev, param_dtype=f32)
        return {
            # base 8: heads of 8 at the attention level, the runner's
            # --base 8 (ROADMAP Queue 3 be)
            "matting": ([munet.MattingUNet(base=8, dtype=dt, **kw)],
                        lambda ms, b: mat.matting_loss(ms[0], *b)),
            "saliency": ([msal.SaliencyTransformer(scfg, **kw)],
                         lambda ms, b: sal.saliency_loss(ms[0], *b)),
            "detector": ([mdet.OpenVocabDetector(dcfg, **kw)],
                         lambda ms, b: det.detection_loss(
                             ms[0], b[0], tokens.to(dev), *b[1:])[0]),
            "depth": ([mda.DepthAnything(acfg, **kw)],
                      lambda ms, b: dd.depth_loss(ms[0], *b)),
            "vae": ([sh.ShapeEncoder(m.vae, device=dev),
                     sh.ShapeDecoder(m.vae, device=dev)],
                    lambda ms, b: sh.vae_loss(ms[0], ms[1], *b)),
            "flow": ([m.cond_encoder(dev), mdit.ShapeDiT(m.dit, device=dev)],
                     lambda ms, b: sh.flow_loss(ms[0], ms[1], b[0], b[1],
                                                None, draws=b[2:])),
        }

    surf = rng.uniform(-1, 1, (2, 64, 3)).astype(np.float32)
    batches = {
        "matting": mat.synth_matting_batch(rng, 2, 32),
        "saliency": sal.synth_saliency_batch(rng, 2, 32),
        "detector": det.synth_detection_batch(rng, 2, 32),
        "depth": dd.synth_depth_batch(rng, 2, 28, "cpu"),
        "vae": (surf, surf[:, :32] * 1.1, rng.normal(0, 0.1, (2, 32))
                .astype(np.float32)),
        "flow": (rng.random((2, 32, 32, 4)).astype(np.float32),
                 rng.normal(size=(2, 16, 8)).astype(np.float32),
                 rng.random(2).astype(np.float32),
                 rng.normal(size=(2, 16, 8)).astype(np.float32),
                 np.asarray([False, True])),
    }
    cpu, card = models("cpu", f32), models("cuda", bf16)
    gen = torch.Generator().manual_seed(4)
    out = {}
    for name, (mods, loss_fn) in cpu.items():
        for mod in mods:
            if name == "flow" and isinstance(mod, mdit.ShapeDiT):
                mdit.init_flax_style_(mod, gen)
                mdit.draw_zero_init_leaves_(mod, gen)   # Queue 3 m
            elif name == "matting":
                munet.init_flax_style_(mod, gen)
                munet.draw_zero_init_leaves_(mod, gen)
            else:
                init_flax_style_(mod, gen)
        for a, b in zip(mods, card[name][0]):
            b.load_state_dict(a.state_dict())
        res = {}
        for dev, (ms, fn) in (("cpu", (mods, loss_fn)),
                              ("cuda", card[name])):
            batch = [torch.from_numpy(np.asarray(x)).to(dev)
                     for x in batches[name]]
            params = [p for m in ms for p in m.parameters()]
            opt = tr.OptaxAdamW(params, tr.cosine_decay_schedule(1e-3, 2),
                                b1=0.9, b2=0.95, weight_decay=1e-4)
            opt.zero_grad()
            loss = fn(ms, batch)
            loss.backward()
            grads = torch.cat([(p.grad if p.grad is not None else
                                torch.zeros_like(p)).float().reshape(-1)
                               .cpu() for p in params])
            opt.step()
            res[dev] = (float(loss.detach()), grads, torch.cat(
                [p.detach().reshape(-1).cpu() for p in params]))
        (lc, gc, pc), (lg, gg, pg) = res["cpu"], res["cuda"]
        errs = dict(loss=abs(lg - lc) / max(abs(lc), 1e-12),
                    grad_mean=float((gg - gc).abs().mean()
                                    / gc.abs().max()),
                    weight_mean=float((pg - pc).abs().mean()
                                      / pc.abs().max()))
        out[name] = errs
        if not (np.isfinite(lg) and bool(torch.isfinite(gg).all())
                and errs["loss"] <= DISTILL_LOSS_ERR
                and errs["grad_mean"] <= DISTILL_MEAN_ERR
                and errs["weight_mean"] <= DISTILL_MEAN_ERR):
            raise AssertionError(f"distill {name}: card against CPU {errs}")
    return out


def matting_base8_runner():
    """``python -m regen3d_tpu_torch.distill matting --base 8`` on the card
    (ROADMAP Queue 3 be: its heads of 8 reach the backward kernels), cut to
    one step of batch 2 at 32² and two held-out samples: the step's loss
    finite and the D = 8 backward launched; its verdict against the
    fallback is reported, not gated."""
    import tempfile

    from regen3d_tpu_torch import distill, kernels

    before = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    with recording_flash_shapes() as shapes, \
            tempfile.TemporaryDirectory(dir=ROOT / "build") as out:
        rep = distill.RUNNERS["matting"](distill.parse(
            ["matting", "--out", out, "--base", "8", "--steps", "1",
             "--batch", "2", "--size", "32", "--eval-samples", "2"]))
    dq = kernels.LAUNCHES["flash_bwd_dq"] - before["flash_bwd_dq"]
    dims = sorted({sh[-1] for sh in shapes})
    row = dict(s=round(time.perf_counter() - t0, 2),
               loss=float(rep["losses"][0]), dims=dims, bwd_dq_launches=dq,
               net=rep["net"], fallback=rep["fallback"])
    log(f"matting runner at --base 8 on the card, one step: {row}")
    if not (math.isfinite(row["loss"]) and dims == [8] and dq > 0):
        raise AssertionError(f"matting --base 8 on the card: {row}")
    return row


def phase_distill(results, sam):
    """The distillation trainers on the card (ROADMAP Queue 1 item 8):
    one training step of each micro trainer against the CPU's f32; the four
    small runners through the CLI's functions at their scripts' defaults
    (detector 600 steps at 128², matting 600 at 128² with batch 16,
    saliency 300 at 96², depth 400 at 112²) and the shape runner cut
    (SHAPE_CUT), at once in processes of their own (distill_runs), each
    gated on a falling loss
    and finite values, its beat-the-fallback verdict reported; then phase 1 from the detector and saliency
    checkpoints those runs trained (distill_config(), small_config():
    heads of 24 and 12, which the parent's kernels refused) through
    run_phases(cfg, [1]) and, for the saliency points, phase1_segmentation
    .run with SAM-H; every flash shape of those runs held against the plain
    version."""
    import shutil

    import torch

    from regen3d_tpu_torch import kernels, orchestrator
    from regen3d_tpu_torch.artifacts import Artifacts
    from regen3d_tpu_torch.config import default_config
    from regen3d_tpu_torch.pipeline import phase1_segmentation as p1

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    checks = distill_card_vs_cpu()
    log(f"distill trainers, one step card vs CPU f32 "
        f"({time.perf_counter() - t0:.1f} s; loss rel. tol "
        f"{DISTILL_LOSS_ERR}, mean/max tol {DISTILL_MEAN_ERR}): {checks}")
    checks["matting_base8_runner"] = matting_base8_runner()
    root = ROOT / "build" / "distill"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    rows, together = distill_runs(results, root)

    # phase 1 from the trained detector and saliency net, through the keys
    # (where a runner refused to save, its child wrote the net beside)
    keys = {f"{k}_checkpoint": str(root / (k if rows[k]["saved"]
                                           else f"{k}_unsaved"))
            for k in ("detector", "saliency")}
    bus_input = ROOT / "build" / "bus" / "bus" / "input.png"
    over = dict(use_points=True, point_method="saliency",
                points_per_object=1, **keys)
    shapes = collections.Counter()
    t0 = time.perf_counter()
    for threshold in (0.25, 0.1, 0.02, 0.0):
        shutil.rmtree(root / "p1", ignore_errors=True)
        cfg = default_config(str(root / "p1" / "output"),
                             input_image=str(bus_input), threshold=threshold,
                             **over)
        kernels.reset_counts()
        with recording_flash_shapes() as got:
            timings = orchestrator.run_phases(cfg, [1], device="cuda")
        results["distill_phase1_launches"] = dict(kernels.LAUNCHES)
        shapes.update(got)
        stems = Artifacts(cfg).list_findings()
        if stems:
            break
    t_cli = time.perf_counter() - t0
    cfg_sam = default_config(str(root / "p1sam" / "output"),
                             input_image=str(bus_input), threshold=threshold,
                             **over)
    kernels.reset_counts()
    with recording_flash_shapes() as got:
        t0 = time.perf_counter()
        found = p1.run(cfg_sam, sam=sam, device="cuda")
        t_sam = time.perf_counter() - t0
    results["distill_phase1_sam_launches"] = dict(kernels.LAUNCHES)
    shapes.update(got)
    dims = {s[-1] for s in shapes}
    log(f"phase 1 from the distilled checkpoints {keys} (threshold "
        f"{threshold}): run_phases(cfg, [1]) {timings} ({t_cli:.1f} s with "
        f"the thresholds tried), {len(stems)} findings; "
        f"phase1_segmentation.run with SAM-H's saliency points {t_sam:.2f} "
        f"s, {len(found)} findings; flash shapes {dict(shapes)}")
    if not {12, 24} <= dims:
        raise AssertionError(f"phase 1 from the distilled checkpoints ran "
                             f"the flash forward at head dims {dims}, not "
                             f"12 and 24")
    gen_t = torch.Generator(device="cuda").manual_seed(47)
    held = []
    for shape in sorted(set(shapes).difference(FLASH_SHAPES)):
        d = shape[-1]
        r = (padded_check(shape, gen_t, -(-d // 16) * 16)
             if d % 16 else fwd_case(shape, gen_t, timed=shape[2] >= 256))
        held.append(dict(shape=shape, launches=shapes[shape], err=r["err"],
                         err_lse=r["err_lse"], **r.get("ms", {})))
    f = results["flash_fwd"]
    for r in held:
        f["max_abs_err"] = max(f["max_abs_err"], r["err"])
        f["max_abs_err_lse"] = max(f["max_abs_err_lse"], r["err_lse"])
    f["distill_phase1_shapes"] = held
    results["distill"] = dict(card_vs_cpu=checks, runs=rows, **together,
                              phase1=dict(threshold=threshold,
                                          timings=timings, cli_s=t_cli,
                                          sam_s=t_sam, findings=len(found)))
    log(f"phase_distill: {time.perf_counter() - t_phase:.1f} s")


def fleet_check(root):
    """run_fleet over three scenes with phases [1, 2] on the card (the
    thread pool): two synthetic rooms (phase_segment's room at 240 × 320)
    and one scene whose input is missing. The good scenes must succeed and
    write their findings and phase 2's prepped images; the bad one must
    fail alone, with its missing file named and no CUDA error, and the card
    must synchronise after."""
    import os

    import torch

    from regen3d_tpu_torch.artifacts import Artifacts
    from regen3d_tpu_torch.config import default_config
    from regen3d_tpu_torch.parallel.fleet import SceneJob, run_fleet
    from regen3d_tpu_torch.utils.image import save_image

    jobs = []
    for i in range(2):
        img = _room_image(seed=i)[0][::4, ::4]
        path = root / f"scene{i}.png"
        save_image(str(path), img)
        jobs.append(SceneJob(f"s{i}", str(path), str(root / f"s{i}" /
                                                      "output")))
    jobs.insert(1, SceneJob("bad", str(root / "missing.png"),
                            str(root / "bad" / "output")))
    t0 = time.perf_counter()
    res = {r.scene_id: r for r in run_fleet(jobs, phases=[1, 2],
                                            device="cuda")}
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    written = {}
    for sid in ("s0", "s1"):
        art = Artifacts(default_config(str(root / sid / "output")))
        written[sid] = (len(art.list_findings()),
                        len(os.listdir(art.prepped_dir))
                        if os.path.isdir(art.prepped_dir) else 0)
    bad = res["bad"]
    row = dict(s=round(dt, 2), ok={k: r.ok for k, r in res.items()},
               written=written, bad_error=bad.error)
    log(f"run_fleet, 3 scenes, phases [1, 2] in its thread pool: {row}")
    if not (res["s0"].ok and res["s1"].ok and not bad.ok
            and all(n > 0 and m == n for n, m in written.values())
            and "missing.png" in (bad.error or "")
            and "CUDA" not in (bad.error or "")):
        raise AssertionError(f"run_fleet: {row}")
    return row


def phase_parallel(results):
    """The parallel layer at world size 1 (ROADMAP Queue 1 item 9): a NCCL
    process group of one rank from a file store, a (1, 1) make_mesh, and
    the dry run's four programs at full width, each bit for bit its
    unsharded run on the same inputs (parallel/dryrun's pairs): the
    DiTConfig.base() train step (phase_dit's seed-0 weights with the
    AdaLN-Zero leaves drawn, B = 8, 257 condition tokens, its fixed draws),
    fit_poses_sharded on the bus's phase-6 batch (phase_bus's 5-iteration
    fit), VGGT-1B's forward through shard_params, and scene_step over the
    mesh against phase_scene's run (the same seed-0 VGGT-1B and inputs,
    SCENE_ITERS iterations). Counts zeroed before the four sharded runs and
    read after them (parallel_launches). Then run_fleet (fleet_check)."""
    import copy
    import shutil

    import torch
    import torch.distributed as dist

    from regen3d_tpu_torch import kernels
    from regen3d_tpu_torch.models.dit import (
        DiTConfig,
        ShapeDiT,
        draw_zero_init_leaves_,
        init_flax_style_,
    )
    from regen3d_tpu_torch.models.vggt import VGGT, VGGTConfig
    from regen3d_tpu_torch.models.vggt import init_flax_style_ as vggt_init
    from regen3d_tpu_torch.parallel import dryrun
    from regen3d_tpu_torch.parallel.mesh import make_mesh, shard_params
    from regen3d_tpu_torch.pipeline.scene_step import scene_step

    t_phase = time.perf_counter()
    root = ROOT / "build" / "parallel"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{root / 'store'}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh()
        shape = (mesh.size(0), mesh.size(1))
        if shape != (1, 1) or mesh.device_type != "cuda":
            raise AssertionError(f"make_mesh at world size 1: {shape} on "
                                 f"{mesh.device_type}")
        launches = collections.Counter()
        secs = {}

        def exact(what, got, ref):
            dryrun.check_close(what, got, ref, 0, 0, True)

        # 1. the DiT-base train step
        cfg = DiTConfig.base()
        model = ShapeDiT(cfg)
        gen = torch.Generator(device="cuda").manual_seed(0)
        init_flax_style_(model, gen)
        draw_zero_init_leaves_(model, gen)
        x0 = torch.randn((8, cfg.latent_tokens, cfg.latent_dim),
                         generator=gen, device="cuda")
        cond = torch.randn((8, 257, cfg.cond_dim), generator=gen,
                           device="cuda").to(torch.bfloat16)
        fixed = _dit_draws(8, x0.shape, torch.Generator().manual_seed(7),
                           "cuda")
        kernels.reset_counts()
        ref, got, t_ref, t = dryrun.dit_step_pair(model, x0, cond, fixed,
                                                  mesh)
        dryrun.check_dit(ref, got, exact=True)
        launches.update(t.launches)
        secs["dit_step"] = t.seconds
        secs["dit_step_unsharded"] = t_ref.seconds
        n_dit = len(ref["params"])
        del model, ref, got

        # 2. the bus's fit
        init, batch, cam, short = results["bus_fit"]["args"]
        ref, got, t = dryrun.fit_pair(init, batch, cam, short, mesh)
        for name in ("translation", "yaw", "rot_aa", "log_scale"):
            exact(f"bus fit {name}", getattr(got.params, name),
                  getattr(ref.params, name))
        exact("bus fit losses", got.losses, ref.losses)
        exact("bus fit converged", got.converged, ref.converged)
        exact("bus fit against phase_bus's", got.losses,
              results["bus_fit"]["ref"].losses)
        if got.num_iters != ref.num_iters:
            raise AssertionError("bus fit: iterations differ")
        launches.update(t.launches)
        secs["fit"] = t.seconds
        del results["bus_fit"]

        # 3. VGGT-1B's forward, 4. the scene step
        vcfg = VGGTConfig()
        model = VGGT(vcfg)
        vggt_init(model, torch.Generator(device="cuda").manual_seed(0))
        model.eval()
        args = _scene_inputs(vcfg, "cuda")
        sharded = copy.deepcopy(model)
        shard_params(sharded, mesh)
        with torch.no_grad():
            with dryrun.Timed("cuda") as t_ref:
                ref = model(args[0][None])
            with dryrun.Timed("cuda") as t:
                got = sharded(args[0][None])
        for key in ("depth", "depth_conf", "pose_enc"):
            exact(f"VGGT-1B {key}", got[key], ref[key])
        launches.update(t.launches)
        secs["vggt"] = t.seconds
        secs["vggt_unsharded"] = t_ref.seconds
        del model
        # the unsharded run is phase_scene's, from the same weights and inputs
        ref = results.pop("scene_ref")
        with dryrun.Timed("cuda") as t:
            got = scene_step(sharded, *args, _scene_fit_cfg(
                vcfg.image_size, iters=SCENE_ITERS), num_points=1024,
                mesh=mesh)
        for key in ("verts_world", "losses", "depth", "points"):
            exact(f"scene step {key}", getattr(got, key), getattr(ref, key))
        launches.update(t.launches)
        secs["scene_step"] = t.seconds
        del sharded, ref, got
        torch.cuda.empty_cache()
        results["parallel_launches"] = dict(launches)
        log(f"parallel programs on a (1, 1) NCCL mesh, each bit for bit its "
            f"unsharded run: DiT-base train step ({n_dit} parameters and "
            f"their gradients, the loss), the bus fit ({short.max_iterations} "
            f"iterations, {batch.verts.shape[0]} objects), VGGT-1B's depth, "
            f"confidence and pose, scene_step_{SCENE_ITERS}it's outputs; "
            f"seconds of the sharded runs (and of two unsharded ones) "
            f"{ {k: round(v, 3) for k, v in secs.items()} }; their launches "
            f"{dict(launches)}")
        for k in ("silhouette_fwd", "silhouette_bwd", "flash_fwd",
                  "flash_bwd_dq", "flash_bwd_dkv"):
            if not launches.get(k):
                raise AssertionError(f"the parallel programs never launched "
                                     f"{k}")
    finally:
        dist.destroy_process_group()

    results["parallel"] = dict(seconds=secs, fleet=fleet_check(root))
    log(f"phase_parallel: {time.perf_counter() - t_phase:.1f} s")


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

    t_start = time.perf_counter()
    results = {}
    clock = {}

    def timed(phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        clock[phase.__name__] = round(time.perf_counter() - t0, 1)
        return out

    timed(phase_device, kernels, results)
    timed(phase_kernels, results)
    timed(phase_bwd_kernels, results)
    timed(phase_scene, results)
    timed(phase_camera, results)
    timed(phase_fit, results)
    timed(phase_bus, results)
    timed(phase_assets, results)
    timed(phase_texture, results)
    timed(phase_lpips, results)
    sam = timed(phase_sam, results)
    timed(phase_segment, results, sam)
    timed(phase_checkpoints, results, sam)
    timed(phase_upscale_edit, results, sam)
    timed(phase_distill, results, sam)
    del sam
    timed(phase_alternates, results)
    timed(phase_dit, results)
    timed(phase_sam_grad, results)
    timed(phase_parallel, results)
    log(f"seconds by phase: {clock}")

    summary = []
    for name, meta in KERNELS.items():
        r = results[name]
        launches = sum(results[path].get(name, 0) for path in MAIN_PATHS)
        if launches == 0:
            raise AssertionError(f"{name} was never launched by the main path")
        summary.append(dict(name=name, **meta, launches=launches,
                            max_abs_err=r["max_abs_err"],
                            tolerance=r["tolerance"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"],
                            library_ms=r["library_ms"],
                            **({"library": r["library"]} if "library" in r
                               else {})))
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
