"""The distillation runners (counterparts of the JAX package's
scripts/distill_{shape,depth,detector,saliency,matting}.py), one command:

    python -m regen3d_tpu_torch.distill detector --out ckpt/detector
    python -m regen3d_tpu_torch.distill matting  --out ckpt/matting
    python -m regen3d_tpu_torch.distill saliency --out ckpt/saliency
    python -m regen3d_tpu_torch.distill depth    --out ckpt/depth
    python -m regen3d_tpu_torch.distill shape    --out checkpoints/shape_distilled.npz

Each trains on its synthetic teacher with the script's flags and defaults
(``--device cpu`` off the card, where the scripts take ``--cpu``), holds
the net against its weightless fallback on held-out scenes drawn from
``seed + 10000``, and refuses to save (exit 1) unless the net wins:

* detector: box recall at IoU 0.5 against the k-means proposer;
* matting: IoU against the white threshold;
* saliency: MAE against the centre prior;
* depth: scale/shift-invariant RMSE against the luminance prior;
* shape: Chamfer against the random-init generator (by 0.02), and the
  shuffled-condition Chamfer above the matched one; ``--force`` saves
  anyway.

The first four write the port's checkpoint directory with the JAX
writers' ``config.json`` sidecar (``detector_checkpoint``,
``matting_checkpoint``, ``saliency_checkpoint`` and
``depth_anything_checkpoint`` read it); shape writes the ``.npz`` that
``shape_checkpoint`` reads. The stages are timed through
``utils/profiling.timed`` and summarised at the end.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from regen3d_tpu_torch.utils import profiling

log = logging.getLogger(__name__)


def _device(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu off the card)")


def _common(ap: argparse.ArgumentParser, steps: int, batch: int, size: int,
            lr: float, eval_samples: int, size_help: str = "") -> None:
    _device(ap)
    ap.add_argument("--out", required=True, help="checkpoint directory")
    ap.add_argument("--steps", type=int, default=steps)
    ap.add_argument("--batch", type=int, default=batch)
    ap.add_argument("--size", type=int, default=size, help=size_help or None)
    ap.add_argument("--lr", type=float, default=lr)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-samples", type=int, default=eval_samples)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m regen3d_tpu_torch.distill",
        description="Train a distilled model and save it if it beats its "
                    "weightless fallback.")
    sub = ap.add_subparsers(dest="kind", required=True)
    _common(sub.add_parser("depth"), 400, 8, 112, 1e-3, 16,
            "train/eval resolution (multiple of 14)")
    _common(sub.add_parser("detector"), 600, 8, 128, 2e-3, 16)
    m = sub.add_parser("matting")
    _common(m, 600, 16, 128, 2e-3, 32)
    m.add_argument("--base", type=int, default=32)
    _common(sub.add_parser("saliency"), 300, 8, 96, 1e-3, 16)
    s = sub.add_parser("shape")
    _device(s)
    s.add_argument("--out", default="checkpoints/shape_distilled.npz")
    s.add_argument("--preset", choices=["small", "micro"], default="small")
    s.add_argument("--shapes", type=int, default=2048)
    s.add_argument("--vae-steps", type=int, default=3000)
    s.add_argument("--flow-steps", type=int, default=5000)
    s.add_argument("--batch", type=int, default=32)
    s.add_argument("--lr", type=float, default=1e-3)
    s.add_argument("--seg", type=int, default=25,
                   help="train steps per segment of host-drawn batches")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--eval-shapes", type=int, default=16)
    s.add_argument("--eval-steps", type=int, default=25)
    s.add_argument("--eval-resolution", type=int, default=64)
    s.add_argument("--force", action="store_true",
                   help="save even if the eval gates fail")
    return ap


def parse(argv: List[str]) -> argparse.Namespace:
    return parser().parse_args(argv)


def _held_out(args) -> np.random.Generator:
    return np.random.default_rng(args.seed + 10_000)


def run_detector(args) -> Dict:
    from regen3d_tpu_torch.pipeline.detector_distill import (
        VOCAB,
        box_recall,
        distill_config,
        distill_detector,
        save_detector_checkpoint,
        synth_detection_batch,
    )
    from regen3d_tpu_torch.pipeline.phase1_segmentation import (
        cluster_proposals,
    )

    with profiling.timed("distill.detector.train"):
        model, losses = distill_detector(
            distill_config(args.size), steps=args.steps, batch=args.batch,
            lr=args.lr, seed=args.seed, device=args.device)
    with profiling.timed("distill.detector.eval"):
        imgs, boxes, _, valid = synth_detection_batch(
            _held_out(args), args.eval_samples, args.size)
        net_r, cluster_r = [], []
        for i in range(args.eval_samples):
            img_u8 = (imgs[i] * 255).astype(np.uint8)
            gt = []
            for m in range(boxes.shape[1]):
                if valid[i, m]:
                    cx, cy, w, h = boxes[i, m]
                    gt.append([(cx - w / 2) * args.size,
                               (cy - h / 2) * args.size,
                               (cx + w / 2) * args.size,
                               (cy + h / 2) * args.size])
            gt = np.asarray(gt)
            net_r.append(box_recall(model.detect(img_u8, VOCAB,
                                                 threshold=0.25), gt))
            cluster_r.append(box_recall(
                cluster_proposals(img_u8, device=args.device), gt))
    n, c = float(np.mean(net_r)), float(np.mean(cluster_r))
    print(f"held-out box recall@0.5: net {n:.3f} vs clustering {c:.3f}")
    return _gate(args, "detector", "box recall@0.5", n, c, n > c, losses,
                 lambda: save_detector_checkpoint(args.out, model),
                 "detector_checkpoint", model)


def run_matting(args) -> Dict:
    from regen3d_tpu_torch.pipeline.matting import (
        MattingModel,
        distill_matting,
        iou,
        synth_matting_batch,
        threshold_alpha,
    )

    with profiling.timed("distill.matting.train"):
        model, losses = distill_matting(
            steps=args.steps, batch=args.batch, size=args.size,
            base=args.base, lr=args.lr, seed=args.seed, device=args.device)
    m = MattingModel(model, eval_size=args.size)
    with profiling.timed("distill.matting.eval"):
        imgs, alphas = synth_matting_batch(_held_out(args),
                                           args.eval_samples, args.size)
        net = float(np.mean([iou(m.alpha(im), a[..., 0])
                             for im, a in zip(imgs, alphas)]))
        thr = float(np.mean([iou(threshold_alpha(im)[..., 0], a[..., 0])
                             for im, a in zip(imgs, alphas)]))
    print(f"held-out IoU: net {net:.4f} vs threshold {thr:.4f}")
    return _gate(args, "matting", "IoU", net, thr, net > thr, losses,
                 lambda: m.save(args.out), "matting_checkpoint", model)


@torch.no_grad()
def _maps(model, imgs: np.ndarray, device) -> List[np.ndarray]:
    return [model(torch.from_numpy(im[None]).to(device))[0].float().cpu()
            .numpy() for im in imgs]


def run_saliency(args) -> Dict:
    from regen3d_tpu_torch.pipeline.saliency_distill import (
        center_prior,
        distill_saliency,
        mae,
        save_saliency_checkpoint,
        small_config,
        synth_saliency_batch,
    )

    with profiling.timed("distill.saliency.train"):
        model, losses = distill_saliency(
            small_config(args.size), steps=args.steps, batch=args.batch,
            lr=args.lr, seed=args.seed, device=args.device)
    with profiling.timed("distill.saliency.eval"):
        imgs, gts = synth_saliency_batch(_held_out(args), args.eval_samples,
                                         args.size)
        prior = center_prior(args.size)
        preds = _maps(model, imgs, args.device)
        n = float(np.mean([mae(p, g) for p, g in zip(preds, gts)]))
        p = float(np.mean([mae(prior, g) for g in gts]))
    print(f"held-out MAE: net {n:.4f} vs center prior {p:.4f}")
    return _gate(args, "saliency", "MAE", n, p, n < p, losses,
                 lambda: save_saliency_checkpoint(args.out, model),
                 "saliency_checkpoint", model)


def run_depth(args) -> Dict:
    from regen3d_tpu_torch.pipeline.depth_distill import (
        distill_depth,
        luminance_prior,
        micro_config,
        save_depth_checkpoint,
        ssi_rmse,
        synth_depth_batch,
    )

    with profiling.timed("distill.depth.train"):
        model, losses = distill_depth(
            micro_config(args.size), steps=args.steps, batch=args.batch,
            lr=args.lr, seed=args.seed, device=args.device)
    with profiling.timed("distill.depth.eval"):
        imgs, disps = synth_depth_batch(_held_out(args), args.eval_samples,
                                        args.size, args.device)
        preds = _maps(model, imgs, args.device)
        net = float(np.mean([ssi_rmse(p, g) for p, g in zip(preds, disps)]))
        prior = float(np.mean([ssi_rmse(luminance_prior(im), g)
                               for im, g in zip(imgs, disps)]))
    print(f"held-out SSI-RMSE: net {net:.4f} vs luminance prior {prior:.4f}")
    return _gate(args, "depth", "SSI-RMSE", net, prior, net < prior, losses,
                 lambda: save_depth_checkpoint(args.out, model),
                 "depth_anything_checkpoint", model)


def run_shape(args) -> Dict:
    from regen3d_tpu_torch.pipeline.phase3_assets import AssetGenerator
    from regen3d_tpu_torch.pipeline.shape_distill import (
        DistillConfig,
        distill_shape,
        eval_generator,
        generator_params,
        save_generator,
    )

    cfg = (DistillConfig.small() if args.preset == "small"
           else DistillConfig.micro())
    t0 = time.time()
    with profiling.timed("distill.shape.train"):
        gen, report = distill_shape(
            cfg, n_shapes=args.shapes, vae_steps=args.vae_steps,
            flow_steps=args.flow_steps, batch=args.batch, lr=args.lr,
            seed=args.seed, seg=args.seg, device=args.device)
    report["train_wall_s"] = round(time.time() - t0, 1)
    with profiling.timed("distill.shape.eval"):
        ev = eval_generator(gen, _held_out(args), n_shapes=args.eval_shapes,
                            num_steps=args.eval_steps,
                            resolution=args.eval_resolution)
        baseline = AssetGenerator.random_init(
            torch.Generator(args.device).manual_seed(args.seed),
            tiny=(args.preset == "micro"), device=args.device)
        ev_base = eval_generator(baseline, _held_out(args),
                                 n_shapes=args.eval_shapes,
                                 num_steps=args.eval_steps,
                                 resolution=args.eval_resolution,
                                 image_size=cfg.image_size)
    report.update({f"trained_{k}": round(v, 4) for k, v in ev.items()})
    report.update({f"random_{k}": round(v, 4) for k, v in ev_base.items()})
    print(json.dumps(report, indent=2))
    wins = ev["chamfer"] < ev_base["chamfer"] - 0.02
    conditions = ev["chamfer"] < ev["chamfer_shuffled"] - 1e-3
    if not wins:
        print(f"REFUSING to save: trained chamfer {ev['chamfer']:.4f} does "
              f"not beat random-init {ev_base['chamfer']:.4f}")
    if not conditions:
        print(f"WARNING: shuffled-condition chamfer "
              f"{ev['chamfer_shuffled']:.4f} <= matched {ev['chamfer']:.4f} "
              "— conditioning carries no signal")
    saved = (wins and conditions) or args.force
    if saved:
        with profiling.timed("distill.shape.save"):
            save_generator(args.out, cfg, generator_params(gen))
        sz = os.path.getsize(args.out) / 1e6
        print(f"saved {args.out} ({sz:.1f} MB)")
    return dict(kind="shape", metric="chamfer", net=ev["chamfer"],
                fallback=ev_base["chamfer"], beats=wins and conditions,
                saved=saved, report=report, model=gen)


def _gate(args, kind, metric, net, fallback, beats, losses, save, key,
          model) -> Dict:
    """Save through ``save`` when the net ``beats`` its fallback; the
    report either way."""
    if beats:
        with profiling.timed(f"distill.{kind}.save"):
            save()
        print(f"saved {kind} checkpoint → {args.out} "
              f"(wire via {key}: {args.out})")
    else:
        print(f"trained {kind} net does NOT beat its fallback — not saving",
              file=sys.stderr)
    return dict(kind=kind, metric=metric, net=net, fallback=fallback,
                beats=beats, saved=beats, losses=losses, model=model)


RUNNERS = {"shape": run_shape, "depth": run_depth, "detector": run_detector,
           "saliency": run_saliency, "matting": run_matting}


def main(argv: Optional[List[str]] = None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    logging.basicConfig(level=logging.INFO)
    profiling.reset()
    out = RUNNERS[args.kind](args)
    profiling.log_summary()
    return 0 if out["saved"] else 1


if __name__ == "__main__":
    sys.exit(main())
