"""Phase orchestrator of the port: the ``run.py -p 1..9`` CLI, in-process
(counterpart of regen3d_tpu/orchestrator.py).

Same CLI surface: ``-p/--phases``, ``-ex/--exclude``, ``--config``, the same
phase numbering and per-phase wall-clock timing; ``--device`` picks the
card (``cuda``, the default) or ``cpu``. Every phase is ported, the MIDI
and DPA baselines (10 and 11) too. Phase 1 runs weightless,
as the JAX CLI's does (no model object is loaded from a checkpoint yet):
the k-means proposer, the findings and the offline depth prior. Phase 2
runs on the host (the offline inpainter without an API key). Phase 3 loads
``checkpoints/shape_distilled.npz`` unless ``shape_checkpoint`` names
another generator. Phase 4 needs a VGGT model object (under ``Use_VGGT:
false`` a DUSt3R one), which no checkpoint reader supplies yet: called
from the CLI it raises as the JAX package's does. Phase 8 renders in
software on the device unless a ``blender`` executable is on PATH. Phases
10 and 11 run weightless, as the JAX CLI's do: the k-means proposer for
segmentation and the random-init tiny generator.
"""

from __future__ import annotations

import argparse
import logging
import time
from typing import Dict, List, Optional

from regen3d_tpu_torch.config import Config, load_config

log = logging.getLogger(__name__)


def _phase1(cfg: Config, device) -> None:
    from regen3d_tpu_torch.pipeline import phase1_segmentation
    phase1_segmentation.run(cfg, device=device)


def _phase2(cfg: Config, device) -> None:
    from regen3d_tpu_torch.pipeline import phase2_inpaint
    phase2_inpaint.run(cfg)


def _phase3(cfg: Config, device) -> None:
    from regen3d_tpu_torch.pipeline import phase3_assets
    phase3_assets.run(cfg, device=device)


def _phase4(cfg: Config, device) -> None:
    if not bool(cfg.get("Use_VGGT", True)):
        # the reference's dust3r variant (run.py:422-433): pairwise stereo
        # and global alignment instead of VGGT
        from regen3d_tpu_torch.pipeline import phase4_dust3r
        phase4_dust3r.run(cfg)
        return
    from regen3d_tpu_torch.pipeline import phase4_camera
    phase4_camera.run(cfg, device=device)


def _phase5(cfg: Config, device) -> None:
    from regen3d_tpu_torch.pipeline import phase5_extract
    phase5_extract.run(cfg, device=device)


def _phase6(cfg: Config, device) -> None:
    from regen3d_tpu_torch.pipeline import phase6_pose
    phase6_pose.run(cfg, device=device)


def _phase7(cfg: Config, device) -> None:
    from regen3d_tpu_torch.pipeline import phase7_assemble
    phase7_assemble.run(cfg, device=device)


def _phase8(cfg: Config, device) -> None:
    from regen3d_tpu_torch.pipeline import phase8_render
    phase8_render.run(cfg, device=device)


def _phase9(cfg: Config, device) -> None:
    from regen3d_tpu_torch.pipeline import phase9_eval
    phase9_eval.run(cfg, device=device)


def _phase10(cfg: Config, device) -> None:
    from regen3d_tpu_torch.pipeline import baseline_midi
    baseline_midi.run(cfg, device=device)


def _phase11(cfg: Config, device) -> None:
    from regen3d_tpu_torch.pipeline import baseline_dpa
    baseline_dpa.run(cfg, device=device)


PHASES: Dict[int, tuple] = {
    1: ("segmentation (detector + SAM → findings)", _phase1),
    2: ("generative inpainting (amodal + empty room)", _phase2),
    3: ("image → 3D assets (flow-matching DiT)", _phase3),
    4: ("camera + point cloud (VGGT)", _phase4),
    5: ("per-object cloud extraction", _phase5),
    6: ("differentiable-rendering pose fit", _phase6),
    7: ("scene assembly + background mesh + ICP", _phase7),
    8: ("rendering", _phase8),
    9: ("evaluation", _phase9),
    10: ("MIDI-3D comparison baseline", _phase10),
    11: ("DeepPriorAssembly comparison baseline", _phase11),
}


def run_phases(cfg: Config, phases: List[int],
               exclude: Optional[List[int]] = None,
               device="cuda") -> Dict[int, float]:
    """Run the selected phases in order; returns {phase: seconds}. A failing
    phase is logged and stops the pipeline (the reference's run.py:204-207)."""
    exclude = set(exclude or [])
    todo = [p for p in phases if p not in exclude]
    for p in todo:
        if p not in PHASES:
            raise ValueError(f"unknown phase {p}")
    timings: Dict[int, float] = {}
    total0 = time.time()
    for p in todo:
        name, fn = PHASES[p]
        log.info("=== phase %d: %s ===", p, name)
        t0 = time.time()
        try:
            fn(cfg, device)
        except Exception:
            log.exception("phase %d failed", p)
            raise
        timings[p] = time.time() - t0
        log.info("=== phase %d done in %.1f min ===", p, timings[p] / 60)
    log.info("pipeline total: %.1f min", (time.time() - total0) / 60)
    return timings


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="regen3d_tpu_torch pipeline (reference CLI: run.py -p 1..9)")
    ap.add_argument("-p", "--phases", type=int, nargs="+",
                    default=list(range(1, 10)))
    ap.add_argument("-ex", "--exclude", type=int, nargs="*", default=[])
    ap.add_argument("--config", default="src/config.yaml")
    ap.add_argument("--device", default="cuda",
                    help="torch device the phases run on (cuda or cpu)")
    args = ap.parse_args(argv)

    cfg = load_config(args.config)
    logging.basicConfig(
        level=getattr(logging, str(cfg.get("logging", "INFO")).upper(), 20),
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    phases = args.phases
    if phases == list(range(1, 10)):
        # baseline flags swap the default flow (reference run.py:468-482);
        # an explicit -p always wins
        if bool(cfg.get("Use_MIDI", False)):
            phases = [10, 7, 9]
        elif bool(cfg.get("Use_DPA", False)):
            phases = [11]
    run_phases(cfg, phases, args.exclude, device=args.device)
