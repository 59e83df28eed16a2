"""Checkpoint conversion CLI: upstream torch checkpoints → the port's
checkpoint directory (counterpart of scripts/convert_weights.py, which
writes orbax).

    python -m regen3d_tpu_torch.convert_weights sam  sam_vit_h_4b8939.pth out/sam
    python -m regen3d_tpu_torch.convert_weights vggt model.pt out/vggt --verify
    python -m regen3d_tpu_torch.convert_weights --selftest

Rule tables live in regen3d_tpu_torch/models/conversion.py (one per family,
each with a zero-checkpoint self-test proving the table covers the port's
module leaf for leaf). ``--verify`` builds the family's module at full
size on the ``meta`` device (shapes only, nothing allocated) and checks
every converted tensor's shape before saving. A conversion that leaves
more than ``--max-unmapped`` of the checkpoint's tensors unmapped refuses
to save. The output directory loads with ``models.weights.load_model`` or
through the config keys of phases 1, 2 and 9.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from regen3d_tpu_torch.models import conversion
from regen3d_tpu_torch.models.from_jax import tree_from_model
from regen3d_tpu_torch.models.weights import (
    convert_state_dict,
    load_torch_file,
    save_checkpoint,
    verify_tree_shapes,
)


def full_model(family: str):
    """The family's port module at its full (released) size on ``meta``."""
    dev = "meta"
    if family == "lpips":
        from regen3d_tpu_torch.models.lpips import LPIPS
        return LPIPS(device=dev)
    if family == "sam":
        from regen3d_tpu_torch.models.sam import SAM, SamConfig
        return SAM(SamConfig(), device=dev)
    if family == "vggt":
        from regen3d_tpu_torch.models.vggt import VGGT, VGGTConfig
        return VGGT(VGGTConfig(), device=dev)
    if family == "dust3r":
        from regen3d_tpu_torch.models.dust3r import (
            AsymmetricCroCo3DStereo,
            Dust3rConfig,
        )
        return AsymmetricCroCo3DStereo(Dust3rConfig(), device=dev)
    if family in ("dit", "midi"):
        from regen3d_tpu_torch.models.dit import DiTConfig, ShapeDiT
        return ShapeDiT(dataclasses.replace(
            DiTConfig.base(), cross_instance=family == "midi"), device=dev)
    if family == "shapevae":
        from regen3d_tpu_torch.models.shapevae import ShapeVAEConfig
        return conversion.shapevae_module(ShapeVAEConfig(), device=dev)
    if family == "depth_anything":
        from regen3d_tpu_torch.models.depth_anything import (
            DepthAnything,
            DepthAnythingConfig,
        )
        return DepthAnything(DepthAnythingConfig.small(), device=dev)
    raise SystemExit(f"no full-size module wired for {family} "
                     f"({conversion.FAMILIES[family].status})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m regen3d_tpu_torch.convert_weights",
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("family", nargs="?", choices=sorted(conversion.FAMILIES))
    ap.add_argument("checkpoint", nargs="?")
    ap.add_argument("out_dir", nargs="?")
    ap.add_argument("--verify", action="store_true",
                    help="build the full-size module on meta and check "
                         "shapes")
    ap.add_argument("--max-unmapped", type=float, default=0.02,
                    help="refuse to save if more than this fraction of "
                         "checkpoint tensors is unmapped")
    ap.add_argument("--selftest", action="store_true",
                    help="run the zero-checkpoint rule-table round trips")
    args = ap.parse_args(argv)

    if args.selftest:
        failed = False
        for fam in sorted(conversion.FAMILIES):
            status = conversion.FAMILIES[fam].status
            errs = conversion.selftest(fam)
            verdict = ("waiting for ROADMAP Queue 1 item 5"
                       if status == "pending" else
                       "OK" if not errs else errs[:5])
            print(f"{fam:14s} [{status:11s}]: {verdict}")
            failed |= bool(errs)
        return 1 if failed else 0

    if not (args.family and args.checkpoint and args.out_dir):
        ap.error("family, checkpoint and out_dir are required "
                 "(or use --selftest)")

    state = load_torch_file(args.checkpoint)
    print(f"loaded {len(state)} tensors from {args.checkpoint}")
    rules = conversion.FAMILIES[args.family].rules()

    unmapped: list = []
    tree = convert_state_dict(state, rules, unmapped_out=unmapped)
    frac = len(unmapped) / max(len(state), 1)
    if frac > args.max_unmapped:
        print(f"REFUSING to save: {len(unmapped)}/{len(state)} "
              f"({frac:.1%}) of checkpoint tensors unmapped — the rule "
              f"table does not fit this checkpoint (see "
              f"regen3d_tpu_torch/models/conversion.py '{args.family}').")
        return 1

    if args.verify:
        fam = conversion.FAMILIES[args.family]
        ref = tree_from_model(full_model(args.family), fam.conv_transpose)
        errors = verify_tree_shapes(tree, ref)
        if errors:
            print(f"{len(errors)} mismatches (first 20):")
            for e in errors[:20]:
                print(" ", e)
            return 1
        print("shape verification OK")

    save_checkpoint(args.out_dir, tree)
    print(f"saved → {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
