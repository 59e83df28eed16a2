"""The multi-rank dry run (counterpart of ``__graft_entry__.dryrun_multichip``):
four programs over a (dp, tp) mesh, each held against its unsharded run.

1. the DiT's training step over dp × tp (parameters placed by
   ``mesh.shard_params``, the batch over 'dp', AdamW on every rank's
   shards);
2. the pose fit with its object axis over 'dp' (``fit_poses_sharded``) at
   b = dp + 1 objects (JAX's size) and at b = 3, both padded to a
   multiple of dp (but at dp = 1, 3);
3. the VGGT forward on parameters split over 'tp' (the fused qkv placed
   head-blocked);
4. the fused scene step (phases 4→6): the tp VGGT, the fit's objects over
   'dp'.

At JAX's sizes (the DiT at width 256, depth 2, 8 heads; the VGGT at
28², width 64, 4 heads) and with JAX's bounds: in f32 the sharded VGGT's
depth and pose encoding within rtol 1e-4, atol 1e-5 of the unsharded
forward's, the scene step's depth the same and its posed vertices within
rtol 1e-3, atol 5e-3 (the fit amplifies the depth's rounding), the fit's
losses within rtol 1e-4 and translations within rtol 1e-3; the DiT step's
loss and gradients within 1e-5 of max |·|, its parameters after the update
within 2·lr (a gradient at rounding level may flip its sign) and within
1e-6 where |g| > 1e-4·max |g|. At world size 1 every program must equal its
unsharded run bit for bit. The card runs the models in bf16 (the flash
kernels take bf16 only), where no bound for several ranks has been read
yet: on the card the dry run runs at world size 1 and refuses more ranks.

Run:

    python -m regen3d_tpu_torch.parallel.dryrun N --device cpu [--out DIR]

spawns N gloo ranks on the meshes ``make_mesh`` gives N (``--tp`` to
choose), or under ``torchrun --nproc-per-node N -m
regen3d_tpu_torch.parallel.dryrun --device cpu``; ``python -m
regen3d_tpu_torch.parallel.dryrun 1`` runs one NCCL rank on the card. Each
rank runs :func:`run_rank`; rank 0 writes each program's arrays to
``<out>/<dp>x<tp>_<program>.npz`` where ``--out`` is given. :func:`spawn`'s
``fixtures`` names a directory whose ``vggt.pt`` and ``dit.pt`` (state
dicts) and ``dit_batch.npz`` (x0, cond, t, eps, drop) replace the seeded
weights and batch (the tests hold the ranks against JAX on them).
"""

from __future__ import annotations

import argparse
import copy
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from regen3d_tpu_torch import kernels

LR = 1e-4                     # make_optimizer's default, the bound's unit


def dit_config(dtype):
    from regen3d_tpu_torch.models.dit import DiTConfig

    return DiTConfig(latent_tokens=16, latent_dim=8, width=256, depth=2,
                     num_heads=8, cond_dim=64, dtype=dtype)


def vggt_config(dtype):
    from regen3d_tpu_torch.models.vggt import VGGTConfig

    return VGGTConfig(image_size=28, patch=14, width=64, depth=2,
                      num_heads=4, backbone_depth=1, num_register_tokens=1,
                      camera_iterations=1, camera_trunk_depth=1, dtype=dtype)


def pose_problem(b: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """JAX's dry-run fit problem (``_dryrun_pose_fit``): b objects of 8
    vertices and 8 faces, a 32² target mask of 0.5, 16 target points."""
    rng = np.random.default_rng(seed)
    return dict(verts=rng.uniform(-0.2, 0.2, (b, 8, 3)).astype(np.float32),
                faces=rng.integers(0, 8, (b, 8, 3)).astype(np.int32),
                points=rng.uniform(-1, 1, (b, 16, 3)).astype(np.float32))


def scene_problem(k: int, s: int = 28, seed: int = 0
                  ) -> Dict[str, np.ndarray]:
    """JAX's dry-run scene step inputs (``_dryrun_scene_step``): two black
    frames, k 6 × 6 object masks, meshes of 8 vertices and 12 faces."""
    rng = np.random.default_rng(seed)
    masks = np.zeros((k, s, s), bool)
    for i in range(k):
        y, x = 2 + 3 * (i % 4), 2 + 3 * (i // 4)
        masks[i, y:y + 6, x:x + 6] = True
    return dict(images=np.zeros((2, s, s, 3), np.float32), masks=masks,
                verts=rng.uniform(-0.2, 0.2, (k, 8, 3)).astype(np.float32),
                faces=rng.integers(0, 8, (k, 12, 3)).astype(np.int32))


def vggt_images(seed: int = 7) -> np.ndarray:
    """(1, 2, 28, 28, 3) uniform frames for the VGGT program."""
    return np.random.default_rng(seed).random((1, 2, 28, 28, 3)).astype(
        np.float32)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _launches(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in kernels.LAUNCHES.items()
            if v != before[k]}


class Timed:
    """Seconds (the device synchronised) and kernel launches of a run."""

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        _sync(self.device)
        self.before, self.t0 = dict(kernels.LAUNCHES), time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync(self.device)
        self.seconds = time.perf_counter() - self.t0
        self.launches = _launches(self.before)


# ---------------------------------------------------------------------------
# the four programs, each as (unsharded run, sharded run) on the same inputs


def dit_step_pair(model, x0, cond, draws, mesh, lr: float = LR):
    """One training step of ``model`` unsharded and of a copy placed on
    ``mesh``, from the same weights, batch and draws. Returns (ref, got,
    ref_timing, timing): ref and got each {'loss', 'grads': {name: …},
    'params': {name: …}} whole, on every rank."""
    from regen3d_tpu_torch.parallel.mesh import full_state_dict, shard_params
    from regen3d_tpu_torch.parallel.train import (
        make_optimizer,
        train_step,
        train_step_sharded,
    )

    sharded = copy.deepcopy(model)
    opt = make_optimizer(model.parameters(), lr)
    with Timed(x0.device) as t_ref:
        loss = train_step(model, opt, x0, cond, None, draws=draws)
    ref = dict(loss=loss, params={n: p.detach() for n, p in
                                  model.named_parameters()},
               grads={n: p.grad for n, p in model.named_parameters()})
    plan = shard_params(sharded, mesh)
    opt = make_optimizer(sharded.parameters(), lr)
    with Timed(x0.device) as t:
        loss = train_step_sharded(sharded, opt, x0, cond, None, mesh,
                                  draws=draws)
    got = dict(loss=loss, params=full_state_dict(sharded, plan, mesh),
               grads=full_state_dict(sharded, plan, mesh, grads=True))
    return ref, got, t_ref, t


def fit_pair(init, batch, cam, cfg, mesh):
    """``fit_poses`` and ``fit_poses_sharded`` on the same problem."""
    from regen3d_tpu_torch.pipeline.pose_fit import fit_poses, fit_poses_sharded

    ref = fit_poses(init, batch, cam, cfg)
    with Timed(batch.verts.device) as t:
        got = fit_poses_sharded(init, batch, cam, cfg, mesh)
    return ref, got, t


def vggt_pair(model, images, mesh):
    """The forward of ``model`` and of a copy placed on ``mesh``."""
    from regen3d_tpu_torch.parallel.mesh import shard_params

    sharded = copy.deepcopy(model)
    shard_params(sharded, mesh)
    with torch.no_grad():
        ref = model(images)
        with Timed(images.device) as t:
            got = sharded(images)
    return ref, got, t


def scene_step_pair(model, args, fit_cfg, mesh, num_points: int):
    """``scene_step`` of ``model`` on one device and of a copy placed on
    ``mesh`` with the objects over 'dp'."""
    from regen3d_tpu_torch.parallel.mesh import shard_params
    from regen3d_tpu_torch.pipeline.scene_step import scene_step

    sharded = copy.deepcopy(model)
    shard_params(sharded, mesh)
    ref = scene_step(model, *args, fit_cfg, num_points=num_points)
    with Timed(args[0].device) as t:
        got = scene_step(sharded, *args, fit_cfg, num_points=num_points,
                         mesh=mesh)
    return ref, got, t


# ---------------------------------------------------------------------------
# comparisons


def _np(x) -> np.ndarray:
    return x.detach().float().cpu().numpy()


def check_close(what: str, got, ref, rtol: float, atol: float,
                exact: bool) -> float:
    """Raise unless ``got`` is ``ref`` bit for bit (``exact``) or within
    rtol·|ref| + atol elementwise; returns the largest difference."""
    g, r = _np(got), _np(ref)
    if g.shape != r.shape:
        raise AssertionError(f"{what}: shape {g.shape} != {r.shape}")
    diff = float(np.abs(g - r).max()) if g.size else 0.0
    if exact:
        if not torch.equal(got.detach().cpu(), ref.detach().cpu()):
            raise AssertionError(f"{what}: not bit for bit the unsharded run "
                                 f"(max difference {diff:.3e})")
    elif not np.all(np.abs(g - r) <= rtol * np.abs(r) + atol):
        raise AssertionError(f"{what}: max difference {diff:.3e} over rtol "
                             f"{rtol:g}, atol {atol:g}")
    return diff


def check_dit(ref, got, exact: bool, lr: float = LR) -> Dict[str, float]:
    """The DiT step's bounds (the module docstring; f32 where not
    ``exact``); returns the largest error of each kind over max |·|."""
    rel = 1e-5
    out = dict(loss=abs(float(got["loss"]) - float(ref["loss"]))
               / max(abs(float(ref["loss"])), 1e-30))
    if exact:
        for kind in ("grads", "params"):
            for n, r in ref[kind].items():
                check_close(f"DiT step {kind} {n}", got[kind][n], r, 0, 0,
                            True)
        check_close("DiT step loss", got["loss"], ref["loss"], 0, 0, True)
        return dict(loss=0.0, grads=0.0, params=0.0)
    if out["loss"] > rel:
        raise AssertionError(f"DiT step loss {float(got['loss'])} against "
                             f"{float(ref['loss'])}")
    out["grads"] = out["params"] = 0.0
    for n, r in ref["grads"].items():
        r, g = _np(r), _np(got["grads"][n])
        scale = max(float(np.abs(r).max()), 1e-30)
        e = float(np.abs(g - r).max()) / scale
        out["grads"] = max(out["grads"], e)
        if e > rel:
            raise AssertionError(f"DiT step gradient {n}: {e:.3e} of max|g|")
        p, q = _np(ref["params"][n]), _np(got["params"][n])
        d = np.abs(q - p)
        out["params"] = max(out["params"], float(d.max()))
        moved = np.abs(r) > 1e-4 * scale
        if d.max() > 2 * lr or (moved.any() and d[moved].max() > 1e-6):
            raise AssertionError(f"DiT step parameter {n}: {d.max():.3e} "
                                 f"(2·lr {2 * lr:g}), where |g| > 1e-4·max "
                                 f"{d[moved].max() if moved.any() else 0:.3e}")
    return out


# ---------------------------------------------------------------------------
# a rank of the dry run


def _fixture(fixtures: Optional[str], name: str) -> Optional[str]:
    """The path of ``name`` in the fixtures directory, where it is."""
    path = os.path.join(fixtures, name) if fixtures else None
    return path if path and os.path.exists(path) else None


def _dit_program(mesh, dev, dtype, exact, fixtures, log):
    from regen3d_tpu_torch.models.dit import (
        ShapeDiT,
        draw_zero_init_leaves_,
        init_flax_style_,
    )

    cfg = dit_config(dtype)
    model = ShapeDiT(cfg, device="cpu")
    weights = _fixture(fixtures, "dit.pt")
    if weights:
        model.load_state_dict(torch.load(weights, map_location="cpu"))
    else:
        gen = torch.Generator().manual_seed(0)
        init_flax_style_(model, gen)
        draw_zero_init_leaves_(model, gen)     # gradients reach every leaf
    model.to(dev)
    dp = mesh.size(mesh.mesh_dim_names.index("dp"))
    batch = _fixture(fixtures, "dit_batch.npz")
    if batch:
        a = dict(np.load(batch))
    else:
        rng, b = np.random.default_rng(1), 2 * dp
        a = dict(x0=rng.standard_normal((b, cfg.latent_tokens,
                                         cfg.latent_dim)),
                 cond=rng.standard_normal((b, 16, cfg.cond_dim)))
        a.update(t=rng.random(b), eps=rng.standard_normal(a["x0"].shape),
                 drop=np.arange(b) % 3 == 0)
    t = lambda k: torch.from_numpy(a[k].astype(np.float32)).to(dev)
    x0, cond, b = t("x0"), t("cond").to(dtype), len(a["x0"])
    draws = (t("t"), t("eps"), torch.from_numpy(a["drop"]).to(dev))
    ref, got, tm_ref, tm = dit_step_pair(model, x0, cond, draws, mesh)
    errs = check_dit(ref, got, exact)
    log(f"dryrun DiT train step OK: B={b}, loss {float(got['loss']):.5f} "
        f"({tm.seconds:.2f} s, the unsharded step {tm_ref.seconds:.2f} s); "
        f"errors against the unsharded step {errs}")
    return {"dit": dict(
        loss=_np(got["loss"]), ref_loss=_np(ref["loss"]),
        **{f"grad/{n}": _np(g) for n, g in got["grads"].items()},
        **{f"ref_grad/{n}": _np(g) for n, g in ref["grads"].items()},
        **{f"param/{n}": _np(p) for n, p in got["params"].items()},
        **{f"ref_param/{n}": _np(p) for n, p in ref["params"].items()})}


def _pose_fit_program(mesh, dev, b, exact, log):
    from regen3d_tpu_torch.camera import lookat_camera
    from regen3d_tpu_torch.pipeline.pose_fit import (
        FitConfig,
        ObjectBatch,
        PoseParams,
    )

    h = 32
    pr = pose_problem(b)
    t = lambda a: torch.from_numpy(a).to(dev)
    ones = lambda *s: torch.ones(*s, dtype=torch.bool, device=dev)
    batch = ObjectBatch(
        verts=t(pr["verts"]), verts_mask=ones(b, 8), faces=t(pr["faces"]),
        faces_mask=ones(b, 8), target_mask=torch.full((b, h, h), 0.5,
                                                      device=dev),
        target_points=t(pr["points"]), points_mask=ones(b, 16),
        pivot_R=torch.eye(3, device=dev).expand(b, 3, 3),
        pivot_t=torch.zeros(b, 3, device=dev), on_floor=~ones(b),
        object_valid=ones(b), bbox_lo=torch.full((3,), -2.0, device=dev),
        bbox_hi=torch.full((3,), 2.0, device=dev))
    cam = lookat_camera([0, 0, -3.0], [0, 0, 0], (h, h), focal_px=40.0,
                        device=dev)
    cfg = FitConfig(image_hw=(h, h), max_iterations=3,
                    early_stop_min_iters=0, record_history=False,
                    face_chunk=8, point_chunk=16)
    ref, got, tm = fit_pair(PoseParams.zeros(b, device=dev), batch, cam, cfg,
                            mesh)
    check_close("sharded fit losses", got.losses, ref.losses, 1e-4, 1e-5,
                exact)
    check_close("sharded fit translations", got.params.translation,
                ref.params.translation, 1e-3, 1e-5, exact)
    if got.num_iters != ref.num_iters:
        raise AssertionError(f"sharded fit ran {got.num_iters} iterations, "
                             f"the unsharded {ref.num_iters}")
    log(f"dryrun pose fit OK: {b} objects, {got.num_iters} iterations "
        f"({tm.seconds:.2f} s)")
    return {f"pose_fit_b{b}": dict(
        losses=_np(got.losses), num_iters=np.asarray(got.num_iters),
        **{k: _np(v) for k, v in got.params._asdict().items()})}


def _vggt_programs(mesh, dev, dtype, exact, fixtures, log):
    """The tp VGGT forward and the scene step, on one VGGT."""
    from regen3d_tpu_torch.models import vggt
    from regen3d_tpu_torch.pipeline.pose_fit import FitConfig

    model = vggt.VGGT(vggt_config(dtype), device="cpu")
    weights = _fixture(fixtures, "vggt.pt")
    if weights:
        model.load_state_dict(torch.load(weights, map_location="cpu"))
    else:
        vggt.init_flax_style_(model, torch.Generator().manual_seed(0))
    model.to(dev)
    ref, got, tm = vggt_pair(model, torch.from_numpy(vggt_images()).to(dev),
                             mesh)
    for key in ("depth", "pose_enc"):
        check_close(f"tp VGGT {key}", got[key], ref[key], 1e-4, 1e-5, exact)
    log(f"dryrun VGGT OK: forward == one device's (depth "
        f"{tuple(got['depth'].shape)}, {tm.seconds:.2f} s)")
    out = {"vggt": {key: _np(v) for key, v in got.items()}}

    k = 2 * mesh.size(mesh.mesh_dim_names.index("dp"))
    sp = scene_problem(k)
    t = lambda a: torch.from_numpy(a).to(dev)
    args = (t(sp["images"]), t(sp["masks"]), t(sp["verts"]),
            torch.ones(k, 8, dtype=torch.bool, device=dev), t(sp["faces"]),
            torch.ones(k, 12, dtype=torch.bool, device=dev))
    cfg = FitConfig(image_hw=(28, 28), sigma=1e-4, max_iterations=2,
                    early_stop_min_iters=2, record_history=False,
                    face_chunk=8, point_chunk=16)
    ref, got, tm = scene_step_pair(model, args, cfg, mesh, 16)
    check_close("scene step depth", got.depth, ref.depth, 1e-4, 1e-5, exact)
    check_close("scene step verts", got.verts_world, ref.verts_world,
                1e-3, 5e-3, exact)
    log(f"dryrun scene step OK: {k} objects ({tm.seconds:.2f} s)")
    out["scene_step"] = dict(depth=_np(got.depth),
                             verts_world=_np(got.verts_world),
                             losses=_np(got.losses))
    return out


def run_programs(mesh, device, dtype, fixtures: Optional[str] = None,
                 log=print) -> Dict[str, Dict[str, np.ndarray]]:
    """The dry run's programs on ``mesh``; raises where a program leaves its
    bound, and for several ranks in another dtype than f32 (no bound read).
    Returns each program's arrays (whole, on every rank), the fit's as
    ``pose_fit_b<b>``."""
    names = mesh.mesh_dim_names
    dp, tp = (mesh.size(names.index(a)) for a in ("dp", "tp"))
    exact = dp * tp == 1
    if not exact and dtype != torch.float32:
        raise NotImplementedError(_UNREAD)
    dev = torch.device(device)
    log(f"dryrun mesh dp={dp} tp={tp} on {dev.type}, {dtype}")
    out = _dit_program(mesh, dev, dtype, exact, fixtures, log)
    for b in sorted({dp + 1, 3}):
        out.update(_pose_fit_program(mesh, dev, b, exact, log))
    out.update(_vggt_programs(mesh, dev, dtype, exact, fixtures, log))
    return out


_UNREAD = ("dryrun: several ranks in bf16 (the card) have no error bound "
           "read from a run yet; run one rank on the card, or N ranks with "
           "--device cpu (f32)")


def _join(rank: int, world: int, init_file: Optional[str], device) -> bool:
    """Join the process group (NCCL on the rank's card, else gloo with
    one thread) through the file store ``init_file``, or torchrun's
    environment where it is None. Returns whether the rank is on a card."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(1)
    backend = "nccl" if cuda else "gloo"
    if init_file is None:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                rank=rank, world_size=world)
    return cuda


def run_rank(rank: int, world: int, init_file: Optional[str],
             device: str = "cpu", out_dir: Optional[str] = None,
             tps: Sequence[Optional[int]] = (None,),
             fixtures: Optional[str] = None) -> None:
    """One rank of the dry run: join the process group (the file store
    ``init_file``, or torchrun's environment where it is None), run the
    programs on a mesh for each tp in ``tps`` (None: make_mesh's default),
    write rank 0's arrays under ``out_dir``, leave the group."""
    from regen3d_tpu_torch.parallel.mesh import make_mesh, mesh_shape

    cuda = _join(rank, world, init_file, device)
    try:
        dtype = torch.bfloat16 if cuda else torch.float32
        log = print if rank == 0 else (lambda *a: None)
        for tp in tps:
            mesh = make_mesh(tp=tp)
            dp, tpn = mesh.size(0), mesh.size(1)
            res = run_programs(mesh, device, dtype, fixtures, log)
            if out_dir and rank == 0:
                for name, arrays in res.items():
                    np.savez(os.path.join(out_dir, f"{dp}x{tpn}_{name}.npz"),
                             **arrays)
        log(f"dryrun OK: {world} ranks, meshes "
            f"{[mesh_shape(world, tp) for tp in tps]}: the DiT train "
            f"step, the dp-sharded pose fit, the tp-sharded VGGT forward and "
            f"the fused scene step, each against its unsharded run")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def fleet_rank(rank: int, world: int, init_file: str, jobs, phases,
               base_overrides: Optional[dict] = None,
               device: str = "cpu") -> None:
    """One rank of ``run_fleet`` over a process group (the file store
    ``init_file``): it runs its round-robin share of ``jobs`` and raises if
    any of them failed."""
    from regen3d_tpu_torch.parallel.fleet import run_fleet

    _join(rank, world, init_file, device)
    try:
        bad = [r for r in run_fleet(jobs, phases, base_overrides=base_overrides,
                                    device=device) if not r.ok]
        if bad:
            raise RuntimeError(f"fleet rank {rank}: {bad}")
    finally:
        dist.destroy_process_group()


def spawn_ranks(target, n: int, args: tuple = (),
                timeout: float = 600.0) -> None:
    """Run ``target(rank, n, init_file, *args)`` in ``n`` spawned processes
    joined by a file store; raises if any rank fails or outlives
    ``timeout`` seconds (the others are then ended)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "store")
        procs = [ctx.Process(target=target, args=(r, n, init_file, *args))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.0))
        finally:
            alive = [p for p in procs if p.is_alive()]
            for p in alive:
                p.kill()
                p.join()
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if alive or bad:
        raise RuntimeError(f"{target.__name__}: ranks {bad} failed"
                           + (f", {len(alive)} ended at the {timeout:.0f}-s "
                              f"limit" if alive else ""))


def spawn(n: int, device: str = "cpu", out_dir: Optional[str] = None,
          tps: Sequence[Optional[int]] = (None,),
          fixtures: Optional[str] = None, timeout: float = 600.0) -> None:
    """The dry run (:func:`run_rank`) on ``n`` spawned ranks."""
    spawn_ranks(run_rank, n, (device, out_dir, tuple(tps), fixtures),
                timeout)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m regen3d_tpu_torch.parallel.dryrun",
        description="Run the four multi-rank programs, each against its "
                    "unsharded run.")
    ap.add_argument("n", type=int, nargs="?", default=None,
                    help="ranks to spawn (under torchrun: omit)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, one rank on the card) or cpu (gloo)")
    ap.add_argument("--tp", type=int, action="append", default=None,
                    help="tp degree of a mesh (repeat for several meshes; "
                         "default make_mesh's)")
    ap.add_argument("--out", default=None,
                    help="directory for rank 0's arrays")
    args = ap.parse_args(argv)
    tps = tuple(args.tp) if args.tp else (None,)
    world = args.n if args.n is not None else int(os.environ["WORLD_SIZE"])
    if torch.device(args.device).type == "cuda" and world > 1:
        raise SystemExit(_UNREAD)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    if args.n is None:
        run_rank(int(os.environ["RANK"]), world, None, args.device,
                 args.out, tps)
    else:
        spawn(args.n, args.device, args.out, tps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
