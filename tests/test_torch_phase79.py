"""Phases 7 and 9 of the port against the JAX package on one synthetic bus
at 96 × 128 (written with the port's writers): camera.npz, two fitted GLBs
and their phase-5 clouds, the empty room's cloud (raw VGGT frame) and
image, PLANE_SAMPLED.ply, a GT scene (the objects at slightly other poses,
the floor and the back wall), the input image and a rendered image of
another size (phase 9's LANCZOS path). Small knobs: 2048 samples, a 32³
Poisson grid, 30 ICP iterations. Each package runs on its own copy.

Both packages sample the GLBs with one numpy sampler (their
``glb_to_point_cloud`` patched; the JAX package draws with
``jax.random``, which torch cannot reproduce, tests/test_torch_eval_ops.py
holds the samplers themselves). Tolerances: the combined GLB and the
backprojected PLY identical; ground_aligned.glb within a Chamfer distance
of 1e-3 of a Poisson cell, its baked colours within 1e-4 at matching
vertices; pred/gt points and the ICP transform within 1e-5; phase 9's
metrics the same keys, within 1e-5 relative.

The last test runs ``python -m regen3d_tpu_torch -p 5 6 7 9 --device cpu``
on tests/test_torch_phase56.py's bus.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from scipy.spatial import cKDTree

from regen3d_tpu import config as jconfig
from regen3d_tpu.pipeline import phase7_assemble as jphase7
from regen3d_tpu.pipeline import phase9_eval as jphase9
from regen3d_tpu_torch import orchestrator
from regen3d_tpu_torch.artifacts import Artifacts, finding_stem
from regen3d_tpu_torch.camera import save_camera_npz
from regen3d_tpu_torch.config import default_config
from regen3d_tpu_torch.pipeline import phase7_assemble as tphase7
from regen3d_tpu_torch.pipeline import phase9_eval as tphase9
from regen3d_tpu_torch.transforms.conventions import p3d_to_blender
from regen3d_tpu_torch.utils.glb import MeshData, SceneData, load_glb, save_glb
from regen3d_tpu_torch.ops import metrics as tmetrics
from regen3d_tpu_torch.utils.image import (
    load_image_rgb,
    read_png,
    resize_pil,
    save_image,
)
from regen3d_tpu_torch.utils.ply import load_ply, save_ply
from test_torch_package import one_torch_thread  # noqa: F401
from test_torch_phase56 import _chair, _frame, _place, _surface, write_bus

H, W = 96, 128
FOCAL = 110.0
FLOOR_Y = -0.5
SMALL = dict(num_samples=2048, background_poisson_resolution=32,
             icp_max_iterations=30, vggt_scene_scale=1.0)
ROOT = Path(__file__).resolve().parent.parent


def _quad(y=None, z=None, n=12):
    """A floor (y fixed) or back-wall (z fixed) grid mesh."""
    a, b = np.meshgrid(np.linspace(-2.0, 2.0, n), np.linspace(0.0, 1.0, n),
                       indexing="ij")
    if y is not None:
        v = np.stack([a, np.full_like(a, y), 1.5 + 3.5 * b], -1)
    else:
        v = np.stack([a, FLOOR_Y + 2.5 * b, np.full_like(a, z)], -1)
    q = np.arange(n * n).reshape(n, n)
    f = np.concatenate([np.stack([q[:-1, :-1], q[1:, :-1], q[1:, 1:]], -1),
                        np.stack([q[:-1, :-1], q[1:, 1:], q[:-1, 1:]], -1)])
    return v.reshape(-1, 3).astype(np.float32), f.reshape(-1, 3).astype(np.int32)


def _room_png(path, rng, hw, alpha=False):
    """A smooth room-like image (walls, floor band, two boxes)."""
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w] / np.asarray([h, w])[:, None, None]
    img = np.stack([0.6 + 0.2 * xx, 0.55 + 0.1 * yy, 0.5 + 0.2 * xx * yy], -1)
    img[yy > 0.7] = (0.35, 0.3, 0.25)
    img[(yy > 0.4) & (yy < 0.8) & (xx > 0.55) & (xx < 0.8)] = (0.7, 0.2, 0.2)
    img = (img * 255 + rng.normal(size=img.shape) * 3).clip(0, 255)
    img = img.astype(np.uint8)
    if alpha:
        a = np.full((h, w, 1), 255, np.uint8)
        a[: h // 8] = 128
        img = np.concatenate([img, a], -1)
    save_image(path, img)


def write_bus79(root):
    """Phase 7's and 9's inputs under root/output and root/tmp; returns the
    path of the GT scene."""
    rng = np.random.default_rng(0)
    cfg = default_config(str(root / "output"))
    art = Artifacts(cfg)
    save_camera_npz(art.camera_npz, p3d_to_blender(np.eye(3), np.zeros(3)),
                    FOCAL, (W, H))
    chair = dict(center=np.asarray([0.25, -0.25, 2.6]), yaw=0.5)
    frame = dict(center=np.asarray([-0.35, 0.45, 3.2]), yaw=-0.2)
    objs = {finding_stem("chair", (70, 60)): (*_chair(), chair),
            finding_stem("picture", (40, 30)): (*_frame(), frame)}
    gt = []
    for k, (stem, (v, f, pose)) in enumerate(objs.items()):
        # the fitted pose a few cm and degrees off the truth
        off = dict(center=pose["center"] + [0.03, -0.02, 0.04],
                   yaw=pose["yaw"] + 0.05)
        save_glb(art.fitted_glb(stem), SceneData(meshes=[MeshData(
            name=stem, vertices=_place(v, off).astype(np.float32), faces=f,
            base_color=np.asarray([0.5, 0.4, 0.3, 1.0]))]))
        cloud = _place(_surface(v, f, 800, rng), pose)
        save_ply(os.path.join(art.pointclouds_dir, f"{stem}.ply"),
                 cloud.astype(np.float32))
        gt.append(MeshData(name=f"gt_{k}",
                           vertices=_place(v, pose).astype(np.float32),
                           faces=f))
    for name, (v, f) in (("floor", _quad(y=FLOOR_Y)), ("wall", _quad(z=5.0))):
        gt.append(MeshData(name=name, vertices=v, faces=f))
    gt_path = str(root / "gt_scene.glb")
    save_glb(gt_path, SceneData(meshes=gt))
    # the empty room: floor and back wall, 3 mm of noise, raw VGGT frame
    n = 1200
    fx, fz = rng.uniform(-2, 2, n), rng.uniform(1.5, 5.0, n)
    wx, wy = rng.uniform(-2, 2, n), rng.uniform(FLOOR_Y, 2.0, n)
    room = np.concatenate([np.stack([fx, np.full(n, FLOOR_Y), fz], -1),
                           np.stack([wx, wy, np.full(n, 5.0)], -1)])
    room += rng.normal(size=room.shape) * 0.003
    save_ply(art.points_empty_ply, (room * [1, -1, -1]).astype(np.float32))
    # the fitted floor plane's samples, 4 cm above the cloud's floor
    gx, gz = np.meshgrid(np.linspace(-2, 2, 30), np.linspace(1.5, 5, 30))
    plane = np.stack([gx.ravel(), np.full(gx.size, FLOOR_Y + 0.04),
                      gz.ravel()], -1)
    save_ply(os.path.join(art.temp, "debug", "PLANE_SAMPLED.ply"),
             plane.astype(np.float32))
    os.makedirs(os.path.dirname(art.empty_room), exist_ok=True)
    # the empty room at half size: the bake's z-buffer tests every pixel
    # against every face
    _room_png(art.empty_room, rng, (H // 2, W // 2), alpha=True)
    _room_png(str(root / "input.png"), rng, (H, W))
    _room_png(art.predicted_image, rng, (72, 100))
    return gt_path


def _numpy_sampler(path, num_samples, seed=0, device=None):
    """One area-weighted surface sampler for both packages."""
    paths = [path] if isinstance(path, str) else list(path)
    meshes = [m for p in paths for m in load_glb(p).meshes]
    v = np.concatenate([m.vertices for m in meshes]).astype(np.float64)
    offs = np.cumsum([0] + [len(m.vertices) for m in meshes[:-1]])
    f = np.concatenate([m.faces + o for m, o in zip(meshes, offs)])
    rng = np.random.default_rng(seed)
    tri = v[f]
    area = np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0],
                                   tri[:, 2] - tri[:, 0]), axis=-1)
    fi = rng.choice(len(f), num_samples, p=area / area.sum())
    w = rng.dirichlet(np.ones(3), num_samples)
    return (tri[fi] * w[..., None]).sum(1).astype(np.float32)


def _art(root):
    return Artifacts(default_config(str(root / "output")))


def _cfgs(jr, tr, gt_path, **over):
    kw = dict(SMALL, GT_scene=gt_path, **over)
    return (jconfig.default_config(str(jr / "output"),
                                   input_image=str(jr / "input.png"), **kw),
            default_config(str(tr / "output"),
                           input_image=str(tr / "input.png"), **kw))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Phases 7 and 9 of both packages, each on its own copy of the bus.
    Phase 9 of both reads the port's background mesh (the JAX package's
    is kept as jax_ground_aligned.glb for the phase-7 test): the
    scene-incl-background metrics sample it, and the two packages' Poisson
    solves differ in f32 rounding."""
    base = tmp_path_factory.mktemp("p79")
    bus = base / "bus"
    bus.mkdir()
    gt_path = write_bus79(bus)
    jr, tr = base / "jax", base / "port"
    shutil.copytree(bus, jr)
    shutil.copytree(bus, tr)
    jcfg, tcfg = _cfgs(jr, tr, gt_path)
    mp = pytest.MonkeyPatch()
    mp.setattr(jphase7, "glb_to_point_cloud", _numpy_sampler)
    mp.setattr(tphase7, "glb_to_point_cloud", _numpy_sampler)
    try:
        sj = jphase7.run(jcfg)
        st = tphase7.run(tcfg, device="cpu")
        shutil.copyfile(_art(jr).ground_aligned_glb, jr / "jax_ground_aligned.glb")
        shutil.copyfile(_art(tr).ground_aligned_glb, _art(jr).ground_aligned_glb)
        mj = jphase9.run(jcfg)
        mt = tphase9.run(tcfg, device="cpu")
    finally:
        mp.undo()
    return jr, tr, (sj, st), (mj, mt)


def test_phase7_combine_and_backproject_identical(runs):
    jr, tr, _stats, _m = runs
    aj, at = _art(jr), _art(tr)
    for name in ("combined_scene_glb", "combined_scene_bp_ply"):
        pj, pt = Path(getattr(aj, name)), Path(getattr(at, name))
        assert pj.exists() and pt.exists(), name
        assert pt.read_bytes() == pj.read_bytes(), name
    meshes = load_glb(at.combined_scene_glb).meshes
    assert len(meshes) == 2 and {m.metallic for m in meshes} == {0.2}


def test_phase7_background_mesh_matches_jax(runs):
    jr, tr, _stats, _m = runs
    (mj,) = load_glb(str(jr / "jax_ground_aligned.glb")).meshes
    (mt,) = load_glb(_art(tr).ground_aligned_glb).meshes
    assert len(mt.faces) > 100 and mt.vertex_colors is not None
    assert abs(len(mt.faces) - len(mj.faces)) <= 0.01 * len(mj.faces)
    # the Poisson cell: the room's largest extent × 1.2 over 31 cells
    pts = load_ply(_art(tr).points_empty_ply).vertices
    cell = float(np.ptp(pts, 0).max()) * 1.2 / 31
    d_tj, i_tj = cKDTree(mj.vertices).query(mt.vertices)
    d_jt, _ = cKDTree(mt.vertices).query(mj.vertices)
    assert 0.5 * (d_tj.mean() + d_jt.mean()) <= 1e-3 * cell
    # colours at the vertices both packages placed at the same spot
    near = d_tj <= 1e-4 * cell
    assert near.mean() > 0.95
    np.testing.assert_allclose(mt.vertex_colors[near],
                               mj.vertex_colors[i_tj[near]], atol=1e-4)
    # the ground was matched: the floor band moved up by about 4 cm
    low = mt.vertices[:, 1] <= np.quantile(mt.vertices[:, 1], 0.05)
    assert abs(float(np.median(mt.vertices[low, 1])) - (FLOOR_Y + 0.04)) < 0.05


def test_phase7_alignment_matches_jax(runs):
    jr, tr, (sj, st), _m = runs
    assert sorted(st) == sorted(sj) == ["icp_iters", "icp_rmse"]
    assert st["icp_rmse"] == pytest.approx(sj["icp_rmse"], rel=1e-5)
    aj, at = _art(jr), _art(tr)
    for name in ("pred_points_ply", "gt_points_ply"):
        pj = load_ply(getattr(aj, name)).vertices
        pt = load_ply(getattr(at, name)).vertices
        assert pt.shape == pj.shape == (2048, 3)
        np.testing.assert_allclose(pt, pj, atol=1e-5)
    xj, xt = (np.load(os.path.join(os.path.dirname(a.pred_points_ply),
                                   "icp_transform.npz")) for a in (aj, at))
    assert sorted(xt.files) == sorted(xj.files) == ["R", "rmse", "s", "t"]
    for k in xj.files:
        np.testing.assert_allclose(xt[k], xj[k], atol=1e-5)
    for name in ("albedo_map", "roughness_map", "metallic_map", "normal_map"):
        pj = jr / "output" / "findings" / "scene_marigold" / f"{name}.png"
        pt = tr / "output" / "findings" / "scene_marigold" / f"{name}.png"
        np.testing.assert_array_equal(read_png(str(pt))[0],
                                      read_png(str(pj))[0])


def test_phase9_metrics_match_jax(runs):
    jr, tr, _stats, (mj, mt) = runs
    assert sorted(mt) == sorted(mj)
    assert {"psnr", "ssim", "chamfer_pcu", "wasserstein",
            "scene_chamfer_incl_bg", "scene_fscore_incl_bg",
            "scene_icp_rmse_incl_bg"} <= set(mt)
    assert len(mt) == 15
    for k in mj:
        assert np.isfinite(mt[k]), k
        # SSIM's variances are differences of f32 window sums (E[x²] −
        # E[x]²); on this bus's smooth images the local variance is ~1e-3 of
        # E[x]², so each package's SSIM is off an f64 evaluation by 1-4e-5
        # (ROADMAP Queue 3 x): 1e-4 there, 1e-5 for every other key
        rel = 1e-4 if k == "ssim" else 1e-5
        assert mt[k] == pytest.approx(mj[k], rel=rel, abs=1e-9), k
    p, r = (load_image_rgb(str(path), None)
            for path in (_art(tr).predicted_image, tr / "input.png"))
    p64, r64 = (torch.from_numpy(x / 255.0)
                for x in (resize_pil(p, r.shape[:2], "lanczos"), r))
    ssim64 = float(tmetrics.ssim(p64, r64))
    for m in (mt, mj):
        assert m["ssim"] == pytest.approx(ssim64, rel=1e-4)
    (run,) = os.listdir(tr / "output" / "evaluation")
    d = tr / "output" / "evaluation" / run
    assert sorted(os.listdir(d)) == ["config.yaml", "metrics.csv",
                                     "metrics.json"]
    with open(d / "config.yaml") as f:
        assert yaml.safe_load(f)["num_samples"] == 2048


def test_phase9_lpips_fn_and_checkpoint(runs, tmp_path, caplog,
                                        monkeypatch):
    """An ``lpips_fn`` adds the lpips key. ``lpips_checkpoint`` naming the
    orbax directory the JAX package's ``save_checkpoint`` wrote (drawn
    AlexNet and heads) gives the value the JAX package's LPIPS gives on the
    same two images, within 1e-5 (both f32), and the port's own directory
    of the same weights the same value bit for bit; a missing path is
    logged and leaves the key out, as in the JAX package; with tensorstore
    hidden the orbax directory is refused, naming it."""
    import jax
    import jax.numpy as jnp

    from regen3d_tpu.models.lpips import LPIPS as JLPIPS, make_lpips_fn
    from regen3d_tpu.models.weights import save_checkpoint as jsave
    from regen3d_tpu_torch.models.lpips import LPIPS
    from regen3d_tpu_torch.models.weights import load_model, save_model

    _jr, tr, _stats, _m = runs
    work = tmp_path / "port"
    shutil.copytree(tr, work)
    cfg = default_config(str(work / "output"), input_image=str(work / "input.png"),
                         eval_scene_incl_background=False, **SMALL)
    m = tphase9.run(cfg, lpips_fn=lambda a, b: torch.tensor(0.25),
                    device="cpu")
    assert m["lpips"] == 0.25 and "scene_fscore_incl_bg" not in m

    rng = np.random.default_rng(21)
    params = jax.tree_util.tree_map_with_path(
        lambda k, s: np.abs(rng.normal(size=s.shape)).astype(np.float32)
        * (0.1 if str(k[1].key).startswith("lin") else 0.05),
        jax.eval_shape(JLPIPS().init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 32, 32, 3))))
    ckpt = str(tmp_path / "lpips_orbax")
    jsave(ckpt, params)
    m = tphase9.run(cfg.with_overrides(lpips_checkpoint=ckpt), device="cpu")
    p, r = (load_image_rgb(str(path), None)
            for path in (_art(work).predicted_image, work / "input.png"))
    p = resize_pil(p, r.shape[:2], "lanczos")
    want = float(make_lpips_fn(params)(jnp.asarray(p / 255.0, jnp.float32),
                                       jnp.asarray(r / 255.0, jnp.float32)))
    assert want > 0 and m["lpips"] == pytest.approx(want, rel=1e-5)
    own = str(tmp_path / "lpips_own")
    save_model(own, load_model(LPIPS(device="cpu"), ckpt))
    m2 = tphase9.run(cfg.with_overrides(lpips_checkpoint=own), device="cpu")
    assert m2["lpips"] == m["lpips"]
    m3 = tphase9.run(cfg.with_overrides(lpips_checkpoint="lpips_ckpt"),
                     device="cpu")
    assert "lpips" not in m3 and "lpips_checkpoint" in caplog.text
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="tensorstore"):
        tphase9.run(cfg.with_overrides(lpips_checkpoint=ckpt), device="cpu")


def test_cli_runs_phases_5_6_7_9(tmp_path):
    """``python -m regen3d_tpu_torch -p 5 6 7 9 --device cpu`` on the
    phase-5/6 bus with a GT scene, an empty room and images added."""
    work = tmp_path / "cli"
    work.mkdir()
    stems = write_bus(work)
    extra = tmp_path / "extra"
    extra.mkdir()
    gt_path = write_bus79(extra)
    art = Artifacts(default_config(str(work / "output")))
    art_x = Artifacts(default_config(str(extra / "output")))
    for src, dst in ((art_x.empty_room, art.empty_room),
                     (extra / "input.png", work / "input.png"),
                     (art_x.predicted_image, art.predicted_image)):
        os.makedirs(os.path.dirname(str(dst)), exist_ok=True)
        shutil.copyfile(src, dst)
    (work / "src").mkdir()
    values = dict(SMALL, output="../output", input_image="../input.png",
                  GT_scene=gt_path, image_size_DR=64, max_iterations=2,
                  early_stop_min_iterations=2, write_fit_gifs=False,
                  fit_max_faces=32, fit_max_points=256, shard_pose_fit=False,
                  mask_shrink_pixels=1, mask_shrink_iterations=1,
                  grid_rotation_steps=4)
    (work / "src" / "cfg.yaml").write_text(yaml.safe_dump(values))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-m", "regen3d_tpu_torch", "-p", "5", "6", "7", "9",
         "--config", str(work / "src" / "cfg.yaml"), "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    o = work / "output"
    for stem in (stems["chair"], stems["picture"]):
        assert (o / "glb" / f"{stem}.glb").exists()
    assert len(load_glb(art.combined_scene_glb).meshes) == 2
    (bg,) = load_glb(art.ground_aligned_glb).meshes
    assert len(bg.faces) > 0 and bg.vertex_colors is not None
    for path in (art.pred_points_ply, art.gt_points_ply):
        assert load_ply(path).vertices.shape == (2048, 3)
    (run,) = os.listdir(o / "evaluation")
    import json
    metrics = json.loads((o / "evaluation" / run / "metrics.json").read_text())
    assert {"chamfer_pcu", "fscore", "psnr", "ssim",
            "scene_chamfer_incl_bg"} <= set(metrics)
    assert all(np.isfinite(v) for v in metrics.values())
    # a phase the orchestrator does not know is refused before anything
    # runs
    before = os.path.getmtime(art.combined_scene_glb)
    with pytest.raises(ValueError, match="unknown phase 12"):
        orchestrator.run_phases(default_config(str(o)), [7, 12], device="cpu")
    assert os.path.getmtime(art.combined_scene_glb) == before
