"""Port fit_poses vs the JAX package on a fixed 2-object batch, on each
rasterizer path, with the path both sides took asserted: params, per-object
losses, iteration count, convergence and history. f32 on both sides.

Two tolerances, for a stated reason. Where the silhouette and its target
disagree at a saturated pixel (alpha a few f32 ulps from the 1e-7 clip
bound), the focal/BCE gradient ~1/alpha turns the rounding of 1 − exp(acc)
into percent-level gradient noise that no two summation orders share, and
Adam's first step moves every component by lr·sign(g). So the full loss is
held to one Adam step: params atol lr = 5e-3, losses rtol 2e-3. With the
silhouette term weighted 0 the same machinery (Adam, clip and freeze gates,
history, stop rule, object groups) is held to atol 1e-6. The rasterizer
gradients themselves are held tightly in test_torch_silhouette.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regen3d_tpu.camera import Camera as JCamera
from regen3d_tpu.pipeline import pose_fit as jpf
from regen3d_tpu_torch.camera import Camera
from regen3d_tpu_torch.pipeline import pose_fit as tpf
from test_torch_package import one_torch_thread  # noqa: F401

IMG = 64


def _batch_np(seed=0, b=2, nv=32, nf=64, n_pts=64):
    rng = np.random.default_rng(seed)
    verts = rng.normal(size=(b, nv, 3)).astype(np.float32) * 0.2
    # three distinct corners per face: a face with a repeated vertex has a
    # discontinuous point distance, where one ulp flips the region
    faces = np.stack([[rng.choice(nv, 3, replace=False) for _ in range(nf)]
                      for _ in range(b)]).astype(np.int32)
    mask = np.zeros((b, IMG, IMG), np.float32)
    mask[:, 16:48, 16:48] = 1.0
    pts = rng.normal(size=(b, n_pts, 3)).astype(np.float32) * 0.2
    pts[..., 2] += 2.5
    fmask = np.ones((b, nf), bool)
    fmask[1, -5:] = False
    return dict(
        verts=verts, verts_mask=np.ones((b, nv), bool), faces=faces,
        faces_mask=fmask, target_mask=mask, target_points=pts,
        points_mask=np.ones((b, n_pts), bool),
        pivot_R=np.tile(np.eye(3, dtype=np.float32)[None], (b, 1, 1)),
        pivot_t=np.zeros((b, 3), np.float32),
        on_floor=np.asarray([False, True]), object_valid=np.ones(b, bool),
        bbox_lo=np.asarray([-10.0, -10.0, 0.0], np.float32),
        bbox_hi=np.asarray([10.0, 10.0, 10.0], np.float32))


def _init_np(b=2):
    t = np.tile(np.asarray([[0.0, 0.0, 2.5]], np.float32), (b, 1))
    return dict(translation=t, yaw=np.asarray([0.0, 0.05], np.float32),
                rot_aa=np.zeros((b, 3), np.float32),
                log_scale=np.zeros(b, np.float32))


def _run_both(cfg_kwargs, seed=0):
    bn, pn = _batch_np(seed), _init_np()
    jcfg = jpf.FitConfig(**cfg_kwargs)
    tcfg = tpf.FitConfig(**cfg_kwargs)
    jcam = JCamera(R=jnp.eye(3), T=jnp.zeros(3), focal=jnp.asarray([64.0, 64.0]),
                   principal=jnp.asarray([32.0, 32.0]), image_size=(IMG, IMG))
    tcam = Camera(R=torch.eye(3), T=torch.zeros(3),
                  focal=torch.tensor([64.0, 64.0]),
                  principal=torch.tensor([32.0, 32.0]), image_size=(IMG, IMG))
    rj = jpf.fit_poses(jpf.PoseParams(**{k: jnp.asarray(v) for k, v in pn.items()}),
                       jpf.ObjectBatch(**{k: jnp.asarray(v) for k, v in bn.items()}),
                       jcam, jcfg)
    rt = tpf.fit_poses(tpf.PoseParams(**{k: torch.from_numpy(v) for k, v in pn.items()}),
                       tpf.ObjectBatch(**{k: torch.from_numpy(v) for k, v in bn.items()}),
                       tcam, tcfg)
    n_faces = bn["faces"].shape[1]
    jax_path = ("streaming" if not (jcfg.use_edge_raster
                                    and jpf._binned_budget_ok(jcfg, n_faces))
                else "edge_kernel" if jpf._use_pallas(jcfg) else "edge")
    return rj, rt, jax_path, tpf.raster_path(tcfg, n_faces, "cpu")


BASE = dict(image_hw=(IMG, IMG), sigma=1e-4, max_iterations=4,
            early_stop_min_iters=4, record_history=True)
CASES = {
    "edge_kernel": dict(BASE, use_edge_raster=True, bin_tile=32,
                        faces_per_tile=64, use_pallas_raster=True),
    "edge": dict(BASE, use_edge_raster=True, bin_tile=32, faces_per_tile=64,
                 use_pallas_raster=False),
    # the bin budget fails (64·4 > 4·32), so both fall back to streaming
    "streaming": dict(BASE, use_edge_raster=True, bin_tile=32,
                      faces_per_tile=32, face_chunk=24, object_chunk=1),
}


def _check(rj, rt, atol, rtol):
    assert rt.num_iters == int(rj.num_iters)
    for name in ("translation", "yaw", "rot_aa", "log_scale"):
        np.testing.assert_allclose(getattr(rt.params, name).numpy(),
                                   np.asarray(getattr(rj.params, name)),
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(rt.losses.numpy(), np.asarray(rj.losses),
                               rtol=rtol)
    np.testing.assert_allclose(rt.history.numpy(), np.asarray(rj.history),
                               atol=atol)
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    # the fit moved the objects; the planar object kept its height
    moved = rt.params.translation.numpy() - _init_np()["translation"]
    assert np.abs(moved).max() > 1e-2 and moved[1, 1] == 0


@pytest.mark.parametrize("path", sorted(CASES))
def test_fit_poses_matches_jax(path):
    rj, rt, jax_path, port_path = _run_both(CASES[path])
    assert jax_path == port_path == path
    _check(rj, rt, atol=5e-3, rtol=2e-3)


@pytest.mark.parametrize("path", sorted(CASES))
def test_fit_machinery_matches_jax_exactly(path):
    rj, rt, jax_path, port_path = _run_both(dict(CASES[path], w_sil=0.0))
    assert jax_path == port_path == path
    _check(rj, rt, atol=1e-6, rtol=1e-5)


def test_early_stop_and_padding_slots():
    cfg = dict(CASES["edge"], max_iterations=6, early_stop_min_iters=2,
               early_stop_grad=1e3)
    rj, rt, _, _ = _run_both(cfg)
    assert rt.num_iters == int(rj.num_iters) == 3
    assert rt.converged.all() and np.asarray(rj.converged).all()


def test_pad_batch_to():
    bn, pn = _batch_np(), _init_np()
    batch = tpf.ObjectBatch(**{k: torch.from_numpy(v) for k, v in bn.items()})
    params = tpf.PoseParams(**{k: torch.from_numpy(v) for k, v in pn.items()})
    pb, pp, b = tpf.pad_batch_to(batch, params, 4)
    jb, jp, jb_n = jpf.pad_batch_to(
        jpf.ObjectBatch(**{k: jnp.asarray(v) for k, v in bn.items()}),
        jpf.PoseParams(**{k: jnp.asarray(v) for k, v in pn.items()}), 4)
    assert b == jb_n == 2
    for name in tpf.ObjectBatch._fields:
        np.testing.assert_array_equal(getattr(pb, name).numpy(),
                                      np.asarray(getattr(jb, name)), name)
    for name in tpf.PoseParams._fields:
        np.testing.assert_array_equal(getattr(pp, name).numpy(),
                                      np.asarray(getattr(jp, name)), name)


def test_auto_takes_the_kernels_only_on_cuda_at_512_with_32px_tiles():
    cfg = tpf.FitConfig(image_hw=(1024, 1024), bin_tile=32, faces_per_tile=128,
                        use_edge_raster=True)
    assert tpf.raster_path(cfg, 2048, "cuda") == "edge_kernel"
    assert tpf.raster_path(cfg, 2048, "cpu") == "edge"
    assert tpf.raster_path(dataclasses.replace(cfg, image_hw=(256, 256)),
                           128, "cuda") == "edge"
    assert tpf.raster_path(dataclasses.replace(cfg, bin_tile=64), 2048,
                           "cuda") == "edge"
