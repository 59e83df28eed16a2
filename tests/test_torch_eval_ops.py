"""The port's phase-7 and phase-9 modules against the JAX package on the
same numpy inputs from a seed (small sizes): surface sampling, ICP, the
Poisson solve and marching tetrahedra, the metric suite, LPIPS, PCA
pre-alignment, ground matching, the vertex-colour bake, the depth prior,
the evaluation store, and Pillow's LANCZOS and alpha compositing (Pillow
is the oracle here; the GPU machine has none).

Tolerances: points from JAX's own draws within 1e-6; ICP within 1e-5 on
clouds whose nearest neighbours are unambiguous (each point's partner 10×
closer than any other point, ROADMAP Queue 3 u); the Poisson field and iso
level within 1e-4·max|χ|, its mesh within a Chamfer distance of 1e-3 of a
grid cell; metrics within 1e-5 relative; marching tetrahedra, LANCZOS,
compositing and the evaluation files exact.
"""

import csv
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from regen3d_tpu import camera as jcam
from regen3d_tpu import config as jconfig
from regen3d_tpu.models.lpips import LPIPS as JLPIPS
from regen3d_tpu.ops import filters as jfilters
from regen3d_tpu.ops import icp as jicp
from regen3d_tpu.ops import marching_cubes as jmc
from regen3d_tpu.ops import metrics as jmetrics
from regen3d_tpu.ops import poisson as jpoisson
from regen3d_tpu.ops import sampling as jsampling
from regen3d_tpu.pipeline import depth as jdepth
from regen3d_tpu.pipeline import phase7_assemble as jphase7
from regen3d_tpu.pipeline import texture as jtexture
from regen3d_tpu.utils import evalstore as jevalstore
from regen3d_tpu.utils import image as jimage
from regen3d_tpu_torch.camera import Camera
from regen3d_tpu_torch.config import default_config
from regen3d_tpu_torch.models.from_jax import load_from_jax
from regen3d_tpu_torch.models.lpips import LPIPS, init_flax_style_, make_lpips_fn
from regen3d_tpu_torch.ops import filters as tfilters
from regen3d_tpu_torch.ops import icp as ticp
from regen3d_tpu_torch.ops import marching_cubes as tmc
from regen3d_tpu_torch.ops import metrics as tmetrics
from regen3d_tpu_torch.ops import poisson as tpoisson
from regen3d_tpu_torch.ops import sampling as tsampling
from regen3d_tpu_torch.pipeline import depth as tdepth
from regen3d_tpu_torch.pipeline import phase7_assemble as tphase7
from regen3d_tpu_torch.pipeline import texture as ttexture
from regen3d_tpu_torch.utils import evalstore as tevalstore
from regen3d_tpu_torch.utils import image as timage
from regen3d_tpu_torch.utils.glb import MeshData, SceneData, load_glb, save_glb
from regen3d_tpu_torch.utils.ply import save_ply
from test_torch_package import one_torch_thread  # noqa: F401


def T(a):
    return torch.from_numpy(np.array(a))


def _mesh(rng, n_faces=24):
    """A random triangle soup with face areas over two decades."""
    v = rng.normal(size=(n_faces * 3, 3)).astype(np.float32)
    v *= rng.uniform(0.1, 1.0, (n_faces * 3, 1)).astype(np.float32)
    return v, np.arange(n_faces * 3, dtype=np.int32).reshape(n_faces, 3)


# --- sampling -----------------------------------------------------------------

def test_points_from_draws_matches_jax_on_its_own_draws():
    v, f = _mesh(np.random.default_rng(0))
    key = jax.random.PRNGKey(3)
    pts_j, nrm_j = jsampling.sample_points_from_meshes(
        jnp.asarray(v), jnp.asarray(f), 4096, key, return_normals=True)
    # JAX's draws, recomputed from the key as sample_points_from_meshes
    # makes them
    logits = jnp.log(jnp.maximum(jsampling.face_areas(jnp.asarray(v),
                                                      jnp.asarray(f)), 1e-30))
    k_face, k_bary = jax.random.split(key)
    fidx = np.asarray(jax.random.categorical(k_face, logits, shape=(4096,)))
    u = np.asarray(jax.random.uniform(k_bary, (4096, 2)))
    pts_t, nrm_t = tsampling.points_from_draws(T(v), T(f), T(fidx), T(u),
                                               return_normals=True)
    np.testing.assert_allclose(pts_t.numpy(), np.asarray(pts_j), atol=1e-6)
    np.testing.assert_allclose(nrm_t.numpy(), np.asarray(nrm_j), atol=1e-6)


def test_port_draws_follow_face_areas():
    """Area-weighted faces (χ² against the areas, p > 1e-3), a face of zero
    area never drawn, barycentrics inside the triangle, and one seed one
    draw."""
    v, f = _mesh(np.random.default_rng(1))
    v[f[5]] = v[f[5, 0]]
    n = 40000
    fidx, u = tsampling.draw_samples(T(v), T(f), n, seed=7)
    areas = tsampling.face_areas(T(v), T(f)).double().numpy()
    counts = np.bincount(fidx.numpy(), minlength=len(f))
    assert areas[5] == 0 and counts[5] == 0
    keep = areas > 0
    expected = areas[keep] / areas.sum() * n
    # χ² with 23 faces − 1 = 22 degrees of freedom; 48.268 is its upper
    # 1e-3 quantile (scipy.stats.chi2.isf(1e-3, 22))
    assert keep.sum() == 23
    assert ((counts[keep] - expected) ** 2 / expected).sum() < 48.268
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    fidx2, u2 = tsampling.draw_samples(T(v), T(f), n, seed=7)
    assert torch.equal(fidx, fidx2) and torch.equal(u, u2)
    (pts,) = tsampling.sample_points_from_meshes(T(v), T(f), 64, seed=7)
    tri = torch.from_numpy(v)[torch.from_numpy(f)[
        tsampling.draw_samples(T(v), T(f), 64, seed=7)[0]].long()]
    # each point is a convex combination of its face's corners
    e1, e2, d = tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], pts - tri[:, 0]
    n_ = torch.cross(e1, e2, dim=-1)
    assert float(((d * n_).sum(-1).abs() / n_.norm(dim=-1)).max()) < 1e-5


# --- ICP ----------------------------------------------------------------------

def _icp_clouds(seed=0, n=512):
    """A jittered grid (spacing 0.1) and the same points turned 3° and
    moved 0.01, with 1 mm of noise: each point's partner lies 10× closer
    than any other point, so no nearest neighbour is near a tie."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(8)] * 3, indexing="ij"), -1)
    src = (g.reshape(-1, 3)[:n] * 0.1
           + rng.uniform(-0.01, 0.01, (n, 3))).astype(np.float32)
    a = np.radians(3.0)
    R = np.asarray([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                    [-np.sin(a), 0, np.cos(a)]])
    dst = (src @ R * 1.02 + [0.01, -0.005, 0.008]
           + rng.normal(size=src.shape) * 1e-3).astype(np.float32)
    return src, dst


@pytest.mark.parametrize("estimate_scale", [False, True])
def test_icp_fixed_count_matches_jax(estimate_scale):
    """30 iterations on both sides: a negative threshold never stops the
    loop early (at 0 both stop where the RMSE repeats exactly, here after
    two iterations, since the correspondences no longer change)."""
    src, dst = _icp_clouds()
    for thr, n in ((0.0, 2), (-1.0, 30)):
        rj = jicp.iterative_closest_point(jnp.asarray(src), jnp.asarray(dst),
                                          max_iterations=30,
                                          estimate_scale=estimate_scale,
                                          relative_rmse_thr=thr)
        rt = ticp.iterative_closest_point(T(src), T(dst), max_iterations=30,
                                          estimate_scale=estimate_scale,
                                          relative_rmse_thr=thr)
        assert int(rj.num_iters) == rt.num_iters == n
    for a, b in ((rj.R, rt.R), (rj.t, rt.t), (rj.s, rt.s),
                 (rj.aligned, rt.aligned)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)
    np.testing.assert_allclose(float(rt.rmse), float(rj.rmse), rtol=1e-5)


def test_icp_default_threshold_matches_jax():
    """Stopping at |Δrmse| ≤ 1e-6·rmse (about 8 f32 ulps): the two may stop
    a few iterations apart; the RMSE agrees within 1e-5."""
    src, dst = _icp_clouds(seed=1)
    rj = jicp.iterative_closest_point(jnp.asarray(src), jnp.asarray(dst))
    rt = ticp.iterative_closest_point(T(src), T(dst))
    assert 2 <= rt.num_iters < 200 and 2 <= int(rj.num_iters) < 200
    np.testing.assert_allclose(float(rt.rmse), float(rj.rmse), rtol=1e-5)
    np.testing.assert_allclose(rt.aligned.numpy(), np.asarray(rj.aligned),
                               atol=1e-5)


# --- Poisson and marching -----------------------------------------------------

def _sphere(rng, n=3000):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v.astype(np.float32), v.astype(np.float32)


def _plane(rng, n=3000):
    pts = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                    np.zeros(n)], -1).astype(np.float32)
    return pts, np.tile(np.asarray([[0, 0, 1.0]], np.float32), (n, 1))


def _iso(chi, pts, origin, cell, r):
    c = np.clip(((pts - origin) / cell).round().astype(int), 0, r - 1)
    return float(chi[c[:, 2], c[:, 1], c[:, 0]].mean())


def _chamfer(a, b):
    d = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return 0.5 * (np.sqrt(d.min(1)).mean() + np.sqrt(d.min(0)).mean())


@pytest.mark.parametrize("shape,quantile", [("sphere", 0.0), ("plane", 0.2)])
def test_poisson_matches_jax(shape, quantile):
    pts, nrm = {"sphere": _sphere, "plane": _plane}[shape](
        np.random.default_rng(2))
    r = 32
    chi_j, dens_j, (org_j, cell_j) = jpoisson._poisson_indicator_jit(
        jnp.asarray(pts), jnp.asarray(nrm), resolution=r)
    chi_t, dens_t, (org_t, cell_t) = tpoisson.poisson_indicator(
        T(pts), T(nrm), resolution=r)
    chi_j = np.asarray(chi_j)
    scale = np.abs(chi_j).max()
    np.testing.assert_allclose(chi_t.numpy(), chi_j, atol=1e-4 * scale)
    np.testing.assert_allclose(dens_t.numpy(), np.asarray(dens_j), atol=1e-4)
    assert float(cell_t) == pytest.approx(float(cell_j), rel=1e-6)
    iso_j = _iso(chi_j, pts, np.asarray(org_j), float(cell_j), r)
    iso_t = _iso(chi_t.numpy(), pts, org_t.numpy(), float(cell_t), r)
    assert abs(iso_t - iso_j) <= 1e-4 * scale
    vj, fj = jpoisson.poisson_reconstruct(pts, nrm, resolution=r,
                                          density_quantile=quantile)
    vt, ft = tpoisson.poisson_reconstruct(pts, nrm, resolution=r,
                                          density_quantile=quantile,
                                          device="cpu")
    assert len(ft) > 50 and abs(len(ft) - len(fj)) <= 0.01 * len(fj)
    assert _chamfer(vt, vj) <= 1e-3 * float(cell_j)
    if shape == "sphere":    # test_metrics_poisson.py's checks
        radii = np.linalg.norm(vt - vt.mean(0), axis=1)
        assert abs(radii.mean() - 1.0) < 0.1 and radii.std() < 0.08
    else:
        inner = vt[(np.abs(vt[:, 0]) < 0.7) & (np.abs(vt[:, 1]) < 0.7)]
        assert len(inner) > 0 and np.median(np.abs(inner[:, 2])) < 0.12


def test_marching_tetrahedra_bit_identical_to_jax():
    """The port's build of its copy of marching.cpp and the JAX package's
    give the same arrays, and the plain numpy version the same surface."""
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, 24)] * 3, indexing="ij")
    rng = np.random.default_rng(4)
    sdf = (np.sqrt(x ** 2 + (1.3 * y) ** 2 + z ** 2) - 0.6
           + 0.02 * rng.normal(size=x.shape)).astype(np.float32)
    assert jmc._get_lib() is not None
    vj, fj = jmc.marching_tetrahedra(sdf, 0.0)
    vt, ft = tmc.marching_tetrahedra(sdf, 0.0)
    assert tmc.lib_path().exists()
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    vp, fp = tmc.marching_tetrahedra_plain(sdf, 0.0)
    vjp, fjp = jmc._marching_tetrahedra_numpy(sdf, 0.0)
    np.testing.assert_array_equal(vp, vjp)
    np.testing.assert_array_equal(fp, fjp)
    # the same surface: as many triangles, the same area, the same vertices
    def area(v, f):
        t = v[f].astype(np.float64)
        return 0.5 * np.linalg.norm(np.cross(t[:, 1] - t[:, 0],
                                             t[:, 2] - t[:, 0]), axis=-1).sum()

    assert len(ft) == len(fp)
    assert area(vp, fp) == pytest.approx(area(vt, ft), rel=1e-6)
    assert _chamfer(vp, vt) < 1e-5


# --- metrics ------------------------------------------------------------------

def test_evaluate_clouds_psnr_ssim_match_jax():
    """Clouds 0.05-0.1 apart (the flat Wasserstein mean |Δ| then dwarfs the
    one-ulp rounding of its interpolated quantiles)."""
    rng = np.random.default_rng(5)
    pred = rng.normal(size=(1500, 3)).astype(np.float32)
    gt = (pred[:1300] * 1.05 + [0.05, 0.0, -0.03]
          + rng.normal(size=(1300, 3)) * 0.03).astype(np.float32)
    mj = jmetrics.evaluate_clouds(jnp.asarray(pred), jnp.asarray(gt), tau=0.1)
    mt = tmetrics.evaluate_clouds(T(pred), T(gt), tau=0.1)
    assert sorted(mt) == sorted(mj) and len(mt) == 10
    for k in mj:
        assert mt[k] == pytest.approx(mj[k], rel=1e-5, abs=1e-12), k
    a = rng.uniform(size=(96, 128, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape) * 0.1, 0, 1).astype(np.float32)
    for fj, ft in ((jmetrics.psnr, tmetrics.psnr), (jmetrics.ssim, tmetrics.ssim)):
        assert float(ft(T(a), T(b))) == pytest.approx(
            float(fj(jnp.asarray(a), jnp.asarray(b))), rel=1e-5)
    assert float(tmetrics.ssim(T(a), T(a))) == pytest.approx(1.0, abs=1e-5)
    assert float(tmetrics.ssim(T(a[..., 0]), T(b[..., 0]))) == pytest.approx(
        float(jmetrics.ssim(jnp.asarray(a[..., 0]), jnp.asarray(b[..., 0]))),
        rel=1e-5)


def test_chamfer_metrics_and_precision_recall_match_jax():
    rng = np.random.default_rng(6)
    pred = rng.normal(size=(900, 3)).astype(np.float32)
    gt = (pred[:700] + rng.normal(size=(700, 3)) * 0.01).astype(np.float32)
    for jf, tf, kw in ((jmetrics.chamfer_metrics, tmetrics.chamfer_metrics,
                        {}),
                       (jmetrics.precision_recall_at,
                        tmetrics.precision_recall_at, {"thr": 0.015})):
        mj = jf(jnp.asarray(pred), jnp.asarray(gt), chunk=256, **kw)
        mt = tf(T(pred), T(gt), chunk=256, **kw)
        assert sorted(mt) == sorted(mj)
        for k in mj:
            assert float(mt[k]) == pytest.approx(float(mj[k]), rel=1e-5), k
    # the same numbers evaluate_clouds reports
    full = tmetrics.evaluate_clouds(T(pred), T(gt))
    for k, v in tmetrics.chamfer_metrics(T(pred), T(gt)).items():
        assert float(v) == pytest.approx(full[k], rel=1e-6), k


def test_lpips_matches_jax_and_its_fixture():
    d = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                             "activations", "lpips.npz"))
    model = JLPIPS()
    params = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0),
                                                jnp.asarray(d["input_x"]),
                                                jnp.asarray(d["input_x2"])))
    port = LPIPS(device="cpu")
    load_from_jax(port, params)
    fn = make_lpips_fn(port)
    assert float(fn(T(d["input_x"]), T(d["input_x2"]))) == pytest.approx(
        float(d["expected_y"]), abs=1e-6)
    rng = np.random.default_rng(6)
    a = rng.uniform(size=(2, 64, 80, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape) * 0.1, 0, 1).astype(np.float32)
    yj = float(jax.jit(model.apply)(params, jnp.asarray(a), jnp.asarray(b)))
    assert float(fn(T(a), T(b))) == pytest.approx(yj, rel=1e-5)
    # an (H, W, 3) pair is a batch of one
    assert float(fn(T(a[0]), T(b[0]))) == float(fn(T(a[:1]), T(b[:1])))
    # the seeded init is flax's: heads at 1/C, the trunk's biases 0 and
    # its kernels lecun-normal
    seeded = LPIPS(device="cpu")
    init_flax_style_(seeded, torch.Generator().manual_seed(0))
    assert float(seeded.lin1.weight.mean()) == pytest.approx(1 / 192)
    w = seeded.alex.conv2.weight
    assert float(w.std()) == pytest.approx((64 * 25) ** -0.5, rel=0.05)
    assert float(make_lpips_fn(seeded)(T(a), T(b))) > 0


# --- PCA pre-alignment (ROADMAP Queue 3 w) ------------------------------------

def _pca_pair(rng):
    src = (rng.normal(size=(2000, 3)) * [3.0, 2.0, 1.0]).astype(np.float32)
    A = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    dst = (src @ A + [1.0, 2.0, 3.0]
           + rng.normal(size=src.shape) * 0.01).astype(np.float32)
    return src, dst


def _axes(p):
    x = p.astype(np.float64) - p.mean(0)
    return np.linalg.eigh(x.T @ x / len(p))[1]


def test_pca_align_agrees_with_jax_up_to_eigenvector_signs():
    """In the clouds' shared eigenbases both packages' R are diagonal sign
    matrices with det +1; where they chose the same signs R and t agree
    within 1e-5. Over 6 seeds they disagree on at least one (LAPACK in
    JAX's eigh and in torch's return other signs) and agree on others."""
    agree = 0
    for seed in range(6):
        src, dst = _pca_pair(np.random.default_rng(seed))
        Rj, tj = map(np.asarray, jfilters.pca_align(jnp.asarray(src),
                                                    jnp.asarray(dst)))
        Rt, tt = (x.numpy() for x in tfilters.pca_align(T(src), T(dst)))
        vs, vd = _axes(src), _axes(dst)
        Dj, Dt = vs.T @ Rj @ vd, vs.T @ Rt @ vd
        for D, R in ((Dj, Rj), (Dt, Rt)):
            np.testing.assert_allclose(np.abs(D), np.eye(3), atol=1e-3)
            assert np.linalg.det(R) == pytest.approx(1.0, abs=1e-5)
        if (np.sign(np.diag(Dj)) == np.sign(np.diag(Dt))).all():
            agree += 1
            np.testing.assert_allclose(Rt, Rj, atol=1e-5)
            np.testing.assert_allclose(tt, tj, atol=1e-4)
    assert 0 < agree < 6


def test_pca_align_rotation_depends_on_the_solvers_signs(monkeypatch):
    """ROADMAP Queue 3 w: negating the source's second and third
    eigenvectors (an equally valid solution of eigh) turns R by 180° about
    an axis, so the same clouds give two proper rotations far apart."""
    src, dst = _pca_pair(np.random.default_rng(0))
    R0 = tfilters.pca_align(T(src), T(dst))[0].numpy()
    eigh = torch.linalg.eigh
    calls = []

    def flipped(a):         # the first call solves for the source's axes
        w, v = eigh(a)
        calls.append(1)
        return w, (v * torch.tensor([1.0, -1.0, -1.0]) if len(calls) == 1
                   else v)

    monkeypatch.setattr(torch.linalg, "eigh", flipped)
    R1 = tfilters.pca_align(T(src), T(dst))[0].numpy()
    rel = R0.T @ R1
    assert np.linalg.det(R1) == pytest.approx(1.0, abs=1e-5)
    assert np.trace(rel) == pytest.approx(-1.0, abs=1e-4)   # a 180° turn
    assert np.abs(R1 - R0).max() > 0.5


# --- ground matching (tests/test_ground_match.py mirrored) -------------------

def _plane_file(cfg, y=0.7):
    from regen3d_tpu_torch.artifacts import Artifacts

    gx, gz = np.meshgrid(np.linspace(-1, 1, 20), np.linspace(-1, 1, 20))
    plane = np.stack([gx.ravel(), np.full(gx.size, y), gz.ravel()], -1)
    path = os.path.join(Artifacts(cfg).temp, "debug", "PLANE_SAMPLED.ply")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    save_ply(path, plane.astype(np.float32))


def test_ground_offset_matches_host_reference_and_jax():
    rng = np.random.default_rng(1234567)
    band = rng.uniform(-1, 1, size=(333, 3)).astype(np.float32)
    target = rng.uniform(-1, 1, size=(777, 3)).astype(np.float32)
    d2 = ((band[:, None, [0, 2]] - target[None, :, [0, 2]]) ** 2).sum(-1)
    idx = d2.argmin(1)
    ok = d2[np.arange(len(band)), idx] <= 0.2 * 0.2
    want = float(np.mean(target[idx[ok], 1] - band[ok, 1]))
    off, cnt = tphase7.ground_offset(T(band), T(target), 0.2)
    assert int(cnt) == int(ok.sum())
    np.testing.assert_allclose(float(off), want, rtol=1e-5, atol=1e-6)
    bp, bm = jphase7._pad_pow2(band)
    tp, tm = jphase7._pad_pow2(target)
    off_j, cnt_j = jphase7._ground_offset_prog(len(bp), len(tp))(
        jnp.asarray(bp), jnp.asarray(bm), jnp.asarray(tp), jnp.asarray(tm),
        jnp.float32(0.2))
    assert int(cnt_j) == int(cnt)
    np.testing.assert_allclose(float(off), float(off_j), rtol=1e-5, atol=1e-6)


def test_ground_offset_excludes_points_out_of_radius():
    band = np.asarray([[0.0, 0.0, 0.0], [5.0, 3.0, 5.0]], np.float32)
    target = np.asarray([[0.01, 1.0, 0.01]], np.float32)
    off, cnt = tphase7.ground_offset(T(band), T(target), 0.1)
    assert int(cnt) == 1
    np.testing.assert_allclose(float(off), 1.0, atol=1e-6)


def test_match_grounds_shifts_mesh_to_plane_as_jax(tmp_path):
    rng = np.random.default_rng(1234567)
    cfg = default_config(str(tmp_path / "output"))
    _plane_file(cfg)
    verts = rng.uniform(-1, 1, size=(1000, 3)).astype(np.float32)
    verts[:, 1] = rng.uniform(0.0, 2.0, size=1000)
    out = tphase7._match_grounds(cfg, verts.copy(), device="cpu")
    shift = float(np.mean(out[:, 1] - verts[:, 1]))
    low = verts[verts[:, 1] <= np.quantile(verts[:, 1], 0.1), 1].mean()
    assert abs(shift - (0.7 - float(low))) < 0.05
    np.testing.assert_allclose(out[:, [0, 2]], verts[:, [0, 2]])
    out_j = jphase7._match_grounds(
        jconfig.default_config(str(tmp_path / "output")), verts.copy())
    np.testing.assert_allclose(out, out_j, rtol=1e-5, atol=1e-5)


def test_match_grounds_without_plane_file_is_a_noop(tmp_path):
    verts = np.random.default_rng(0).uniform(-1, 1, (100, 3)).astype(np.float32)
    out = tphase7._match_grounds(default_config(str(tmp_path / "output")),
                                 verts.copy(), device="cpu")
    np.testing.assert_array_equal(out, verts)


# --- vertex-colour bake (tests/test_texture.py's mesh) -----------------------

def _box(half=0.4):
    v = np.asarray([[x, y, z] for x in (-half, half) for y in (-half, half)
                    for z in (-half, half)], np.float32)
    f = np.asarray([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                    [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                    [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return v + np.asarray([0, 0, 2.0], np.float32), f


def test_bake_vertex_colors_matches_jax():
    """The camera sees the box's front face; the vertices of the back face,
    hidden, take the mean colour of the front ones."""
    verts, faces = _box()
    rng = np.random.default_rng(8)
    img = rng.uniform(size=(64, 64, 3)).astype(np.float32)
    img[:, :, 0] = 1.0
    kw = dict(R=np.eye(3, dtype=np.float32), T=np.zeros(3, np.float32),
              focal=np.asarray([64.0, 64.0], np.float32),
              principal=np.asarray([32.0, 31.0], np.float32))
    cj = jcam.Camera(**{k: jnp.asarray(v) for k, v in kw.items()},
                     image_size=(64, 64))
    ct = Camera(**{k: T(v) for k, v in kw.items()}, image_size=(64, 64))
    rj = jtexture.bake_vertex_colors(verts, faces, [(cj, img)])
    rt = ttexture.bake_vertex_colors(verts, faces, [(ct, img)])
    assert rt.shape == (8, 4)
    np.testing.assert_allclose(rt, rj, atol=1e-5)
    front = verts[:, 2] < 1.8
    np.testing.assert_allclose(rt[front, 0], 1.0, atol=1e-3)
    np.testing.assert_allclose(rt[~front, :3],
                               np.broadcast_to(rt[front, :3].mean(0), (4, 3)),
                               atol=1e-6)


# --- depth prior --------------------------------------------------------------

def test_depth_prior_matches_jax_and_a_model_is_refused(tmp_path,
                                                       monkeypatch):
    """The prior matches JAX; ``depth_anything_checkpoint`` naming the
    orbax directory the JAX package's ``save_depth_checkpoint`` wrote (a
    tiny Depth-Anything on drawn weights, its config in the sidecar)
    loads. The directory in an f32 port model gives the JAX package's f32
    depth.png within one level (measured: identical); as the config key
    runs it, in bf16, it gives JAX's bf16 depth.png by the mean error,
    since the two packages round bf16 in other places (ROADMAP Queue 3
    af): a mean under 0.7% of the range and at most 10 levels (measured
    1.15 and 6). With tensorstore hidden the directory is refused, naming
    it."""
    from regen3d_tpu.models import depth_anything as jda
    from regen3d_tpu.pipeline.depth_distill import save_depth_checkpoint

    img = np.random.default_rng(9).integers(0, 256, (48, 64, 3), np.uint8)
    np.testing.assert_array_equal(tdepth.estimate_depth(img),
                                  jdepth.estimate_depth(img))
    ac = jda.DepthAnythingConfig.tiny()
    rng = np.random.default_rng(10)
    params = jax.tree_util.tree_map(
        lambda s: (0.2 * rng.normal(size=s.shape)).astype(np.float32),
        jax.eval_shape(jda.DepthAnything(ac).init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 56, 56, 3))))
    ckpt = str(tmp_path / "depth_ckpt")
    save_depth_checkpoint(ckpt, params, ac)
    Image.fromarray(img).save(tmp_path / "in.png")
    out = {}
    for name, run in (("jax", jdepth.run),
                      ("port", lambda c: tdepth.run(c, device="cpu"))):
        cfg = default_config(str(tmp_path / name / "output"),
                             input_image=str(tmp_path / "in.png"),
                             depth_anything_checkpoint=ckpt)
        out[name] = np.asarray(Image.open(run(cfg))).astype(int)
    assert out["port"].shape == out["jax"].shape == img.shape[:2]
    # the control: the same directory in an f32 port model
    from regen3d_tpu_torch.models import depth_anything as tda
    from regen3d_tpu_torch.models.from_jax import (
        DEPTH_ANYTHING_CONV_TRANSPOSE,
    )
    from regen3d_tpu_torch.models.weights import load_model
    f32 = load_model(tda.DepthAnything(dataclasses.replace(
        tda.DepthAnythingConfig.tiny(), dtype=torch.float32), device="cpu"),
        ckpt, DEPTH_ANYTHING_CONV_TRANSPOSE)
    out["f32"] = (tdepth.estimate_depth(img, f32) * 255).astype(int)
    jf32 = jda.DepthAnything(dataclasses.replace(ac, dtype=jnp.float32))
    out["jax_f32"] = (jdepth.estimate_depth(img, jf32, params)
                      * 255).astype(int)
    assert np.abs(out["f32"] - out["jax_f32"]).max() <= 1
    diff = np.abs(out["port"] - out["jax"])
    print("bf16 depth.png levels apart: mean", diff.mean(), "max",
          diff.max())
    assert diff.mean() <= 0.007 * 255 and diff.max() <= 10
    assert out["port"].std() > 10                  # not the prior's ramp
    prior = (tdepth.estimate_depth(img) * 255).astype(np.uint8)
    assert (out["port"] != prior).mean() > 0.5
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="tensorstore"):
        tdepth.run(cfg, device="cpu")


# --- Pillow's LANCZOS and alpha compositing -----------------------------------

@pytest.mark.parametrize("src,dst", [
    ((960, 1280), (384, 512)),      # phase 7's bake image (max_side 512)
    ((96, 128), (40, 57)),          # downscale, odd sizes
    ((37, 53), (96, 128)),          # upscale
    ((31, 17), (29, 61)),           # one axis down, the other up
    ((40, 64), (40, 33)),           # one axis only
])
def test_resize_lanczos_is_pillows_bit_for_bit(src, dst):
    rng = np.random.default_rng(src[0] * dst[1])
    a = rng.integers(0, 256, src + (3,), np.uint8)
    want = np.asarray(Image.fromarray(a).resize(dst[::-1], Image.LANCZOS))
    np.testing.assert_array_equal(timage.resize_pil(a, dst, "lanczos"), want)
    g = a[..., 0]
    np.testing.assert_array_equal(
        timage.resize_pil(g, dst, "lanczos"),
        np.asarray(Image.fromarray(g).resize(dst[::-1], Image.LANCZOS)))


def test_alpha_over_white_is_pillows_for_every_alpha_and_value():
    a, v = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    rgba = np.stack([v, 255 - v, (v * 7) % 256, a], -1).astype(np.uint8)
    white = Image.new("RGBA", (256, 256), (255, 255, 255, 255))
    want = np.asarray(Image.alpha_composite(white, Image.fromarray(rgba))
                      .convert("RGB"))
    np.testing.assert_array_equal(timage.alpha_over_white(rgba), want)


@pytest.mark.parametrize("mode", ["RGBA", "LA", "RGB", "L"])
def test_load_image_rgb_matches_jax(tmp_path, mode):
    rng = np.random.default_rng(10)
    ch = {"RGBA": 4, "LA": 2, "RGB": 3, "L": 1}[mode]
    arr = rng.integers(0, 256, (150, 210, ch), np.uint8)
    path = str(tmp_path / f"img_{mode}.png")
    Image.fromarray(arr[..., 0] if ch == 1 else arr, mode).save(path)
    for max_side in (None, 128):
        np.testing.assert_array_equal(timage.load_image_rgb(path, max_side),
                                      jimage.load_image_rgb(path, max_side))


def test_load_image_rgb_refuses_other_formats(tmp_path, monkeypatch):
    """A JPEG (the paper's own input) loads as the JAX package loads it,
    through PIL; where PIL is absent it is refused, naming PIL and the
    format."""
    path = str(tmp_path / "img.jpg")
    rng = np.random.default_rng(11)
    Image.fromarray(rng.integers(0, 256, (150, 210, 3), np.uint8)).save(path)
    for max_side in (None, 128):
        got = timage.load_image_rgb(path, max_side)
        assert got.dtype == np.uint8 and got.shape[2] == 3
        np.testing.assert_array_equal(got,
                                      jimage.load_image_rgb(path, max_side))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="JPEG.*PIL"):
        timage.load_image_rgb(path)


# --- evaluation store ---------------------------------------------------------

def test_dump_evaluation_writes_the_jax_packages_files(tmp_path):
    config = {"seed": 1, "num_samples": 2048, "tau": 1e-05, "name": "1.0",
              "flag": True, "none": None, "labels": ["chair", "floor: 1"],
              "nested": {"a": [1, 2.5], "b": {}}, "path": "../output/x"}
    runs = [({"chamfer": 0.5, "psnr": 20.0, "zero": 0.0}, "24_01_01_000000"),
            ({"chamfer": 0.4, "psnr": 21.0, "zero": 1.0, "new": 3.0},
             "24_01_02_000000")]
    for pkg, root in ((jevalstore, tmp_path / "jax"),
                      (tevalstore, tmp_path / "port")):
        for metrics, ts in runs:
            pkg.dump_evaluation(str(root), metrics, config, timestamp=ts)
    for ts in ("24_01_01_000000", "24_01_02_000000"):
        for name in ("metrics.json", "metrics.csv", "comparison.csv"):
            pj, pt = tmp_path / "jax" / ts / name, tmp_path / "port" / ts / name
            assert pj.exists() == pt.exists(), name
            if pj.exists():
                assert pt.read_bytes() == pj.read_bytes(), name
        with open(tmp_path / "port" / ts / "config.yaml") as f:
            got = yaml.safe_load(f)
        with open(tmp_path / "jax" / ts / "config.yaml") as f:
            assert got == yaml.safe_load(f) == config
    prev = tevalstore.get_previous_evaluation(str(tmp_path / "port"))
    assert prev["chamfer"] == 0.4
    with open(tmp_path / "port" / "24_01_02_000000" / "comparison.csv") as f:
        rows = {r[0]: r for r in csv.reader(f)}
    assert rows["zero"][4] == "inf" and rows["new"][1] == ""
    assert json.loads((tmp_path / "port" / "24_01_02_000000"
                       / "metrics.json").read_text())["new"] == 3.0


# --- the ICP replay onto GLBs ----------------------------

def test_apply_similarity_to_glb_matches_jax(tmp_path):
    rng = np.random.default_rng(12)
    src = str(tmp_path / "in.glb")
    save_glb(src, SceneData(meshes=[MeshData(
        name=f"m{i}", vertices=rng.normal(size=(30, 3)).astype(np.float32),
        faces=rng.integers(0, 30, (20, 3)).astype(np.int32))
        for i in range(2)]))
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    t = np.asarray([0.1, -0.2, 0.3], np.float32)
    jphase7.apply_similarity_to_glb(src, R, t, 1.5, str(tmp_path / "j.glb"))
    tphase7.apply_similarity_to_glb(src, R, t, 1.5, str(tmp_path / "t.glb"))
    assert (tmp_path / "t.glb").read_bytes() == (tmp_path / "j.glb").read_bytes()
