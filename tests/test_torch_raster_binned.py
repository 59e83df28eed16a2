"""The port's binned rasterizers, the top-k point-mesh loss, point splats and
camera rays against the JAX package on the CPU, at 64² to 128² with tens to
a few thousand faces, inputs drawn with numpy from a seed. Tolerances:

* the binned z-buffer: face ids identical to JAX's, barycentrics within
  1e-6 and depth within 1e-5 relative (XLA on the CPU contracts the edge
  functions' products into fused multiply-adds, which eager PyTorch rounds
  one by one: depths near 2 differ by up to 5e-6, as the port's dense
  z-buffer's do); against the port's own dense z-buffer bit for bit (both
  compute a pair's depth with the same operations);
* the dispatch: ``max_faces_per_tile`` equal to JAX's, the same path as
  JAX's ``rasterize_hard_auto`` takes, the same fragments;
* the binned silhouette: alpha within 1e-5 (the sum over a tile's faces
  in another order, as test_torch_silhouette.py holds the streaming one),
  the screen-vertex gradient within 1e-5 of max |g|;
* the top-k loss: value and gradients within 1e-5 relative, and the exact
  loss where every candidate is taken;
* point splats: rgb within 1e-6, alpha within 1e-5; rays within 1e-6;
* fits with ``use_binned_raster`` and ``pm_topk``: as test_torch_pose_fit
  holds the streaming path (one Adam step; ROADMAP Queue 3 g), and with the
  silhouette weighted 0 within 1e-6;
* the soft silhouettes against test_softras_oracle.py's numpy transcription
  of pytorch3d's rasterizer, with that file's bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regen3d_tpu.camera import Camera as JCamera
from regen3d_tpu.ops import point_mesh as jpm
from regen3d_tpu.ops import rasterize as jr
from regen3d_tpu.pipeline import pose_fit as jpf
from regen3d_tpu_torch.camera import Camera
from regen3d_tpu_torch.ops import point_mesh as tpm
from regen3d_tpu_torch.ops import rasterize as tr
from test_softras_oracle import _random_scene, pytorch3d_soft_silhouette_oracle
from test_torch_package import one_torch_thread  # noqa: F401
from test_torch_pose_fit import _check, _run_both

H = W = 128


def _jcam(hw=(H, W), focal=128.0):
    h, w = hw
    return JCamera(R=jnp.eye(3), T=jnp.zeros(3),
                   focal=jnp.asarray([focal, focal]),
                   principal=jnp.asarray([w / 2.0, h / 2.0]), image_size=hw)


def _screen(seed, n_faces, hw=(H, W), spread=0.6, size=0.08):
    """Random separate triangles in front of the camera → screen vertices
    (V, 3) and faces (F, 3), from JAX's view_to_screen."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n_faces, 3, 3)).astype(np.float32) * size
    c = rng.uniform(-spread, spread, (n_faces, 1, 3)).astype(np.float32)
    v = (v + c + np.asarray([0, 0, 2.5], np.float32)).reshape(-1, 3)
    vs = np.asarray(_jcam(hw).view_to_screen(jnp.asarray(v)))
    return vs, np.arange(3 * n_faces, dtype=np.int32).reshape(-1, 3)


def _t(x):
    return torch.from_numpy(np.array(x))


def _frag_equal(a, b):
    for f in ("face_idx", "bary", "depth"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("masked", [False, True])
def test_binned_hard_matches_jax_and_dense(masked):
    vs, f = _screen(0, 300)
    mask = np.random.default_rng(1).random(300) > 0.3 if masked else None
    tm = None if mask is None else _t(mask)[None]
    jm = None if mask is None else jnp.asarray(mask)
    got = tr.rasterize_hard_binned(_t(vs)[None], _t(f)[None], (H, W),
                                   faces_mask=tm, tile=32, faces_per_tile=300,
                                   tiles_per_step=3, chunk=64)
    ref = jr.rasterize_hard_binned(jnp.asarray(vs), jnp.asarray(f), (H, W),
                                   faces_mask=jm, tile=32, faces_per_tile=300)
    np.testing.assert_array_equal(got.face_idx[0].numpy(),
                                  np.asarray(ref.face_idx))
    np.testing.assert_allclose(got.bary[0].numpy(), np.asarray(ref.bary),
                               atol=1e-6)
    np.testing.assert_allclose(got.depth[0].numpy(), np.asarray(ref.depth),
                               rtol=1e-5)
    assert (got.face_idx >= 0).float().mean() > 0.1
    dense = tr.rasterize_hard(_t(vs)[None], _t(f)[None], (H, W),
                              faces_mask=tm, chunk=64)
    _frag_equal(got, dense)


def test_binned_hard_is_dense_bit_for_bit_over_a_batch():
    """Two objects at once, K the batch's largest per-tile count, chunks of
    K smaller than K: the fragments of the dense path exactly."""
    a, fa = _screen(2, 200, spread=0.3, size=0.15)
    b, fb = _screen(3, 200, spread=0.5)
    vs, f = _t(np.stack([a, b])), _t(np.stack([fa, fb]))
    k = int(tr.max_faces_per_tile(vs, f, (H, W), tile=64).max())
    got = tr.rasterize_hard_binned(vs, f, (H, W), tile=64, faces_per_tile=k,
                                   chunk=max(k // 3, 1))
    _frag_equal(got, tr.rasterize_hard(vs, f, (H, W), chunk=48))


def _slivers(n=2100, hw=(64, 128)):
    """``n`` thin triangles inside the first 64² tile and 60 elsewhere."""
    rng = np.random.default_rng(4)
    x0 = rng.uniform(4, 56, (n, 1))
    y0 = rng.uniform(4, 56, (n, 1))
    uv = np.concatenate([np.stack([x0, y0], -1),
                         np.stack([x0 + 6, y0 + 0.5], -1),
                         np.stack([x0 + 0.5, y0 + 6], -1)], 1)
    far = rng.uniform([70, 5], [120, 55], (60, 1, 2)) + rng.uniform(
        -4, 4, (60, 3, 2))
    uv = np.concatenate([uv, far]).astype(np.float32)
    z = rng.uniform(1.0, 3.0, (len(uv), 3, 1)).astype(np.float32)
    vs = np.concatenate([uv, z], -1).reshape(-1, 3)
    return vs, np.arange(len(vs), dtype=np.int32).reshape(-1, 3), hw


def _dispatch_cases():
    vs, f = _screen(5, 400, spread=0.7)              # aligned, bins
    yield "aligned", vs, f, (H, W)
    vs, f = _screen(6, 300, hw=(96, 100))            # not 64-aligned
    yield "unaligned", vs, f, (96, 100)
    vs, f = _screen(7, 200)                          # F ≤ 256
    yield "few_faces", vs, f, (H, W)
    vs, f, hw = _slivers()                           # kmax > 2048
    yield "over_2048", vs, f, hw


@pytest.mark.parametrize("case", ["aligned", "unaligned", "few_faces",
                                  "over_2048"])
def test_auto_dispatch_matches_jax(case, monkeypatch):
    name, vs, f, hw = next(c for c in _dispatch_cases() if c[0] == case)
    taken = []
    for attr in ("_rasterize_hard_jit", "_rasterize_hard_binned_jit"):
        real = getattr(jr, attr)

        def spy(*a, _real=real, _attr=attr, **kw):
            taken.append("binned" if "binned" in _attr else "dense")
            return _real(*a, **kw)

        monkeypatch.setattr(jr, attr, spy)
    ref = jr.rasterize_hard_auto(jnp.asarray(vs), jnp.asarray(f), hw)
    path = tr.hard_raster_path(_t(vs)[None], _t(f)[None], hw)
    assert [path.path] == taken
    if path.kmax is not None:
        kj = int(jr.max_faces_per_tile(jnp.asarray(vs), jnp.asarray(f), hw))
        assert path.kmax == kj
        assert int(tr.max_faces_per_tile(_t(vs)[None], _t(f)[None], hw)[0]) == kj
    expect = {"aligned": "binned", "unaligned": "dense", "few_faces": "dense",
              "over_2048": "dense"}[case]
    assert path.path == expect
    if case == "over_2048":
        assert path.kmax > 2048 and path.k is None
    got = tr.rasterize_hard_auto(_t(vs)[None], _t(f)[None], hw, chunk=128)
    np.testing.assert_array_equal(got.face_idx[0].numpy(),
                                  np.asarray(ref.face_idx))
    np.testing.assert_allclose(got.depth[0].numpy(), np.asarray(ref.depth),
                               rtol=1e-5)


def test_soft_silhouette_binned_value_and_gradient():
    vs, f = _screen(8, 48)
    mask = np.random.default_rng(9).random(48) > 0.2
    kw = dict(sigma=1e-4, tile=32, faces_per_tile=48)
    v = _t(vs)[None].requires_grad_()
    alpha = tr.soft_silhouette_binned(v, _t(f)[None], (H, W),
                                      faces_mask=_t(mask)[None],
                                      tiles_per_step=5, **kw)
    w = np.random.default_rng(10).random((H, W)).astype(np.float32)
    (alpha[0] * _t(w)).sum().backward()

    def loss(x):
        a = jr.soft_silhouette_binned(x, jnp.asarray(f), (H, W),
                                      faces_mask=jnp.asarray(mask), **kw)
        return jnp.sum(a * w), a

    (_, ref), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(vs))
    np.testing.assert_allclose(alpha[0].detach().numpy(), np.asarray(ref),
                               atol=1e-5)
    g = np.asarray(g)
    assert np.abs(v.grad[0].numpy() - g).max() <= 1e-5 * np.abs(g).max()
    assert float(ref.max()) > 0.5


def _mesh_problem(seed, b=2, nv=40, nf=60, n_pts=50):
    rng = np.random.default_rng(seed)
    verts = rng.normal(size=(b, nv, 3)).astype(np.float32) * 0.3
    faces = np.stack([[rng.choice(nv, 3, replace=False) for _ in range(nf)]
                      for _ in range(b)]).astype(np.int32)
    pts = rng.normal(size=(b, n_pts, 3)).astype(np.float32) * 0.3
    fmask = np.ones((b, nf), bool)
    fmask[1, -7:] = False
    pmask = np.ones((b, n_pts), bool)
    pmask[0, -5:] = False
    return verts, faces, pts, fmask, pmask


@pytest.mark.parametrize("k", [4, 16])
def test_point_mesh_topk_matches_jax(k):
    verts, faces, pts, fmask, pmask = _mesh_problem(11)
    v, p = _t(verts).requires_grad_(), _t(pts).requires_grad_()
    got = tpm.point_mesh_face_distance_topk(v, _t(faces), p, _t(pmask),
                                            _t(fmask), k=k, chunk=16)
    got.sum().backward()
    fn = jax.jit(jax.value_and_grad(
        lambda a, c, f, pm, fm: jpm.point_mesh_face_distance_topk(
            a, f, c, pm, fm, k=k, chunk=16), argnums=(0, 1)))
    for i in range(2):
        ref, (gv, gp) = fn(*(jnp.asarray(x[i]) for x in
                             (verts, pts, faces, pmask, fmask)))
        np.testing.assert_allclose(float(got[i]), float(ref), rtol=1e-5)
        for mine, theirs in ((v.grad[i], gv), (p.grad[i], gp)):
            theirs = np.asarray(theirs)
            assert (np.abs(mine.numpy() - theirs).max()
                    <= 1e-5 * np.abs(theirs).max())


def test_point_mesh_topk_is_exact_with_every_candidate():
    """k at least the faces and the points: the exact loss."""
    verts, faces, pts, fmask, pmask = _mesh_problem(12, nf=40, n_pts=30)
    args = (_t(verts), _t(faces), _t(pts), _t(pmask), _t(fmask))
    topk = tpm.point_mesh_face_distance_topk(*args, k=40)
    exact = tpm.point_mesh_face_distance_fast(*args)
    np.testing.assert_allclose(topk.numpy(), exact.numpy(), rtol=1e-6)


def test_render_points_soft_matches_jax():
    rng = np.random.default_rng(13)
    pts = np.concatenate([rng.uniform(0, 96, (300, 2)),
                          rng.uniform(0.5, 3.0, (300, 1))], -1).astype(np.float32)
    pts[::17, 2] = 1e-4                                # behind znear
    pts[5] = pts[4]                                    # a tie in z
    cols = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    pmask = rng.random(300) > 0.1
    rgb, alpha = tr.render_points_soft(_t(pts)[None], (64, 96), radius_px=2.5,
                                       colors=_t(cols)[None],
                                       points_mask=_t(pmask)[None], chunk=64)
    rj, aj = jr.render_points_soft(jnp.asarray(pts), (64, 96), radius_px=2.5,
                                   colors=jnp.asarray(cols),
                                   points_mask=jnp.asarray(pmask), chunk=64)
    np.testing.assert_allclose(rgb[0].numpy(), np.asarray(rj), atol=1e-6)
    np.testing.assert_allclose(alpha[0].numpy(), np.asarray(aj), atol=1e-5)
    assert float(aj.max()) > 0.5
    # default colours
    rgb, alpha = tr.render_points_soft(_t(pts)[None], (64, 96))
    rj, aj = jr.render_points_soft(jnp.asarray(pts), (64, 96))
    np.testing.assert_allclose(rgb[0].numpy(), np.asarray(rj), atol=1e-6)
    np.testing.assert_allclose(alpha[0].numpy(), np.asarray(aj), atol=1e-5)


def test_pixel_rays_world_matches_jax():
    from regen3d_tpu.camera import lookat_camera as jlookat
    from regen3d_tpu_torch.camera import lookat_camera

    eye, target = [0.4, 1.3, -0.7], [0.1, 0.0, 2.0]
    jc = jlookat(np.asarray(eye), np.asarray(target), (48, 80), 60.0)
    tc = lookat_camera(eye, target, (48, 80), 60.0, device="cpu")
    yy, xx = np.meshgrid(np.arange(48) + 0.5, np.arange(80) + 0.5,
                         indexing="ij")
    ref = np.asarray(jc.pixel_rays_world(jnp.asarray(xx, jnp.float32),
                                         jnp.asarray(yy, jnp.float32)))
    got = tc.pixel_rays_world(_t(xx.astype(np.float32)),
                              _t(yy.astype(np.float32)))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)


BINNED = dict(image_hw=(64, 64), sigma=1e-4, max_iterations=3,
              early_stop_min_iters=3, record_history=True,
              use_binned_raster=True, bin_tile=32, faces_per_tile=64)
FITS = {"binned": BINNED,
        "pm_topk": dict(BINNED, use_binned_raster=False, pm_topk=8,
                        point_chunk=24)}


@pytest.mark.parametrize("w_sil", [0.1, 0.0])
@pytest.mark.parametrize("case", sorted(FITS))
def test_fit_leftovers_match_jax(case, w_sil):
    cfg = dict(FITS[case], w_sil=w_sil)
    rj, rt, _, port_path = _run_both(cfg)
    jcfg = jpf.FitConfig(**cfg)
    jax_binned = jcfg.use_binned_raster and jpf._binned_budget_ok(jcfg, 64)
    assert port_path == ("binned" if jax_binned else "streaming")
    assert port_path == ("binned" if case == "binned" else "streaming")
    if w_sil:
        _check(rj, rt, atol=5e-3, rtol=2e-3)
    else:
        _check(rj, rt, atol=1e-6, rtol=1e-5)


# the port's soft silhouettes against the numpy transcription of pytorch3d
SIGMAS = [1e-4, 1e-5]


def _oracle_alpha(path, verts, faces, img_hw, sigma, faces_mask=None):
    v, f = _t(verts)[None], _t(faces)[None]
    m = None if faces_mask is None else _t(faces_mask)[None]
    if path == "streaming":
        out = tr.soft_silhouette(v, f, img_hw, sigma=sigma, faces_mask=m)
    elif path == "binned":
        out = tr.soft_silhouette_binned(v, f, img_hw, sigma=sigma,
                                        faces_mask=m, tile=16,
                                        faces_per_tile=len(faces))
    else:
        out = tr.soft_silhouette_edge(v, f, img_hw, sigma=sigma,
                                      faces_mask=m, tile=16)
    return out[0].numpy()


@pytest.mark.parametrize("path", ["streaming", "binned"])
@pytest.mark.parametrize("sigma", SIGMAS)
@pytest.mark.parametrize("seed", [0, 1])
def test_exact_silhouettes_match_pytorch3d_oracle(path, sigma, seed):
    img_hw = (48, 64)
    verts, faces = _random_scene(seed, 12, img_hw)
    ours = _oracle_alpha(path, verts, faces, img_hw, sigma)
    oracle = pytorch3d_soft_silhouette_oracle(verts, faces, img_hw,
                                              sigma=sigma)
    assert oracle.max() > 0.5
    assert np.abs(ours - oracle).max() < 5e-3


@pytest.mark.parametrize("path", ["streaming", "binned"])
def test_masked_and_culled_faces_match_pytorch3d_oracle(path):
    img_hw = (48, 64)
    verts, faces = _random_scene(3, 8, img_hw)
    keep = np.ones(len(faces), bool)
    keep[::2] = False
    ours = _oracle_alpha(path, verts, faces, img_hw, 1e-4, keep)
    oracle = pytorch3d_soft_silhouette_oracle(verts, faces[keep], img_hw,
                                              sigma=1e-4)
    assert np.abs(ours - oracle).max() < 5e-3
    img_hw = (32, 32)
    verts, faces = _random_scene(4, 6, img_hw)
    verts = verts.copy()
    verts[faces[0], 2] = 1e-4                 # the first face before znear
    ours = _oracle_alpha(path, verts, faces, img_hw, 1e-4)
    oracle = pytorch3d_soft_silhouette_oracle(verts, faces, img_hw, sigma=1e-4)
    assert np.abs(ours - oracle).max() < 5e-3


@pytest.mark.parametrize("sigma", SIGMAS)
def test_edge_silhouette_tracks_pytorch3d_oracle(sigma):
    """The min-edge-line formulation: coverage agrees but for corner halos,
    interiors match, the exterior's halo is small on average."""
    img_hw = (48, 64)
    verts, faces = _random_scene(7, 12, img_hw)
    ours = _oracle_alpha("edge", verts, faces, img_hw, sigma)
    oracle = pytorch3d_soft_silhouette_oracle(verts, faces, img_hw,
                                              sigma=sigma)
    assert np.mean((ours > 0.5) != (oracle > 0.5)) < 0.02
    inside = oracle > 0.999
    assert inside.any() and np.abs(ours - oracle)[inside].max() < 5e-2
    outside = oracle < 1e-3
    assert np.abs(ours - oracle)[outside].mean() < 0.02
