"""Phase-5/6 geometry of the port against the JAX package on the same numpy
inputs: kNN and Chamfer (values, indices and the custom backward), the yaw
grid search, OBB and AABB, plane fits (RANSAC on JAX's own draw, with a tie
in the inlier count), the point filters, normals, the hard rasterizer and
Phong shading, rigid transforms, conventions and the camera, and the plain
edge silhouette at a non-square size.

Tolerances (f32 on both sides): distances, gradients, boxes and transforms
within 1e-6 (a few ulp: the two sum the same terms in other orders), kNN
distances within 1e-6 of |x|² + |y|² (the magnitude the expansion cancels);
plane normals and per-point normals within 1e-5 (eigenvectors from two
LAPACK builds); barycentrics, Phong colours and relative depth within 1e-5
(1/Σ(b/z) over rounded edge functions); indices, masks, face ids and angles
equal. The data keep eigenvalues apart by far more than 1%, and
distances off ties, except where a test is about the tie.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regen3d_tpu import camera as jcam
from regen3d_tpu.ops import filters as jf
from regen3d_tpu.ops import knn as jk
from regen3d_tpu.ops import obb as jo
from regen3d_tpu.ops import plane as jp
from regen3d_tpu.ops import rasterize as jr
from regen3d_tpu.pipeline import pose_fit as jpf
from regen3d_tpu.transforms import conventions as jconv
from regen3d_tpu.transforms import rigid as jrig
from regen3d_tpu_torch import camera as tcam
from regen3d_tpu_torch.ops import filters as tf
from regen3d_tpu_torch.ops import knn as tk
from regen3d_tpu_torch.ops import obb as to
from regen3d_tpu_torch.ops import plane as tp
from regen3d_tpu_torch.ops import rasterize as tr
from regen3d_tpu_torch.pipeline import pose_fit as tpf
from regen3d_tpu_torch.transforms import conventions as tconv
from regen3d_tpu_torch.transforms import rigid as trig
from test_torch_package import one_torch_thread  # noqa: F401


def _t(x):
    return torch.from_numpy(np.array(x))


def _clouds(seed, n=300, m=257):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    y = (rng.normal(size=(m, 3)) * [1.0, 0.5, 2.0] + 0.3).astype(np.float32)
    return rng, x, y


@pytest.mark.parametrize("masked", [False, True])
def test_nn_distances_values_indices_and_both_gradients(masked):
    rng, x, y = _clouds(0)
    xm = rng.random(len(x)) > 0.2 if masked else None
    ym = rng.random(len(y)) > 0.3 if masked else None
    g = rng.normal(size=len(x)).astype(np.float32)

    def jloss(x_, y_):
        d, _ = jk.nn_distances(x_, y_, None if xm is None else jnp.asarray(xm),
                               None if ym is None else jnp.asarray(ym), 100)
        return jnp.sum(d * g)

    dj, ij = jk.nn_distances(jnp.asarray(x), jnp.asarray(y),
                             None if xm is None else jnp.asarray(xm),
                             None if ym is None else jnp.asarray(ym), 100)
    gxj, gyj = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    xt, yt = _t(x).requires_grad_(), _t(y).requires_grad_()
    dt, it = tk.nn_distances(xt, yt, None if xm is None else _t(xm),
                             None if ym is None else _t(ym), 100)
    (dt * _t(g)).sum().backward()
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.detach().numpy(), np.asarray(dj), atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gxj), atol=1e-6)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(gyj), atol=1e-6)


def test_nn_ties_go_to_the_lowest_index_across_chunks():
    x = np.zeros((4, 3), np.float32)
    # equal distance 1 at indices 1, 5 and 9 (chunks of 4): index 1 wins
    y = np.full((12, 3), 5.0, np.float32)
    y[[1, 5, 9]] = [[1, 0, 0], [0, 1, 0], [0, 0, 1]]
    _, ij = jk.nn_distances(jnp.asarray(x), jnp.asarray(y), chunk=4)
    _, it = tk.nn_distances(_t(x), _t(y), chunk=4)
    assert it.tolist() == np.asarray(ij).tolist() == [1] * 4


def test_knn_points_and_chamfer_loss():
    rng, x, y = _clouds(1)
    ym = rng.random(len(y)) > 0.25
    # duplicated targets: equal distances, the lower index first
    y[200:210] = y[100:110]
    dj, ij = jk.knn_points(jnp.asarray(x), jnp.asarray(y), 7,
                           y_mask=jnp.asarray(ym), chunk=64)
    dt, it = tk.knn_points(_t(x), _t(y), 7, y_mask=_t(ym), chunk=64)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    # the expansion cancels |x|² + |y|² down to the distance: both round
    # within a few ulp of that magnitude, not of the distance
    mag = (x * x).sum(-1)[:, None] + (y * y).sum(-1)[np.asarray(ij)]
    assert (np.abs(dt.numpy() - np.asarray(dj)) <= 1e-6 * mag).all()
    xm = rng.random(len(x)) > 0.1
    lj = jk.chamfer_loss(jnp.asarray(x), jnp.asarray(y), jnp.asarray(xm),
                         jnp.asarray(ym), 128)
    lt = tk.chamfer_loss(_t(x), _t(y), _t(xm), _t(ym), 128)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)


@pytest.mark.parametrize("true_yaw", [0.0, 2.4, 4.0])
def test_find_best_initial_yaw_same_angle(true_yaw):
    """An asymmetric shape (an L of points) rotated by ``true_yaw``: both
    searches pick the same candidate, the one nearest the truth."""
    rng = np.random.default_rng(2)
    arm1 = np.stack([rng.uniform(0, 0.6, 200), rng.uniform(0, 0.4, 200),
                     rng.uniform(0, 0.1, 200)], -1)
    arm2 = np.stack([rng.uniform(0, 0.1, 120), rng.uniform(0, 0.4, 120),
                     rng.uniform(0, 0.3, 120)], -1)
    verts = np.concatenate([arm1, arm2]).astype(np.float32)
    verts -= verts.mean(0)
    c, s = np.cos(true_yaw), np.sin(true_yaw)
    R = np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    target = (verts[::2] @ R + rng.normal(size=(160, 3)) * 0.005
              ).astype(np.float32)
    aj = float(jax.jit(jpf.find_best_initial_yaw, static_argnames=(
        "num_steps", "chunk"))(jnp.asarray(verts), jnp.asarray(target),
                               num_steps=8, chunk=64))
    at = float(tpf.find_best_initial_yaw(_t(verts), _t(target), num_steps=8,
                                         chunk=64))
    assert at == aj
    err = (at - true_yaw + np.pi) % (2 * np.pi) - np.pi
    assert abs(err) <= np.pi / 8 + 1e-6


@pytest.mark.parametrize("masked", [False, True])
def test_obb_and_aabb(masked):
    rng = np.random.default_rng(3)
    pts = (rng.uniform(-1, 1, (400, 3)) * [0.8, 0.5, 0.3]).astype(np.float32)
    a = 0.7
    R = np.asarray([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                    [-np.sin(a), 0, np.cos(a)]], np.float32)
    pts = pts @ R + np.asarray([0.5, -0.2, 3.0], np.float32)
    m = rng.random(400) > 0.3 if masked else None
    bj = jax.jit(jo.oriented_bounding_box_2d_up)(
        jnp.asarray(pts), None if m is None else jnp.asarray(m))
    bt = to.oriented_bounding_box_2d_up(_t(pts), None if m is None else _t(m))
    for name in ("center", "axes", "half_extents"):
        np.testing.assert_allclose(getattr(bt, name).numpy(),
                                   np.asarray(getattr(bj, name)), atol=1e-6)
    np.testing.assert_allclose(float(bt.volume), float(bj.volume), rtol=1e-6)
    np.testing.assert_allclose(bt.corners().numpy(), np.asarray(bj.corners()),
                               atol=1e-6)
    for lt, lj in zip(to.aabb(_t(pts), None if m is None else _t(m), pad=0.1),
                      jo.aabb(jnp.asarray(pts),
                              None if m is None else jnp.asarray(m), pad=0.1)):
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-6)


def test_square_footprint_obb_tie_diverges():
    """ROADMAP Queue 3 r: for a square footprint the 2×2 covariance has two
    equal eigenvalues, so every direction is a major axis. A stretch of
    1e-4 along x or along the diagonal picks the axis, and with it a box
    twice as large, in both packages alike: an eigen solver that breaks the
    exact tie the other way (LAPACK against cuSOLVER) moves ``volume``, the
    phase-6 scale init, by up to 2^(1/3)."""
    g = np.linspace(-0.5, 0.5, 21)
    gx, gz = np.meshgrid(g, g)
    base = np.stack([gx.ravel(), np.zeros(gx.size), gz.ravel()], -1)
    base = np.concatenate([base, base + [0, 0.4, 0]]).astype(np.float32)
    cov = np.cov(base[:, [0, 2]].T)
    assert abs(cov[0, 0] - cov[1, 1]) < 1e-6 and abs(cov[0, 1]) < 1e-6
    vols = {}
    for name, axis in (("x", [1.0, 0.0]), ("diag", [0.7071, 0.7071])):
        d = np.asarray([axis[0], 0, axis[1]], np.float32)
        stretched = (base + 1e-4 * (base @ d)[:, None] * d).astype(np.float32)
        vj = float(jo.oriented_bounding_box_2d_up(jnp.asarray(stretched)).volume)
        vt = float(to.oriented_bounding_box_2d_up(_t(stretched)).volume)
        np.testing.assert_allclose(vt, vj, rtol=1e-5)
        vols[name] = vt
    np.testing.assert_allclose(vols["diag"] / vols["x"], 2.0, rtol=1e-2)


def test_plane_frame_is_left_handed_in_both_packages():
    """ROADMAP Queue 3 s: plane_transforms stacks the columns (t1, n, t2)
    with t1 = helper × n and t2 = n × t1, so t1 × n = −t2: the world →
    plane basis has det −1 in both packages. Phase 6 fits on-floor objects
    in that frame and exports x @ p2w.R, so an on-floor object's fitted
    mesh is the mirror image of its asset (a mirror-symmetric asset, as
    most furniture is, comes out as itself, its vertices swapped with their
    mirror partners)."""
    n = np.asarray([0.02, 0.999, -0.03], np.float32)
    n /= np.linalg.norm(n)
    c = np.asarray([0.1, -1.2, 3.0], np.float32)
    pj = jp.Plane(jnp.asarray(n), jnp.asarray(-(n @ c)), jnp.asarray(c))
    pt = tp.Plane(_t(n), torch.tensor(-(n @ c)), _t(c))
    (wj, vj), (wt, vt) = jp.plane_transforms(pj), tp.plane_transforms(pt)
    np.testing.assert_allclose(wt.R.numpy(), np.asarray(wj.R), atol=1e-6)
    np.testing.assert_allclose(vt.R.numpy(), np.asarray(vj.R), atol=1e-6)
    assert np.linalg.det(np.asarray(wj.R)) == pytest.approx(-1.0, abs=1e-5)
    assert float(torch.linalg.det(wt.R)) == pytest.approx(-1.0, abs=1e-5)
    # the normal maps to +y and the centroid to the origin, as intended
    np.testing.assert_allclose(wt.apply(_t(c + n)).numpy(), [0, 1, 0], atol=1e-5)


def _floor(seed, n=500):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2, 2, n), rng.normal(0, 0.01, n) - 0.3,
                    rng.uniform(1, 4, n)], -1)
    tilt = 0.1
    R = np.asarray([[1, 0, 0], [0, np.cos(tilt), np.sin(tilt)],
                    [0, -np.sin(tilt), np.cos(tilt)]])
    outl = rng.uniform(-2, 2, (80, 3)) + [0, 1.0, 2.5]
    return np.concatenate([pts @ R, outl]).astype(np.float32)


def _plane_close(pt, pj, atol):
    np.testing.assert_allclose(pt.normal.numpy(), np.asarray(pj.normal), atol=atol)
    np.testing.assert_allclose(float(pt.offset), float(pj.offset), atol=atol)
    np.testing.assert_allclose(pt.centroid.numpy(), np.asarray(pj.centroid),
                               atol=atol)


def test_fit_plane_svd_and_ransac_on_the_jax_draw():
    pts = _floor(4)
    up = np.asarray([0.0, 1.0, 0.0], np.float32)
    _plane_close(tp.fit_plane_svd(_t(pts), up_hint=_t(up)),
                 jax.jit(jp.fit_plane_svd)(jnp.asarray(pts),
                                           up_hint=jnp.asarray(up)), 1e-5)
    key = jax.random.PRNGKey(1234567)
    idx = np.asarray(jax.random.randint(key, (300, 3), 0, len(pts)))
    pj, mj = jax.jit(jp.fit_plane_ransac, static_argnames=(
        "num_iters", "threshold"))(jnp.asarray(pts), key, num_iters=300,
                                   threshold=0.05, up_hint=jnp.asarray(up))
    pt, mt = tp.fit_plane_ransac(_t(pts), num_iters=300, threshold=0.05,
                                 up_hint=_t(up), idx=_t(idx))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    _plane_close(pt, pj, 1e-5)
    # the port's own draw from a seeded generator is repeatable
    gen = lambda: torch.Generator().manual_seed(1234567)
    a, _ = tp.fit_plane_ransac(_t(pts), gen(), num_iters=300, up_hint=_t(up))
    b, _ = tp.fit_plane_ransac(_t(pts), gen(), num_iters=300, up_hint=_t(up))
    assert torch.equal(a.normal, b.normal)
    for wt, wj in zip(tp.plane_transforms(pt),
                      jax.jit(jp.plane_transforms)(pj)):
        for f in ("R", "t", "s"):
            np.testing.assert_allclose(getattr(wt, f).numpy(),
                                       np.asarray(getattr(wj, f)), atol=1e-5)


def test_ransac_tie_in_inlier_count_takes_the_first_hypothesis():
    """Two disjoint planes of 60 points each: hypothesis 0 lies on the
    vertical one, hypothesis 1 on the floor, with equal inlier counts. Both
    take hypothesis 0 (first maximum), then refit on its inliers."""
    rng = np.random.default_rng(5)
    floor = np.stack([rng.uniform(0, 1, 60), np.zeros(60),
                      rng.uniform(0, 1, 60)], -1)
    wall = np.stack([rng.uniform(0, 1, 60), rng.uniform(1, 2, 60),
                     np.full(60, 5.0)], -1)
    pts = np.concatenate([floor, wall]).astype(np.float32)
    idx = np.asarray([[60, 61, 62], [0, 1, 2]], np.int32)
    key = jax.random.PRNGKey(0)
    # JAX's fit draws its own indices: run its scoring on ours instead
    tri = jnp.asarray(pts)[idx]
    n = jnp.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n = n / jnp.linalg.norm(n, axis=-1, keepdims=True)
    d = -jnp.sum(n * tri[:, 0], -1)
    counts = (jnp.abs(jnp.asarray(pts) @ n.T + d) < 0.05).sum(0)
    assert counts[0] == counts[1] == 60 and int(jnp.argmax(counts)) == 0
    pt, mt = tp.fit_plane_ransac(_t(pts), num_iters=2, idx=_t(idx))
    assert mt[60:].all() and not mt[:60].any()
    np.testing.assert_allclose(pt.normal.abs().numpy(), [0, 0, 1], atol=1e-6)
    del key


@pytest.mark.parametrize("masked", [False, True])
def test_quantile_and_dbscan_masks_equal(masked):
    rng = np.random.default_rng(6)
    blob = rng.normal(size=(150, 3)) * 0.05
    far = rng.normal(size=(40, 3)) * 0.05 + [1.0, 0, 0]
    noise = rng.uniform(-2, 2, (15, 3))
    pts = np.concatenate([blob, far, noise]).astype(np.float32)
    m = rng.random(len(pts)) > 0.1 if masked else None
    jm, tm = (None, None) if m is None else (jnp.asarray(m), _t(m))
    np.testing.assert_array_equal(
        tf.quantile_filter(_t(pts), 0.02, tm).numpy(),
        np.asarray(jf.quantile_filter(jnp.asarray(pts), 0.02, jm)))
    kj = np.asarray(jax.jit(jf.dbscan_largest_cluster, static_argnames=(
        "eps", "min_points", "chunk"))(jnp.asarray(pts), eps=0.1, min_points=10,
                                       mask=jm, chunk=64))
    kt = tf.dbscan_largest_cluster(_t(pts), 0.1, 10, tm, chunk=64).numpy()
    np.testing.assert_array_equal(kt, kj)
    assert 100 < kt.sum() <= 150


def test_estimate_normals():
    rng = np.random.default_rng(7)
    u, v = rng.uniform(-1, 1, (2, 400))
    pts = np.stack([u, 0.3 * np.sin(2 * u) + 0.2 * v * v, v + 3], -1)
    pts = (pts + rng.normal(size=pts.shape) * 0.003).astype(np.float32)
    vp = np.asarray([0.1, 2.0, 0.0], np.float32)
    nj = jf.estimate_normals(jnp.asarray(pts), k=12, viewpoint=jnp.asarray(vp),
                             chunk=128)
    nt = tf.estimate_normals(_t(pts), k=12, viewpoint=_t(vp), chunk=128)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), atol=1e-5)
    assert ((nt.numpy() * (vp - pts)).sum(-1) >= 0).all()


HW = (40, 56)


def _scene(seed, b=2, nf=30, size=0.15):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(b, nf, 3, 3)).astype(np.float32) * size
    v += rng.uniform(-0.6, 0.6, size=(b, nf, 1, 3)).astype(np.float32)
    v += np.asarray([0, 0, 3.0], np.float32)
    v = v.reshape(b, -1, 3)
    f = np.tile(np.arange(nf * 3, dtype=np.int32).reshape(-1, 3), (b, 1, 1))
    mask = rng.random((b, nf)) > 0.15
    return v, f, mask


def _cams(hw=HW):
    h, w = hw
    args = dict(focal=[60.0, 60.0], principal=[w / 2, h / 2])
    jc = jcam.Camera(R=jnp.eye(3), T=jnp.zeros(3),
                     focal=jnp.asarray(args["focal"]),
                     principal=jnp.asarray(args["principal"]), image_size=hw)
    tc = tcam.Camera(R=torch.eye(3), T=torch.zeros(3),
                     focal=torch.tensor(args["focal"]),
                     principal=torch.tensor(args["principal"]), image_size=hw)
    return jc, tc


def test_rasterize_hard_and_phong_shade():
    v, f, mask = _scene(8, size=0.4)
    jc, tc = _cams()
    vs = np.stack([np.asarray(jc.view_to_screen(jnp.asarray(x))) for x in v])
    frag_t = tr.rasterize_hard(_t(vs), _t(f), HW, faces_mask=_t(mask), chunk=16)
    rng = np.random.default_rng(9)
    nrm = rng.normal(size=v.shape).astype(np.float32)
    col = rng.uniform(0.2, 0.9, v.shape).astype(np.float32)
    light = np.asarray([0.3, 2.0, 0.0], np.float32)
    img_t = tr.phong_shade(frag_t, _t(f), _t(v), _t(nrm), _t(col), _t(light),
                           torch.zeros(3))
    phong = jax.jit(jr.phong_shade)
    for b in range(len(v)):
        fj = jr._rasterize_hard_jit(jnp.asarray(vs[b]), jnp.asarray(f[b]), HW,
                                    faces_mask=jnp.asarray(mask[b]), chunk=16)
        np.testing.assert_array_equal(frag_t.face_idx[b].numpy(),
                                      np.asarray(fj.face_idx))
        np.testing.assert_allclose(frag_t.bary[b].numpy(), np.asarray(fj.bary),
                                   atol=1e-5)
        np.testing.assert_allclose(frag_t.depth[b].numpy(), np.asarray(fj.depth),
                                   rtol=1e-5)
        ij = phong(fj, jnp.asarray(f[b]), jnp.asarray(v[b]),
                            jnp.asarray(nrm[b]), jnp.asarray(col[b]),
                            jnp.asarray(light), jnp.zeros(3))
        np.testing.assert_allclose(img_t[b].numpy(), np.asarray(ij), atol=1e-5)
        assert (frag_t.face_idx[b] >= 0).float().mean() > 0.2


def test_plain_edge_path_matches_jax_at_a_non_square_size():
    """The phase-6 edge path at 64 × 96 (H ≠ W, NDC scaled by the shorter
    side), tiles of 32: alpha within 1e-5 at σ = 1e-4."""
    hw = (64, 96)
    v, f, mask = _scene(10, nf=40)
    jc, _ = _cams(hw)
    vs = np.stack([np.asarray(jc.view_to_screen(jnp.asarray(x))) for x in v])
    got = tr.soft_silhouette_edge(_t(vs), _t(f), hw, sigma=1e-4,
                                  faces_mask=_t(mask), tile=32,
                                  faces_per_tile=40)
    for b in range(len(v)):
        # eager, as the other edge-path tests hold it: XLA's fusions under
        # jit round the edge coefficients another way
        want = jr.soft_silhouette_edge(jnp.asarray(vs[b]), jnp.asarray(f[b]),
                                       hw, sigma=1e-4,
                                       faces_mask=jnp.asarray(mask[b]),
                                       tile=32, faces_per_tile=40)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want), atol=1e-5)
        assert float(got[b].max()) > 0.5


def test_rigid_transforms_and_solvers():
    rng = np.random.default_rng(11)
    src = rng.normal(size=(50, 3)).astype(np.float32)
    a = 0.4
    R = np.asarray([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                    [0, 0, 1]], np.float32)
    dst = (src @ R * 1.3 + [0.2, -0.1, 0.5]).astype(np.float32)
    w = rng.uniform(0.5, 1.0, 50).astype(np.float32)
    for ot, oj in zip(trig.umeyama(_t(src), _t(dst), _t(w)),
                      jax.jit(jrig.umeyama)(jnp.asarray(src), jnp.asarray(dst),
                                            jnp.asarray(w))):
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-5)
    for ot, oj in zip(trig.kabsch(_t(src), _t(dst)),
                      jax.jit(jrig.kabsch)(jnp.asarray(src), jnp.asarray(dst))):
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-5)
    tj = jrig.Transform3d(jnp.asarray(R), jnp.asarray([1.0, 2, 3]),
                          jnp.asarray(0.5))
    tt = trig.Transform3d(_t(R), torch.tensor([1.0, 2, 3]), torch.tensor(0.5))
    for got, want in ((tt.apply(_t(src)), tj.apply(jnp.asarray(src))),
                      (tt.inverse().compose(tt).as_matrix(),
                       tj.inverse().compose(tj).as_matrix())):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_array_equal(
        tconv.blender_points_reorder(_t(src)).numpy(),
        np.asarray(jconv.blender_points_reorder(jnp.asarray(src))))
    B = rng.normal(size=(4, 4))
    for x, y in zip(tconv.blender_to_p3d(B), jconv.blender_to_p3d(B)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(tconv.p3d_to_blender(R, [1.0, 2, 3]),
                                  jconv.p3d_to_blender(R, [1.0, 2, 3]))
    np.testing.assert_array_equal(tconv.vggt_raw_to_world(src, 2.0),
                                  jconv.vggt_raw_to_world(src, 2.0))


def test_camera_npz_and_projection(tmp_path):
    rng = np.random.default_rng(12)
    B = jconv.p3d_to_blender(np.eye(3) @ np.asarray(
        [[np.cos(0.2), 0, np.sin(0.2)], [0, 1, 0], [-np.sin(0.2), 0, np.cos(0.2)]]),
        np.asarray([0.1, -0.2, 0.3]))
    tcam.save_camera_npz(str(tmp_path / "t.npz"), B, 700.0, (1280, 960))
    jcam.save_camera_npz(str(tmp_path / "j.npz"), B, 700.0, (1280, 960))
    for k in ("extrinsic", "focal", "image_size", "camera_angle_x"):
        a, b = np.load(tmp_path / "t.npz")[k], np.load(tmp_path / "j.npz")[k]
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    ct = tcam.camera_from_npz(str(tmp_path / "t.npz"), (1024, 1344),
                              device="cpu")
    cj = jcam.camera_from_npz(str(tmp_path / "t.npz"), (1024, 1344))
    for f in ("R", "T", "focal", "principal"):
        np.testing.assert_array_equal(getattr(ct, f).numpy(),
                                      np.asarray(getattr(cj, f)))
    assert ct.image_size == cj.image_size == (1024, 1344)
    np.testing.assert_allclose(ct.center.numpy(), np.asarray(cj.center),
                               atol=1e-6)
    pts = (rng.normal(size=(40, 3)) + [0, 0, 4]).astype(np.float32)
    (uv_t, z_t), (uv_j, z_j) = ct.project(_t(pts)), cj.project(jnp.asarray(pts))
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), rtol=1e-6)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=1e-6)
    back = ct.unproject(uv_t, z_t)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(cj.unproject(uv_j, z_j)), atol=1e-5)
    np.testing.assert_allclose(back.numpy(), pts, atol=1e-4)
