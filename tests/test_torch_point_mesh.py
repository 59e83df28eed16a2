"""Port point↔mesh distance vs the JAX package: value and the argmin-pair
gradients, with and without masks. f32 on both sides; rtol 1e-5 on the
value and 1e-4 on gradients (sum order of the scattered pair gradients)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regen3d_tpu.ops import point_mesh as jpm
from regen3d_tpu_torch.ops import point_mesh as tpm
from test_torch_package import one_torch_thread  # noqa: F401


def _case(seed, b=2, nv=30, nf=50, n_pts=70):
    rng = np.random.default_rng(seed)
    verts = rng.normal(size=(b, nv, 3)).astype(np.float32) * 0.3
    faces = rng.integers(0, nv, (b, nf, 3)).astype(np.int32)
    pts = rng.normal(size=(b, n_pts, 3)).astype(np.float32) * 0.4
    pmask = rng.random((b, n_pts)) > 0.3
    fmask = rng.random((b, nf)) > 0.2
    return verts, faces, pts, pmask, fmask


def test_point_triangle_distance():
    rng = np.random.default_rng(0)
    p, a, b, c = (rng.normal(size=(500, 3)).astype(np.float32) for _ in range(4))
    want = np.asarray(jpm.point_triangle_distance(*map(jnp.asarray, (p, a, b, c))))
    got = tpm.point_triangle_distance(*map(torch.from_numpy, (p, a, b, c)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_point_mesh_face_distance_fast(masked):
    verts, faces, pts, pmask, fmask = _case(1)
    chunk = 16          # several chunks on both axes, a ragged last one
    vt = torch.from_numpy(verts).requires_grad_()
    pt = torch.from_numpy(pts).requires_grad_()
    loss_t = tpm.point_mesh_face_distance_fast(
        vt, torch.from_numpy(faces), pt,
        torch.from_numpy(pmask) if masked else None,
        torch.from_numpy(fmask) if masked else None, chunk)
    (loss_t * torch.tensor([1.0, 2.0])).sum().backward()
    for b, w in enumerate((1.0, 2.0)):
        def loss_j(v, p):
            return w * jpm.point_mesh_face_distance_fast(
                v, jnp.asarray(faces[b]), p,
                jnp.asarray(pmask[b]) if masked else None,
                jnp.asarray(fmask[b]) if masked else None, chunk)
        val, (gv, gp) = jax.value_and_grad(loss_j, argnums=(0, 1))(
            jnp.asarray(verts[b]), jnp.asarray(pts[b]))
        np.testing.assert_allclose(loss_t[b].item() * w, float(val), rtol=1e-5)
        np.testing.assert_allclose(vt.grad[b].numpy(), np.asarray(gv),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(pt.grad[b].numpy(), np.asarray(gp),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_point_mesh_face_distance_matches_jax(masked):
    """The JAX package's scan version (one object): the value within 1e-5,
    the gradients to the vertices and points within 1e-4, over several
    chunks with a ragged last one."""
    verts, faces, pts, pmask, fmask = _case(3)
    vt = torch.from_numpy(verts[0]).requires_grad_()
    pt = torch.from_numpy(pts[0]).requires_grad_()
    pm = pmask[0] if masked else None
    fm = fmask[0] if masked else None
    loss_t = tpm.point_mesh_face_distance(
        vt, torch.from_numpy(faces[0]), pt,
        None if pm is None else torch.from_numpy(pm),
        None if fm is None else torch.from_numpy(fm), 16)
    loss_t.backward()
    val, (gv, gp) = jax.value_and_grad(
        lambda v, p: jpm.point_mesh_face_distance(
            v, jnp.asarray(faces[0]), p,
            None if pm is None else jnp.asarray(pm),
            None if fm is None else jnp.asarray(fm), 16),
        argnums=(0, 1))(jnp.asarray(verts[0]), jnp.asarray(pts[0]))
    assert loss_t.shape == ()
    np.testing.assert_allclose(loss_t.item(), float(val), rtol=1e-5)
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(gv), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(gp), rtol=1e-4,
                               atol=1e-6)


def test_points_to_mesh_argmin_matches():
    verts, faces, pts, _, fmask = _case(2)
    d_t, i_t = tpm.points_to_mesh_distance(
        torch.from_numpy(pts), torch.from_numpy(verts), torch.from_numpy(faces),
        None, torch.from_numpy(fmask), 16)
    for b in range(2):
        d_j, i_j = jpm.points_to_mesh_distance(
            jnp.asarray(pts[b]), jnp.asarray(verts[b]), jnp.asarray(faces[b]),
            None, jnp.asarray(fmask[b]), 16)
        np.testing.assert_allclose(d_t[b].numpy(), np.asarray(d_j), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_array_equal(i_t[b].numpy(), np.asarray(i_j))


@pytest.mark.parametrize("shape", [(3,), ()])
def test_scatter_add_rows_is_index_add_in_a_fixed_order(shape):
    """The fixed-order scatter of the point-to-mesh, kNN and gather
    backwards (ROADMAP Queue 3 z): equal to ``index_add`` within f32
    rounding (on the CPU, bit for bit: both add each destination's rows in
    index order from the left), the same bits on a second call, and
    destinations without rows keep their base."""
    from regen3d_tpu_torch.ops import scatter_add_rows, take_rows

    rng = np.random.default_rng(3)
    base = torch.from_numpy(rng.normal(size=(40,) + shape).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 30, 500))       # 30..39 get none
    src = torch.from_numpy((rng.normal(size=(500,) + shape)
                            * 10.0 ** rng.integers(-4, 4, (500,) + shape))
                           .astype(np.float32))
    want = base.index_add(0, idx, src)
    got = scatter_add_rows(base, idx, src)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6 * float(want.abs().max()))
    assert torch.equal(got, want)
    assert torch.equal(scatter_add_rows(base, idx, src), got)
    assert torch.equal(got[30:], base[30:])
    # the gather whose backward it is
    x = base.clone().requires_grad_()
    g = torch.from_numpy(rng.normal(size=(500,) + shape).astype(np.float32))
    (gx,) = torch.autograd.grad(take_rows(x, idx), x, g)
    assert torch.equal(gx, torch.zeros_like(base).index_add(0, idx, g))
