"""Port silhouettes vs the JAX package: bins, edge coefficients, the edge
tile function (plain version of the CUDA kernels) against the Pallas kernel
in interpret mode, the plain edge path and the streaming SoftRas.

Tolerances: f32 on both sides. Alpha atol 1e-5 (sum order over faces);
vertex gradients rtol 1e-3 / atol 2e-6, the bound the JAX package holds its
own Pallas gradients to (tests/test_pallas_rasterize.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regen3d_tpu.camera import Camera as JCamera
from regen3d_tpu.ops import pallas_rasterize as jpr
from regen3d_tpu.ops import rasterize as jr
from regen3d_tpu_torch.camera import Camera
from regen3d_tpu_torch.ops import rasterize as tr
from regen3d_tpu_torch.ops import silhouette_kernel as tk
from test_torch_package import one_torch_thread  # noqa: F401

H = W = 128


def _cams():
    jc = JCamera(R=jnp.eye(3), T=jnp.zeros(3), focal=jnp.asarray([128.0, 128.0]),
                 principal=jnp.asarray([W / 2.0, H / 2.0]), image_size=(H, W))
    tc = Camera(R=torch.eye(3), T=torch.zeros(3),
                focal=torch.tensor([128.0, 128.0]),
                principal=torch.tensor([W / 2.0, H / 2.0]), image_size=(H, W))
    return jc, tc


def _meshes(seed, b=2, n_faces=48):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(b, n_faces, 3, 3)).astype(np.float32) * 0.08
    v += rng.uniform(-0.5, 0.5, size=(b, n_faces, 1, 3)).astype(np.float32)
    v += np.asarray([0, 0, 2.5], np.float32)
    f = np.tile(np.arange(n_faces * 3, dtype=np.int32).reshape(-1, 3), (b, 1, 1))
    mask = rng.random((b, n_faces)) > 0.2
    return v.reshape(b, -1, 3), f, mask


def _screen(v):
    """The same screen vertices for both sides: at sigma 1e-5 one ulp of a
    vertex moves alpha by ~1e-5, so the projection is held apart (the
    gradient tests below go through both cameras)."""
    jc, _ = _cams()
    vs = np.stack([np.asarray(jc.view_to_screen(jnp.asarray(x))) for x in v])
    return vs, torch.from_numpy(vs)


@pytest.mark.parametrize("faces_per_tile,margin", [(16, 0.0), (48, 8.0)])
def test_bins_identical_including_ties(faces_per_tile, margin):
    v, f, mask = _meshes(0)
    vs_j, vs_t = _screen(v)
    idx_t, val_t = tr.compute_silhouette_bins(
        vs_t, torch.from_numpy(f), (H, W), 1e-5, torch.from_numpy(mask),
        tile=32, faces_per_tile=faces_per_tile, margin_px=margin)
    for b in range(v.shape[0]):
        idx_j, val_j = jr.compute_silhouette_bins(
            jnp.asarray(vs_j[b]), jnp.asarray(f[b]), (H, W), 1e-5,
            jnp.asarray(mask[b]), tile=32, faces_per_tile=faces_per_tile,
            margin_px=margin)
        np.testing.assert_array_equal(idx_t[b].numpy(), np.asarray(idx_j))
        np.testing.assert_array_equal(val_t[b].numpy(), np.asarray(val_j))
        if faces_per_tile == 16:
            # some bin is full, so which overlapping faces it keeps
            # depends on the tie order
            assert np.asarray(val_j).all(axis=1).any()


def test_face_edge_coeffs():
    rng = np.random.default_rng(1)
    tri = rng.normal(size=(64, 3, 2)).astype(np.float32)
    tri[0, 1] = tri[0, 0]                      # a degenerate edge
    want = np.asarray(jr.face_edge_coeffs(jnp.asarray(tri)))
    got = tr.face_edge_coeffs(torch.from_numpy(tri)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


# At sigma 1e-5, z = d·|d|/σ amplifies the last-bit difference of an edge
# value (a small difference of O(1) terms, which XLA may contract into an
# FMA) to ~2e-5 in alpha at a few pixels; the JAX package holds its own
# kernel to 1e-4 there (tests/test_pallas_rasterize.py).
SIGMA_ATOL = [(1e-5, 1e-4), (1e-4, 1e-5)]


@pytest.mark.parametrize("sigma,atol", SIGMA_ATOL)
def test_tile_function_forward_vs_pallas(sigma, atol):
    v, f, mask = _meshes(2)
    vs_j, vs_t = _screen(v)
    got = tk.soft_silhouette_edge_kernel(
        vs_t, torch.from_numpy(f), (H, W), sigma=sigma,
        faces_mask=torch.from_numpy(mask), faces_per_tile=48)
    for b in range(v.shape[0]):
        want = jpr.soft_silhouette_edge_pallas(
            jnp.asarray(vs_j[b]), jnp.asarray(f[b]), (H, W), sigma=sigma,
            faces_mask=jnp.asarray(mask[b]), faces_per_tile=48, interpret=True)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want), atol=atol)
    assert got.min() >= 0 and got.max() > 0.5


def test_tile_function_gradients_vs_pallas():
    v, f, _ = _meshes(3, n_faces=24)
    jc, tc = _cams()

    def loss_j(x, b):
        return jnp.mean(jpr.soft_silhouette_edge_pallas(
            jc.view_to_screen(x), jnp.asarray(f[b]), (H, W), sigma=1e-4,
            faces_per_tile=24, interpret=True))

    vt = torch.from_numpy(v).requires_grad_()
    alpha = tk.soft_silhouette_edge_kernel(
        tc.view_to_screen(vt), torch.from_numpy(f), (H, W), sigma=1e-4,
        faces_per_tile=24)
    alpha.mean((1, 2)).sum().backward()
    for b in range(v.shape[0]):
        want = np.asarray(jax.grad(loss_j)(jnp.asarray(v[b]), b))
        np.testing.assert_allclose(vt.grad[b].numpy(), want, atol=2e-6,
                                   rtol=1e-3)


def test_plain_backward_routes_ties_left_to_right():
    """Equal edge values send the gradient to the first of them."""
    k = 8
    coeffs = torch.zeros(1, 3 * k, 3)
    coeffs[0, :, 2] = 0.01                    # three equal edges per face
    valid = torch.zeros(1, k)
    valid[0, 0] = 1.0
    nvalid = torch.tensor([1], dtype=torch.int32)
    uv = torch.zeros(1, 2)
    g = torch.ones(1, tk.P)
    dc = tk.silhouette_tiles_bwd(nvalid, coeffs, valid, uv, g, 1e4, 0.01)
    assert dc[0, 0, 2] != 0
    assert torch.all(dc[0, k] == 0) and torch.all(dc[0, 2 * k] == 0)
    assert torch.all(dc[0, 1:k] == 0)


@pytest.mark.parametrize("sigma,atol", SIGMA_ATOL)
def test_plain_edge_path_matches_jax(sigma, atol):
    v, f, mask = _meshes(4)
    vs_j, vs_t = _screen(v)
    got = tr.soft_silhouette_edge(vs_t, torch.from_numpy(f), (H, W),
                                  sigma=sigma, faces_mask=torch.from_numpy(mask),
                                  tile=32, faces_per_tile=48)
    for b in range(v.shape[0]):
        want = jr.soft_silhouette_edge(
            jnp.asarray(vs_j[b]), jnp.asarray(f[b]), (H, W), sigma=sigma,
            faces_mask=jnp.asarray(mask[b]), tile=32, faces_per_tile=48)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want), atol=atol)


def test_streaming_soft_silhouette_forward_and_gradient():
    hw = (40, 48)
    v, f, mask = _meshes(5, n_faces=20)
    jc = JCamera(R=jnp.eye(3), T=jnp.zeros(3), focal=jnp.asarray([40.0, 40.0]),
                 principal=jnp.asarray([24.0, 20.0]), image_size=hw)
    tc = Camera(R=torch.eye(3), T=torch.zeros(3), focal=torch.tensor([40.0, 40.0]),
                principal=torch.tensor([24.0, 20.0]), image_size=hw)
    target = (np.random.default_rng(6).random(hw) > 0.5).astype(np.float32)

    def loss_j(x, b):
        a = jr.soft_silhouette(jc.view_to_screen(x), jnp.asarray(f[b]), hw,
                               sigma=1e-4, faces_mask=jnp.asarray(mask[b]),
                               chunk=8)
        return jnp.sum(a * target), a

    vt = torch.from_numpy(v).requires_grad_()
    a_t = tr.soft_silhouette(tc.view_to_screen(vt), torch.from_numpy(f), hw,
                             sigma=1e-4, faces_mask=torch.from_numpy(mask),
                             chunk=8)
    (a_t * torch.from_numpy(target)).sum().backward()
    for b in range(v.shape[0]):
        (_, a_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(
            jnp.asarray(v[b]), b)
        np.testing.assert_allclose(a_t[b].detach().numpy(), np.asarray(a_j),
                                   atol=1e-5)
        np.testing.assert_allclose(vt.grad[b].numpy(), np.asarray(g_j),
                                   rtol=1e-3, atol=1e-4)
