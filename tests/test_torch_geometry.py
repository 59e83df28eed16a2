"""Port rotations, camera and pose-fit losses vs the JAX package, values and
gradients, f32 on both sides (rtol 1e-5 / atol 1e-6: elementwise math in
the same order, so only last-bit differences; loss gradients atol 1e-5,
where 1/p at the clip bound scales those bits up)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regen3d_tpu import camera as jcam
from regen3d_tpu.ops import losses as jlo
from regen3d_tpu.transforms import rotations as jrot
from regen3d_tpu_torch import camera as tcam
from regen3d_tpu_torch.ops import losses as tlo
from regen3d_tpu_torch.transforms import rotations as trot
from test_torch_package import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["so3_exp", "yaw_rotation", "quat_to_matrix"])
def test_rotations_and_their_gradients(name):
    rng = np.random.default_rng(0)
    shape = {"so3_exp": (5, 3), "yaw_rotation": (5,), "quat_to_matrix": (5, 4)}
    x = rng.normal(size=shape[name]).astype(np.float32)
    if name == "so3_exp":
        x[0] = 0.0                      # the identity, where the fit starts
    w = rng.normal(size=(5, 3, 3)).astype(np.float32)
    jf, tf = getattr(jrot, name), getattr(trot, name)
    want, g_want = jax.value_and_grad(
        lambda a: jnp.sum(jf(a) * w))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = (tf(xt) * torch.from_numpy(w)).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(tf(torch.from_numpy(x)).numpy(),
                               np.asarray(jf(jnp.asarray(x))), **TOL)
    assert np.isfinite(xt.grad.numpy()).all()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_want), **TOL)


def test_camera_projection_and_rescale():
    rng = np.random.default_rng(1)
    R = np.array(jrot.so3_exp(jnp.asarray([0.1, -0.3, 0.2])))
    T = np.asarray([0.2, -0.1, 0.5], np.float32)
    kw = dict(focal=[300.0, 320.0], principal=[130.0, 120.0])
    jc = jcam.Camera(R=jnp.asarray(R), T=jnp.asarray(T),
                     focal=jnp.asarray(kw["focal"]),
                     principal=jnp.asarray(kw["principal"]),
                     image_size=(240, 256))
    tc = tcam.Camera(R=torch.from_numpy(R), T=torch.from_numpy(T),
                     focal=torch.tensor(kw["focal"]),
                     principal=torch.tensor(kw["principal"]),
                     image_size=(240, 256))
    pts = (rng.normal(size=(50, 3)) + [0, 0, 4]).astype(np.float32)
    for a, b in ((jc, tc), (jc.rescaled(120, 128), tc.rescaled(120, 128))):
        want = a.view_to_screen(a.world_to_view(jnp.asarray(pts)))
        got = b.view_to_screen(b.world_to_view(torch.from_numpy(pts)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert b.image_size == a.image_size


@pytest.mark.parametrize("use_focal", [False, True])
def test_silhouette_loss_and_gradient_at_the_clip_bounds(use_focal):
    rng = np.random.default_rng(2)
    pred = rng.random((2, 8, 8)).astype(np.float32)
    pred[:, 0] = 1.0
    pred[:, -1] = 0.0
    # saturated alphas land exactly on the clip bounds, where jnp.clip
    # splits the gradient and torch.clamp would pass all of it
    pred[:, 1] = np.float32(1.0 - 1e-7)
    pred[:, -2] = np.float32(1e-7)
    target = (rng.random((2, 8, 8)) > 0.5).astype(np.float32)
    pt = torch.from_numpy(pred).requires_grad_()
    got = tlo.silhouette_loss(pt, torch.from_numpy(target), use_focal)
    got.sum().backward()
    for b in range(2):
        val, g = jax.value_and_grad(
            lambda p: jlo.silhouette_loss(p, jnp.asarray(target[b]), use_focal)
        )(jnp.asarray(pred[b]))
        np.testing.assert_allclose(got[b].item(), float(val), **TOL)
        np.testing.assert_allclose(pt.grad[b].numpy(), np.asarray(g),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_bbox_hinge_loss(masked):
    rng = np.random.default_rng(3)
    verts = rng.normal(size=(2, 40, 3)).astype(np.float32) * 2
    mask = rng.random((2, 40)) > 0.3
    lo, hi = np.asarray([-1.0, -1.5, 0.0], np.float32), np.ones(3, np.float32)
    got = tlo.bbox_hinge_loss(torch.from_numpy(verts), torch.from_numpy(lo),
                              torch.from_numpy(hi),
                              torch.from_numpy(mask) if masked else None)
    for b in range(2):
        want = jlo.bbox_hinge_loss(jnp.asarray(verts[b]), jnp.asarray(lo),
                                   jnp.asarray(hi),
                                   jnp.asarray(mask[b]) if masked else None)
        np.testing.assert_allclose(got[b].item(), float(want), **TOL)
