"""Port scene_step vs the JAX package end to end on the tiny VGGT (f32,
weights carried by from_jax), mirroring tests/test_scene_step.py: depth and
cloud (rtol 1e-4), the bf16-quantised crop picking the same points, the
fitted params and posed vertices (one Adam step, atol 5e-3: see
test_torch_pose_fit.py), the coarse-fit leg, and numpy's nanmedian."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regen3d_tpu.models.vggt import VGGT as JVGGT, VGGTConfig as JConfig
from regen3d_tpu.pipeline.pose_fit import FitConfig as JFit
from regen3d_tpu.pipeline.scene_step import scene_step as jax_scene_step
from regen3d_tpu_torch.models.from_jax import load_from_jax
from regen3d_tpu_torch.models.vggt import VGGT, VGGTConfig
from regen3d_tpu_torch.pipeline.pose_fit import FitConfig
from regen3d_tpu_torch.pipeline.scene_step import nanmedian, scene_step
from test_torch_package import one_torch_thread  # noqa: F401


def _cube(side=0.3):
    v = np.asarray([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                    [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]],
                   np.float32) * side / 2
    f = np.asarray([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
                    [0, 1, 5], [0, 5, 4], [2, 3, 7], [2, 7, 6],
                    [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]], np.int32)
    return v, f


@pytest.fixture(scope="module")
def setup():
    jc = dataclasses.replace(JConfig.tiny(), dtype=jnp.float32)
    s = jc.image_size
    imgs = np.random.default_rng(0).random((2, s, s, 3)).astype(np.float32)
    jm = JVGGT(jc)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(imgs)[None])
    tm = VGGT(dataclasses.replace(VGGTConfig.tiny(), dtype=torch.float32),
              device="cpu")
    load_from_jax(tm, jax.device_get(params))
    masks = np.zeros((2, s, s), bool)
    masks[0, 2:12, 2:12] = True
    masks[1, 14:26, 14:26] = True
    v, f = _cube()
    mesh = dict(verts=np.stack([v, v]), verts_mask=np.ones((2, 8), bool),
                faces=np.stack([f, f]), faces_mask=np.ones((2, 12), bool))
    return jm, params, tm, imgs, masks, mesh


def _both(setup, fit_hw, num_points=64):
    jm, params, tm, imgs, masks, mesh = setup
    kw = dict(image_hw=fit_hw, sigma=1e-4, max_iterations=3,
              early_stop_min_iters=3, record_history=False)
    rj = jax_scene_step(params, jm, jnp.asarray(imgs), jnp.asarray(masks),
                        *(jnp.asarray(mesh[k]) for k in
                          ("verts", "verts_mask", "faces", "faces_mask")),
                        JFit(**kw), num_points=num_points)
    rt = scene_step(tm, torch.from_numpy(imgs), torch.from_numpy(masks),
                    *(torch.from_numpy(mesh[k]) for k in
                      ("verts", "verts_mask", "faces", "faces_mask")),
                    FitConfig(**kw), num_points=num_points)
    return rj, rt


@pytest.mark.parametrize("fit", ["full", "half"])
def test_scene_step_matches_jax(setup, fit):
    s = setup[3].shape[1]
    rj, rt = _both(setup, (s, s) if fit == "full" else (s // 2, s // 2))
    np.testing.assert_allclose(rt.depth.numpy(), np.asarray(rj.depth),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(rt.points_valid.numpy(),
                                  np.asarray(rj.points_valid))
    valid = np.asarray(rj.points_valid)
    np.testing.assert_allclose(rt.points.numpy()[valid],
                               np.asarray(rj.points)[valid], rtol=1e-4,
                               atol=1e-4)
    for name in ("translation", "yaw", "log_scale"):
        np.testing.assert_allclose(getattr(rt.params, name).numpy(),
                                   np.asarray(getattr(rj.params, name)),
                                   atol=5e-3, err_msg=name)
    np.testing.assert_allclose(rt.verts_world.numpy(),
                               np.asarray(rj.verts_world), atol=5e-3)
    np.testing.assert_allclose(rt.losses.numpy(), np.asarray(rj.losses),
                               rtol=2e-3)
    assert torch.isfinite(rt.verts_world).all()


def test_crop_picks_the_same_points_on_ties():
    """Equal bf16-rounded scores go to the lowest index, as lax.top_k does."""
    from regen3d_tpu.pipeline.scene_step import _extract_object_points as jx
    from regen3d_tpu_torch.pipeline.scene_step import _extract_object_points as tx

    rng = np.random.default_rng(0)
    n = 400
    conf = (1.0 + 1e-4 * rng.standard_normal(n)).astype(np.float32)
    cloud = rng.normal(size=(n, 3)).astype(np.float32)
    masks = rng.random((3, n)) > 0.5
    masks[2] = False
    pj, vj = jx(jnp.asarray(cloud), jnp.asarray(conf), jnp.asarray(masks), 64)
    pt, vt = tx(torch.from_numpy(cloud), torch.from_numpy(conf),
                torch.from_numpy(masks), 64)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_non_divisible_fit_resolution_raises(setup):
    with pytest.raises(ValueError, match="must divide"):
        _both(setup, (15, 15))


def test_nanmedian_is_numpys():
    x = np.asarray([[1.0, np.nan, 4.0, 2.0], [np.nan] * 4, [3.0, 1.0, 2.0, 5.0]],
                   np.float32)
    got = nanmedian(torch.from_numpy(x), 1).numpy()
    with np.errstate(all="ignore"), pytest.warns(RuntimeWarning):
        want = np.nanmedian(x, axis=1)
    np.testing.assert_array_equal(got, want)
