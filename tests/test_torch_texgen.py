"""The port's multiview texture generation against the JAX package on the
CPU (``regen3d_tpu_torch/pipeline/texgen.py``).

The weights are the port's tiny models drawn from a seed (a tiny SD UNet
with 12 input channels and a class per view, the tiny VAE, the tiny
ESRGAN) and carried into the JAX package's trees by ``tree_from_model``,
so both packages run the same weights; the JAX side runs its plain
attention (the kernel's arithmetic in f32), both in f32:

* ``orbit_views``, ``render_geometry_maps`` (pixels whose centre lies on
  a face edge may fall in the other face: XLA's multiply-adds, ROADMAP
  Queue 3 ag) and ``camera_feats``;
* ``MultiviewTexGen``, one denoising step, within 1e-5;
* ``ddim_sample`` over 2 steps from JAX's first noise (``jax.random`` has
  no torch counterpart: the port takes the noise as ``x0``), and the
  schedule's quirks (truncated timesteps, ``alphas_bar[0]`` last);
* ``generate_views`` and ``generate_views_pbr`` at ``TexGenConfig.tiny()``;
* ``texture_mesh`` and ``texture_mesh_pbr`` (with RealESRGAN ×4 on the
  albedo atlas) end to end on a small sphere: the decoded atlases, the UVs
  and the new faces.
"""

import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from regen3d_tpu.models import esrgan as je
from regen3d_tpu.models import sd_unet as ju
from regen3d_tpu.models import sd_vae as jv
from regen3d_tpu.ops import attention as ja
from regen3d_tpu.pipeline import texgen as jtg
from regen3d_tpu.pipeline import texture as jtex
from regen3d_tpu_torch.models import esrgan as te
from regen3d_tpu_torch.models import sd_unet as tu
from regen3d_tpu_torch.models import sd_vae as tv
from regen3d_tpu_torch.models.from_jax import tree_from_model
from regen3d_tpu_torch.ops.marching_cubes import marching_tetrahedra
from regen3d_tpu_torch.pipeline import texgen as ttg
from regen3d_tpu_torch.pipeline import texture as ttex
from regen3d_tpu_torch.utils.image import decode_png
from test_torch_package import one_torch_thread  # noqa: F401

CFG = ttg.TexGenConfig.tiny()          # 3 views, 32², 2 steps
JCFG = jtg.TexGenConfig.tiny()


@pytest.fixture(scope="module", autouse=True)
def plain_jax_attention():
    mp = pytest.MonkeyPatch()
    for mod in (ju, jv):
        mp.setattr(mod, "flash_attention",
                   lambda q, k, v: ja.attention_reference(q, k, v))
    yield
    mp.undo()


def _stack(n_class, seed):
    """(port model, port VAE, JAX tex tree, JAX VAE tree, JAX UNet cfg,
    JAX VAE cfg), f32, the port's weights drawn from ``seed``."""
    ucfg = dataclasses.replace(tu.SDUNetConfig.tiny(
        in_channels=12, class_embeddings=n_class), dtype=torch.float32)
    vcfg = dataclasses.replace(tv.SDVAEConfig.tiny(), dtype=torch.float32)
    model, vae = ttg.init_texgen(CFG, torch.Generator().manual_seed(seed),
                                 ucfg, vcfg, device="cpu")
    jucfg = dataclasses.replace(ju.SDUNetConfig.tiny(
        in_channels=12, class_embeddings=n_class), dtype=jnp.float32)
    jvcfg = dataclasses.replace(jv.SDVAEConfig.tiny(), dtype=jnp.float32)
    return (model, vae, tree_from_model(model), tree_from_model(vae), jucfg,
            jvcfg)


@pytest.fixture(scope="module")
def stack():
    return _stack(CFG.num_views, 0)


@pytest.fixture(scope="module")
def pbr_stack():
    return _stack(2 * CFG.num_views, 1)


@pytest.fixture(scope="module")
def mesh():
    """A sphere of radius 0.6 from a 12³ SDF (a few hundred faces)."""
    g = np.linspace(-1, 1, 12, dtype=np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    verts, faces = marching_tetrahedra(np.sqrt(x * x + y * y + z * z) - 0.6,
                                       0.0, bounds=(-1.0, 1.0))
    return verts.astype(np.float32), faces.astype(np.int32)


def _ref_image(seed):
    return np.random.default_rng(seed).integers(
        0, 256, (40, 40, 3)).astype(np.uint8)


def _jax_x0(seed, n):
    lh = CFG.resolution // 2
    return np.array(jax.random.normal(jax.random.PRNGKey(seed),
                                      (n, lh, lh, 4), jnp.float32))


def _ring(verts):
    center = verts.mean(0)
    radius = 2.2 * float(np.abs(verts - center).max())
    img = np.zeros((CFG.resolution, CFG.resolution, 3), np.float32)
    return (jtex.orbit_views(center, radius, img, n_views=CFG.num_views),
            ttex.orbit_views(center, radius, img, n_views=CFG.num_views,
                             device="cpu"))


def _png(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def test_ring_geometry_maps_and_camera_feats(mesh):
    verts, faces = mesh
    jring, tring = _ring(verts)
    for (jc, _), (tc, _) in zip(jring, tring):
        np.testing.assert_array_equal(np.asarray(jc.R), tc.R.numpy())
        np.testing.assert_array_equal(np.asarray(jc.T), tc.T.numpy())
    jcams, tcams = [c for c, _ in jring], [c for c, _ in tring]
    jg, jm = jtg.render_geometry_maps(verts, faces, jcams, CFG.resolution)
    tg, tm = ttg.render_geometry_maps(verts, faces, tcams, CFG.resolution)
    assert tg.shape == (3, 32, 32, 3) and tm.shape == (3, 32, 32)
    # edge-centred pixels may fall in the neighbouring face (Queue 3 ag)
    same = (np.abs(jg - tg).max(-1) <= 1e-6) & (jm == tm)
    assert same.mean() >= 0.99 and tm.sum() > 0, same.mean()
    np.testing.assert_array_equal(jtg.camera_feats(jcams),
                                  ttg.camera_feats(tcams))


def test_one_denoising_step(stack):
    model, _, tp, _, jucfg, _ = stack
    rng = np.random.default_rng(2)
    lat = rng.standard_normal((3, 16, 16, 4)).astype(np.float32)
    ref = rng.standard_normal((16, 16, 4)).astype(np.float32)
    geom = rng.standard_normal((3, 16, 16, 4)).astype(np.float32)
    cams = rng.standard_normal((3, 13)).astype(np.float32)
    ids = np.arange(3, dtype=np.int32)
    want = jax.jit(jtg.MultiviewTexGen(jucfg).apply)(
        tp, lat, jnp.float32(642.0), ref, ids, geom, cams)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in (lat,)), 642.0,
                    torch.from_numpy(ref), torch.arange(3),
                    torch.from_numpy(geom), torch.from_numpy(cams))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_ddim_two_steps_from_jax_noise(stack):
    model, _, tp, _, jucfg, _ = stack
    rng = np.random.default_rng(3)
    ref = rng.standard_normal((16, 16, 4)).astype(np.float32)
    geom = rng.standard_normal((3, 16, 16, 4)).astype(np.float32)
    cams = rng.standard_normal((3, 13)).astype(np.float32)
    want = jtg.ddim_sample(tp, jtg.MultiviewTexGen(jucfg), jnp.asarray(ref),
                           (3, 16, 16, 4), 2, jax.random.PRNGKey(7),
                           jnp.asarray(geom), jnp.asarray(cams))
    got = ttg.ddim_sample(model, torch.from_numpy(ref), (3, 16, 16, 4), 2,
                          torch.from_numpy(geom), torch.from_numpy(cams),
                          x0=torch.from_numpy(_jax_x0(7, 3)))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # the schedule: t = 999 then 0, alphas_bar read at the truncated t and
    # at 0 for the last step's t_prev
    ts, ab = ttg.ddim_schedule(15)
    assert ts[0] == 999 and ts[-1] == 0 and ts.dtype == np.float32
    np.testing.assert_allclose(ab[0], 1 - 8.5e-4, rtol=1e-7)
    assert int(ts[1]) == 927 and ab.shape == (1000,)


def test_generate_views_rgb_and_pbr(stack, pbr_stack):
    for (model, vae, tp, vp, jucfg, jvcfg), n in ((stack, 3),
                                                   (pbr_stack, 6)):
        ref = _ref_image(n)
        rng = np.random.default_rng(n)
        geom = rng.uniform(0, 1, (3, 32, 32, 3)).astype(np.float32)
        feats = rng.standard_normal((3, 13)).astype(np.float32)
        x0 = torch.from_numpy((_jax_x0(5, n)))
        if n == 3:
            want = [jtg.generate_views(tp, vp, JCFG, ref, jucfg, jvcfg, 5,
                                       geom, feats)]
            got = [ttg.generate_views(model, vae, CFG, ref, geom_maps=geom,
                                      cam_feats_arr=feats, x0=x0)]
        else:
            want = jtg.generate_views_pbr(tp, vp, JCFG, ref, jucfg, jvcfg,
                                          5, geom, feats)
            got = ttg.generate_views_pbr(model, vae, CFG, ref,
                                         geom_maps=geom, cam_feats_arr=feats,
                                         x0=x0)
        for g, w in zip(got, want):
            assert g.shape == (3, 32, 32, 3)
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def test_texture_mesh_end_to_end(stack, mesh):
    model, vae, tp, vp, jucfg, jvcfg = stack
    verts, faces = mesh
    ref = _ref_image(11)
    want = jtg.texture_mesh(verts, faces, ref, JCFG, tp, vp, jucfg, jvcfg,
                            texels_per_face=4, seed=9)
    got = ttg.texture_mesh(verts, faces, ref, CFG, model, vae,
                           texels_per_face=4,
                           x0=torch.from_numpy(_jax_x0(9, 3)))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    a, b = decode_png(got[3])[0].astype(int), _png(want[3]).astype(int)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 1 and (a != b).mean() <= 0.01


def test_texture_mesh_pbr_end_to_end(pbr_stack, mesh):
    model, vae, tp, vp, jucfg, jvcfg = pbr_stack
    verts, faces = mesh
    esr = te.RRDBNet(te.ESRGANConfig.tiny(), device="cpu")
    te.init_flax_style_(esr, torch.Generator().manual_seed(4))
    ref = _ref_image(12)
    want = jtg.texture_mesh_pbr(
        verts, faces, ref, JCFG, tp, vp, jucfg, jvcfg, texels_per_face=2,
        seed=8, esrgan=(tree_from_model(esr), je.ESRGANConfig.tiny()))
    got = ttg.texture_mesh_pbr(
        verts, faces, ref, CFG, model, vae, texels_per_face=2, esrgan=esr,
        x0=torch.from_numpy(_jax_x0(8, 6)))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    albedo, mr = decode_png(got[3])[0].astype(int), decode_png(got[4])[0]
    assert albedo.shape[0] == 4 * mr.shape[0]          # ×4 upscaled
    for a, b in ((albedo, _png(want[3])), (mr.astype(int), _png(want[4]))):
        assert a.shape == b.shape
        assert np.abs(a - b.astype(int)).max() <= 1
        assert (a != b).mean() <= 0.01
