"""The port's SD-x4 and FLUX upscalers (``regen3d_tpu_torch/pipeline/
upscale.py``), the x4 UNet's DDIM sampler (``models/unet.ddim_sample``) and
the upscaler's VAE (``models/vae.py``) against the JAX package on the CPU.

* The DDIM schedule: the int timesteps equal ``jnp.linspace(999, 0,
  n).astype(int32)`` for n = 1..100; ᾱ within 1e-6 of XLA's ``cumprod``
  (a sequential f32 product; XLA rounds otherwise).
* ``ddim_sample`` at ``UNetConfig.tiny()`` in f32 over 2 steps unguided
  and 3 guided (5.0) from JAX's first noise, and the VAE's encode, decode
  and ``__call__`` (with JAX's noise): within 1e-5 of max |ref|
  (measured: the sampler 7e-7 and 2.2e-6, though step 1 divides by
  √ᾱ₉₉₉ ≈ 6e-3); every leaf drawn from a numpy seed, the JAX side on its
  plain attention.
* ``Upscaler.upscale`` (a 16² crop, guidance 5, 2 steps) and
  ``FluxUpscaler.upscale`` (``test_upscale_flux.py``'s sizes) in f32 on the
  same noise: the uint8 outputs within one level of JAX's at every pixel
  (measured: equal).
* The weightless LANCZOS ×4 and ``run``'s 512² PNGs pixel for pixel;
  ``make_upscaler``'s switch and its error; ``square_pad``.
* The reference's three divergences, each in both packages (ROADMAP
  Queue 3 ax-az).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from regen3d_tpu.config import default_config as jdefault_config
from regen3d_tpu.models import dit as jdit
from regen3d_tpu.models import flux as jflux
from regen3d_tpu.models import layers as jlayers
from regen3d_tpu.models import sd_vae as jsv
from regen3d_tpu.models import unet as ju
from regen3d_tpu.models import vae as jv
from regen3d_tpu.ops import attention as ja
from regen3d_tpu.pipeline import upscale as jup
from regen3d_tpu_torch.config import default_config
from regen3d_tpu_torch.models import dit as tdit
from regen3d_tpu_torch.models import flux as tflux
from regen3d_tpu_torch.models import sd_vae as tsv
from regen3d_tpu_torch.models import unet as tu
from regen3d_tpu_torch.models import vae as tv
from regen3d_tpu_torch.models.from_jax import load_from_jax
from regen3d_tpu_torch.pipeline import upscale as tup
from regen3d_tpu_torch.utils.image import read_png
from test_torch_flux import close, drawn_params, fast_jit
from test_torch_package import one_torch_thread  # noqa: F401

SEED = 1234567                       # default_config's seed


@pytest.fixture(scope="module", autouse=True)
def plain_jax_attention():
    mp = pytest.MonkeyPatch()
    for mod in (jlayers, jsv):
        mp.setattr(mod, "flash_attention",
                   lambda q, k, v: ja.attention_reference(q, k, v))
    yield
    mp.undo()


def _f32(cfg):
    return dataclasses.replace(cfg, dtype=jnp.float32)


def _t32(cfg):
    return dataclasses.replace(cfg, dtype=torch.float32)


@pytest.fixture(scope="module")
def unet():
    """The tiny x4 UNet in f32, both packages, one drawn tree."""
    jm = ju.UNet(_f32(ju.UNetConfig.tiny()))
    params = drawn_params(jm, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                          jnp.zeros((1, 8, 8, 3)), seed=11)
    m = tu.UNet(_t32(tu.UNetConfig.tiny()), device="cpu")
    load_from_jax(m, params)
    return jm, params, m


@pytest.fixture(scope="module")
def vae():
    jm = jv.AutoencoderKL(_f32(jv.VAEConfig.tiny()))
    params = drawn_params(jm, jnp.zeros((1, 16, 16, 3)), seed=12)
    m = tv.AutoencoderKL(_t32(tv.VAEConfig.tiny()), device="cpu")
    load_from_jax(m, params)
    return jm, params, m


def test_ddim_schedule_is_jaxs():
    # one program for the hundred schedules (the eager calls give the same)
    want = jax.jit(lambda: tuple(jnp.linspace(999, 0, n).astype(jnp.int32)
                                 for n in range(1, 101)))()
    for n in range(1, 101):
        ts, _ = tu.ddim_schedule(n)
        np.testing.assert_array_equal(ts, np.asarray(want[n - 1]),
                                      err_msg=str(n))
    _, a = tu.ddim_schedule(50)
    want = np.asarray(jnp.cumprod(1.0 - jnp.linspace(1e-4, 0.02, 1000)))
    np.testing.assert_allclose(a, want, rtol=1e-6, atol=0)
    assert a.dtype == np.float32


@pytest.mark.parametrize("steps,guidance", [(2, 1.0), (3, 5.0)],
                         ids=["unguided_2", "guided_3"])
def test_ddim_sample(unet, steps, guidance):
    jm, params, m = unet
    rng = np.random.default_rng(13)
    cond = rng.uniform(-1, 1, size=(1, 8, 8, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    shape = (1, 8, 8, 4)
    want = ju.ddim_sample(jm, params, key, shape, cond_img=jnp.asarray(cond),
                          num_steps=steps, guidance_scale=guidance)
    got = tu.ddim_sample(m, shape, cond_img=torch.from_numpy(cond),
                         num_steps=steps, guidance_scale=guidance,
                         x0=torch.from_numpy(np.array(
                             jax.random.normal(key, shape))))
    close(got, want)


def test_vae_encode_decode_call(vae):
    jm, params, m = vae
    rng = np.random.default_rng(14)
    img = rng.uniform(-1, 1, size=(1, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    eps = np.asarray(jax.random.normal(key, (1, 8, 8, 4)))
    with torch.no_grad():
        x = torch.from_numpy(img)
        close(m.encode(x), fast_jit(lambda p, i: jm.apply(
            p, i, method=jv.AutoencoderKL.encode), params, img))
        close(m.encode(x, eps=torch.from_numpy(eps)), fast_jit(
            lambda p, i: jm.apply(p, i, key, method=jv.AutoencoderKL.encode),
            params, img))
        z = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
        close(m.decode(torch.from_numpy(z)), fast_jit(lambda p, z: jm.apply(
            p, z, method=jv.AutoencoderKL.decode), params, z))
        rec, (mean, logvar) = m(x, eps=torch.from_numpy(eps))
    jrec, (jmean, jlogvar) = fast_jit(lambda p, i: jm.apply(p, i, key),
                                      params, img)
    for a, b in ((rec, jrec), (mean, jmean), (logvar, jlogvar)):
        close(a, b)
    assert float(logvar.min()) >= -30 and float(logvar.max()) <= 20


def _levels(got, want):
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_upscaler_against_jax(unet, vae, tmp_path):
    """A 16² crop: DDIM at its 8² latent grid (guidance 5, 2 steps), the
    tiny VAE's decode; JAX draws its noise from PRNGKey(seed)."""
    jm, jp, m = unet
    jvm, jvp, vm = vae
    img = np.random.default_rng(15).integers(0, 256, (16, 16, 3), np.uint8)
    over = dict(num_inference_steps=2, guidance_scale=5.0)
    want = jup.Upscaler(jm, jp, jvm, jvp).upscale(
        img, jdefault_config(str(tmp_path / "j"), **over))
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(SEED),
                                         (1, 8, 8, 4)))
    got = tup.Upscaler(m, vm).upscale(
        img, default_config(str(tmp_path / "t"), **over),
        noise=torch.from_numpy(noise))
    assert got.shape == (16, 16, 3)        # the tiny VAE decodes 2×
    _levels(got, want)


def test_flux_upscaler_against_jax(tmp_path):
    """``test_upscale_flux.py``'s sizes: an 8² crop, the tiny SD VAE, a
    ShapeDiT of 64 tokens of 16 (2 steps, guidance 5: one batched
    forward a step)."""
    side, tok = 8, 64
    dcfg = jdit.DiTConfig(latent_tokens=tok, latent_dim=16, width=32,
                          depth=1, num_heads=2, cond_dim=16,
                          dtype=jnp.float32)
    jd = jdit.ShapeDiT(dcfg)
    dp = drawn_params(jd, jnp.zeros((1, tok, 16)), jnp.zeros((1,)),
                      jnp.zeros((1, tok, 16)), seed=16)
    jvm = jsv.SDAutoencoderKL(_f32(jsv.SDVAEConfig.tiny()))
    vp = drawn_params(jvm, jnp.zeros((1, 8, 8, 3)), seed=17)
    d = tdit.ShapeDiT(tdit.DiTConfig(**{
        f.name: getattr(dcfg, f.name) for f in dataclasses.fields(dcfg)
        if f.name != "dtype"}, dtype=torch.float32), device="cpu")
    load_from_jax(d, dp)
    vm = tsv.SDAutoencoderKL(_t32(tsv.SDVAEConfig.tiny()), device="cpu")
    load_from_jax(vm, vp)
    img = np.random.default_rng(18).integers(0, 256, (side, side, 3),
                                             np.uint8)
    over = dict(num_inference_steps=2)
    want = jup.FluxUpscaler(jd, dp, jvm, vp).upscale(
        img, jdefault_config(str(tmp_path / "j"), **over))
    lat = np.asarray(jax.random.normal(jax.random.PRNGKey(SEED),
                                       (1, tok, 16)))
    got = tup.FluxUpscaler(d, vm).upscale(
        img, default_config(str(tmp_path / "t"), **over),
        latents=torch.from_numpy(lat))
    assert got.shape == (32, 32, 3)
    _levels(got, want)


def test_weightless_switch_pad_and_run(tmp_path):
    """LANCZOS ×4 bit for bit Pillow's, both classes; the config's switch
    and its error; ``square_pad``; ``run``'s PNGs pixel for pixel."""
    rng = np.random.default_rng(19)
    img = rng.integers(0, 256, (12, 17, 3), np.uint8)
    want = np.asarray(Image.fromarray(img).resize((68, 48), Image.LANCZOS))
    for cls in (tup.Upscaler, tup.FluxUpscaler):
        assert not cls().has_weights
        np.testing.assert_array_equal(cls().upscale(img, {}), want)
    for name, cls in (("SD", tup.Upscaler), ("flux", tup.FluxUpscaler)):
        assert isinstance(tup.make_upscaler({"upscaler_model_name": name}),
                          cls)
    with pytest.raises(ValueError, match="SD.*FLUX"):
        tup.make_upscaler({"upscaler_model_name": "DALLE"})
    for shape in ((10, 20, 3), (9, 4, 3), (6, 6, 3)):
        a = rng.integers(0, 256, shape, np.uint8)
        np.testing.assert_array_equal(tup.square_pad(a), jup.square_pad(a))
    crops = {"chair__(5, 5)": (40, 30), "lamp__(90, 12)": (13, 41)}
    for pkg in ("jax", "port"):
        crop_dir = tmp_path / pkg / "output" / "findings" / "cropped"
        crop_dir.mkdir(parents=True)
        for i, (stem, hw) in enumerate(crops.items()):
            Image.fromarray(np.random.default_rng(i).integers(
                0, 256, (*hw, 3), np.uint8)).save(crop_dir / f"{stem}.png")
    assert jup.run(jdefault_config(str(tmp_path / "jax" / "output"))) == 2
    assert tup.run(default_config(str(tmp_path / "port" / "output"))) == 2
    for stem in crops:
        rel = os.path.join("output", "findings", "upscaled", "cropped",
                           f"{stem}.png")
        got, mode = read_png(str(tmp_path / "port" / rel))
        assert mode == "RGB" and got.shape == (512, 512, 3)
        np.testing.assert_array_equal(
            got, np.asarray(Image.open(tmp_path / "jax" / rel)))


# --- the reference's divergences (ROADMAP Queue 3 ax-az) --------------------

class _LatentVAE:
    """A stand-in for the JAX VAE: ``encode`` gives an 8² latent of 4
    channels (the error comes before any decode)."""

    def encode(self):
        pass

    def apply(self, params, x, method=None):
        z = jnp.zeros((1, 8, 8, 4))
        return z, z


def test_flux_transformer_cannot_drive_the_upscaler():
    """ax. ``FluxUpscaler.upscale`` calls ``sample`` without latents, which
    reads the model's ``latent_dim`` before any forward: with a
    ``FluxTransformer`` both packages raise ``AttributeError``, and so
    does ``sample`` itself."""
    jm = jflux.FluxTransformer(jflux.FluxConfig.tiny())
    img = np.zeros((8, 8, 3), np.uint8)
    cfg = dict(num_inference_steps=1)
    with pytest.raises(AttributeError, match="latent_dim"):
        jup.FluxUpscaler(jm, {}, _LatentVAE(), {}).upscale(img, cfg)
    with pytest.raises(AttributeError, match="latent_dim"):
        jdit.sample(jm, {}, jax.random.PRNGKey(0), jnp.zeros((1, 4, 32)),
                    num_steps=1, guidance_scale=1.0)
    m = tflux.FluxTransformer(tflux.FluxConfig.tiny(), device="cpu")
    vm = tsv.SDAutoencoderKL(tsv.SDVAEConfig.tiny(), device="cpu")
    with pytest.raises(AttributeError, match="latent_dim"):
        tup.FluxUpscaler(m, vm).upscale(img, cfg)
    with pytest.raises(AttributeError, match="latent_dim"):
        tdit.sample(m, torch.zeros(1, 4, 32), num_steps=1,
                    guidance_scale=1.0)


def test_upscaler_refuses_sides_that_do_not_pool(unet, vae):
    """ay. The x4 UNet concatenates skips after each pool: a crop whose
    latent side (side / 2) the pools do not divide fails in both packages
    (``UNetConfig()``: sides that are multiples of 16; the tiny UNet's one
    pool: multiples of 4). The port names the rule."""
    jm, jp, m = unet
    jvm, jvp, vm = vae
    img = np.zeros((18, 18, 3), np.uint8)          # latent 9², one pool
    cfg = dict(num_inference_steps=1, guidance_scale=1.0)
    with pytest.raises(TypeError):
        jup.Upscaler(jm, jp, jvm, jvp).upscale(img, cfg)
    with pytest.raises(ValueError, match="multiples of 4"):
        tup.Upscaler(m, vm).upscale(img, cfg, noise=torch.zeros(1, 9, 9, 4))


def test_cli_upscales_with_lanczos(tmp_path):
    """az. No config key loads upscaler weights: the CLI's ``use_banana:
    false`` runs the weightless upscaler in both packages, whatever
    ``upscaler_model_name`` says."""
    for name in ("SD", "FLUX"):
        for mk in (jup.make_upscaler, tup.make_upscaler):
            assert not mk({"upscaler_model_name": name}).has_weights
