"""The port's SD UNet, AutoencoderKL and RealESRGAN against the JAX package
on the CPU.

* ``SDUNet`` at the tiny config (heads of 4, class labels, a 5-token
  cross-attention) and ``SDAutoencoderKL`` (encode, decode, the
  reparameterised draw) with the JAX package's tiny inits at PRNGKey(0)
  carried by ``from_jax``: within 1e-5 elementwise in f32 (the JAX side on
  its plain attention, the kernel's arithmetic in f32); in the serving
  bf16 by the mean error over max |f32|, within 1e-2 and no more than
  twice the JAX package's own bf16 lies from its f32 (the packages round
  bf16 in other places, ROADMAP Queue 3 af).
* ``RRDBNet`` in f32 within 1e-5, and ``upscale_x4`` on a 300 × 40 image,
  which crosses a tile seam (two 256-px tiles with their 16-px context).
* The committed activation fixtures: ``esrgan.npz`` at the JAX test's
  atol 2e-4 in f32; ``sd_unet.npz``, ``marigold.npz`` (the same tiny
  UNet) and ``sd_vae.npz``, which are XLA's eager bf16, by the mean error
  against the JAX package's jitted bf16 (ROADMAP Queue 3 av).
* The flash forward's new widths on their plain version: D = 4 zero-padded
  to 8 columns with the scale 1/√4 gives the same o and lse (on the card
  the D = 4 instance computes on zero-filled columns in shared memory), and
  D = 512 at the VAE's one head.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regen3d_tpu.models import esrgan as je
from regen3d_tpu.models import sd_unet as ju
from regen3d_tpu.models import sd_vae as jv
from regen3d_tpu.ops import attention as ja
from regen3d_tpu_torch.models import esrgan as te
from regen3d_tpu_torch.models import sd_unet as tu
from regen3d_tpu_torch.models import sd_vae as tv
from regen3d_tpu_torch.models.from_jax import load_from_jax
from regen3d_tpu_torch.ops import attention as att
from test_torch_package import one_torch_thread  # noqa: F401

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "activations"
KEY = jax.random.PRNGKey(0)


@pytest.fixture(scope="module")
def plain_jax_attention():
    mp = pytest.MonkeyPatch()
    for mod in (ju, jv):
        mp.setattr(mod, "flash_attention",
                   lambda q, k, v: ja.attention_reference(q, k, v))
    yield
    mp.undo()


def _f32(cfg):
    return dataclasses.replace(cfg, dtype=jnp.float32)


def jax_init(module, *args):
    """``module.init(PRNGKey(0), *args)`` compiled without XLA's expensive
    passes (the same values; a third less compile time)."""
    args = (KEY, *args)
    compiled = jax.jit(module.init).lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})
    return jax.device_get(compiled(*args))


@pytest.fixture(scope="module")
def unet(plain_jax_attention):
    """The JAX package's tiny UNet with 4 class embeddings at PRNGKey(0)
    (the fixture's UNet is the same tree without ``class_embedding``:
    flax draws each leaf from its own path)."""
    c = ju.SDUNetConfig.tiny(class_embeddings=4)
    params = jax_init(ju.SDUNet(_f32(c)), jnp.zeros((1, 16, 16, 7)),
                      jnp.zeros((1,)), jnp.zeros((1, 8, 16)),
                      jnp.zeros((1,), jnp.int32))
    return c, params


@pytest.fixture(scope="module")
def vae(plain_jax_attention):
    c = jv.SDVAEConfig.tiny()
    params = jax_init(jv.SDAutoencoderKL(_f32(c)), jnp.zeros((1, 32, 32, 3)))
    return c, params


@pytest.fixture(scope="module")
def esrgan():
    c = je.ESRGANConfig.tiny()
    params = jax_init(je.RRDBNet(c), jnp.zeros((1, 16, 16, 3)))
    return c, params


def _port_unet(dtype, params, class_embeddings=4):
    m = tu.SDUNet(dataclasses.replace(
        tu.SDUNetConfig.tiny(class_embeddings=class_embeddings),
        dtype=dtype), device="cpu")
    load_from_jax(m, params)
    return m


def _port_vae(dtype, params):
    m = tv.SDAutoencoderKL(dataclasses.replace(tv.SDVAEConfig.tiny(),
                                               dtype=dtype), device="cpu")
    load_from_jax(m, params)
    return m


def _unet_inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 16, 16, 7)).astype(np.float32),
            np.asarray([10.5, 731.25], np.float32),
            rng.standard_normal((2, 5, 16)).astype(np.float32),
            np.asarray([1, 3], np.int32))


def _bf16_errors(got16, want16, want32):
    """(mean |port bf16 − JAX bf16|, mean |JAX bf16 − JAX f32|), each over
    max |JAX f32|."""
    scale = float(np.abs(want32).max())
    return (float(np.abs(got16 - want16).mean()) / scale,
            float(np.abs(want16 - want32).mean()) / scale)


def test_sd_unet_matches_jax(unet):
    c, params = unet
    x, t, ctx, cl = _unet_inputs()
    want = {}
    for dt in (jnp.float32, jnp.bfloat16):
        m = ju.SDUNet(dataclasses.replace(c, dtype=dt))
        want[dt] = np.asarray(jax.jit(m.apply)(params, x, t, ctx, cl),
                              np.float32)
    got = {}
    for dt in (torch.float32, torch.bfloat16):
        with torch.no_grad():
            got[dt] = _port_unet(dt, params)(
                torch.from_numpy(x), torch.from_numpy(t),
                torch.from_numpy(ctx), torch.from_numpy(cl).long()
            ).float().numpy()
    assert got[torch.float32].shape == (2, 16, 16, 4)
    np.testing.assert_allclose(got[torch.float32], want[jnp.float32],
                               rtol=0, atol=1e-5)
    mine, theirs = _bf16_errors(got[torch.bfloat16], want[jnp.bfloat16],
                                want[jnp.float32])
    assert mine <= 1e-2 and mine <= 2 * theirs, (mine, theirs)
    # the class labels and the cross-attention context both move the output
    with torch.no_grad():
        m = _port_unet(torch.float32, params)
        args = [torch.from_numpy(a) for a in (x, t, ctx)]
        base = m(*args, torch.from_numpy(cl).long())
        other_cls = m(*args, torch.tensor([0, 2]))
        other_ctx = m(args[0], args[1], -args[2], torch.from_numpy(cl).long())
    assert float((base - other_cls).abs().max()) > 1e-4
    assert float((base - other_ctx).abs().max()) > 1e-4


def test_sd_vae_matches_jax(vae):
    c, params = vae
    img = np.random.default_rng(1).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    want = {}
    for dt in (jnp.float32, jnp.bfloat16):
        m = jv.SDAutoencoderKL(dataclasses.replace(c, dtype=dt))
        mean, logvar = jax.jit(lambda p, x: m.apply(
            p, x, method=jv.SDAutoencoderKL.encode))(params, img)
        dec = jax.jit(lambda p, z: m.apply(
            p, z, method=jv.SDAutoencoderKL.decode))(params, mean)
        want[dt] = [np.asarray(a, np.float32) for a in (mean, logvar, dec)]
    z32 = torch.from_numpy(want[jnp.float32][0].copy())
    for dt in (torch.float32, torch.bfloat16):
        m = _port_vae(dt, params)
        with torch.no_grad():
            mean, logvar = m.encode(torch.from_numpy(img))
            dec = m.decode(z32 if dt == torch.float32
                           else torch.from_numpy(want[jnp.bfloat16][0].copy()))
        got = [a.float().numpy() for a in (mean, logvar, dec)]
        ref = want[jnp.float32 if dt == torch.float32 else jnp.bfloat16]
        for g, w, w32 in zip(got, ref, want[jnp.float32]):
            assert g.shape == w.shape
            if dt == torch.float32:
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
            else:
                mine, theirs = _bf16_errors(g, w, w32)
                assert mine <= 1e-2 and mine <= 2 * theirs, (mine, theirs)
    # the reparameterised draw: mean + exp(½·clip(logvar))·ε, ε from the
    # generator; without one, z is the mean
    m = _port_vae(torch.float32, params)
    with torch.no_grad():
        dec_g, mean, logvar = m(torch.from_numpy(img),
                                torch.Generator().manual_seed(5))
        eps = torch.randn(mean.shape, generator=torch.Generator().manual_seed(5))
        z = mean + torch.exp(0.5 * torch.clamp(logvar, -30, 20)) * eps
        torch.testing.assert_close(dec_g, m.decode(z), rtol=0, atol=0)
        torch.testing.assert_close(m(torch.from_numpy(img))[0],
                                   m.decode(mean), rtol=0, atol=0)


def test_rrdbnet_and_upscale_across_a_tile_seam(esrgan):
    c, params = esrgan
    rng = np.random.default_rng(2)
    m = te.RRDBNet(te.ESRGANConfig.tiny(), device="cpu")
    load_from_jax(m, params)
    x = rng.uniform(0, 1, (1, 12, 10, 3)).astype(np.float32)
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(je.RRDBNet(c).apply)(params, x))
    assert got.shape == (1, 48, 40, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    img = rng.uniform(0, 1, (300, 40, 3)).astype(np.float32)
    up = te.upscale_x4(m, img)
    jup = je.upscale_x4(params, c, img)
    assert up.shape == (1200, 160, 3) and 0 <= up.min() and up.max() <= 1
    np.testing.assert_allclose(up, jup, rtol=0, atol=1e-5)
    # the seam: the second tile's rows come from their own, cropped run
    whole = te.upscale_x4(m, img, tile=None)
    assert float(np.abs(up - whole).max()) > 0


def _mean_err(got, want):
    return float(np.abs(np.asarray(got, np.float32) - want).mean()
                 / np.abs(want).max())


def test_activation_fixtures(unet, vae, esrgan):
    """The fixtures on the models the JAX recorder builds: the tiny UNet
    (no class embedding) and VAE in their default bf16, the ESRGAN in f32.
    The ESRGAN meets the JAX test's atol 2e-4. The SD fixtures are XLA's
    eager bf16 (ROADMAP Queue 3 av): the JAX package's own jitted bf16
    apply misses ``sd_unet.npz`` by 0.053 and no port meets the atol, so
    the port's bf16 is held by the mean error over max |fixture|, within
    1.25× of the jitted apply's (measured: UNet 0.355% against 0.313%, VAE
    below it)."""
    _, params = unet
    p = {"params": {k: v for k, v in params["params"].items()
                    if k != "class_embedding"}}
    jm = ju.SDUNet(ju.SDUNetConfig.tiny())
    for family in ("sd_unet", "marigold"):
        d = np.load(FIXTURES / f"{family}.npz")
        args = [d[f"input_{k}"] for k in ("x", "t", "cond")]
        m = _port_unet(torch.bfloat16, p, class_embeddings=None)
        with torch.no_grad():
            got = m(*(torch.from_numpy(a) for a in args)).float().numpy()
        jit = jax.jit(jm.apply)(p, *args)
        want = d["expected_eps"]
        assert got.shape == want.shape and np.isfinite(got).all()
        assert _mean_err(got, want) <= 1.25 * _mean_err(jit, want), family
    d = np.load(FIXTURES / "sd_vae.npz")
    with torch.no_grad():
        got = _port_vae(torch.bfloat16, vae[1])(torch.from_numpy(d["input_x"]))
    jit = jax.jit(jv.SDAutoencoderKL(jv.SDVAEConfig.tiny()).apply)(
        vae[1], d["input_x"])
    for name, g, j in zip(("recon", "mean", "logvar"), got, jit):
        want = d[f"expected_{name}"]
        assert g.shape == want.shape
        assert _mean_err(g.float().numpy(), want) \
            <= 1.25 * _mean_err(j, want), name
    d = np.load(FIXTURES / "esrgan.npz")
    m = te.RRDBNet(te.ESRGANConfig.tiny(), device="cpu")
    load_from_jax(m, esrgan[1])
    with torch.no_grad():
        got = m(torch.from_numpy(d["input_x"])).numpy()
    np.testing.assert_allclose(got, d["expected_y"], rtol=0, atol=2e-4)


def test_flash_forward_new_widths_on_the_plain_version():
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(3, 2, 37, 4, generator=gen).to(torch.bfloat16)
               for _ in range(3))
    o, lse = att.flash_attention_fwd(q, k, v)
    pad = lambda t: torch.nn.functional.pad(t, (0, 4))
    o8, lse8 = att.flash_attention_fwd(pad(q), pad(k), pad(v), scale=0.5)
    torch.testing.assert_close(o, o8[..., :4], rtol=0, atol=0)
    torch.testing.assert_close(lse, lse8, rtol=0, atol=1e-6)
    assert float(o8[..., 4:].abs().max()) == 0.0
    assert {4, 512} <= set(att.FWD_KERNEL_HEAD_DIMS)
    # D = 512 as the VAE's mid-block gives it: one head, f32 sums
    q, k, v = (torch.randn(1, 1, 70, 512, generator=gen) for _ in range(3))
    o, lse = att.flash_attention_fwd(q, k, v)
    want = torch.softmax(q @ k.transpose(-1, -2) / 512 ** 0.5, -1) @ v
    torch.testing.assert_close(o, want, rtol=0, atol=1e-5)
