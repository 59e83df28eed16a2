"""The port's FLUX transformer (``regen3d_tpu_torch/models/flux.py``)
against the JAX package's on the CPU.

* ``rope_tables`` and ``apply_rope`` on random ids and inputs, the double-
  and single-stream blocks and ``FluxTransformer`` at the tiny config in
  f32 (square and non-square image lengths, default and given ids,
  ``guidance`` and ``pooled`` None and given), every leaf drawn from a
  numpy seed and carried by ``from_jax``: within 1e-5 of max |ref| (the
  JAX side on its plain attention, the kernel's arithmetic in f32).
* ``flux.npz`` in bf16 on the JAX package's tiny init at PRNGKey(0)
  carried through the upstream layout: the mean error over max |fixture|
  no larger than the port's f32 arithmetic's (the fixture is XLA's eager
  bf16, ROADMAP Queue 3 ba).
* ``dit.sample`` driving the tiny FLUX over 2 steps from JAX's latents at
  guidance 1.0, where the sampler takes the model as given.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regen3d_tpu.models import dit as jdit
from regen3d_tpu.models import flux as jf
from regen3d_tpu.ops import attention as ja
from regen3d_tpu_torch.models import conversion as tconv
from regen3d_tpu_torch.models import dit as tdit
from regen3d_tpu_torch.models import flux as tf
from regen3d_tpu_torch.models.from_jax import load_from_jax
from test_torch_package import one_torch_thread  # noqa: F401

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "activations"
JC = dataclasses.replace(jf.FluxConfig.tiny(), dtype=jnp.float32)
TC = dataclasses.replace(tf.FluxConfig.tiny(), dtype=torch.float32)
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module", autouse=True)
def plain_jax_attention():
    mp = pytest.MonkeyPatch()
    mp.setattr(jf, "flash_attention",
               lambda q, k, v: ja.attention_reference(q, k, v))
    yield
    mp.undo()


def fast_jit(fn, *args):
    """``fn(*args)`` compiled without XLA's expensive passes."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST)(*args)


def drawn_params(module, *args, seed=0):
    """The module's flax tree (shapes from ``jax.eval_shape``) with every
    leaf drawn from a numpy seed: kernels N(0, 1/fan_in), RMSNorm scales
    1 + N(0, 0.1²), biases N(0, 0.1²)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def draw(path, s):
        x = rng.normal(size=s.shape)
        name = path[-1].key
        if name == "kernel":
            x = x / np.sqrt(s.shape[0])
        elif name == "scale":
            x = 1.0 + 0.1 * x
        else:
            x = 0.1 * x
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def close(got, want, rel=1e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rel, err


def _inputs(rng, l, lt=8, b=2):
    c = JC
    return (rng.normal(size=(b, l, c.in_channels)).astype(np.float32),
            rng.uniform(size=(b,)).astype(np.float32),
            rng.normal(size=(b, lt, c.cond_dim)).astype(np.float32))


def test_rope_tables_and_apply_rope():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 40, size=(2, 12, 3)).astype(np.float32)
    cos, sin = tf.rope_tables(torch.from_numpy(ids), TC.axes_dim, TC.theta)
    jcos, jsin = jf.rope_tables(jnp.asarray(ids), JC.axes_dim, JC.theta)
    close(cos, jcos)
    close(sin, jsin)
    x = rng.normal(size=(2, 4, 12, 16)).astype(np.float32)
    close(tf.apply_rope(torch.from_numpy(x), cos, sin),
          jf.apply_rope(jnp.asarray(x), jcos, jsin))
    # bf16 in, bf16 out: the rotation in f32, one rounding at the end
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = tf.apply_rope(xb, cos, sin)
    want = jf.apply_rope(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                         jcos, jsin)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def _rope(l, lt, b):
    ids = np.random.default_rng(8).integers(0, 9, size=(b, l, 3))
    img = jf.rope_tables(jnp.asarray(ids, jnp.float32), JC.axes_dim,
                         JC.theta)
    txt = jf.rope_tables(jnp.zeros((b, lt, 3)), JC.axes_dim, JC.theta)
    return img, txt


def test_blocks():
    rng = np.random.default_rng(1)
    b, l, lt, w = 2, 16, 8, JC.width
    img, txt, vec = (rng.normal(size=s).astype(np.float32)
                     for s in ((b, l, w), (b, lt, w), (b, w)))
    img_rope, txt_rope = _rope(l, lt, b)
    both = tuple(jnp.concatenate([t, i], 1) for t, i in zip(txt_rope,
                                                            img_rope))
    to_t = lambda r: tuple(torch.from_numpy(np.array(a)) for a in r)

    jd = jf.FluxDoubleBlock(JC)
    pd = drawn_params(jd, img, txt, vec, img_rope, txt_rope, seed=2)
    want = fast_jit(jd.apply, pd, img, txt, vec, img_rope, txt_rope)
    md = tf.FluxDoubleBlock(TC, device="cpu")
    load_from_jax(md, pd)
    with torch.no_grad():
        got = md(torch.from_numpy(img), torch.from_numpy(txt),
                 torch.from_numpy(vec), to_t(img_rope), to_t(txt_rope))
    close(got[0], want[0])
    close(got[1], want[1])

    x = np.concatenate([txt, img], 1)
    js = jf.FluxSingleBlock(JC)
    ps = drawn_params(js, x, vec, both, seed=3)
    want = fast_jit(js.apply, ps, x, vec, both)
    ms = tf.FluxSingleBlock(TC, device="cpu")
    load_from_jax(ms, ps)
    with torch.no_grad():
        got = ms(torch.from_numpy(x), torch.from_numpy(vec), to_t(both))
    close(got, want)


@pytest.fixture(scope="module")
def transformer():
    x, t, cond = _inputs(np.random.default_rng(4), 16)
    jm = jf.FluxTransformer(JC)
    params = drawn_params(jm, x, t, cond, seed=5)
    m = tf.FluxTransformer(TC, device="cpu")
    load_from_jax(m, params)
    return jm, params, m


@pytest.mark.parametrize("case", ["square_defaults", "linear_ids",
                                  "given_everything"])
def test_transformer_f32(transformer, case):
    """A 16-token image (square: grid ids) with guidance and pooled None;
    12 tokens (not a square: linear ids); given ids, guidance and
    pooled."""
    jm, params, m = transformer
    rng = np.random.default_rng(6)
    l = 12 if case == "linear_ids" else 16
    x, t, cond = _inputs(rng, l)
    kw = {}
    if case == "given_everything":
        f32 = np.float32
        kw = dict(pooled=rng.normal(size=(2, JC.pooled_dim)).astype(f32),
                  guidance=np.asarray([1.5, 4.0], f32),
                  img_ids=rng.integers(0, 9, size=(2, l, 3)).astype(f32),
                  txt_ids=rng.integers(0, 3, size=(2, 8, 3)).astype(f32))
    names = sorted(kw)
    want = fast_jit(lambda p, x, t, c, *a: jm.apply(p, x, t, c,
                                                    **dict(zip(names, a))),
                    params, x, t, cond, *(kw[n] for n in names))
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(t),
                torch.from_numpy(cond),
                **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert got.dtype == torch.float32
    close(got, want)


def test_fixture_by_the_mean_error():
    """``flux.npz`` is XLA's eager bf16 apply with the Pallas kernel of the
    tiny FLUX at PRNGKey(0) (the eager apply reproduces it exactly; ROADMAP
    Queue 3 ba). Through the upstream layout into the port, the port's
    bf16 lies no further from it, by the mean error over max |fixture|,
    than the port's f32 arithmetic (measured: 0.304% against 0.324%; the
    JAX package's f32 jit 0.324%, its bf16 jit 0.180%, which the port's
    bf16, rounding in torch's places, does not reach)."""
    d = np.load(FIXTURES / "flux.npz")
    args = [torch.from_numpy(d[f"input_{k}"]) for k in ("x", "t", "cond")]
    # conversion._flux_tiny_init's tree, compiled without the slow passes
    params = jax.device_get(fast_jit(
        jf.FluxTransformer(jf.FluxConfig.tiny()).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 16, 8)), jnp.zeros((1,)), jnp.zeros((1, 8, 32))))
    state = tconv.upstream_state("flux", params)
    want = d["expected_v"]
    err = {}
    for dt in (torch.bfloat16, torch.float32):
        m = tf.FluxTransformer(dataclasses.replace(tf.FluxConfig.tiny(),
                                                   dtype=dt), device="cpu")
        tconv.load_upstream("flux", state, m)
        with torch.no_grad():
            got = m(*args).numpy()
        assert got.shape == want.shape and np.isfinite(got).all()
        err[dt] = float(np.abs(got - want).mean() / np.abs(want).max())
    assert err[torch.bfloat16] <= err[torch.float32], err


def test_sample_drives_flux_from_given_latents(transformer):
    """``dit.sample`` at guidance 1.0 takes one forward a step (no
    classifier-free batch, no ``cross_instance`` read) from the latents
    given: 2 Euler steps against the JAX sampler from the same draw."""
    jm, params, m = transformer
    rng = np.random.default_rng(7)
    cond = rng.normal(size=(1, 8, JC.cond_dim)).astype(np.float32)
    lat = np.asarray(jax.random.normal(jax.random.PRNGKey(3),
                                       (1, 16, JC.in_channels)))
    want = fast_jit(lambda p, c, x: jdit.sample(
        jm, p, jax.random.PRNGKey(0), c, num_steps=2, guidance_scale=1.0,
        latents=x), params, cond, lat)
    got = tdit.sample(m, torch.from_numpy(cond), num_steps=2,
                      guidance_scale=1.0, latents=torch.from_numpy(lat))
    close(got, want)
