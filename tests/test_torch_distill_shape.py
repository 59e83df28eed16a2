"""The shape generator's distillation against the JAX package's, on the
CPU at ``DistillConfig.micro()`` in f32: the dataset (points and SDFs bit
for bit, the condition views but for pixels whose centre lies on a face
edge, ROADMAP Queue 3 ag); stage A's loss and gradient and two steps from
the port's seeded init carried to JAX, on the batches JAX's segment runner
draws; stage B's the same on JAX's draws of t, ε and the condition drop,
with the AdaLN-Zero leaves drawn non-zero (Queue 3 m); a micro
``distill_shape`` written by the port and read by JAX's
``load_generator``: the same SDF grid and sampled latents from one
noise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from regen3d_tpu.models import dit as jdit
from regen3d_tpu.models import shapevae as jsv
from regen3d_tpu.pipeline import shape_distill as jsh
from regen3d_tpu_torch.models import dit as tdit
from regen3d_tpu_torch.models.from_jax import load_from_jax, tree_from_model
from regen3d_tpu_torch.models.shapevae import (
    ShapeDecoder,
    ShapeEncoder,
    decode_grid,
)
from regen3d_tpu_torch.pipeline import shape_distill as tsh
from regen3d_tpu_torch.pipeline.phase3_assets import init_flax_style_
from test_torch_distill import (
    F32,
    edge_allowance,
    grads_close,
    jax_cond_f32,
    jax_steps,
    micro_f32,
    params_close,
    port_grads,
    t_,
)
from test_torch_package import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def data():
    return jsh.build_dataset(np.random.default_rng(9), 6, 32, n_surface=64,
                             n_query=64)


def _tree(model):
    return jax.tree_util.tree_map(np.array, tree_from_model(model))


def test_shape_dataset(data):
    tdata = tsh.build_dataset(np.random.default_rng(9), 6, 32, n_surface=64,
                              n_query=64, device="cpu")
    for k in ("surf", "qpts", "qsdf"):
        np.testing.assert_array_equal(tdata[k], data[k])
    edge_allowance(tdata["imgs"], data["imgs"], 1e-5, 0.02)
    assert [s.family for s in tdata["specs"]] == \
        [s.family for s in data["specs"]]


def _segment_batches(seed, n, batch, seg, steps):
    """The index rows JAX's segment runner draws: per segment,
    ``rng.integers(0, n, (k, batch))``."""
    rng = np.random.default_rng(seed)
    rows, done = [], 0
    while done < steps:
        k = min(seg, steps - done)
        rows.extend(rng.integers(0, n, (k, batch)))
        done += k
    return rows


def test_shape_vae_trainer(data, monkeypatch):
    jcfg, tcfg = micro_f32()
    seed, steps, batch = 0, 2, 3
    te = ShapeEncoder(tcfg.vae, device="cpu")
    td = ShapeDecoder(tcfg.vae, device="cpu")
    gen = torch.Generator().manual_seed(5)
    init_flax_style_(te, gen)
    with torch.no_grad():
        te.latent_queries.normal_(0.0, 0.02, generator=gen)
    init_flax_style_(td, gen)
    init = {"enc": _tree(te), "dec": _tree(td)}
    enc, dec = jsv.ShapeEncoder(jcfg.vae), jsv.ShapeDecoder(jcfg.vae)

    def jloss(p, surf, qpts, qsdf):   # train_shape_vae's loss
        lat = enc.apply(p["enc"], surf)
        pred = dec.apply(p["dec"], lat, qpts)
        t_gt = jnp.clip(qsdf, -jsh.SDF_TRUNC, jsh.SDF_TRUNC)
        w = 1.0 + 3.0 * (jnp.abs(qsdf) < 0.05)
        rec = jnp.sum(jnp.abs(pred - t_gt) * w) / jnp.sum(w)
        mu, sd = lat.mean((0, 1)), lat.std((0, 1))
        return rec + 0.02 * ((mu ** 2).mean() + ((sd - 1.0) ** 2).mean())

    rows = _segment_batches(seed, 6, batch, 1, steps)
    batches = [tuple(data[k][r] for k in ("surf", "qpts", "qsdf"))
               for r in rows]
    tx = optax.adamw(optax.cosine_decay_schedule(1e-3, steps, 0.05))
    jp, (jl, jg) = jax_steps(jax.jit(jax.value_and_grad(jloss)), init,
                             batches, tx)
    loss = port_grads(lambda: tsh.vae_loss(te, td, *map(t_, batches[0])),
                      list(te.parameters()) + list(td.parameters()))
    assert loss == pytest.approx(float(jl), rel=1e-5)
    grads_close(te, jg["enc"])
    grads_close(td, jg["dec"])
    monkeypatch.setattr(tsh, "init_autoencoder_", lambda e, d, g: (
        load_from_jax(e, init["enc"]), load_from_jax(d, init["dec"])))
    te2, td2, losses = tsh.train_shape_vae(
        tcfg, data, steps, batch=batch, seed=seed, seg=1, log_every=0,
        device="cpu")
    assert losses[0] == pytest.approx(float(jl), rel=1e-5)
    params_close(te2, jp["enc"])
    params_close(td2, jp["dec"])


def _jax_flow_draws(seed, steps, seg, n, shape, cond_drop=0.1):
    """The draws JAX's segment runner gives the flow loss at each step: a
    segment key split from PRNGKey(seed), a step key split from it in the
    scan, then (t, ε, drop) from its three-way split."""
    key = jax.random.PRNGKey(seed)
    out, done = [], 0
    while done < steps:
        k = min(seg, steps - done)
        key, sub = jax.random.split(key)
        for _ in range(k):
            sub, step_key = jax.random.split(sub)
            k_t, k_eps, k_drop = jax.random.split(step_key, 3)
            out.append(tuple(torch.from_numpy(np.array(a)) for a in (
                jax.random.uniform(k_t, (n,)),
                jax.random.normal(k_eps, shape),
                jax.random.bernoulli(k_drop, cond_drop, (n,)))))
        done += k
    return out


def test_flow_trainer(data, monkeypatch):
    jcfg, tcfg = micro_f32()
    seed, steps, batch = 1, 2, 3
    lats = np.random.default_rng(10).normal(size=(6, 16, 8)).astype(
        np.float32)
    imgs = data["imgs"]
    tc = tcfg.cond_encoder("cpu")
    td = tdit.ShapeDiT(tcfg.dit, device="cpu")
    gen = torch.Generator().manual_seed(5)
    init_flax_style_(tc, gen)
    tdit.init_flax_style_(td, gen)
    tdit.draw_zero_init_leaves_(td, gen)
    init = {"cond": _tree(tc), "dit": _tree(td)}
    cond, dit = jax_cond_f32(jcfg), jdit.ShapeDiT(jcfg.dit)
    draws = _jax_flow_draws(seed, steps, 25, batch, (batch, 16, 8))

    def jloss(p, img, x0, t, eps, drop):   # train_flow's loss, its draws
        cond_tok = cond.apply(p["cond"], img)
        x_t = (1.0 - t)[:, None, None] * x0 + t[:, None, None] * eps
        cond_used = jnp.where(drop[:, None, None], 0.0, cond_tok)
        v = dit.apply(p["dit"], x_t, t, cond_used)
        return jnp.mean((v - (eps - x0)) ** 2)

    rows = _segment_batches(seed, 6, batch, 25, steps)
    batches = [(imgs[r], lats[r], *(d.numpy() for d in dr))
               for r, dr in zip(rows, draws)]
    tx = optax.adamw(optax.cosine_decay_schedule(1e-3, steps, 0.05))
    jp, (jl, jg) = jax_steps(jax.jit(jax.value_and_grad(jloss)), init,
                             batches, tx)
    loss = port_grads(lambda: tsh.flow_loss(tc, td, t_(batches[0][0]),
                                            t_(batches[0][1]), None,
                                            draws=draws[0]),
                      list(tc.parameters()) + list(td.parameters()))
    assert loss == pytest.approx(float(jl), rel=1e-5)
    grads_close(tc, jg["cond"])
    grads_close(td, jg["dit"])
    # JAX's weights and, step by step, JAX's draws
    monkeypatch.setattr(tsh, "init_flax_style_",
                        lambda m, g: load_from_jax(m, init["cond"]))
    monkeypatch.setattr(tsh, "init_dit_",
                        lambda m, g: load_from_jax(m, init["dit"]))
    step_draws, flow_loss = iter(draws), tsh.flow_loss
    monkeypatch.setattr(tsh, "flow_loss", lambda *a: flow_loss(
        *a, draws=next(step_draws)))
    tc2, td2, losses = tsh.train_flow(
        tcfg, lats, imgs, steps, batch=batch, seed=seed, log_every=0,
        device="cpu")
    assert losses[0] == pytest.approx(float(jl), rel=1e-5)
    params_close(tc2, jp["cond"])
    params_close(td2, jp["dit"])


def test_micro_checkpoint_loads_in_jax(tmp_path):
    """A micro distill_shape saved by the port decodes in JAX's
    load_generator to the same SDF grid, and its sampler gives the same
    latents from one noise (both in f32)."""
    cfg = tsh.DistillConfig.micro()
    gen, report = tsh.distill_shape(cfg, n_shapes=4, vae_steps=2,
                                    flow_steps=2, batch=2, seg=1, log_every=0,
                                    n_surface=64, n_query=64, device="cpu")
    assert np.isfinite(report["vae_loss_final"])
    path = str(tmp_path / "g.npz")
    tsh.save_generator(path, cfg, tsh.generator_params(gen))
    jgen = jsh.load_generator(path)
    tcfg, params = tsh.load_params(path)
    tgen = tsh.build_generator(tcfg.with_dtype(torch.float32),
                               params["cond"], params["dit"], params["dec"],
                               device="cpu")
    jvae = dataclasses.replace(jgen.vae_cfg, dtype=F32)
    jdcfg = dataclasses.replace(jgen.dit_cfg, dtype=F32)
    z = np.random.default_rng(12).normal(size=(1, 16, 8)).astype(np.float32)
    jvol = jsv.decode_grid(jsv.ShapeDecoder(jvae), jgen.params["dec"],
                           jnp.asarray(z), resolution=12, chunk=512)
    with torch.no_grad():
        tvol = decode_grid(tgen.decoder, t_(z), resolution=12, chunk=512)
    np.testing.assert_allclose(tvol.numpy(), np.asarray(jvol), rtol=0,
                               atol=1e-5)
    img = np.random.default_rng(13).random((1, 32, 32, 4)).astype(np.float32)
    jc = jax_cond_f32(tcfg).apply(jgen.params["cond"], jnp.asarray(img))
    jlat = jdit.sample(jdit.ShapeDiT(jdcfg), jgen.params["dit"],
                       jax.random.PRNGKey(0), jc, num_steps=2,
                       guidance_scale=3.0, latents=jnp.asarray(z))
    with torch.no_grad():
        tlat = tdit.sample(tgen.dit, tgen.cond(t_(img)), num_steps=2,
                           guidance_scale=3.0, latents=t_(z))
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), rtol=0,
                               atol=2e-5)
