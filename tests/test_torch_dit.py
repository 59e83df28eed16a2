"""Port shape DiT and its training step vs the JAX package in f32 on
``DiTConfig.tiny()`` (width 64, 4 heads of 16, depth 2), weights carried by
``from_jax`` and drawn from a numpy seed with every leaf non-zero: the
AdaLN-Zero leaves (``adaLN``, ``adaLN_out``, ``x_out`` kernels and the
``inst_gate``s) start at zero in flax, where the gradient stops at
``x_out`` and a backward that returned zeros would pass. The JAX side runs
its Pallas flash kernels in interpret mode under ``jax.jit``.

* the forward with the MIDI cross-instance attention, rtol 2e-4, atol 2e-5
  of the largest value; and the zero-gate cross-instance model equals the
  plain one;
* ``flow_matching_loss`` and every gradient leaf, fed JAX's own draws
  (t, ε, drop), at rtol 2e-4 and atol 2e-5 of each leaf's largest value;
* three ``train_step``s against JAX's with optax ``adamw``: the parameters
  within atol 2·lr (Adam's normalised step moves a parameter whose gradient
  is near 0 by ±lr whichever its sign);
* ``make_optimizer`` against optax ``adamw`` on plain tensors, 1e-6;
* ``sample`` at 4 steps, guidance 5, from the same latents;
* the weight bridge uses every leaf once (strict).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from regen3d_tpu.models import dit as jd
from regen3d_tpu.parallel import train as jt
from regen3d_tpu_torch.models import dit as td
from regen3d_tpu_torch.models.from_jax import load_from_jax, state_from_jax
from regen3d_tpu_torch.parallel import train as tt
from test_torch_package import one_torch_thread  # noqa: F401

B, COND_LEN = 4, 5
LR = 1e-4


def jax_params(cross_instance, seed=0):
    """A flax tree for the tiny DiT in f32, drawn from a numpy seed: kernels
    N(0, 1/fan_in), norm scales 1 + N(0, 0.1²), every other leaf N(0, 0.1²)
    (so biases, ``latent_pos`` and the gates are non-zero)."""
    jc = dataclasses.replace(jd.DiTConfig.tiny(), dtype=jnp.float32,
                             cross_instance=cross_instance)
    c = jc
    shapes = jax.eval_shape(
        jd.ShapeDiT(jc).init, jax.random.PRNGKey(0),
        jnp.zeros((1, c.latent_tokens, c.latent_dim)), jnp.zeros((1,)),
        jnp.zeros((1, COND_LEN, c.cond_dim)))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        x = rng.normal(size=leaf.shape)
        if name == "kernel":
            x = x / np.sqrt(leaf.shape[0])
        elif name == "scale":
            x = 1.0 + 0.1 * x
        else:
            x = 0.1 * x
        return x.astype(np.float32)

    return jd.ShapeDiT(jc), jax.tree_util.tree_map_with_path(draw, shapes)


def port_dit(params, cross_instance):
    tc = dataclasses.replace(td.DiTConfig.tiny(), dtype=torch.float32,
                             cross_instance=cross_instance)
    model = td.ShapeDiT(tc, device="cpu")
    load_from_jax(model, params)
    return model


def inputs(seed=1):
    c = td.DiTConfig.tiny()
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(B, c.latent_tokens, c.latent_dim)).astype(np.float32)
    cond = rng.normal(size=(B, COND_LEN, c.cond_dim)).astype(np.float32)
    return x0, cond


def jax_draws(key, x0):
    """The (t, ε, drop) that JAX's ``flow_matching_loss`` draws from
    ``key``, as numpy."""
    k_t, k_eps, k_drop = jax.random.split(key, 3)
    b = x0.shape[0]
    return (np.asarray(jax.random.uniform(k_t, (b,))),
            np.asarray(jax.random.normal(k_eps, x0.shape, x0.dtype)),
            np.asarray(jax.random.bernoulli(k_drop, 0.1, (b,))))


def keys_with_a_drop(x0, n):
    """n keys in a fixed order whose draws drop the condition for some but
    not all of the batch, so the masking is exercised."""
    out, i = [], 0
    while len(out) < n:
        key = jax.random.PRNGKey(100 + i)
        drop = jax_draws(key, x0)[2]
        if drop.any() and not drop.all():
            out.append(key)
        i += 1
    return out


def torch_draws(draws):
    return tuple(torch.from_numpy(np.array(a)) for a in draws)


def assert_leaf_close(got, want, name):
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=2e-5 * np.abs(want).max(), err_msg=name)


@pytest.fixture(scope="module")
def plain_pair():
    jm, params = jax_params(cross_instance=False)
    return jm, params, port_dit(params, False)


@pytest.fixture(scope="module")
def ci_pair():
    """The cross-instance model's flax module and tree."""
    return jax_params(cross_instance=True)


def test_weight_bridge_uses_every_leaf_once(ci_pair):
    params = jax.tree_util.tree_map(np.array, ci_pair[1])
    n_leaves = len(jax.tree_util.tree_leaves(params))
    state = state_from_jax(params)
    model = port_dit(params, True)
    assert len(state) == n_leaves == len(model.state_dict())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    np.testing.assert_array_equal(
        model.block0.attn.q_norm.weight.detach().numpy(),
        params["params"]["block0"]["attn"]["q_norm"]["scale"])
    np.testing.assert_array_equal(model.inst_gate1.detach().numpy(),
                                  params["params"]["inst_gate1"])
    params["params"]["block1"]["stray"] = np.zeros(3, np.float32)
    with pytest.raises(RuntimeError, match="stray"):
        load_from_jax(model, params)


def test_forward_matches_jax_with_cross_instance(ci_pair):
    jm, params = ci_pair
    model = port_dit(params, True)
    x0, cond = inputs()
    t = np.random.default_rng(2).random(B).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(params, x0, t, cond))
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in (x0, t, cond)))
    assert got.shape == want.shape == x0.shape
    assert_leaf_close(got.numpy(), want, "v")


def test_zero_gate_cross_instance_is_the_plain_model(plain_pair, ci_pair):
    """With every ``inst_gate`` at zero (flax's init), the cross-instance
    model gives the plain model's output: a plain checkpoint loads and
    behaves the same."""
    _, params, plain = plain_pair
    model = port_dit(ci_pair[1], True)
    model.load_state_dict(plain.state_dict(), strict=False)
    with torch.no_grad():
        for i in range(model.cfg.depth):
            getattr(model, f"inst_gate{i}").zero_()
        x0, cond = (torch.from_numpy(a) for a in inputs())
        t = torch.full((B,), 0.3)
        torch.testing.assert_close(model(x0, t, cond), plain(x0, t, cond),
                                   atol=0, rtol=0)


@pytest.fixture(scope="module")
def jax_training(plain_pair):
    """Three steps of JAX's ``train_step`` with optax ``adamw``, each with
    ``jax.value_and_grad`` of its loss at the step's starting parameters,
    in one jitted program (one compile for both)."""
    jm, params, _ = plain_pair
    x0, cond = (jnp.asarray(a) for a in inputs())
    opt = jt.make_optimizer(LR)

    def run(state, key):
        grad = jax.value_and_grad(
            lambda p: jd.flow_matching_loss(jm, p, key, x0, cond))
        return jt.train_step(jm, opt, state, key, x0, cond), grad(state.params)

    step = jax.jit(run)
    state = jt.TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
    keys = keys_with_a_drop(np.asarray(x0), 3)
    losses, grads = [], []
    for key in keys:
        (state, loss), (_, g) = step(state, key)
        losses.append(float(loss))
        grads.append(g)
    return dict(keys=keys, losses=losses, first_grads=grads[0],
                params=state.params)


def test_loss_and_every_gradient_match_jax(plain_pair, jax_training):
    _, _, model = plain_pair
    x0, cond = inputs()
    key = jax_training["keys"][0]
    model.zero_grad(set_to_none=True)
    loss = td.flow_matching_loss(model, torch.from_numpy(x0),
                                 torch.from_numpy(cond), None,
                                 draws=torch_draws(jax_draws(key, x0)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()),
                               jax_training["losses"][0], rtol=2e-5)
    flat = state_from_jax(jax_training["first_grads"])
    got = dict(model.named_parameters())
    assert set(flat) == set(got)
    for name, w in flat.items():
        assert_leaf_close(got[name].grad.numpy(), w.numpy(), name)
    # every attention sees a gradient
    assert float(got["block0.attn.q.weight"].grad.abs().max()) > 0


def test_three_train_steps_match_jax(plain_pair, jax_training):
    _, params, _ = plain_pair
    model = port_dit(params, False)
    x0, cond = inputs()
    t_opt = tt.make_optimizer(model.parameters(), lr=LR)
    for key, want_loss in zip(jax_training["keys"], jax_training["losses"]):
        loss = tt.train_step(model, t_opt, torch.from_numpy(x0),
                             torch.from_numpy(cond), None,
                             draws=torch_draws(jax_draws(key, x0)))
        np.testing.assert_allclose(float(loss), want_loss, rtol=2e-4)
    got = model.state_dict()
    start = state_from_jax(params)
    moved = 0.0
    for name, w in state_from_jax(jax_training["params"]).items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=2 * LR,
                                   rtol=0, err_msg=name)
        moved = max(moved, float(np.abs(w.numpy()
                                        - start[name].numpy()).max()))
    assert moved > 2 * LR          # the steps moved the parameters


def test_make_optimizer_is_optax_adamw():
    """torch's decoupled decay and bias corrections against optax's on
    plain tensors, three steps with varied gradients."""
    rng = np.random.default_rng(3)
    p0 = rng.normal(size=(5, 7)).astype(np.float32)
    grads = [rng.normal(size=p0.shape).astype(np.float32) for _ in range(3)]
    opt = jt.make_optimizer(1e-2, weight_decay=0.1)
    jp = jnp.asarray(p0)
    st = opt.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = tt.make_optimizer([tp], lr=1e-2, weight_decay=0.1)
    for g in grads:
        upd, st = opt.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        topt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), atol=1e-6)


def test_sample_matches_jax(plain_pair):
    jm, params, model = plain_pair
    c = td.DiTConfig.tiny()
    rng = np.random.default_rng(4)
    cond = rng.normal(size=(2, COND_LEN, c.cond_dim)).astype(np.float32)
    lat = rng.normal(size=(2, c.latent_tokens, c.latent_dim)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, cd, la: jd.sample(
        jm, p, jax.random.PRNGKey(0), cd, num_steps=4, guidance_scale=5.0,
        latents=la))(params, cond, lat))
    got = td.sample(model, torch.from_numpy(cond), num_steps=4,
                    guidance_scale=5.0, latents=torch.from_numpy(lat))
    assert got.shape == want.shape == lat.shape
    assert_leaf_close(got.numpy(), want, "sample")


def test_flax_style_init_zeroes_the_adaln_zero_leaves():
    cfg = dataclasses.replace(td.DiTConfig.tiny(), cross_instance=True)
    model = td.ShapeDiT(cfg, device="cpu")
    tt.init_state(model, torch.Generator().manual_seed(0))
    for name, p in model.named_parameters():
        zero = (name.endswith(("adaLN.weight", "adaLN_out.weight",
                               "x_out.weight")) or name.startswith("inst_gate")
                or name.endswith(".bias"))
        assert (float(p.detach().abs().max()) == 0) == zero, name
    td.draw_zero_init_leaves_(model, torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert float(model.x_out.weight.abs().min()) > 0
        assert float(model.inst_gate0.abs().min()) > 0
        assert float(model.block1.adaLN.weight.abs().max()) > 0
