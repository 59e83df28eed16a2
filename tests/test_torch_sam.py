"""Port SAM vs the JAX package in f32 on ``SamConfig.tiny()`` with weights
carried by ``from_jax``, all drawn from a numpy seed; the rel-pos tables
are N(0, 0.5²) (they start at zero in flax, where a dropped bias would go
unseen):

* ``grid_bias_reference`` (the grid-bias kernel's plain version) against
  JAX ``flash_attention_grid_bias`` in interpret mode, atol/rtol 2e-5;
* ``ConvTranspose`` taps against flax's with a non-symmetric kernel;
* the weight bridge uses every leaf once (strict);
* the image encoder through the einsum path and the grid-bias path,
  rtol 2e-4, atol 2e-5 (``tests/test_models_sam.py``'s tolerance);
* ``SAM.decode`` with boxes, points and padding labels: masks and IoU
  within 1e-4 of their largest value;
* the image encoder's gradient (of Σ emb²) against ``jax.grad`` through the
  grid-bias path and the einsum path: every parameter within 2e-4 relative
  plus 2e-5 of its largest value.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regen3d_tpu.models import sam as js
from regen3d_tpu.ops.attention import _gb_fwd_impl, flash_attention_grid_bias
from regen3d_tpu_torch.models import sam as ts
from regen3d_tpu_torch.models.from_jax import (
    SAM_CONV_TRANSPOSE,
    load_from_jax,
    state_from_jax,
)
from regen3d_tpu_torch.models.layers import ConvTranspose
from regen3d_tpu_torch.ops.attention import (
    flash_attention_grid_bias_fwd,
    grid_bias_reference,
)
from test_torch_package import one_torch_thread  # noqa: F401

REL_POS_STD = 0.5


def jax_tiny_sam(flash_min_tokens=1024, seed=0):
    """JAX tiny SAM in f32 and params for it drawn from a numpy seed: the
    tree's shapes come from ``jax.eval_shape`` (no compile), kernels are
    N(0, 1/fan_in), every other leaf N(0, 0.5²) but LayerNorm scales
    1 + N(0, 0.1²), so biases, LayerNorms and the rel-pos tables are all
    non-trivial."""
    jc = dataclasses.replace(js.SamConfig.tiny(), dtype=jnp.float32,
                             flash_min_tokens=flash_min_tokens)
    model = js.SAM(jc)
    s = jc.image_size
    shapes = jax.eval_shape(
        model.init, jax.random.PRNGKey(0), jnp.zeros((1, s, s, 3)),
        jnp.zeros((1, 4, 2)), -jnp.ones((1, 4)), jnp.zeros((1, 2, 2)))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        x = rng.normal(size=leaf.shape)
        if name == "kernel":
            x = x / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "scale":
            x = 1.0 + 0.1 * x
        else:
            x = x * REL_POS_STD
        return x.astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(draw, shapes)


def port_sam(params, flash_min_tokens=1024):
    tc = dataclasses.replace(ts.SamConfig.tiny(), dtype=torch.float32,
                             flash_min_tokens=flash_min_tokens)
    model = ts.SAM(tc, device="cpu")
    load_from_jax(model, params, SAM_CONV_TRANSPOSE)
    return model.eval()


@pytest.fixture(scope="module")
def tiny_pair():
    jm, params = jax_tiny_sam()
    return jm, params, port_sam(params)


def _grid_problem(rng, b, h, kh, kw, d):
    s = kh * kw
    q, k, v = (rng.normal(size=(b, h, s, d)).astype(np.float32)
               for _ in range(3))
    bh = (rng.normal(size=(b, h, s, kh)) * 0.5).astype(np.float32)
    bw = (rng.normal(size=(b, h, s, kw)) * 0.5).astype(np.float32)
    return q, k, v, bh, bw


@pytest.mark.parametrize("b,h,kh,kw,d,block_q", [(1, 2, 6, 10, 16, 16),
                                                 (2, 2, 14, 14, 8, 64)])
def test_grid_bias_reference_matches_pallas(b, h, kh, kw, d, block_q):
    """The second case is the 14×14 SAM window, which the JAX side pads to
    whole key-grid rows and q tiles."""
    args = _grid_problem(np.random.default_rng(7), b, h, kh, kw, d)
    want = np.asarray(flash_attention_grid_bias(
        *(jnp.asarray(a) for a in args), kw, None, block_q, True))
    _, want_lse = _gb_fwd_impl(*(jnp.asarray(a) for a in args), kw, None,
                               block_q, True)
    o, lse = grid_bias_reference(*(torch.from_numpy(a) for a in args), kw)
    np.testing.assert_allclose(o.numpy(), want, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=2e-5,
                               rtol=2e-5)
    # the wrapper takes the plain version for CPU tensors
    o2, _ = flash_attention_grid_bias_fwd(
        *(torch.from_numpy(a) for a in args), kw)
    torch.testing.assert_close(o2, o)


def test_grid_bias_wrapper_rejects_bad_shapes():
    q, k, v, bh, bw = (torch.from_numpy(a) for a in _grid_problem(
        np.random.default_rng(0), 1, 2, 4, 5, 16))
    with pytest.raises(ValueError, match="shapes"):
        flash_attention_grid_bias_fwd(q, k, v, bh, bw, 3)   # 20 % 3 != 0
    with pytest.raises(ValueError, match="bias shapes"):
        flash_attention_grid_bias_fwd(q, k, v, bw, bh, 5)   # factors swapped


@pytest.mark.parametrize("c_in,c_out", [(4, 6), (5, 5)])
def test_conv_transpose_taps_match_flax(c_in, c_out):
    """Each 2×2 tap is distinct, so a tap landing on the wrong output offset
    fails; I = O is the case a Conv rule would load without complaint."""
    rng = np.random.default_rng(c_in)
    x = rng.normal(size=(2, 3, 4, c_in)).astype(np.float32)
    conv = fnn.ConvTranspose(c_out, (2, 2), strides=(2, 2))
    params = {"params": {"up1": {
        "kernel": rng.normal(size=(2, 2, c_in, c_out)).astype(np.float32),
        "bias": rng.normal(size=(c_out,)).astype(np.float32)}}}
    want = conv.apply({"params": params["params"]["up1"]}, jnp.asarray(x))
    mod = ConvTranspose(c_in, c_out, device="cpu")
    state = state_from_jax(params, frozenset({"up1"}))
    mod.load_state_dict({k.split(".", 1)[1]: v for k, v in state.items()})
    got = mod(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 6, 8, c_out)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)


def test_weight_bridge_uses_every_leaf_once(tiny_pair):
    _, params, model = tiny_pair
    n_leaves = len(jax.tree_util.tree_leaves(params))
    state = state_from_jax(params, SAM_CONV_TRANSPOSE)
    assert len(state) == n_leaves == len(model.state_dict())
    k = np.asarray(params["params"]["mask_decoder"]["up1"]["kernel"])
    np.testing.assert_array_equal(
        model.mask_decoder.up1.weight.detach().numpy(),
        k[::-1, ::-1].transpose(2, 3, 0, 1))
    rel = params["params"]["image_encoder"]["block1"]["attn"]["rel_pos_h"]
    assert np.abs(rel).max() > 0.5
    np.testing.assert_array_equal(
        model.image_encoder.block1.attn.rel_pos_h.detach().numpy(), rel)
    # without the ConvTranspose rule the up-convolutions do not load
    with pytest.raises(RuntimeError, match="up1"):
        model.load_state_dict(state_from_jax(params), strict=True)
    stray = jax.tree_util.tree_map(lambda x: x, params)
    stray["params"]["mask_decoder"]["stray"] = np.zeros(3, np.float32)
    with pytest.raises(RuntimeError, match="stray"):
        load_from_jax(model, stray, SAM_CONV_TRANSPOSE)


@pytest.mark.parametrize("flash_min_tokens", [10 ** 9, 1],
                         ids=["einsum", "grid_bias"])
def test_image_encoder_matches_jax(tiny_pair, flash_min_tokens):
    """10⁹: every block takes the einsum path; 1: every block (the 2×2
    windows and the 4×4 global block) takes the grid-bias path."""
    _, params, _ = tiny_pair
    jc = dataclasses.replace(js.SamConfig.tiny(), dtype=jnp.float32,
                             flash_min_tokens=flash_min_tokens)
    img = np.random.default_rng(5).random((2, 64, 64, 3)).astype(np.float32)
    enc_params = {"params": params["params"]["image_encoder"]}
    want = jax.jit(js.SamImageEncoder(jc).apply)(enc_params, jnp.asarray(img))
    model = port_sam(params, flash_min_tokens)
    with torch.no_grad():
        got = model.encode(torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)


def test_decode_matches_jax(tiny_pair):
    jm, params, model = tiny_pair
    rng = np.random.default_rng(11)
    emb = rng.normal(size=(4, 4, 4, 32)).astype(np.float32)
    pts = rng.random((4, 4, 2)).astype(np.float32)
    labs = np.array([[1, 0, -1, -1], [1, 1, 1, 1], [-1, -1, -1, -1],
                     [0, -1, 1, -1]], np.float32)
    lo = rng.random((4, 2)) * 0.5
    boxes = np.stack([lo, lo + 0.1 + rng.random((4, 2)) * 0.4], 1) \
        .astype(np.float32)
    want_m, want_iou = jax.jit(lambda *a: jm.apply(params, *a,
                                                   method=js.SAM.decode))(
        jnp.asarray(emb), jnp.asarray(pts), jnp.asarray(labs),
        jnp.asarray(boxes))
    with torch.no_grad():
        got_m, got_iou = model.decode(*(torch.from_numpy(a) for a in
                                        (emb, pts, labs, boxes)))
    want_m, want_iou = np.asarray(want_m), np.asarray(want_iou)
    assert got_m.shape == want_m.shape == (4, 4, 16, 16)
    assert np.abs(got_m.numpy() - want_m).max() <= 1e-4 * np.abs(want_m).max()
    assert np.abs(got_iou.numpy() - want_iou).max() <= \
        1e-4 * np.abs(want_iou).max()


@pytest.mark.parametrize("flash_min_tokens", [10 ** 9, 1],
                         ids=["einsum", "grid_bias"])
def test_image_encoder_gradient_matches_jax(tiny_pair, flash_min_tokens):
    """The gradient of Σ emb² with respect to every encoder parameter. On
    the grid-bias path the bias factors come from q, so q's gradient has a
    bias term that autograd adds through the op's dbias outputs; the qkv
    and rel-pos gradients see it."""
    _, params, _ = tiny_pair
    jc = dataclasses.replace(js.SamConfig.tiny(), dtype=jnp.float32,
                             flash_min_tokens=flash_min_tokens)
    img = np.random.default_rng(6).random((1, 64, 64, 3)).astype(np.float32)
    enc = js.SamImageEncoder(jc)

    def loss(p):
        return jnp.sum(enc.apply({"params": p}, jnp.asarray(img)) ** 2)

    want = jax.jit(jax.grad(loss))(params["params"]["image_encoder"])
    model = port_sam(params, flash_min_tokens)
    (model.encode(torch.from_numpy(img)) ** 2).sum().backward()
    got = {name: p.grad for name, p in model.image_encoder.named_parameters()}
    flat = state_from_jax({"params": want})
    assert set(flat) == set(got)
    for name, w in flat.items():
        w = w.numpy()
        np.testing.assert_allclose(got[name].numpy(), w, rtol=2e-4,
                                   atol=2e-5 * np.abs(w).max(), err_msg=name)
    assert np.abs(flat["block1.attn.rel_pos_h"].numpy()).max() > 0
