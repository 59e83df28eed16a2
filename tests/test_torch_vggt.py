"""Port VGGT vs the JAX package in f32 on the tiny config with weights
carried by from_jax: the layers where flax and torch differ (tanh GELU,
LayerNorm eps 1e-6, SAME conv padding, antialiased bilinear resize), the
sin-cos embedding, the whole model (rtol 1e-4, atol 1e-4), and the camera
decoding and depth unprojection."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regen3d_tpu.models import layers as jl
from regen3d_tpu.models import vggt as jv
from regen3d_tpu_torch.models import layers as tl
from regen3d_tpu_torch.models import vggt as tv
from regen3d_tpu_torch.models.from_jax import load_from_jax
from test_torch_package import one_torch_thread  # noqa: F401


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 101).astype(np.float32)
    np.testing.assert_allclose(tl.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(fnn.gelu(jnp.asarray(x))), atol=1e-6)


def test_layernorm_eps_and_affine():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 16)) * 1e-3).astype(np.float32)   # eps matters
    scale = rng.normal(size=16).astype(np.float32)
    bias = rng.normal(size=16).astype(np.float32)
    ln = fnn.LayerNorm()
    want = ln.apply({"params": {"scale": scale, "bias": bias}}, jnp.asarray(x))
    mod = tl.LayerNorm(16, device="cpu")
    mod.weight.data = torch.from_numpy(scale)
    mod.bias.data = torch.from_numpy(bias)
    np.testing.assert_allclose(mod(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    plain = fnn.LayerNorm(use_scale=False, use_bias=False).apply({}, jnp.asarray(x))
    np.testing.assert_allclose(tl.LayerNorm(16, affine=False, device="cpu")(torch.from_numpy(x)).numpy(),
                               np.asarray(plain), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel,stride,hw", [(3, 1, 9), (1, 1, 5), (14, 14, 28)])
def test_conv_same_padding(kernel, stride, hw):
    rng = np.random.default_rng(kernel)
    x = rng.normal(size=(2, hw, hw, 4)).astype(np.float32)
    conv = fnn.Conv(6, (kernel, kernel), strides=(stride, stride))
    p = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = conv.apply(p, jnp.asarray(x))
    mod = tl.Conv(4, 6, kernel, stride=stride, device="cpu")
    mod.weight.data = torch.from_numpy(
        np.asarray(p["params"]["kernel"]).transpose(3, 2, 0, 1).copy())
    mod.bias.data = torch.from_numpy(np.array(p["params"]["bias"]))
    np.testing.assert_allclose(mod(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("src,dst", [(37, 18), (37, 148), (18, 37), (8, 3),
                                     (148, 518)])
def test_dpt_resize_matches_jax_image_resize(src, dst):
    x = np.random.default_rng(src).normal(size=(1, src, src, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (1, dst, dst, 3), "bilinear")
    got = tv.resize_bilinear(torch.from_numpy(x), (dst, dst))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_posemb_sincos_2d():
    np.testing.assert_allclose(tl.posemb_sincos_2d(3, 5, 18).numpy(),
                               np.asarray(jl.posemb_sincos_2d(3, 5, 18)),
                               atol=1e-6)


@pytest.fixture(scope="module")
def tiny_pair():
    jc = dataclasses.replace(jv.VGGTConfig.tiny(), dtype=jnp.float32)
    tc = dataclasses.replace(tv.VGGTConfig.tiny(), dtype=torch.float32)
    imgs = np.random.default_rng(0).random((1, 2, 28, 28, 3)).astype(np.float32)
    jm = jv.VGGT(jc)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(imgs))
    # non-trivial LayerScale and modulation, so those paths carry signal
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.05 if path[-1].key in ("ls1", "ls2") else
        (x + 0.01 if "poseLN_modulation" in str(path) else x), params)
    tm = tv.VGGT(tc, device="cpu")
    load_from_jax(tm, jax.device_get(params))
    return jm, params, tm, imgs


def test_tiny_vggt_matches_jax(tiny_pair):
    jm, params, tm, imgs = tiny_pair
    want = jax.jit(jm.apply)(params, jnp.asarray(imgs))
    with torch.no_grad():
        got = tm(torch.from_numpy(imgs))
    for key in ("pose_enc", "depth", "depth_conf"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


def test_pose_encoding_to_camera_and_unproject():
    rng = np.random.default_rng(3)
    enc = rng.normal(size=(2, 9)).astype(np.float32)
    enc[:, 7:9] = [0.9, 1.1]
    hw = (24, 32)
    want = jv.pose_encoding_to_camera(jnp.asarray(enc), hw)
    got = tv.pose_encoding_to_camera(torch.from_numpy(enc), hw)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    depth = (1.0 + rng.random(hw)).astype(np.float32)
    np.testing.assert_allclose(
        tv.unproject_depth(torch.from_numpy(depth), got, 1).numpy(),
        np.asarray(jv.unproject_depth(jnp.asarray(depth), want, 1)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ratio", [0.5])
def test_token_merging_matches_jax(tiny_pair, ratio):
    """FastVGGT merging (replaces the refusal the port had before it was
    ported): the merged tiny model against the JAX package's, rtol/atol
    1e-4, at a ratio that merges 2 of the second frame's 4 patch tokens."""
    jm, params, tm, imgs = tiny_pair
    jc = dataclasses.replace(jm.cfg, token_merge_ratio=ratio)
    tc = dataclasses.replace(tm.cfg, token_merge_ratio=ratio)
    want = jax.jit(jv.VGGT(jc).apply)(params, jnp.asarray(imgs))
    merged = tv.VGGT(tc, device="cpu")
    merged.load_state_dict(tm.state_dict())
    with torch.no_grad():
        got = merged(torch.from_numpy(imgs))
        plain = tm(torch.from_numpy(imgs))
    for key in ("pose_enc", "depth", "depth_conf"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)
    # the merge is on this path: the result moves against the plain model
    assert float((got["depth"] - plain["depth"]).abs().max()) > 1e-4
