"""The port's upstream key layouts (``regen3d_tpu_torch/models/
conversion.py``) against the JAX package's tables, on the CPU:

* each of the eight ported families: the JAX package's
  ``conversion.synthetic_state`` (its inverse map on a tiny tree, drawn
  from a seed so that every leaf carries signal) loads through the port's
  ``load_upstream`` with zero unmapped keys into the tensors
  ``from_jax.load_from_jax`` gives from the same tree, and the port's own
  inverse (``upstream_state``) rebuilds the JAX package's state dict key for
  key and value for value;
* the diverged families raise as in JAX, the unported ones name Queue 1
  item 5;
* the CLI: ``--selftest``, a conversion with ``--verify`` into a directory
  that loads, and the ``--max-unmapped`` refusal;
* VGGT, SAM and the DiT on the committed activation fixtures (the tiny
  models at PRNGKey(0), carried into the port through the upstream layout).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regen3d_tpu.models import conversion as jc
from regen3d_tpu_torch import convert_weights
from regen3d_tpu_torch.models import conversion as tc
from regen3d_tpu_torch.models.from_jax import load_from_jax
from regen3d_tpu_torch.models.weights import (
    convert_state_dict,
    load_model,
    to_numpy,
)
from test_torch_package import ROOT, one_torch_thread  # noqa: F401

PORTED = ["sam", "vggt", "dust3r", "lpips", "dit", "midi", "depth_anything",
          "shapevae"]
FIXTURES = ROOT / "tests" / "fixtures" / "activations"


def _drawn_tiny_init(family, seed):
    """The JAX family's tiny tree (shapes from ``jax.eval_shape``, no
    compile) with every leaf drawn from a numpy seed."""
    shapes = jax.eval_shape(jc.FAMILIES[family].tiny_init)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (0.2 * rng.normal(size=s.shape)).astype(np.float32), shapes)


@pytest.mark.parametrize("family", PORTED)
def test_family_loads_the_jax_synthetic_state(family, monkeypatch):
    init = _drawn_tiny_init(family, PORTED.index(family))
    if family == "dust3r":      # upstream shares one final decoder norm
        init["params"]["dec_norm2"] = init["params"]["dec_norm1"]
    monkeypatch.setattr(jc.FAMILIES[family], "tiny_init", lambda: init)
    state, _ = jc.synthetic_state(family)
    fam = tc.FAMILIES[family]
    assert fam.status == jc.FAMILIES[family].status
    # zero unmapped keys, every leaf of the tree
    unmapped = []
    convert_state_dict(state, fam.rules(), unmapped_out=unmapped)
    assert unmapped == []
    got = fam.tiny_model(torch.Generator().manual_seed(1))
    want = fam.tiny_model(torch.Generator().manual_seed(2))
    tc.load_upstream(family, state, got)
    load_from_jax(want, init, fam.conv_transpose)
    sg, sw = got.state_dict(), want.state_dict()
    assert sorted(sg) == sorted(sw)
    for k in sg:
        assert torch.equal(sg[k], sw[k]), k
    # the port's inverse rebuilds the JAX package's state dict
    mine = tc.upstream_state(family, init)
    assert sorted(mine) == sorted(state)
    for k in state:
        np.testing.assert_array_equal(mine[k], np.asarray(state[k]),
                                      err_msg=k)
    # a key no rule knows is refused
    with pytest.raises(KeyError, match="unmapped"):
        tc.load_upstream(family, {**state, "stray.weight": np.zeros(2)}, got)


@pytest.mark.parametrize("family", ["detector", "saliency", "matting"])
def test_diverged_families_raise_as_in_jax(family):
    with pytest.raises(NotImplementedError) as j_err:
        jc.FAMILIES[family].rules()
    with pytest.raises(NotImplementedError) as t_err:
        tc.FAMILIES[family].rules()
    assert str(t_err.value) == str(j_err.value)
    assert tc.selftest(family) == []


@pytest.mark.parametrize("family", ["sd_unet", "sd_vae", "marigold",
                                    "esrgan", "flux"])
def test_unported_families_name_item_5(family):
    assert family in jc.FAMILIES and tc.FAMILIES[family].status == "pending"
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        tc.FAMILIES[family].rules()
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        tc.tiny_init(family)


def test_selftest_cli(capsys):
    assert convert_weights.main(["--selftest"]) == 0
    out = capsys.readouterr().out
    for fam in PORTED:
        assert f"{fam}" in out
    assert out.count(": OK") == len(PORTED) + 3
    assert out.count("waiting for ROADMAP Queue 1 item 5") == 5


def test_convert_cli_writes_a_directory_that_loads(tmp_path):
    """An upstream LPIPS ``.pth`` (the port's tiny module in upstream
    layout) → ``--verify`` against the full-size module on ``meta`` → the
    port's directory, which loads into the same tensors; one key too many
    past ``--max-unmapped`` refuses to save."""
    from regen3d_tpu_torch.models.lpips import LPIPS

    state, tree = tc.synthetic_state("lpips", seed=3)
    ckpt = str(tmp_path / "lpips.pth")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in state.items()}},
            ckpt)
    out = str(tmp_path / "out")
    assert convert_weights.main(["lpips", ckpt, out, "--verify"]) == 0
    model = load_model(LPIPS(device="cpu"), out)
    ref = LPIPS(device="cpu")
    load_from_jax(ref, tree)
    for a, b in zip(model.state_dict().values(), ref.state_dict().values()):
        assert torch.equal(a, b)
    # 1 stray key of 16 is over 2%: refused, nothing written
    torch.save({**{k: torch.from_numpy(v) for k, v in state.items()},
             "stray": torch.zeros(1)}, ckpt)
    assert convert_weights.main(["lpips", ckpt, str(tmp_path / "no")]) == 1
    assert not (tmp_path / "no").exists()
    # a family with no full-size module is named
    with pytest.raises(SystemExit, match="detector"):
        convert_weights.full_model("detector")


def test_upstream_conv_transpose_is_mirrored_once():
    """SAM's upstream ``output_upscaling.0.weight`` (in, out, kh, kw) goes
    ``t2j_convtranspose`` → flax → the bridge's tap mirror: the port's
    ``up1`` holds the upstream taps mirrored once, so the port computes
    what the JAX package computes on the converted tree (ROADMAP Queue 3
    k, at)."""
    state, _ = tc.synthetic_state("sam", seed=4)
    model = tc.FAMILIES["sam"].tiny_model(torch.Generator().manual_seed(0))
    tc.load_upstream("sam", state, model)
    w = state["mask_decoder.output_upscaling.0.weight"]
    np.testing.assert_array_equal(
        to_numpy(model.mask_decoder.up1.weight), w[:, :, ::-1, ::-1])


# --- the committed activation fixtures ------------------------------------------

def _fixture_model(family, dtype):
    """(port module at the tiny config in ``dtype``, fixture) with the JAX
    package's tiny init at PRNGKey(0) carried through the upstream layout
    (the port's inverse, then ``load_upstream``)."""
    d = np.load(FIXTURES / f"{family}.npz")
    if family == "vggt":
        from regen3d_tpu.models.vggt import VGGT as J, VGGTConfig as JC
        from regen3d_tpu_torch.models.vggt import VGGT as T, VGGTConfig as TC
        args = (jnp.asarray(d["input_images"]),)
    elif family == "sam":
        from regen3d_tpu.models.sam import SAM as J, SamConfig as JC
        from regen3d_tpu_torch.models.sam import SAM as T, SamConfig as TC
        args = tuple(jnp.asarray(d[f"input_{k}"])
                     for k in ("img", "points", "labels", "boxes"))
    else:
        from regen3d_tpu.models.dit import DiTConfig as JC, ShapeDiT as J
        from regen3d_tpu_torch.models.dit import DiTConfig as TC, ShapeDiT as T
        args = tuple(jnp.asarray(d[f"input_{k}"]) for k in ("x", "t", "cond"))
    params = jax.device_get(jax.jit(J(JC.tiny()).init)(jax.random.PRNGKey(0),
                                                        *args))
    state = tc.upstream_state(family, params)
    models = {}
    for dt in dtype:
        m = T(dataclasses.replace(TC.tiny(), dtype=dt), device="cpu")
        tc.load_upstream(family, state, m)
        models[dt] = m
    return models, d


def _outputs(family, m, d):
    with torch.no_grad():
        if family == "vggt":
            out = m(torch.from_numpy(d["input_images"]))
            return {k: out[k] for k in ("pose_enc", "depth", "depth_conf")}
        if family == "sam":
            masks, iou = m(*(torch.from_numpy(d[f"input_{k}"])
                             for k in ("img", "points", "labels", "boxes")))
            return {"masks": masks, "iou": iou}
        return {"v": m(*(torch.from_numpy(d[f"input_{k}"])
                         for k in ("x", "t", "cond")))}


@pytest.mark.parametrize("family", ["vggt", "sam"])
def test_activation_fixture_by_the_mean_error(family):
    """The fixtures are XLA's eager bf16 (ROADMAP Queue 3 ar): no port
    meets their atol 2e-4, not even in f32 (max errors near 2e-2). The
    port's bf16 is held by the mean error over max |ref|: no further from
    the fixture than the port's exact f32 arithmetic lies (measured: VGGT
    0.37/0.21/0.07% against 0.42/0.23/0.10%, SAM 0.30/0.28% against
    0.38/0.39%)."""
    models, d = _fixture_model(family, (torch.bfloat16, torch.float32))
    outs = {dt: _outputs(family, m, d) for dt, m in models.items()}
    for key, got in outs[torch.bfloat16].items():
        want = d[f"expected_{key}"]
        err = {dt: float(np.abs(outs[dt][key].float().numpy().reshape(
            want.shape) - want).mean() / np.abs(want).max()) for dt in outs}
        print(family, key, "mean error / max |fixture|", err)
        assert np.isfinite(got.float().numpy()).all()
        assert err[torch.bfloat16] <= err[torch.float32], (key, err)


def test_dit_activation_fixture():
    """The DiT fixture at its own atol 2e-4, in bf16 as recorded. At flax's
    init the AdaLN-Zero ``x_out`` kernel is zero, so the recorded velocity
    is zero whatever the trunk computes (ROADMAP Queue 3 as): the fixture
    pins the layout's shapes and the output head, no more."""
    models, d = _fixture_model("dit", (torch.bfloat16,))
    got = _outputs("dit", models[torch.bfloat16], d)["v"].float().numpy()
    want = d["expected_v"]
    assert got.shape == want.shape and not want.any()
    np.testing.assert_allclose(got, want, atol=2e-4)
