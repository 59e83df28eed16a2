"""The port's distillation trainers against the JAX package's, on the CPU
at micro sizes, from numpy seeds:

* the synthetic batches: matting's and the detector's bit for bit (pure
  numpy), saliency's to f32 rounding (``jax.image.resize`` against
  ``layers.resize_bilinear``), the depth rooms' and the shape condition
  views' renders allowing the pixels whose centre lies on a face edge
  (ROADMAP Queue 3 ag), the shape dataset's points and SDFs bit for bit;
* each loss and its gradient, from JAX's parameters through the bridge
  and the same batch, in f32 (the flow loss on JAX's draws);
* optax's chains against ``parallel/train.OptaxAdamW`` step by step (the
  detector's clip and warm-up among them), and each trainer's first two
  steps from JAX's init against the JAX trainer's (Queue 3 g: 5e-3 where
  Adam's normalisation amplifies a near-zero gradient's rounding, the
  median within 1e-6);
* ``fold_latent_norm``: dec′(z) = dec(z·σ + μ), and JAX's fold;
* a micro ``distill_shape`` written by the port's ``save_generator`` and
  read by JAX's ``load_generator``: the same SDF grid and sampled latents
  from one noise;
* the weight bridge's round trip of every trainer's tree;
* ``utils/profiling``'s spans;
* the runners' CLI on ``--device cpu`` (a refusal to save among them);
* the flash kernels' head dims: D = 12 and 24 in both directions, and the
  detector and saliency checkpoints at ``distill_config()`` /
  ``small_config()`` load into models whose every head dim has a kernel.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from regen3d_tpu.models import depth_anything as jda
from regen3d_tpu.models import detector as jdet
from regen3d_tpu.models import saliency as jsal
from regen3d_tpu.models import shapevae as jsv
from regen3d_tpu.models import dit as jdit
from regen3d_tpu.models.unet import MattingUNet as JMattingUNet
from regen3d_tpu.pipeline import depth_distill as jdd
from regen3d_tpu.pipeline import detector_distill as jdtd
from regen3d_tpu.pipeline import matting as jmat
from regen3d_tpu.pipeline import phase3_assets as jp3
from regen3d_tpu.pipeline import saliency_distill as jsd
from regen3d_tpu.pipeline import shape_distill as jsh
from regen3d_tpu_torch import distill
from regen3d_tpu_torch.models import depth_anything as tda
from regen3d_tpu_torch.models import detector as tdet
from regen3d_tpu_torch.models import saliency as tsal
from regen3d_tpu_torch.models.dit import ShapeDiT
from regen3d_tpu_torch.models.from_jax import (
    DEPTH_ANYTHING_CONV_TRANSPOSE,
    SALIENCY_CONV_TRANSPOSE,
    load_from_jax,
    state_from_jax,
    tree_from_model,
)
from regen3d_tpu_torch.models.layers import Attention, FusedAttention
from regen3d_tpu_torch.models.shapevae import ShapeDecoder, ShapeEncoder
from regen3d_tpu_torch.models.unet import MattingUNet
from regen3d_tpu_torch.ops import attention as att
from regen3d_tpu_torch.parallel import train as ttrain
from regen3d_tpu_torch.parallel.batches import BatchStream
from regen3d_tpu_torch.pipeline import depth_distill as tdd
from regen3d_tpu_torch.pipeline import detector_distill as tdtd
from regen3d_tpu_torch.pipeline import matting as tmat
from regen3d_tpu_torch.pipeline import saliency_distill as tsd
from regen3d_tpu_torch.pipeline import shape_distill as tsh
from regen3d_tpu_torch.pipeline.phase3_assets import CondEncoder
from regen3d_tpu_torch.utils import profiling
from test_torch_package import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
F32 = jnp.float32

# micro configs of each trainer's model, JAX's and the port's, in f32
SAL = dict(image_size=32, width=32, depth=1, num_heads=2)
DET = dict(image_size=32, patch=16, width=32, depth=1, num_heads=2,
           text_width=16, text_depth=1, text_len=16, embed_dim=16)
DEPTH = dict(image_size=28, patch=14, width=32, depth=4, num_heads=2,
             out_idx=(0, 1, 2, 3), features=8, out_channels=(4, 8, 16, 32))


def t_(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def leaves(tree):
    return {"/".join(k): v for k, v in _flat(tree).items()}


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v, np.float32)
    return out


def grads_close(model, jgrads, conv_transpose=frozenset(), rtol=1e-5):
    """Every parameter's gradient against JAX's (carried to the port's
    layout by the bridge): within rtol of the largest |gradient| of the
    whole tree, elementwise."""
    ref = {k: v.float() for k, v in state_from_jax(
        jax.device_get(jgrads), conv_transpose).items()}
    scale = max(float(v.abs().max()) for v in ref.values())
    assert scale > 0
    worst = 0.0
    for name, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        err = float((g.float() - ref[name]).abs().max())
        worst = max(worst, err)
        assert err <= rtol * scale, (name, err, scale)
    return worst, scale


def params_close(model, jparams, conv_transpose=frozenset(), atol=5e-3):
    """Parameters after the trainers' steps: every element within ``atol``
    (Queue 3 g), the median difference within 1e-6."""
    ref = state_from_jax(jax.device_get(jparams), conv_transpose)
    diffs = []
    for name, p in model.named_parameters():
        d = (p.detach().float() - ref[name].float()).abs().reshape(-1)
        diffs.append(d)
        assert float(d.max()) <= atol, (name, float(d.max()))
    d = torch.cat(diffs)
    assert float(d.median()) <= 1e-6, float(d.median())
    return float(d.max())


def micro_f32():
    """DistillConfig.micro() in f32, JAX's and the port's."""
    j = jsh.DistillConfig.micro()
    j = dataclasses.replace(j, dit=dataclasses.replace(j.dit, dtype=F32),
                            vae=dataclasses.replace(j.vae, dtype=F32))
    return j, tsh.DistillConfig.micro().with_dtype(torch.float32)


def jax_cond_f32(self):
    """JAX's ``DistillConfig.cond_encoder`` in f32 (its condition encoder
    takes CondEncoder's default bf16)."""
    return jp3.CondEncoder(width=self.dit.cond_dim, depth=self.cond_depth,
                           num_heads=self.cond_heads, patch=self.cond_patch,
                           dtype=F32)


def jax_steps(vg, params, batches, tx):
    """The JAX trainer's steps: its loss and gradient (``vg``, jitted) on
    each batch, then its optax chain ``tx``, jitted (one compile of the
    update for the tree, where eager optax compiles each leaf's operations
    one by one); → (params, the first step's loss and gradient)."""
    state = tx.init(params)
    first = None

    @jax.jit
    def update(grads, state, params):
        upd, state = tx.update(grads, state, params)
        return optax.apply_updates(params, upd), state

    for b in batches:
        loss, grads = vg(params, *b)
        first = first or (loss, grads)
        params, state = update(grads, state, params)
    return params, first


def port_grads(model_loss, params_of):
    """The port's loss and gradients at its current weights: the loss of
    ``model_loss()``, backward, the grads left on the parameters."""
    for p in params_of:
        p.grad = None
    out = model_loss()
    loss = out[0] if isinstance(out, tuple) else out
    loss.backward()
    return float(loss.detach())


# ---------------------------------------------------------------------------
# kernels' head dims (the fault this slice repairs)


@pytest.mark.parametrize("d", [12, 24])
def test_kernel_inputs_accept_12_and_24(d):
    for dims in (att.KERNEL_HEAD_DIMS, att.FWD_KERNEL_HEAD_DIMS):
        att._check_kernel_inputs("flash", d, dims, ())
    with pytest.raises(ValueError, match="head dim 20"):
        att._check_kernel_inputs("flash", 20, att.KERNEL_HEAD_DIMS, ())


def _head_dims(model):
    dims = set()
    for mod in model.modules():
        if isinstance(mod, Attention):
            dims.add(mod.q.weight.shape[0] // mod.num_heads)
        elif isinstance(mod, FusedAttention):
            dims.add(mod.proj.weight.shape[0] // mod.num_heads)
    return dims


def test_distilled_checkpoints_have_kernel_head_dims(tmp_path):
    """The fault: ``load_detector_checkpoint`` / ``SaliencyModel.load`` of
    the runners' configs built heads of 24 and 12, which the parent's
    kernels refused on the card."""
    det = tdet.OpenVocabDetector(tdtd.distill_config(), device="cpu")
    tdtd.save_detector_checkpoint(str(tmp_path / "det"), det)
    loaded = tdtd.load_detector_checkpoint(str(tmp_path / "det"), device="cpu")
    sal = tsal.SaliencyTransformer(tsd.small_config(), device="cpu")
    tsd.save_saliency_checkpoint(str(tmp_path / "sal"), sal)
    sal_loaded = tsd.SaliencyModel.load(str(tmp_path / "sal"), device="cpu")
    dims = _head_dims(loaded) | _head_dims(sal_loaded.model)
    assert dims == {12, 24}, dims
    assert dims <= set(att.FWD_KERNEL_HEAD_DIMS)
    assert dims <= set(att.KERNEL_HEAD_DIMS)


# ---------------------------------------------------------------------------
# batches


def test_matting_and_detector_batches_bit_for_bit():
    a = jmat.synth_matting_batch(np.random.default_rng(3), 3, 32)
    b = tmat.synth_matting_batch(np.random.default_rng(3), 3, 32)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    img = a[0][0]
    np.testing.assert_array_equal(jmat.threshold_alpha(img),
                                  tmat.threshold_alpha(img))
    a = jdtd.synth_detection_batch(np.random.default_rng(4), 4, 64)
    b = tdtd.synth_detection_batch(np.random.default_rng(4), 4, 64)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert tdtd.VOCAB == jdtd.VOCAB


def test_saliency_batch_to_f32_rounding():
    ja, jg = jsd.synth_saliency_batch(np.random.default_rng(5), 3, 32)
    ta, tg = tsd.synth_saliency_batch(np.random.default_rng(5), 3, 32)
    np.testing.assert_allclose(ta, ja, rtol=0, atol=2e-6)
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_array_equal(tsd.center_prior(32), jsd.center_prior(32))
    assert tsd.mae(ta[0, ..., 0], tg[0]) == pytest.approx(
        jsd.mae(ja[0, ..., 0], jg[0]), abs=1e-6)


def edge_allowance(a, b, tol, max_frac):
    """a and b agree within ``tol`` but for at most ``max_frac`` of the
    pixels (those whose centre lies on a face edge, Queue 3 ag)."""
    bad = np.abs(a - b) > tol
    while bad.ndim > 3:
        bad = bad.any(-1)
    assert bad.mean() <= max_frac, bad.mean()
    return bad.mean()


def test_depth_batch_and_losses():
    ji, jd = jdd.synth_depth_batch(np.random.default_rng(6), 3, 28)
    ti, td = tdd.synth_depth_batch(np.random.default_rng(6), 3, 28, "cpu")
    edge_allowance(ti, ji, 1e-5, 0.02)
    edge_allowance(td, jd, 1e-4, 0.02)
    pred = np.random.default_rng(0).random((3, 28, 28)).astype(np.float32)
    j = float(jdd.ssi_loss(jnp.asarray(pred), jnp.asarray(jd)))
    t = float(tdd.ssi_loss(t_(pred), t_(jd)))
    assert t == pytest.approx(j, rel=1e-5)
    assert tdd.ssi_rmse(pred[0], jd[0]) == pytest.approx(
        jdd.ssi_rmse(pred[0], jd[0]), rel=1e-5)
    np.testing.assert_allclose(tdd.luminance_prior(ji[0]),
                               jdd.luminance_prior(ji[0]), atol=1e-7)


# ---------------------------------------------------------------------------
# optax's chains


@pytest.mark.parametrize("chain", ["shape", "adamw_b95", "detector"])
def test_optax_adamw_matches_optax(chain):
    rng = np.random.default_rng(8)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 2, 3)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    steps = 8
    if chain == "shape":
        sched = (optax.cosine_decay_schedule(1e-2, steps, 0.05),
                 ttrain.cosine_decay_schedule(1e-2, steps, 0.05))
        tx = optax.adamw(sched[0])
        kw = {}
    elif chain == "adamw_b95":
        sched = (optax.cosine_decay_schedule(2e-3, steps),
                 ttrain.cosine_decay_schedule(2e-3, steps))
        tx = optax.adamw(sched[0], b1=0.9, b2=0.95, weight_decay=1e-4)
        kw = dict(b1=0.9, b2=0.95, weight_decay=1e-4)
    else:
        warm = min(30, steps // 4)
        sched = (optax.warmup_cosine_decay_schedule(0.0, 2e-3, warm, steps),
                 ttrain.warmup_cosine_decay_schedule(0.0, 2e-3, warm, steps))
        tx = optax.chain(optax.clip_by_global_norm(1.0),
                         optax.adamw(sched[0], b1=0.9, b2=0.95,
                                     weight_decay=1e-4))
        kw = dict(b1=0.9, b2=0.95, weight_decay=1e-4, clip_norm=1.0)
    for c in range(steps + 2):
        assert sched[1](c) == pytest.approx(float(sched[0](c)), rel=1e-6,
                                            abs=1e-12)
    tp = {k: torch.nn.Parameter(t_(v)) for k, v in params.items()}
    opt = ttrain.OptaxAdamW(tp.values(), sched[1], **kw)
    state = tx.init(params)
    jp = params
    for step in range(4):
        # gradients large enough for the clip to act on steps 1 and 3
        g = {k: (rng.normal(size=s) * (5.0 if step % 2 else 0.1))
             .astype(np.float32) for k, s in shapes.items()}
        upd, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = t_(g[k])
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), jp[k],
                                       rtol=0, atol=1e-6)


def test_batch_stream_draws_alike_in_a_worker_process():
    """The trainers' batches drawn in a worker process (as on the card) are
    the ones drawn in process, the JAX trainer's init batch first."""
    kw = dict(seed=3, init_args=(1, 32), args=(2, 32), steps=3)
    want = jmat.synth_matting_batch(np.random.default_rng(3), 1, 32)
    rng = np.random.default_rng(3)
    jmat.synth_matting_batch(rng, 1, 32)
    with BatchStream(tmat.synth_matting_batch, process=False,
                            **kw) as a, \
            BatchStream(tmat.synth_matting_batch, process=True,
                               **kw) as b:
        for i in range(3):
            ref = jmat.synth_matting_batch(rng, 2, 32)
            for x, y, z in zip(a(i), b(i), ref):
                np.testing.assert_array_equal(x, z)
                np.testing.assert_array_equal(y, z)
    assert want[0].shape == (1, 32, 32, 3)


# ---------------------------------------------------------------------------
# the detector's assignment, the fold


def test_detector_assign_ties_take_the_first_box():
    """Two valid GT boxes of equal area both containing a patch centre:
    ``argmin`` over the equal costs takes the first index in both."""
    boxes = np.asarray([[[0.5, 0.5, 0.4, 0.2], [0.5, 0.5, 0.2, 0.4],
                         [0.0, 0.0, 0.0, 0.0], [0.1, 0.1, 0.1, 0.1]]],
                       np.float32)
    labels = np.asarray([[3, 7, 0, 5]], np.int32)
    valid = np.asarray([[True, True, False, False]])
    ja, jb, jl = jdtd._assign(4, 4, jnp.asarray(boxes), jnp.asarray(labels),
                              jnp.asarray(valid))
    ta, tb, tl = tdtd._assign(4, 4, t_(boxes), torch.from_numpy(labels),
                              torch.from_numpy(valid))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert set(tl.numpy()[ta.numpy()].tolist()) == {3}


def test_fold_latent_norm():
    _, tcfg = micro_f32()
    dec = ShapeDecoder(tcfg.vae, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for p in dec.parameters():
        with torch.no_grad():
            p.normal_(0.0, 0.2, generator=gen)
    rng = np.random.default_rng(11)
    mu = rng.normal(size=8).astype(np.float32)
    sd = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    z = rng.normal(size=(2, 16, 8)).astype(np.float32)
    pts = rng.uniform(-1, 1, (2, 32, 3)).astype(np.float32)
    folded = tsh.fold_latent_norm(dec, mu, sd)
    with torch.no_grad():
        a = folded(t_(z), t_(pts))
        b = dec(t_(z * sd + mu), t_(pts))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)
    jfold = jsh.fold_latent_norm(tree_from_model(dec), mu, sd)
    for k, v in leaves(tree_from_model(folded)).items():
        np.testing.assert_array_equal(v, leaves(jfold)[k])


# ---------------------------------------------------------------------------
# the bridge, profiling, the CLI


def _jax_tree(name):
    """(name → the JAX init's tree of shapes, filled from a seed), the
    port modules in the training layout (f32 weights), and the model's
    transposed convolutions: ``jax.eval_shape`` of each flax init, with no
    compile."""
    jcfg, tcfg = micro_f32()
    key = jax.random.PRNGKey(0)
    ct = frozenset()
    f32 = dict(device="cpu", param_dtype=torch.float32)
    if name == "matting":
        inits = {"m": (JMattingUNet(base=8, dtype=F32).init,
                       jnp.zeros((1, 32, 32, 3)))}
        mods = {"m": MattingUNet(base=8, **f32)}
    elif name == "saliency":
        inits = {"m": (jsal.SaliencyTransformer(
            jsal.SaliencyConfig(**SAL, dtype=F32)).init,
            jnp.zeros((1, 32, 32, 3)))}
        mods = {"m": tsal.SaliencyTransformer(tsal.SaliencyConfig(**SAL),
                                              **f32)}
        ct = SALIENCY_CONV_TRANSPOSE
    elif name == "detector":
        inits = {"m": (jdet.OpenVocabDetector(
            jdet.DetectorConfig(**DET, dtype=F32)).init,
            jnp.zeros((1, 32, 32, 3)), jnp.zeros((2, 16), jnp.int32))}
        mods = {"m": tdet.OpenVocabDetector(tdet.DetectorConfig(**DET),
                                            **f32)}
    elif name == "depth":
        inits = {"m": (jda.DepthAnything(
            jda.DepthAnythingConfig(**DEPTH, dtype=F32)).init,
            jnp.zeros((1, 28, 28, 3)))}
        mods = {"m": tda.DepthAnything(tda.DepthAnythingConfig(**DEPTH),
                                       **f32)}
        ct = DEPTH_ANYTHING_CONV_TRANSPOSE
    elif name == "enc_dec":
        inits = {"enc": (jsv.ShapeEncoder(jcfg.vae).init,
                         jnp.zeros((1, 64, 3))),
                 "dec": (jsv.ShapeDecoder(jcfg.vae).init,
                         jnp.zeros((1, 16, 8)), jnp.zeros((1, 8, 3)))}
        mods = {"enc": ShapeEncoder(tcfg.vae, device="cpu"),
                "dec": ShapeDecoder(tcfg.vae, device="cpu")}
    else:
        inits = {"cond": (jax_cond_f32(jcfg).init,
                          jnp.zeros((1, 32, 32, 4))),
                 "dit": (jdit.ShapeDiT(jcfg.dit).init, jnp.zeros((1, 16, 8)),
                         jnp.zeros((1,)), jnp.zeros((1, 16, 64)))}
        mods = {"cond": tcfg.cond_encoder("cpu"),
                "dit": ShapeDiT(tcfg.dit, device="cpu")}
    rng = np.random.default_rng(0)
    trees = {k: jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32),
        jax.eval_shape(init, key, *args))
        for k, (init, *args) in inits.items()}
    return trees, mods, ct


@pytest.mark.parametrize("name", ["matting", "saliency", "detector", "depth",
                                  "enc_dec", "cond_dit"])
def test_bridge_round_trips_each_trainer_tree(name):
    """Every leaf of the JAX trainer's tree loads (strict: each used once,
    every parameter set) and comes back from ``tree_from_model`` the same,
    in the training layout's f32 weights."""
    trees, mods, ct = _jax_tree(name)
    for k, tree in trees.items():
        load_from_jax(mods[k], tree, ct)
        back = leaves(tree_from_model(mods[k], ct))
        ref = leaves(tree)
        assert back.keys() == ref.keys()
        for leaf, v in ref.items():
            np.testing.assert_array_equal(back[leaf], v)


def test_profiling_spans(tmp_path):
    profiling.reset()
    with profiling.timed("a", log_it=False):
        pass
    with profiling.timed("a", log_it=False):
        pass
    with profiling.timed("b"):
        sum(range(1000))
    rows = {r[0]: r for r in profiling.span_summary()}
    assert rows["a"][1] == 2 and rows["b"][1] == 1
    assert rows["a"][2] >= 0 and rows["a"][3] == pytest.approx(
        rows["a"][2] / 2)
    with profiling.device_timed("c", "cpu"):
        pass
    assert profiling.device_span_summary() == []
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(4).sum()
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    profiling.reset()
    assert profiling.span_summary() == []
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() is None


def test_cli_matting_saves_and_loads(tmp_path):
    out = str(tmp_path / "m")
    rc = distill.main(["matting", "--out", out, "--steps", "3", "--batch",
                       "2", "--size", "32", "--base", "8", "--eval-samples",
                       "2", "--device", "cpu"])
    assert rc == 0
    m = tmat.MattingModel.load(out, base=8, device="cpu")
    a = m.alpha(np.full((20, 24, 3), 200, np.uint8))
    assert a.shape == (20, 24) and np.isfinite(a).all()


def test_cli_refuses_to_save_and_runs_as_a_module(tmp_path):
    out = tmp_path / "d"
    cmd = [sys.executable, "-m", "regen3d_tpu_torch.distill", "detector",
           "--out", str(out), "--steps", "2", "--batch", "2", "--size", "32",
           "--eval-samples", "2", "--device", "cpu"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env=env)
    assert p.returncode == 1, p.stdout + p.stderr
    assert "held-out box recall@0.5" in p.stdout
    assert "NOT beat" in p.stderr and not out.exists()
    args = distill.parse(["saliency", "--out", "x", "--device", "cpu"])
    assert (args.kind, args.device, args.steps, args.size) == \
        ("saliency", "cpu", 300, 96)
    args = distill.parse(["shape"])
    assert (args.out, args.preset, args.vae_steps, args.seg, args.device) \
        == ("checkpoints/shape_distilled.npz", "small", 3000, 25, "cuda")
