"""The four small trainers (matting, saliency, detector, depth) against the
JAX package's, on the CPU at micro sizes in f32: from the port's seeded
init carried to JAX through the bridge, on the same batches, each loss and
every parameter's gradient (within 1e-5 of the largest), then the
parameters after two steps of the trainer (the port's ``distill_*``
against JAX's loss and optax chain: within Queue 3 g's 5e-3, the median
within 1e-6). The losses the closures of the JAX trainers compute are
written out here as they stand there; the detector's and depth's are the
JAX package's own functions. The port's trainers take JAX's weights by
their init functions patched to load them, and the JAX trainers' batches
where the port's generator gives them only to rounding."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from regen3d_tpu.models import depth_anything as jda
from regen3d_tpu.models import detector as jdet
from regen3d_tpu.models import saliency as jsal
from regen3d_tpu.models.unet import MattingUNet as JMattingUNet
from regen3d_tpu.pipeline import depth_distill as jdd
from regen3d_tpu.pipeline import detector_distill as jdtd
from regen3d_tpu.pipeline import matting as jmat
from regen3d_tpu.pipeline import saliency_distill as jsd
from regen3d_tpu_torch.models import depth_anything as tda
from regen3d_tpu_torch.models import detector as tdet
from regen3d_tpu_torch.models import saliency as tsal
from regen3d_tpu_torch.models import unet as tunet
from regen3d_tpu_torch.models.from_jax import (
    DEPTH_ANYTHING_CONV_TRANSPOSE,
    SALIENCY_CONV_TRANSPOSE,
    load_from_jax,
    tree_from_model,
)
from regen3d_tpu_torch.parallel import train as ttrain
from regen3d_tpu_torch.pipeline import depth_distill as tdd
from regen3d_tpu_torch.pipeline import detector_distill as tdtd
from regen3d_tpu_torch.pipeline import matting as tmat
from regen3d_tpu_torch.pipeline import saliency_distill as tsd
from test_torch_distill import (
    DEPTH,
    DET,
    F32,
    SAL,
    grads_close,
    jax_steps,
    params_close,
    port_grads,
    t_,
)
from test_torch_package import one_torch_thread  # noqa: F401

F = torch.float32


def _tree(model, ct=frozenset()):
    """The port model's weights as a JAX tree (copies)."""
    return jax.tree_util.tree_map(np.array, tree_from_model(model, ct))


def _adamw_b95(lr, steps):
    return optax.adamw(optax.cosine_decay_schedule(lr, steps), b1=0.9,
                       b2=0.95, weight_decay=1e-4)


def _matting_loss_jax(model, p, imgs, alphas):
    pred = model.apply(p, imgs)
    pred = jnp.clip(pred.astype(F32), 1e-6, 1 - 1e-6)
    bce = -(alphas * jnp.log(pred) + (1 - alphas) * jnp.log(1 - pred)).mean()
    return bce + jnp.abs(pred - alphas).mean()


def test_matting_trainer(monkeypatch):
    size, base, seed, steps = 32, 8, 0, 2
    tm = tunet.MattingUNet(base=base, dtype=F, device="cpu", param_dtype=F)
    gen = torch.Generator().manual_seed(5)
    tunet.init_flax_style_(tm, gen)
    tunet.draw_zero_init_leaves_(tm, gen)   # conv2 and out start at 0
    params = _tree(tm)
    rng = np.random.default_rng(seed)
    jmat.synth_matting_batch(rng, 1, size)
    batches = [jmat.synth_matting_batch(rng, 2, size) for _ in range(steps)]
    jm = JMattingUNet(base=base, dtype=F32)
    vg = jax.jit(jax.value_and_grad(
        lambda p, i, a: _matting_loss_jax(jm, p, i, a)))
    jparams, (jl, jg) = jax_steps(vg, params, batches,
                                  _adamw_b95(2e-3, steps))
    loss = port_grads(lambda: tmat.matting_loss(tm, *map(t_, batches[0])),
                      tm.parameters())
    assert loss == pytest.approx(float(jl), rel=1e-5)
    grads_close(tm, jg)
    # the trainer in f32 from JAX's weights
    monkeypatch.setattr(tmat, "MattingUNet",
                        functools.partial(tunet.MattingUNet, dtype=F))
    monkeypatch.setattr(tmat, "init_flax_style_",
                        lambda m, g: load_from_jax(m, params))
    model, losses = tmat.distill_matting(
        steps=steps, batch=2, size=size, base=base, seed=seed, log_every=0,
        device="cpu")
    assert losses[0] == pytest.approx(float(jl), rel=1e-5)
    params_close(model, jparams)


def _saliency_loss_jax(model, p, imgs, gts):
    pred = model.apply(p, imgs).astype(F32)
    pred = jnp.clip(pred, 1e-6, 1 - 1e-6)
    pos = jnp.clip(gts.mean(), 1e-3, 0.5)
    w = gts / pos + (1 - gts) / (1 - pos)
    bce = -(w * (gts * jnp.log(pred)
                 + (1 - gts) * jnp.log(1 - pred))).mean() / 2
    inter = (pred * gts).sum((1, 2))
    dice = 1 - (2 * inter + 1) / (pred.sum((1, 2)) + gts.sum((1, 2)) + 1)
    return bce + dice.mean()


def test_saliency_trainer(monkeypatch):
    seed, steps = 0, 2
    tcfg = tsal.SaliencyConfig(**SAL, dtype=F)
    tm = tsal.SaliencyTransformer(tcfg, device="cpu", param_dtype=F)
    tsal.init_flax_style_(tm, torch.Generator().manual_seed(5))
    ct = SALIENCY_CONV_TRANSPOSE
    params = _tree(tm, ct)
    rng = np.random.default_rng(seed)
    first = jsd.synth_saliency_batch(rng, 1, SAL["image_size"])
    batches = [jsd.synth_saliency_batch(rng, 2, SAL["image_size"])
               for _ in range(steps)]
    jm = jsal.SaliencyTransformer(jsal.SaliencyConfig(**SAL, dtype=F32))
    vg = jax.jit(jax.value_and_grad(
        lambda p, i, g: _saliency_loss_jax(jm, p, i, g)))
    jparams, (jl, jg) = jax_steps(vg, params, batches,
                                  _adamw_b95(1e-3, steps))
    loss = port_grads(lambda: tsd.saliency_loss(tm, *map(t_, batches[0])),
                      tm.parameters())
    assert loss == pytest.approx(float(jl), rel=1e-5)
    grads_close(tm, jg, ct)
    # JAX's batches, which the port's generator gives to f32 rounding
    feed = iter([first] + batches)
    monkeypatch.setattr(tsd, "synth_saliency_batch",
                        lambda rng, b, s: next(feed))
    monkeypatch.setattr(tsd, "init_flax_style_",
                        lambda m, g: load_from_jax(m, params, ct))
    model, losses = tsd.distill_saliency(tcfg, steps=steps, batch=2,
                                         seed=seed, log_every=0,
                                         device="cpu")
    assert losses[0] == pytest.approx(float(jl), rel=1e-5)
    params_close(model, jparams, ct)


def test_detector_trainer():
    """Two of eight steps: the warm-up's first two (lr 0, then half the
    peak) and the clip at a global norm of 1."""
    seed, steps, s = 0, 8, DET["image_size"]
    tcfg = tdet.DetectorConfig(**DET, dtype=F)
    tm = tdet.OpenVocabDetector(tcfg, device="cpu", param_dtype=F)
    tdet.init_flax_style_(tm, torch.Generator().manual_seed(5))
    params = _tree(tm)
    tokens = jdet.tokenize_bytes(jdtd.VOCAB, DET["text_len"])
    rng = np.random.default_rng(seed)
    jdtd.synth_detection_batch(rng, 1, s)
    batches = [jdtd.synth_detection_batch(rng, 4, s) for _ in range(2)]
    jm = jdet.OpenVocabDetector(jdet.DetectorConfig(**DET, dtype=F32))
    vg = jax.jit(jax.value_and_grad(
        lambda p, i, b, lab, v: jdtd.detection_loss(
            jm, p, i, jnp.asarray(tokens), b, lab, v)[0]))
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(0.0, 2e-3, 2, steps), b1=0.9,
        b2=0.95, weight_decay=1e-4))
    jparams, (jl, jg) = jax_steps(vg, params, batches, tx)

    tt = torch.from_numpy(tokens).long()

    def loss_of(model, b):
        return tdtd.detection_loss(model, t_(b[0]), tt, t_(b[1]),
                                   torch.from_numpy(b[2]),
                                   torch.from_numpy(b[3]))

    loss = port_grads(lambda: loss_of(tm, batches[0]), tm.parameters())
    assert loss == pytest.approx(float(jl), rel=1e-5)
    grads_close(tm, jg)
    # the trainer's own pieces: its config, init, chain and loss
    model = tdet.OpenVocabDetector(tdtd.trainer_config(tcfg, "cpu"),
                                   device="cpu", param_dtype=F)
    load_from_jax(model, params)
    opt = ttrain.OptaxAdamW(
        model.parameters(),
        ttrain.warmup_cosine_decay_schedule(0.0, 2e-3, min(30, steps // 4),
                                            steps),
        b1=0.9, b2=0.95, weight_decay=1e-4, clip_norm=1.0)
    rng = np.random.default_rng(seed)
    tdtd.synth_detection_batch(rng, 1, s)
    for _ in range(2):
        b = tdtd.synth_detection_batch(rng, 4, s)
        opt.zero_grad()
        loss_of(model, b)[0].backward()
        opt.step()
    params_close(model, jparams)


def test_depth_trainer(monkeypatch):
    seed, steps, s = 0, 2, DEPTH["image_size"]
    tcfg = tda.DepthAnythingConfig(**DEPTH, dtype=F)
    tm = tda.DepthAnything(tcfg, device="cpu", param_dtype=F)
    tda.init_flax_style_(tm, torch.Generator().manual_seed(5))
    ct = DEPTH_ANYTHING_CONV_TRANSPOSE
    params = _tree(tm, ct)
    rng = np.random.default_rng(seed)
    first = jdd.synth_depth_batch(rng, 1, s)
    batches = [jdd.synth_depth_batch(rng, 2, s) for _ in range(steps)]
    jm = jda.DepthAnything(jda.DepthAnythingConfig(**DEPTH, dtype=F32))
    vg = jax.jit(jax.value_and_grad(lambda p, i, d: jdd.ssi_loss(
        jm.apply(p, i).astype(F32), d)))
    jparams, (jl, jg) = jax_steps(vg, params, batches,
                                  _adamw_b95(1e-3, steps))
    loss = port_grads(lambda: tdd.depth_loss(tm, *map(t_, batches[0])),
                      tm.parameters())
    assert loss == pytest.approx(float(jl), rel=1e-5)
    grads_close(tm, jg, ct)
    # JAX's renders, which the port's rasteriser gives but for edge pixels
    feed = iter([first] + batches)
    monkeypatch.setattr(tdd, "synth_depth_batch",
                        lambda rng, b, s, device: next(feed))
    monkeypatch.setattr(tdd, "init_flax_style_",
                        lambda m, g: load_from_jax(m, params, ct))
    model, losses = tdd.distill_depth(tcfg, steps=steps, batch=2, seed=seed,
                                      log_every=0, device="cpu")
    assert losses[0] == pytest.approx(float(jl), rel=1e-5)
    params_close(model, jparams, ct)
