"""The port's MIDI and DPA baselines (``-p 10``, ``-p 11``) against the JAX
package on the CPU.

* MIDI stage by stage, both packages' runs on one room with the generator
  replaced by a recorder that hands both the same SDF volumes: the
  detections' overlay (``segmentation.png``) the same pixels, the crops
  and box tokens the generator is given within 1e-6, its knobs equal, the
  scene GLB's meshes (layout on the same volumes) within 1e-5; in label
  mode and in box mode;
* the MIDI generator (``cross_instance``, instance gates and AdaLN-Zero
  leaves drawn non-zero, box tokens appended) in f32 with the JAX
  package's weights, from one injected noise: the volumes within 1e-4 of
  max |ref|;
* DPA stage by stage the same way: the masks and inpainted objects the
  same pixels, the crops within 1e-6, the generated objects' GLBs and the
  geometry cloud within 1e-5, and the 5-DOF fit on the tile-binned edge
  path in both, its poses within one Adam step (5e-3, ROADMAP Queue 3 g)
  and its losses within 2e-3;
* the CLI: ``-p 10 11`` through the port's with ``--device cpu`` (the
  random-init tiny generator), and the ``Use_MIDI`` / ``Use_DPA`` phase
  swaps of both CLIs.

The k-means proposer runs under one OpenMP thread, where scikit-learn's
float32 sums have one order (``test_torch_phase1_run.py``).
"""

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from threadpoolctl import threadpool_limits

import regen3d_tpu.models.layers as jl
import regen3d_tpu.ops.attention as ja
from regen3d_tpu import config as jconfig
from regen3d_tpu import orchestrator as jorch
from regen3d_tpu.models import dit as jdit
from regen3d_tpu.models import shapevae as jsv
from regen3d_tpu.pipeline import baseline_dpa as jdpa
from regen3d_tpu.pipeline import baseline_midi as jmidi
from regen3d_tpu.pipeline import phase3_assets as jp3
from regen3d_tpu.pipeline import pose_fit as jpf
from regen3d_tpu_torch import orchestrator as torch_orch
from regen3d_tpu_torch.config import default_config
from regen3d_tpu_torch.models import dit as tdit
from regen3d_tpu_torch.models import shapevae as tsv
from regen3d_tpu_torch.models.from_jax import load_from_jax
from regen3d_tpu_torch.pipeline import baseline_dpa as tdpa
from regen3d_tpu_torch.pipeline import baseline_midi as tmidi
from regen3d_tpu_torch.pipeline import phase3_assets as tp3
from regen3d_tpu_torch.pipeline import pose_fit as tpf
from regen3d_tpu_torch.utils.glb import load_glb
from regen3d_tpu_torch.utils.image import read_png, save_image
from regen3d_tpu_torch.utils.ply import load_ply
from test_torch_package import one_torch_thread  # noqa: F401


def _room(path, h=96, w=128):
    """The JAX package's baseline room: wall, floor band, two boxes."""
    img = np.full((h, w, 3), 210, np.uint8)
    img[60:, :] = (150, 110, 80)
    img[64:88, 16:44] = (200, 40, 40)
    img[62:86, 80:112] = (40, 60, 200)
    save_image(str(path), img)
    return str(path)


def _sphere_volumes(b, res):
    """(b, res, res, res) SDFs of spheres of radius 0.45 to 0.6 on the
    decode grid (±1.01)."""
    g = np.linspace(-1.01, 1.01, res, dtype=np.float32)
    r = np.sqrt(sum(a ** 2 for a in np.meshgrid(g, g, g, indexing="ij")))
    return np.stack([r - (0.45 + 0.05 * (i % 4)) for i in range(b)])


def _recorder(calls, res=6):
    """A generate_sdf_batch that records its arguments (as numpy) and hands
    back sphere volumes at ``res`` (144 faces each at 6)."""
    def generate(_rng, images, steps, guidance, resolution, chunk,
                 extra_cond_tokens=None):
        if isinstance(images, torch.Tensor):
            images = images.cpu().numpy()
        calls.append(dict(images=np.asarray(images, np.float32), steps=steps,
                          guidance=guidance, resolution=resolution,
                          chunk=chunk, extra=None if extra_cond_tokens is None
                          else np.asarray(extra_cond_tokens, np.float32)))
        return _sphere_volumes(len(images), res)
    return generate


def _stub(dit_cfg, calls, device=None):
    gen = types.SimpleNamespace(dit_cfg=dit_cfg,
                                generate_sdf_batch=_recorder(calls))
    if device is not None:
        gen.device = torch.device(device)
    return gen


def _same_calls(tcalls, jcalls):
    assert len(tcalls) == len(jcalls) == 1
    t, j = tcalls[0], jcalls[0]
    for key in ("steps", "guidance", "resolution", "chunk"):
        assert t[key] == j[key], key
    np.testing.assert_allclose(t["images"], j["images"], rtol=0, atol=1e-6)
    if j["extra"] is None:
        assert t["extra"] is None
    else:
        np.testing.assert_allclose(t["extra"], j["extra"], rtol=0, atol=1e-6)


def _same_glb(tpath, jpath, atol):
    tm, jm = load_glb(tpath).meshes, load_glb(jpath).meshes
    assert [m.name for m in tm] == [m.name for m in jm]
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a.faces, b.faces)
        np.testing.assert_allclose(a.vertices, b.vertices, rtol=0, atol=atol)
    return tm


def _cfgs(tmp_path, **over):
    img = _room(tmp_path / "room.png")
    return (jconfig.default_config(str(tmp_path / "j" / "output"),
                                   input_image=img, **over),
            default_config(str(tmp_path / "t" / "output"), input_image=img,
                           **over))


@pytest.mark.parametrize("seg_mode", ["label", "box"])
def test_midi_matches_jax_stage_by_stage(tmp_path, seg_mode):
    jcfg, tcfg = _cfgs(tmp_path, seg_mode=seg_mode,
                       num_inference_steps_midi=3, octree_resolution_hy=24)
    if seg_mode == "box":
        with open(tmp_path / "room.boxes.txt", "w") as f:
            f.write("16 64 44 88\n80 62 112 86\n")
    cfg_dit = dataclasses.replace(tdit.DiTConfig.tiny(), cross_instance=True)
    jcalls, tcalls = [], []
    with threadpool_limits(1):
        jout = jmidi.run(jcfg, generator=_stub(
            dataclasses.replace(jdit.DiTConfig.tiny(), cross_instance=True),
            jcalls))
        tout = tmidi.run(tcfg, generator=_stub(cfg_dit, tcalls, "cpu"))
    _same_calls(tcalls, jcalls)
    assert jcalls[0]["extra"].shape[1:] == (1, cfg_dit.cond_dim)
    seg = "segmentation.png"
    np.testing.assert_array_equal(
        read_png(os.path.join(tcfg.path("midi_output"), seg))[0],
        read_png(os.path.join(jcfg.path("midi_output"), seg))[0])
    meshes = _same_glb(tout, jout, 1e-5)
    assert len(meshes) == (2 if seg_mode == "box" else len(jcalls[0]["images"]))
    assert all(m.vertices[:, 2].min() > 0 for m in meshes)


def _draw_zero_init(params, rng, std=0.2):
    """The AdaLN-Zero leaves (adaLN, adaLN_out and x_out kernels) and the
    instance gates of a flax ShapeDiT tree drawn from N(0, std²): at flax's
    init the velocity is exactly 0 and the instance attention is gated
    off."""
    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            elif k.startswith("inst_gate") or (
                    k == "kernel" and path[-1] in tdit.ZERO_INIT_DENSE):
                node[k] = rng.normal(0, std, np.shape(v)).astype(np.float32)
    walk(params, ())
    return params


def _drawn_generator_params(gen, rng):
    """The flax trees {"cond", "dit", "dec"} of ``gen``'s modules (shapes
    only, no init run) with every leaf drawn: kernels N(0, 1/fan_in), norm
    scales 1 + N(0, 0.1²), the rest N(0, 0.05²). Every AdaLN-Zero leaf and
    instance gate is non-zero, so each attention reaches the velocity."""
    key = jax.random.PRNGKey(0)
    c, v = gen.dit_cfg, gen.vae_cfg
    lat = jnp.zeros((1, c.latent_tokens, c.latent_dim))
    shapes = {
        "cond": jax.eval_shape(gen.cond.init, key, jnp.zeros((1, 64, 64, 4))),
        "dit": jax.eval_shape(gen.dit.init, key, lat, jnp.zeros((1,)),
                              jnp.zeros((1, 16, c.cond_dim))),
        "dec": jax.eval_shape(gen.decoder.init, key, lat[..., :v.latent_dim],
                              jnp.zeros((1, 8, 3)))}

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            std = 1.0 / np.sqrt(np.prod(leaf.shape[:-1]))
            return rng.normal(0, std, leaf.shape).astype(np.float32)
        if name == "scale":
            return (1 + rng.normal(0, 0.1, leaf.shape)).astype(np.float32)
        return rng.normal(0, 0.05, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize("n", [2, 3])
def test_midi_generator_matches_jax_in_f32(monkeypatch, n):
    """The tiny cross-instance generator with the JAX package's weights
    (every leaf drawn, instance gates and AdaLN-Zero leaves too), ``n``
    instances with box tokens, guidance 7, 2 steps, the dense 16³ decode,
    from one N(0, 1) noise: volumes within 1e-4 of max |ref|. At 3 both
    packages pad the batch to 4 with a copy of the last instance, which
    joins the instance attention; the noise covers the copy too."""
    monkeypatch.setattr(jl, "flash_attention",
                        lambda q, k, v: ja.attention_reference(q, k, v))
    jdc = dataclasses.replace(jdit.DiTConfig.tiny(), cross_instance=True,
                              dtype=jnp.float32)
    jvc = dataclasses.replace(jsv.ShapeVAEConfig.tiny(), dtype=jnp.float32)
    j32 = jp3.AssetGenerator(
        dit_cfg=jdc, vae_cfg=jvc,
        cond=jp3.CondEncoder(width=jdc.cond_dim, depth=2, num_heads=4,
                             dtype=jnp.float32),
        dit=jdit.ShapeDiT(jdc), decoder=jsv.ShapeDecoder(jvc), params=None,
        image_size=64)
    rng = np.random.default_rng(4)
    j32.params = _drawn_generator_params(j32, rng)
    params = j32.params
    tdc = dataclasses.replace(tdit.DiTConfig.tiny(), cross_instance=True,
                              dtype=torch.float32)
    tvc = dataclasses.replace(tsv.ShapeVAEConfig.tiny(), dtype=torch.float32)
    t32 = tp3.AssetGenerator(
        dit_cfg=tdc, vae_cfg=tvc,
        cond=tp3.CondEncoder(width=tdc.cond_dim, depth=2, num_heads=4,
                             dtype=torch.float32, device="cpu"),
        dit=tdit.ShapeDiT(tdc, device="cpu"),
        decoder=tsv.ShapeDecoder(tvc, device="cpu"), image_size=64)
    for mod, part in ((t32.cond, "cond"), (t32.dit, "dit"),
                      (t32.decoder, "dec")):
        load_from_jax(mod, params[part])

    imgs = rng.random((n, 64, 64, 4)).astype(np.float32)
    dets = [types.SimpleNamespace(box=types.SimpleNamespace(
        xmin=x0, ymin=y0, xmax=x1, ymax=y1))
        for x0, y0, x1, y1 in ((16, 64, 44, 88), (80, 62, 112, 86),
                               (50, 10, 70, 40))[:n]]
    tok = tmidi.box_tokens(dets, 96, 128, tdc.cond_dim)
    bucket = n if n <= 2 else 4
    noise = rng.standard_normal((bucket, tdc.latent_tokens,
                                 tdc.latent_dim)).astype(np.float32)
    jsample, tsample = jdit.sample, tdit.sample
    monkeypatch.setattr(jp3, "dit_sample", lambda *a, **k: jsample(
        *a, **k, latents=jnp.asarray(noise)))
    monkeypatch.setattr(tp3, "dit_sample", lambda m, c, num_steps,
                        guidance_scale, generator: tsample(
                            m, c, num_steps=num_steps,
                            guidance_scale=guidance_scale,
                            latents=torch.from_numpy(noise)))
    jp3._jitted_generate.cache_clear()
    try:
        want = j32.generate_sdf_batch(jax.random.PRNGKey(0), imgs, 2, 7.0,
                                      16, 2048, extra_cond_tokens=tok)
    finally:
        jp3._jitted_generate.cache_clear()
    got = t32.generate_sdf_batch(None, torch.from_numpy(imgs), 2, 7.0, 16,
                                 2048, extra_cond_tokens=tok)
    assert got.shape == want.shape == (n, 16, 16, 16)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    # the instances denoise jointly: the second instance's volume moves
    # with the first one's noise, and the last one's with the padding's
    noise[0] += 1.0
    noise[n:] += 1.0
    moved = t32.generate_sdf_batch(None, torch.from_numpy(imgs), 2, 7.0, 16,
                                   2048, extra_cond_tokens=tok)
    assert np.abs(moved[1] - got[1]).max() > 1e-4 * np.abs(got).max()
    if n < bucket:
        noise[0] -= 1.0
        moved = t32.generate_sdf_batch(None, torch.from_numpy(imgs), 2, 7.0,
                                       16, 2048, extra_cond_tokens=tok)
        assert np.abs(moved[n - 1] - got[n - 1]).max() \
            > 1e-4 * np.abs(got).max()


def test_dpa_matches_jax_stage_by_stage(tmp_path, monkeypatch):
    jcfg, tcfg = _cfgs(tmp_path, dpa_iterations=2, num_inf_steps_hy=6,
                       octree_resolution_hy=24)
    jcalls, tcalls = [], []
    fits = {}

    def recorded(fit, key, raster_path):
        def call(init, batch, cam, cfg):
            fits[key] = (fit(init, batch, cam, cfg),
                         raster_path(cfg, batch.faces.shape[1]))
            return fits[key][0]
        return call

    monkeypatch.setattr(jpf, "fit_poses", recorded(
        jpf.fit_poses, "j", lambda c, n: "edge" if c.use_edge_raster
        and jpf._binned_budget_ok(c, n) else "other"))
    monkeypatch.setattr(tdpa, "fit_poses", recorded(
        tdpa.fit_poses, "t", lambda c, n: tpf.raster_path(c, n, "cpu")))
    with threadpool_limits(1):
        jout = jdpa.run(jcfg, generator=_stub(jdit.DiTConfig.tiny(), jcalls))
        tout = tdpa.run(tcfg, generator=_stub(tdit.DiTConfig.tiny(), tcalls,
                                              "cpu"))
    _same_calls(tcalls, jcalls)
    assert tcalls[0]["steps"] == 3 and tcalls[0]["resolution"] == 24
    jroot, troot = jcfg.path("dpa_output"), tcfg.path("dpa_output")
    for stage in ("segmentation", "inpainting"):
        names = sorted(os.listdir(os.path.join(jroot, stage)))
        assert names and sorted(os.listdir(os.path.join(troot, stage))) == names
        for n in names:
            np.testing.assert_array_equal(
                read_png(os.path.join(troot, stage, n))[0],
                read_png(os.path.join(jroot, stage, n))[0], err_msg=n)
    objs = sorted(os.listdir(os.path.join(jroot, "object_generation")))
    assert sorted(os.listdir(os.path.join(troot, "object_generation"))) == objs
    for n in objs:
        _same_glb(os.path.join(troot, "object_generation", n),
                  os.path.join(jroot, "object_generation", n), 1e-5)
    geo = os.path.join("geometry", "scene.ply")
    np.testing.assert_allclose(load_ply(os.path.join(troot, geo)).vertices,
                               load_ply(os.path.join(jroot, geo)).vertices,
                               rtol=0, atol=1e-5)
    # the fit: one Adam step apart at most (ROADMAP Queue 3 g), on the
    # tile-binned edge path in both. Two iterations: from the third on,
    # Adam's m/√v on near-zero gradients amplifies the silhouette's
    # rounding noise (measured 1.3e-4 on yaw after two, 6.5e-3 after
    # three, 2.5e-4 after three with the silhouette weighted 0)
    (rj, jpath), (rt, tpath) = fits["j"], fits["t"]
    assert jpath == tpath == "edge"
    assert rt.num_iters == int(rj.num_iters) == 2
    for name in ("translation", "yaw", "rot_aa", "log_scale"):
        np.testing.assert_allclose(getattr(rt.params, name).numpy(),
                                   np.asarray(getattr(rj.params, name)),
                                   rtol=0, atol=5e-3, err_msg=name)
    np.testing.assert_allclose(rt.losses.numpy(), np.asarray(rj.losses),
                               rtol=2e-3)
    tm, jm = load_glb(tout).meshes, load_glb(jout).meshes
    assert [m.name for m in tm] == [m.name for m in jm]
    assert len(tm) == len(objs)
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a.faces, b.faces)
        assert a.vertices.shape == b.vertices.shape
        assert np.isfinite(a.vertices).all()


# --- the CLI ----------------------------------------------------------------

def _write_cfg(root, **over):
    root.mkdir(parents=True, exist_ok=True)
    img = _room(root / "room.png", 32, 32)
    values = dict(jconfig.default_config(str(root / "output"),
                                         input_image=img, **over))
    path = root / "cfg.yaml"
    path.write_text(yaml.safe_dump(values))
    return str(path)


def test_cli_runs_phases_10_and_11(tmp_path):
    """``-p 10 11`` through the port's CLI on the CPU, no generator passed
    (the random-init tiny one), tiny knobs: the MIDI scene GLB in front of
    the camera, every DPA stage directory filled, finite registered
    meshes."""
    cfg = _write_cfg(tmp_path, num_inference_steps_midi=2,
                     octree_resolution_hy=8, num_inf_steps_hy=2,
                     dpa_iterations=1)
    with threadpool_limits(1):
        torch_orch.main(["-p", "10", "11", "--config", cfg, "--device", "cpu"])
    c = default_config(str(tmp_path / "output"))
    midi = load_glb(c.path("glb_scene_path_midi")).meshes
    assert midi and all(m.vertices[:, 2].min() > 0 for m in midi)
    assert os.path.exists(os.path.join(c.path("midi_output"),
                                       "segmentation.png"))
    root = c.path("dpa_output")
    for stage in tdpa.STAGES:
        assert os.listdir(os.path.join(root, stage)), stage
    dpa = load_glb(os.path.join(root, "final_registration", "scene.glb"))
    assert dpa.meshes and all(np.isfinite(m.vertices).all()
                              for m in dpa.meshes)


@pytest.mark.parametrize("flag,phases", [("Use_MIDI", [10, 7, 9]),
                                         ("Use_DPA", [11])])
def test_phase_swaps_match_jax(tmp_path, monkeypatch, flag, phases):
    """The baseline flags swap the default flow in both CLIs alike; an
    explicit ``-p`` wins."""
    calls = {"j": [], "t": []}
    monkeypatch.setattr(jorch, "run_phases",
                        lambda cfg, ps, *a, **k: calls["j"].append(list(ps)))
    monkeypatch.setattr(torch_orch, "run_phases",
                        lambda cfg, ps, *a, **k: calls["t"].append(list(ps)))
    cfg = _write_cfg(tmp_path, **{flag: True})
    for argv in (["--config", cfg], ["--config", cfg, "-p", "1", "2"]):
        jorch.main(argv)
        torch_orch.main(argv)
    assert calls["j"] == calls["t"] == [phases, [1, 2]]


def test_midi_dit_fixture_and_drawn_gates(monkeypatch):
    """The committed ``midi.npz`` (the cross-instance tiny DiT at
    PRNGKey(0)): the port in bf16 and in f32 on its weights and inputs
    within 1e-5 of the fixture's velocity. At flax's init the instance gates
    and the AdaLN-Zero leaves are zero (ROADMAP Queue 3 m), so the port in
    f32 is also held against the live JAX model with them drawn, on two
    instances whose tokens the instance attention mixes: within 1e-5 of
    max |ref|."""
    monkeypatch.setattr(jl, "flash_attention",
                        lambda q, k, v: ja.attention_reference(q, k, v))
    d = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                             "activations", "midi.npz"))
    jc = dataclasses.replace(jdit.DiTConfig.tiny(), cross_instance=True)
    params = jax.device_get(jax.jit(jdit.ShapeDiT(jc).init)(
        jax.random.PRNGKey(0), jnp.zeros((2, jc.latent_tokens, jc.latent_dim)),
        jnp.zeros((2,)), jnp.zeros((2, 4, jc.cond_dim))))
    args = [d["input_x"], d["input_t"], d["input_cond"]]
    for dt in (torch.bfloat16, torch.float32):
        m = tdit.ShapeDiT(dataclasses.replace(
            tdit.DiTConfig.tiny(), cross_instance=True, dtype=dt), device="cpu")
        load_from_jax(m, params)
        with torch.no_grad():
            v = m(*map(torch.from_numpy, args)).float().numpy()
        np.testing.assert_allclose(v, d["expected_v"], rtol=0, atol=1e-5)

    rng = np.random.default_rng(8)
    params = _draw_zero_init(params, rng)
    args = [rng.normal(size=(2, jc.latent_tokens, jc.latent_dim)),
            np.asarray([0.3, 0.7]), rng.normal(size=(2, 5, jc.cond_dim))]
    args = [np.asarray(a, np.float32) for a in args]
    want = np.asarray(jax.jit(jdit.ShapeDiT(dataclasses.replace(
        jc, dtype=jnp.float32)).apply)(params, *map(jnp.asarray, args)))
    m = tdit.ShapeDiT(dataclasses.replace(
        tdit.DiTConfig.tiny(), cross_instance=True, dtype=torch.float32),
        device="cpu")
    load_from_jax(m, params)
    with torch.no_grad():
        got = m(*map(torch.from_numpy, args)).numpy()
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
