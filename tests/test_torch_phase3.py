"""Phase 3 of the port against the JAX package on the CPU.

- The committed ``checkpoints/shape_distilled.npz`` read by both packages'
  loaders: every leaf equal after the f16 → f32 cast, and every leaf in the
  port's modules.
- The checkpoint's condition tokens, ``sample`` (3 steps, guidance 5, shared
  latents) and the 32³ decode against JAX on rendered object images, in f32
  compute at rtol 2e-4 and atol 2e-5·max|ref| (the JAX side on its plain
  attention, which is the kernel's arithmetic in f32), and in the serving
  bf16 by the mean error, within 1e-2·max|ref|: there the packages round
  in different places (XLA keeps f32 across fused ops), so elements part by
  up to 7% of max|ref| through the chain while the mean stays under 0.7%
  (ROADMAP Queue 3 af).
- ``extract_and_clean`` on the same volumes: identical faces, vertices
  within 1e-6, the ±1.01 grid mapped to ±1.0 (ROADMAP Queue 3 ad);
  ``vertex_colors_from_image`` within 1e-6; ``lookat_camera``;
  ``marching_tetrahedra(bounds=…)``; the RGBA loader against Pillow;
  ``save_generator`` → ``load_generator`` in both directions.
- ``python -m regen3d_tpu_torch -p 3 --device cpu`` and ``run.py -p 3`` (the
  JAX side on its plain attention) on the same prepped images at 3 steps
  and 24³: a non-placeholder GLB per object under the same names (the
  noise differs between the packages, so only the contract is compared);
  the texture branches (``bake_texture_atlas``, ``use_multiview_texgen``
  and its PBR ring) on one sphere mesh in both packages; the random-init
  generator when no checkpoint loads.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from regen3d_tpu import config as jconfig
from regen3d_tpu import orchestrator as jorch
from regen3d_tpu.camera import lookat_camera as j_lookat
from regen3d_tpu.models import dit as jd
from regen3d_tpu.models import layers as jl
from regen3d_tpu.models import shapevae as jsv
from regen3d_tpu.ops import attention as ja
from regen3d_tpu.ops.marching_cubes import marching_tetrahedra as j_march
from regen3d_tpu.pipeline import phase3_assets as jp3
from regen3d_tpu.pipeline import shape_distill as jsd
from regen3d_tpu_torch.artifacts import Artifacts
from regen3d_tpu_torch.camera import lookat_camera
from regen3d_tpu_torch.config import default_config
from regen3d_tpu_torch.models import dit as td
from regen3d_tpu_torch.models import shapevae as tsv
from regen3d_tpu_torch.models.from_jax import state_from_jax
from regen3d_tpu_torch.ops.marching_cubes import marching_tetrahedra
from regen3d_tpu_torch.pipeline import phase3_assets as tp3
from regen3d_tpu_torch.pipeline import shape_distill as tsd
from regen3d_tpu_torch.utils.glb import load_glb
from regen3d_tpu_torch.utils.image import load_image_rgba
from test_torch_package import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
CKPT = str(ROOT / "checkpoints" / "shape_distilled.npz")


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def ckpt():
    """(JAX generator, port cfg, port f32 trees, port bf16 generator) of the
    committed checkpoint, and two rendered object images at 64²."""
    rng = np.random.default_rng(0)
    specs = [jsd.sample_spec(rng) for _ in range(2)]
    imgs = np.asarray(jsd.render_cond_batch(specs, rng, 64), np.float32)
    cfg, params = tsd.load_params(CKPT)
    return dict(jg=jsd.load_generator(CKPT), cfg=cfg, params=params,
                tg=tsd.load_generator(CKPT, device="cpu"), imgs=imgs,
                lat=rng.normal(size=(2, 64, 16)).astype(np.float32))


def test_checkpoint_leaves_equal(ckpt):
    """Every f32 leaf of both loaders is the same array, and the port's
    modules hold them all (strict), in f32."""
    jg, tg, params = ckpt["jg"], ckpt["tg"], ckpt["params"]
    assert ckpt["cfg"].dit.width == 256 and ckpt["cfg"].vae.dec_depth == 4
    assert tg.trained and tg.image_size == jg.image_size == 64
    for part, module in (("cond", tg.cond), ("dit", tg.dit),
                         ("dec", tg.decoder)):
        want = _leaves(jax.device_get(jg.params[part]))
        got = _leaves(params[part])
        assert set(got) == set(want), part
        for path, a in want.items():
            assert got[path].dtype == np.float32
            np.testing.assert_array_equal(got[path], a, err_msg=str(path))
        state = module.state_dict()
        mapped = state_from_jax(params[part])
        assert set(state) == set(mapped)
        for name, t in state.items():
            assert t.dtype == torch.float32, name
            np.testing.assert_array_equal(t.numpy(), mapped[name].numpy())


def _chain_jax(jg, dtype, imgs, lat):
    jc = jp3.CondEncoder(width=jg.dit_cfg.cond_dim, depth=2, num_heads=8,
                         patch=8, dtype=dtype)
    jdit = jd.ShapeDiT(dataclasses.replace(jg.dit_cfg, dtype=dtype))
    jdec = jsv.ShapeDecoder(dataclasses.replace(jg.vae_cfg, dtype=dtype))
    cond = np.asarray(jc.apply(jg.params["cond"], jnp.asarray(imgs)))
    latents = np.asarray(jd.sample(
        jdit, jg.params["dit"], None, jnp.asarray(cond), num_steps=3,
        guidance_scale=5.0, latents=jnp.asarray(lat)))
    vol = np.asarray(jsv.decode_grid(jdec, jg.params["dec"],
                                     jnp.asarray(latents), resolution=32,
                                     chunk=8192))
    return cond, latents, vol


def _chain_port(cond_mod, dit, dec, imgs, cond_j, lat, lat_j):
    """The port's chain, each stage fed JAX's input to it."""
    with torch.no_grad():
        cond = cond_mod(T(imgs)).numpy()
        latents = td.sample(dit, T(cond_j), num_steps=3, guidance_scale=5.0,
                            latents=T(lat)).numpy()
        vol = tsv.decode_grid(dec, T(lat_j), resolution=32,
                              chunk=8192).numpy()
    return cond, latents, vol


@pytest.fixture
def plain_jax_attention(monkeypatch):
    """The JAX package's plain attention in place of its interpreted Pallas
    kernel (the same f32 arithmetic; seconds instead of tens)."""
    monkeypatch.setattr(jl, "flash_attention",
                        lambda q, k, v: ja.attention_reference(q, k, v))


def test_checkpoint_chain_matches_jax_in_f32(ckpt, plain_jax_attention):
    params = ckpt["params"]
    want = _chain_jax(ckpt["jg"], jnp.float32, ckpt["imgs"], ckpt["lat"])
    g = tsd.build_generator(ckpt["cfg"].with_dtype(torch.float32),
                            params["cond"], params["dit"], params["dec"],
                            device="cpu")
    assert g.cond.dtype == torch.float32
    got = _chain_port(g.cond, g.dit, g.decoder, ckpt["imgs"], want[0],
                      ckpt["lat"], want[1])
    assert (want[2] < 0).sum() > 100        # the shapes have an inside
    for name, g, w in zip(("cond", "latents", "volume"), got, want):
        np.testing.assert_allclose(g, w, rtol=2e-4,
                                   atol=2e-5 * np.abs(w).max(), err_msg=name)


def test_checkpoint_chain_bf16_mean_error(ckpt, plain_jax_attention):
    jg, tg = ckpt["jg"], ckpt["tg"]
    want = _chain_jax(jg, jnp.bfloat16, ckpt["imgs"], ckpt["lat"])
    got = _chain_port(tg.cond, tg.dit, tg.decoder, ckpt["imgs"], want[0],
                      ckpt["lat"], want[1])
    for name, g, w in zip(("cond", "latents", "volume"), got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        err = float(np.abs(g - w).mean())
        assert err <= 1e-2 * np.abs(w).max(), (name, err, np.abs(w).max())


# --- extraction, colours, camera, I/O ---------------------------------------

def _blobs(res=40, bounds=1.01):
    """An SDF on make_grid's points: a sphere of radius 0.5, a box beside
    it joined by nothing, and a small floater."""
    p = tsv.make_grid(res, bounds).numpy().reshape(res, res, res, 3)
    sphere = np.linalg.norm(p - [-0.3, 0, 0], axis=-1) - 0.5
    q = np.abs(p - [0.55, 0.1, 0.0]) - [0.2, 0.3, 0.25]
    box = (np.linalg.norm(np.maximum(q, 0), axis=-1)
           + np.minimum(q.max(-1), 0))
    floater = np.linalg.norm(p - [0.6, -0.7, 0.6], axis=-1) - 0.12
    return np.minimum(np.minimum(sphere, box), floater).astype(np.float32)


@pytest.mark.parametrize("target_faces", [None, 600])
def test_extract_and_clean_matches_jax(target_faces):
    vol = _blobs()
    vj, fj = jp3.extract_and_clean(vol, target_faces)
    vt, ft = tp3.extract_and_clean(vol, target_faces)
    assert len(fj) > 100
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-6)
    if target_faces:
        assert len(ft) <= target_faces


def test_extraction_maps_the_decode_grid_to_the_unit_cube():
    """ROADMAP Queue 3 ad, pinned in both packages: the decode grid spans
    ±1.01 but extraction maps the volume to ±1.0, so a sphere of radius 0.5
    decoded on the grid comes out at 0.5/1.01."""
    p = tsv.make_grid(48).numpy().reshape(48, 48, 48, 3)
    vol = (np.linalg.norm(p, axis=-1) - 0.5).astype(np.float32)
    for extract in (jp3.extract_and_clean, tp3.extract_and_clean):
        v, _ = extract(vol)
        r = np.linalg.norm(v, axis=-1)
        assert abs(np.median(r) - 0.5 / 1.01) < 2e-3
        assert abs(np.median(r) - 0.5) > 3e-3


@pytest.mark.parametrize("hw", [(60, 50), (270, 110)])
def test_vertex_colors_match_jax(hw):
    """A cleaned mesh baked from an object image: below 256 px directly,
    above it after the antialiased shrink, within 1e-6."""
    verts, faces = jp3.extract_and_clean(_blobs(20))
    rng = np.random.default_rng(9)
    img = rng.uniform(size=hw + (4,)).astype(np.float32)
    img[..., :3] = np.cumsum(img[..., :3], axis=1) / hw[1]   # smooth in x
    want = jp3.vertex_colors_from_image(verts, faces, img)
    got = tp3.vertex_colors_from_image(verts, faces, img, device="cpu")
    assert got.shape == (len(verts), 4)
    assert 0 <= got.min() and got.max() <= 1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("eye, target, up", [
    ((0.3, -0.2, -2.5), (0.1, 0.0, 0.2), (0, 1, 0)),
    ((1.0, 2.0, 3.0), (-1.0, 0.5, 0.0), (0, 0, 1)),
    ((0.0, 3.0, 0.0), (0.0, 0.0, 0.0), (0, 1, 0)),     # along up
])
def test_lookat_camera_matches_jax(eye, target, up):
    e, t = np.asarray(eye, np.float32), np.asarray(target, np.float32)
    want = j_lookat(e, t, (120, 90), 132.0, up=up)
    got = lookat_camera(e, t, (120, 90), 132.0, up=up, device="cpu")
    for key in ("R", "T", "focal", "principal"):
        np.testing.assert_allclose(getattr(got, key).numpy(),
                                   np.asarray(getattr(want, key)), rtol=0,
                                   atol=1e-6, err_msg=key)
    assert got.image_size == want.image_size == (120, 90)
    assert (got.znear, got.zfar) == (want.znear, want.zfar)
    np.testing.assert_allclose(got.R.numpy().T @ got.R.numpy(), np.eye(3),
                               atol=1e-6)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_load_image_rgba_matches_pillow(tmp_path, mode):
    rng = np.random.default_rng(10)
    chans = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    arr = rng.integers(0, 256, (17, 23, chans), dtype=np.uint8)
    path = tmp_path / f"{mode}.png"
    Image.fromarray(arr[..., 0] if chans == 1 else arr, mode).save(path)
    want = np.asarray(Image.open(path).convert("RGBA"))
    got = load_image_rgba(str(path))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_marching_bounds_match_jax():
    vol = _blobs(24)
    for bounds in (None, (-1.0, 1.0), (-1.01, 1.01)):
        vj, fj = j_march(vol, 0.0, bounds=bounds)
        vt, ft = marching_tetrahedra(vol, 0.0, bounds=bounds)
        assert vt.dtype == np.float32
        np.testing.assert_array_equal(ft, fj)
        np.testing.assert_array_equal(vt, vj)


def _micro_params(seed=0):
    """Flax trees of ``DistillConfig.micro()``'s three modules, drawn from a
    numpy seed."""
    cfg = jsd.DistillConfig.micro()
    s = cfg.image_size
    shapes = {
        "cond": jax.eval_shape(cfg.cond_encoder().init, jax.random.PRNGKey(0),
                               jnp.zeros((1, s, s, 4))),
        "dit": jax.eval_shape(
            jd.ShapeDiT(cfg.dit).init, jax.random.PRNGKey(0),
            jnp.zeros((1, cfg.dit.latent_tokens, cfg.dit.latent_dim)),
            jnp.zeros((1,)), jnp.zeros((1, 16, cfg.dit.cond_dim))),
        "dec": jax.eval_shape(
            jsv.ShapeDecoder(cfg.vae).init, jax.random.PRNGKey(0),
            jnp.zeros((1, cfg.vae.latent_tokens, cfg.vae.latent_dim)),
            jnp.zeros((1, 8, 3))),
    }
    rng = np.random.default_rng(seed)
    return cfg, jax.tree_util.tree_map(
        lambda l: (0.1 * rng.normal(size=l.shape)).astype(np.float32), shapes)


def test_save_load_generator_round_trip(tmp_path):
    """The port writes what both loaders read to the same leaves (the first
    two parts through f16), and reads what the JAX package writes."""
    jcfg, params = _micro_params()
    tcfg = tsd.DistillConfig.micro()
    assert (dataclasses.asdict(tcfg.dit).keys()
            == dataclasses.asdict(jcfg.dit).keys())
    ours, theirs = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tsd.save_generator(ours, tcfg, params)
    jsd.save_generator(theirs, jcfg, params)
    for path in (ours, theirs):
        cfg, got = tsd.load_params(path)
        assert cfg == tcfg
        want = jsd.load_generator(path).params
        for part in tsd.PARTS:
            w, g = _leaves(jax.device_get(want[part])), _leaves(got[part])
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
            src = _leaves(params[part])
            for k in w:     # f16 storage for cond and dit, f32 for dec
                dt = np.float32 if part == "dec" else np.float16
                np.testing.assert_array_equal(
                    g[k], src[k].astype(dt).astype(np.float32))
        gen = tsd.load_generator(path, device="cpu")
        assert gen.trained and gen.image_size == 32
        assert gen.cond.patch_size == 8


def test_random_init_generator_repeats():
    """The random-init generator on the CPU: the same seed gives the same
    volume, bit for bit; the tiny one capped as the JAX package caps it."""
    vols = []
    for _ in range(2):
        g = torch.Generator().manual_seed(4)
        gen = tp3.AssetGenerator.random_init(g, tiny=True, device="cpu")
        img = np.random.default_rng(12).uniform(size=(64, 64, 4))
        vols.append(gen.generate_sdf(g, img.astype(np.float32), 2, 5.0, 16,
                                     1024))
    assert vols[0].shape == (16, 16, 16) and np.isfinite(vols[0]).all()
    np.testing.assert_array_equal(vols[0], vols[1])
    assert not gen.trained and gen.image_size == 64


# --- the CLIs ---------------------------------------------------------------

def _prepped_root(root, imgs, **over):
    """A config under root with two prepped RGBA objects (the rendered
    images padded on a larger canvas) and tiny phase-3 knobs."""
    values = dict(jconfig.default_config(
        str(root / "output"), input_image=str(root / "in.png"),
        num_inf_steps_hy=3, octree_resolution_hy=24, **over))
    root.mkdir(parents=True, exist_ok=True)
    path = root / "cfg.yaml"
    path.write_text(yaml.safe_dump(values))
    art = Artifacts(default_config(str(root / "output")))
    os.makedirs(art.prepped_dir, exist_ok=True)
    names = ["chair__(120, 80)", "table__(300, 200)"]
    for name, img, size in zip(names, imgs, (96, 80)):
        canvas = np.zeros((size, size, 4), np.uint8)
        o = (size - 64) // 2
        canvas[o:o + 64, o:o + 64] = np.round(img * 255).astype(np.uint8)
        Image.fromarray(canvas, "RGBA").save(
            os.path.join(art.prepped_dir, f"{name}.png"))
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(root / "in.png")
    return str(path), art, names


def _assert_assets(art, names):
    assert art.list_assets() == sorted(names)
    for name in names:
        mesh = load_glb(art.asset_glb(name)).meshes[0]
        assert len(mesh.vertices) > 24, name        # not the placeholder
        assert np.isfinite(mesh.vertices).all()
        assert np.abs(mesh.vertices).max() <= 1.0 + 1e-6
        c = mesh.vertex_colors
        assert c is not None and c.shape == (len(mesh.vertices), 4)
        assert 0 <= c.min() and c.max() <= 1


def test_phase3_cli_writes_the_contract_like_jax(tmp_path, ckpt,
                                                plain_jax_attention):
    j_cfg, j_art, names = _prepped_root(tmp_path / "j", ckpt["imgs"])
    t_cfg, t_art, _ = _prepped_root(tmp_path / "t", ckpt["imgs"])
    jorch.main(["-p", "3", "--config", j_cfg])
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-m", "regen3d_tpu_torch", "-p", "3", "--config",
         t_cfg, "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "loaded distilled shape generator" in out.stderr
    _assert_assets(j_art, names)
    _assert_assets(t_art, names)


def _sphere_volumes(n, res):
    """n copies of a sphere's SDF (radius 0.5) on the decode grid."""
    g = np.linspace(-1.01, 1.01, res, dtype=np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    return np.repeat((np.sqrt(x * x + y * y + z * z) - 0.5)[None], n, 0)


def _fixed_volumes(monkeypatch):
    """Both packages' generators give the sphere (the two samplers' noise
    differs, so their meshes would too): the same mesh goes into both
    texture paths."""
    def jax_batch(self, key, images, num_steps, guidance, res, chunk,
                  **kw):
        return _sphere_volumes(len(images), res)

    def port_batch(self, generator, images, num_steps, guidance, res,
                   chunk, **kw):
        return _sphere_volumes(images.shape[0], res)

    monkeypatch.setattr(jp3.AssetGenerator, "generate_sdf_batch", jax_batch)
    monkeypatch.setattr(tp3.AssetGenerator, "generate_sdf_batch", port_batch)


def _texgen_weights(monkeypatch, cfg):
    """The JAX CLI's ``init_texgen`` given the port CLI's weights (the port's
    tiny texgen model and VAE from seed 0, as its phase 3 draws them): the
    two packages draw random inits from different generators, and the JAX
    package's eager init of the tiny UNet takes about a minute."""
    from regen3d_tpu.pipeline import texgen as jtg
    from regen3d_tpu_torch.models.from_jax import tree_from_model
    from regen3d_tpu_torch.models.sd_unet import SDUNetConfig
    from regen3d_tpu_torch.models.sd_vae import SDVAEConfig
    from regen3d_tpu_torch.pipeline import texgen as ttg

    n = int(cfg["max_num_view"])
    model, vae = ttg.init_texgen(
        ttg.TexGenConfig(num_views=n), torch.Generator().manual_seed(0),
        SDUNetConfig.tiny(in_channels=12, class_embeddings=n),
        SDVAEConfig.tiny(), device="cpu")
    trees = (tree_from_model(model), tree_from_model(vae))
    monkeypatch.setattr(jtg, "init_texgen", lambda tcfg, key=None,
                        unet_cfg=None, vae_cfg=None: (*trees, unet_cfg,
                                                      vae_cfg))
    from regen3d_tpu.models import sd_unet as jsu
    from regen3d_tpu.models import sd_vae as jsva
    for mod in (jsu, jsva):
        monkeypatch.setattr(mod, "flash_attention",
                            lambda q, k, v: ja.attention_reference(q, k, v))


@pytest.mark.parametrize("knob", ["use_multiview_texgen",
                                  "bake_texture_atlas"])
def test_texture_branches_write_a_textured_glb(tmp_path, ckpt, knob,
                                               monkeypatch):
    """Each switch writes a textured GLB per object through both packages'
    ``run`` on the same sphere mesh: per-corner UVs, a baseColor PNG and no
    vertex colours. ``bake_texture_atlas`` gives the JAX package's mesh,
    UVs and atlas: decoded pixels within one level on all but the texels
    whose visibility flips at a face edge (Queue 3 ag), which take the
    unseen texels' mean colour in one package (5 of 55,696 texels, 96
    levels off; 273 more differ by one level); ``use_multiview_texgen``
    its GLB contract (the same faces, UVs and texture size; the noise
    differs)."""
    from regen3d_tpu_torch.utils.image import decode_png

    _fixed_volumes(monkeypatch)
    over = {knob: True, "texels_per_face": 2, "texgen_resolution": 16,
            "texgen_steps": 1, "max_num_view": 2}
    meshes = {}
    for pkg in ("j", "t"):
        _, art, names = _prepped_root(tmp_path / pkg, ckpt["imgs"][:1])
        if pkg == "j":
            cfg = jconfig.default_config(str(tmp_path / pkg / "output"),
                                         octree_resolution_hy=24, **over)
            if knob == "use_multiview_texgen":
                _texgen_weights(monkeypatch, cfg)
            done = jp3.run(cfg)
        else:
            done = tp3.run(default_config(str(tmp_path / pkg / "output"),
                                          octree_resolution_hy=24, **over),
                           device="cpu")
        assert done == names[:1]
        meshes[pkg] = load_glb(art.asset_glb(names[0])).meshes[0]
    t, j = meshes["t"], meshes["j"]
    assert t.vertex_colors is None and t.texture_png and t.uvs is not None
    assert len(t.faces) > 100 and len(t.vertices) == 3 * len(t.faces)
    np.testing.assert_array_equal(t.faces, j.faces)
    np.testing.assert_allclose(t.vertices, j.vertices, atol=1e-6)
    np.testing.assert_array_equal(t.uvs, j.uvs)
    got, want = decode_png(t.texture_png)[0], decode_png(j.texture_png)[0]
    assert got.shape == want.shape
    if knob == "bake_texture_atlas":
        d = np.abs(got.astype(int) - want)
        d = d.max(-1)
        assert (d > 0).mean() <= 0.01 and (d > 1).mean() <= 2e-4


def test_texgen_pbr_cli_writes_albedo_and_mr_atlases(tmp_path, ckpt,
                                                     monkeypatch):
    """``use_multiview_texgen`` under ``use_hunyuan21`` (and
    ``enable_texture_hy21``, its default): the PBR ring, an albedo and a
    metallic-roughness atlas of one size on one layout, metallic and
    roughness factors 1; a ``realesrgan_ckpt_path`` that does not exist
    leaves the albedo at the atlas's size, as in the JAX package."""
    from regen3d_tpu_torch.utils.image import decode_png

    _fixed_volumes(monkeypatch)
    _, art, names = _prepped_root(tmp_path, ckpt["imgs"][:1])
    cfg = default_config(str(tmp_path / "output"), octree_resolution_hy21=24,
                         use_multiview_texgen=True, use_hunyuan21=True,
                         texels_per_face=2, texgen_resolution=16,
                         texgen_steps=1, max_num_view_hy21=2,
                         realesrgan_ckpt_path=str(tmp_path / "none.pth"))
    assert tp3.run(cfg, device="cpu") == names[:1]
    mesh = load_glb(art.asset_glb(names[0])).meshes[0]
    assert mesh.texture_png and mesh.mr_texture_png
    assert mesh.metallic == 1.0 and mesh.roughness == 1.0
    albedo, mr = decode_png(mesh.texture_png)[0], \
        decode_png(mesh.mr_texture_png)[0]
    assert albedo.shape == mr.shape and len(mesh.uvs) == len(mesh.vertices)


def test_random_init_when_no_checkpoint_loads(tmp_path, ckpt, caplog):
    """A ``shape_checkpoint`` that is missing: a warning, then the
    random-init generator writes an asset per object all the same."""
    _, art, names = _prepped_root(tmp_path, ckpt["imgs"])
    c = default_config(str(tmp_path / "output"), num_inf_steps_hy=2,
                       octree_resolution_hy=16,
                       shape_checkpoint=str(tmp_path / "missing.npz"))
    with caplog.at_level("WARNING"):
        done = tp3.run(c, device="cpu")
    assert done == sorted(names)
    assert "not found" in caplog.text and "random-init" in caplog.text
    for name in names:
        assert os.path.exists(art.asset_glb(name))


def test_no_checkpoint_on_the_card_raises(tmp_path, ckpt, monkeypatch):
    """Without a checkpoint the card takes the random-init tiny generator,
    as the CPU does (no FileNotFoundError any more): every head dim its
    attentions give the flash forward passes the kernel's shape check, 8
    (the condition encoder's, the D = 8 instance) among them. On a machine
    without a card, ``run(device="cuda")`` raises torch's CUDA error:
    nothing falls back to the CPU; on one with a card it writes every
    object's GLB."""
    from regen3d_tpu_torch.ops import attention as att

    dims = set()
    plain = att.attention_reference

    def recorded(q, k, v, scale=None):
        dims.add(q.shape[-1])
        return plain(q, k, v, scale)

    monkeypatch.setattr(att, "attention_reference", recorded)
    g = tp3.AssetGenerator.random_init(torch.Generator().manual_seed(0),
                                       tiny=True, device="cpu")
    g.generate_sdf_batch(torch.Generator().manual_seed(0),
                         torch.rand(1, 64, 64, 4), 1, 5.0, 16, 4096)
    assert 8 in dims and dims <= set(att.FWD_KERNEL_HEAD_DIMS), dims
    _, art, names = _prepped_root(tmp_path, ckpt["imgs"])
    missing = str(tmp_path / "missing.npz")
    c = default_config(str(tmp_path / "output"), shape_checkpoint=missing,
                       num_inf_steps_hy=2, octree_resolution_hy=16)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tp3.run(c, device="cuda")
    else:
        assert tp3.run(c, device="cuda") == sorted(names)
        for name in names:
            assert os.path.exists(art.asset_glb(name))
