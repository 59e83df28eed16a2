"""The port's DUSt3R phase 4 (``Use_VGGT: false``) against the JAX package
on the CPU.

* ``rope_2d``, the RoPE attention (self and cross), both blocks, the head's
  post-processing and the tiny model in f32 with weights carried by
  ``from_jax``, within 1e-5 of max |ref|; ``rope_2d`` and the tiny model
  in bf16 by the mean error over max |ref|, no further than the port's f32
  lies (ROADMAP Queue 3 af); the committed ``dust3r.npz`` fixture's
  weights and input the same way;
* ``estimate_focal`` at rel 1e-5, ``pair_viewer`` at 1e-5, the aligner's
  first 5 steps at 1e-5 (of max |ref|) and its recovery of exact
  synthetic pairs at the JAX test's 0.05;
* ``export_dust3r_scene`` on one scene in both packages: every file the
  same bytes (npz by content); ``run_from_model`` in f32 on one image
  (the pair viewer) within 1e-4;
* the JAX package's flash kernel runs through its plain reference (the same
  f32 arithmetic as its interpreted Pallas kernel, in seconds).
"""

import dataclasses
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import regen3d_tpu.ops.attention as ja
from regen3d_tpu import config as jconfig
from regen3d_tpu.models import dust3r as jd
from regen3d_tpu.pipeline import phase4_dust3r as jp
from regen3d_tpu_torch.artifacts import Artifacts
from regen3d_tpu_torch.config import default_config
from regen3d_tpu_torch.models import dust3r as td
from regen3d_tpu_torch.models.from_jax import load_from_jax
from regen3d_tpu_torch.pipeline import phase4_dust3r as tp
from regen3d_tpu_torch.utils.image import save_image
from test_torch_package import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests"))
from test_dust3r import _synthetic_scene  # noqa: E402


@pytest.fixture(autouse=True)
def plain_jax_attention(monkeypatch):
    monkeypatch.setattr(jd, "flash_attention",
                        lambda q, k, v: ja.attention_reference(q, k, v))


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got, want, tol=1e-5, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), (what, err)


def mean_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).mean() / np.abs(want).max())


# --- the model --------------------------------------------------------------

def test_rope_2d_matches_jax():
    rng = np.random.default_rng(0)
    t = rng.normal(size=(2, 3, 12, 16)).astype(np.float32)
    pos = rng.integers(0, 9, size=(12, 2))
    want = np.asarray(jd.rope_2d(jnp.asarray(t), jnp.asarray(pos)))
    close(td.rope_2d(T(t), T(pos)).numpy(), want, what="f32")
    # bf16: cos and sin cast before the products
    wb = np.asarray(jd.rope_2d(jnp.asarray(t, jnp.bfloat16), jnp.asarray(pos)),
                    np.float32)
    gb = td.rope_2d(T(t).to(torch.bfloat16), T(pos)).float().numpy()
    g32 = td.rope_2d(T(t).to(torch.bfloat16).float(), T(pos)).numpy()
    assert mean_err(gb, wb) <= max(mean_err(g32, wb), 1e-6)


def _block_case(kind):
    """(flax module, port module, args as numpy) of one block at width 64,
    4 heads of 16, on a 3 × 4 patch grid."""
    rng = np.random.default_rng(1)
    pos = np.stack(np.meshgrid(np.arange(3), np.arange(4),
                               indexing="ij"), -1).reshape(-1, 2)
    x = rng.normal(size=(2, 12, 64)).astype(np.float32)
    y = rng.normal(size=(2, 12, 64)).astype(np.float32)
    f32 = dict(dtype=jnp.float32)
    kw = dict(dtype=torch.float32, device="cpu")
    if kind == "self":
        return (jd.RopeAttention(4, 100.0, **f32),
                td.RopeAttention(64, 4, 100.0, **kw), (x, pos))
    if kind == "cross":
        return (jd.RopeAttention(4, 100.0, **f32),
                td.RopeAttention(64, 4, 100.0, **kw), (x, pos, y, pos[::-1]))
    if kind == "encoder":
        return (jd.EncoderBlock(4, 100.0, jnp.float32),
                td.EncoderBlock(64, 4, 100.0, **kw), (x, pos))
    return (jd.DecoderBlock(4, 100.0, jnp.float32),
            td.DecoderBlock(64, 4, 100.0, **kw), (x, pos, y, pos))


@pytest.mark.parametrize("kind", ["self", "cross", "encoder", "decoder"])
def test_blocks_match_jax_in_f32(kind):
    jm, tm, args = _block_case(kind)
    params = jax.device_get(jm.init(jax.random.PRNGKey(2),
                                    *map(jnp.asarray, args)))
    load_from_jax(tm, params)
    want = np.asarray(jm.apply(params, *map(jnp.asarray, args)))
    with torch.no_grad():
        got = tm(*map(T, args)).numpy()
    close(got, want, what=kind)


def test_head_matches_jax_in_f32():
    rng = np.random.default_rng(3)
    tok = rng.normal(size=(2, 6, 48)).astype(np.float32) * 0.3
    jm = jd.LinearHead(8, jnp.float32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(4), jnp.asarray(tok),
                                    (2, 3)))
    # a bias that takes the confidence past its clip at 10
    params["params"]["proj"]["bias"] = rng.normal(
        size=(8 * 8 * 4,)).astype(np.float32) * 8.0
    tm = td.LinearHead(48, 8, device="cpu")
    load_from_jax(tm, params)
    want = jm.apply(params, jnp.asarray(tok), (2, 3))
    with torch.no_grad():
        got = tm(T(tok), (2, 3))
    for g, w, name in zip(got, want, ("pts", "conf")):
        close(g.numpy(), np.asarray(w), what=name)
    assert float(np.asarray(want[1]).max()) == pytest.approx(1 + np.exp(10))


@pytest.fixture(scope="module")
def tiny():
    """The tiny DUSt3R's flax weights at PRNGKey(0) (the committed
    fixture's) and a pair of 24² image batches."""
    jc = jd.Dust3rConfig.tiny()
    s = 3 * jc.patch
    params = jax.device_get(jax.jit(jd.AsymmetricCroCo3DStereo(jc).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, s, s, 3)), jnp.zeros((1, s, s, 3))))
    rng = np.random.default_rng(5)
    imgs = [rng.uniform(size=(2, s, s, 3)).astype(np.float32) for _ in range(2)]
    return params, imgs


def _port(dtype, params):
    m = td.AsymmetricCroCo3DStereo(dataclasses.replace(
        td.Dust3rConfig.tiny(), dtype=dtype), device="cpu")
    load_from_jax(m, params)
    return m


def _apply(jdtype, params, imgs):
    m = jd.AsymmetricCroCo3DStereo(dataclasses.replace(
        jd.Dust3rConfig.tiny(), dtype=jdtype))
    with jax.default_matmul_precision("highest"):
        out = jax.jit(m.apply)(params, *map(jnp.asarray, imgs))
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def test_tiny_model_matches_jax(tiny):
    params, imgs = tiny
    want = _apply(jnp.float32, params, imgs)
    with torch.no_grad():
        got = _port(torch.float32, params)(*map(T, imgs))
    for k in want:
        close(got[k].numpy(), want[k], what=k)


# the port's bf16 against the JAX package's bf16, over the port's f32
# against the same: the two round in other places (ROADMAP Queue 3 af), so
# the bf16 path is held to lie no further than exact arithmetic would, with
# a margin (measured 1.00 to 1.04 on the fixture)
BF16_OVER_F32 = 1.25


def test_dust3r_fixture(tiny):
    """The committed fixture's weights (the tiny model at PRNGKey(0)) and
    inputs: the port in bf16 against the JAX package's bf16 apply by the
    mean error over max |ref|, within BF16_OVER_F32 of the port's f32."""
    params, _ = tiny
    d = np.load(ROOT / "tests" / "fixtures" / "activations" / "dust3r.npz")
    imgs = (d["input_img1"], d["input_img2"])
    want = _apply(jnp.bfloat16, params, imgs)
    for k in ("pts3d1", "pts3d2", "conf1", "conf2"):
        rec = d["expected_" + k.replace("3d", "")]
        print(k, "JAX bf16 vs fixture", float(np.abs(want[k] - rec).max()))
    with torch.no_grad():
        got = {dt: _port(dt, params)(*map(T, imgs))
               for dt in (torch.bfloat16, torch.float32)}
    for k in want:
        assert np.isfinite(got[torch.bfloat16][k].float().numpy()).all()
        err = mean_err(got[torch.bfloat16][k].numpy(), want[k])
        control = mean_err(got[torch.float32][k].numpy(), want[k])
        print(k, "bf16", err, "f32", control)
        assert err <= BF16_OVER_F32 * control, k


def test_estimate_focal_matches_jax():
    h, w, f = 24, 32, 40.0
    vv, uu = np.mgrid[0:h, 0:w].astype(np.float64)
    depth = 2.0 + 0.1 * np.sin(uu / 3) + 0.05 * np.cos(vv)
    pts = np.stack([(uu + 0.5 - w / 2) / f * depth,
                    (vv + 0.5 - h / 2) / f * depth * 1.01, depth],
                   -1).astype(np.float32)
    want = float(jd.estimate_focal(jnp.asarray(pts)))
    got = float(td.estimate_focal(T(pts)))
    assert got == pytest.approx(want, rel=1e-5)
    assert got == pytest.approx(f, rel=2e-2)


# --- the aligners -----------------------------------------------------------

def _pairwise(n, h, w, f, seed, noise=0.0):
    """``chip_smoke.synthetic_pairs`` (the JAX test's scene, exact pairwise
    pointmaps) plus ``noise`` on pts3d1 and drawn confidences."""
    c2ws, own, pairs, pred = chip_smoke.synthetic_pairs(n, h, w, f, seed)
    rng = np.random.default_rng(seed)
    e = len(pairs)
    pred["pts3d1"] = (pred["pts3d1"] + noise * rng.normal(size=(e, h, w, 3))
                      ).astype(np.float32)
    pred["conf1"] = rng.uniform(2, 9, (e, h, w)).astype(np.float32)
    pred["conf2"] = rng.uniform(2, 9, (e, h, w)).astype(np.float32)
    return c2ws, own, pairs, pred


def test_pair_viewer_matches_jax():
    _, _, pairs, pred = _pairwise(2, 16, 20, 30.0, seed=3, noise=0.01)
    want = jp.pair_viewer(pred, pairs)
    got = tp.pair_viewer(pred, pairs, device="cpu")
    for k in want:
        close(got[k], want[k], what=k)


def test_global_align_first_steps_match_jax():
    _, _, pairs, pred = _pairwise(3, 12, 16, 24.0, seed=4, noise=0.01)
    want = jp.global_align(pred, pairs, 3, niter=5)
    got = tp.global_align(pred, pairs, 3, niter=5, device="cpu")
    for k in want:
        close(got[k], want[k], what=k)
    assert np.isfinite(got["losses"]).all()


def test_global_align_recovers_poses():
    """The JAX test's construction: 3 views, exact pairwise pointmaps,
    150 iterations; poses (up to the gauge) and depths within 0.05."""
    c2ws, own, pairs, pred = _pairwise(3, 12, 16, 24.0, seed=4)
    pred["conf1"][:] = 8.0
    pred["conf2"][:] = 8.0
    scene = tp.global_align(pred, pairs, 3, niter=150, device="cpu")
    for k in range(3):
        want = np.linalg.inv(c2ws[0]) @ c2ws[k]
        np.testing.assert_allclose(scene["c2w"][k][:3, :3], want[:3, :3],
                                   atol=0.05)
        np.testing.assert_allclose(scene["c2w"][k][:3, 3], want[:3, 3],
                                   atol=0.05)
    np.testing.assert_allclose(scene["depth"][0], own[0][..., 2], rtol=0.05)
    assert np.isfinite(scene["losses"]).all()


# --- export and the run -----------------------------------------------------

def _artifact_files(cfg):
    art = Artifacts(cfg)
    return [os.path.join(art.pre3d_dir, "scene.glb"), art.scene_cloud_ply] + \
        sorted(os.path.join(art.colmap_sparse, f)
               for f in os.listdir(art.colmap_sparse))


def _same_artifacts(jcfg, tcfg):
    jfiles, tfiles = _artifact_files(jcfg), _artifact_files(tcfg)
    assert [os.path.basename(f) for f in jfiles] == \
        [os.path.basename(f) for f in tfiles]
    for jf, tf in zip(jfiles, tfiles):
        with open(jf, "rb") as a, open(tf, "rb") as b:
            assert a.read() == b.read(), tf
    ja_, ta = np.load(Artifacts(jcfg).camera_npz), \
        np.load(Artifacts(tcfg).camera_npz)
    assert sorted(ja_.files) == sorted(ta.files)
    for k in ja_.files:
        np.testing.assert_array_equal(ta[k], ja_[k], err_msg=k)


def test_export_matches_jax_file_for_file(tmp_path):
    """export_dust3r_scene on one scene (a frame 0 that is not the
    identity, a confidence threshold that empties one frame) in both
    packages: the same bytes."""
    rng = np.random.default_rng(6)
    c2ws, own = _synthetic_scene(2, 12, 16, 20.0, seed=6)
    scene = {"c2w": np.stack(c2ws) @ np.linalg.inv(c2ws[1]),
             "depth": np.stack([o[..., 2] for o in own]),
             "focal": np.asarray([20.0, 21.5]),
             "pts3d": np.stack(own)}
    images = rng.uniform(size=(2, 12, 16, 3)).astype(np.float32)
    confs = np.stack([rng.uniform(1, 6, (12, 16)),
                      np.full((12, 16), 1.5)]).astype(np.float32)
    names = ["in.png", "empty_room.png"]
    jcfg = jconfig.default_config(str(tmp_path / "j" / "output"))
    tcfg = default_config(str(tmp_path / "t" / "output"))
    jp.export_dust3r_scene(jcfg, scene, images, names, confs)
    tp.export_dust3r_scene(tcfg, scene, images, names, confs)
    _same_artifacts(jcfg, tcfg)


def test_run_from_model_matches_jax_in_f32(tmp_path, tiny, n_images=1):
    """run_from_model at the tiny model in f32 on one image (duplicated:
    the pair viewer), resized from 48 × 64 to 24²: camera.npz within 1e-4,
    the exported scene cloud within 1e-4 of max |ref|."""
    params, _ = tiny
    rng = np.random.default_rng(7)
    paths = []
    for k in range(n_images):
        p = str(tmp_path / f"im{k}.png")
        save_image(p, rng.integers(0, 255, (48, 64, 3)).astype(np.uint8))
        paths.append(p)
    over = dict(input_image=paths[0], Use_VGGT=False, image_size=24,
                dust3r_niter=5, min_conf_thr=1.0)
    jcfg = jconfig.default_config(str(tmp_path / "j" / "output"), **over)
    tcfg = default_config(str(tmp_path / "t" / "output"), **over)
    jm = jd.AsymmetricCroCo3DStereo(dataclasses.replace(
        jd.Dust3rConfig.tiny(), dtype=jnp.float32))
    jp.run_from_model(jcfg, params, jm, tuple(paths))
    tp.run_from_model(tcfg, _port(torch.float32, params), tuple(paths))
    ja_ = np.load(Artifacts(jcfg).camera_npz)
    ta = np.load(Artifacts(tcfg).camera_npz)
    for k in ja_.files:
        np.testing.assert_allclose(ta[k], ja_[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    from regen3d_tpu_torch.utils.ply import load_ply
    jpts = load_ply(Artifacts(jcfg).scene_cloud_ply).vertices
    tpts = load_ply(Artifacts(tcfg).scene_cloud_ply).vertices
    assert jpts.shape == tpts.shape
    np.testing.assert_allclose(tpts, jpts, atol=1e-4 * np.abs(jpts).max())


# --- 3D-FRONT cameras -------------------------------------------------------

@pytest.mark.parametrize("meta", [
    {"camera": {"pos": [1.0, 1.5, -3.0], "look_at": [0.2, 0.8, 1.0],
                "fov": 62.5}, "width": 640, "height": 480},
    {"pos": [0.0, 2.0, 0.5], "target": [0.3, 0.1, 4.0],
     "up": [0.05, 1.0, 0.0]},
])
def test_front3d_camera_matches_jax(tmp_path, meta):
    """use_3d_front: camera.npz from the JSON beside the input image
    (the nested and the top-level layout, defaults filled) in both packages
    within 1e-6; phase 5's run writes it before it reads it; without the
    flag nothing is written."""
    import json

    from regen3d_tpu.pipeline import front3d as jf
    from regen3d_tpu_torch.pipeline import front3d as tf

    img = tmp_path / "scene.png"
    save_image(str(img), np.zeros((8, 8, 3), np.uint8))
    (tmp_path / "scene.json").write_text(json.dumps(meta))
    over = dict(input_image=str(img), use_3d_front=True)
    jcfg = jconfig.default_config(str(tmp_path / "j" / "output"), **over)
    tcfg = default_config(str(tmp_path / "t" / "output"), **over)
    assert jf.maybe_extract(jcfg) and tf.maybe_extract(tcfg)
    want, got = (np.load(Artifacts(c).camera_npz) for c in (jcfg, tcfg))
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    off = default_config(str(tmp_path / "off" / "output"),
                         input_image=str(img))
    assert tf.maybe_extract(off) is None
    assert not os.path.exists(Artifacts(off).camera_npz)
    # phase 5 extracts first: with no findings it stops after the camera
    from regen3d_tpu_torch.pipeline import phase5_extract
    os.remove(Artifacts(tcfg).camera_npz)
    with pytest.raises(FileNotFoundError):
        phase5_extract.run(tcfg, device="cpu")
    assert os.path.exists(Artifacts(tcfg).camera_npz)
