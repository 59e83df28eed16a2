"""Port phase 1 end to end against the JAX package, on the CPU:

* ``ops.kmeans`` against scikit-learn's ``KMeans(n_clusters=6, n_init=4,
  random_state=seed)`` (one OpenMP thread, where scikit-learn's float32
  sums have one order) on the verify skill's synthetic room and on two
  noisy 960×1280 rooms from a seed: every k-means++ seed row the same,
  the same run chosen, the same centres and every pixel's label the same
  (the criterion is 99.9%); with the seeding's distances one float32 step
  off, 99.9% of the labels stay; ``cluster_proposals`` gives the JAX
  package's finding stems;
* the tiny detector, saliency net and Depth-Anything in f32 with weights
  carried by ``from_jax``: scores, boxes, maps and depth within 1e-5 of
  the largest value (f32 sums in another order), ``detect`` the same
  detections; Depth-Anything in bf16 against the JAX package's bf16 by
  the mean error, on the fixture's PRNGKey(0) weights and on drawn ones,
  no further than the port's f32 lies (ROADMAP Queue 3 af, am);
* ``export_findings``, and ``-p 1`` through both CLIs on one PNG (the port
  with ``--device cpu``): the same files, pixel for pixel, ``depth.png``
  too; ``run`` with tiny SAM, detector, saliency net and Depth-Anything:
  the same stems, masks equal but for pixels where SAM's logit is within
  rounding of 0 (at most 0.5% of a finding), depth.png within one level;
* the refusals and fallbacks.

``cv2`` is hidden from the JAX package, whose outline dilation and
distance transform take their numpy/scipy branches then, as the port does.
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
from threadpoolctl import threadpool_limits

from regen3d_tpu import orchestrator as jorch
from regen3d_tpu.config import default_config as jdefault_config
from regen3d_tpu.models import depth_anything as jda
from regen3d_tpu.models import detector as jdet
from regen3d_tpu.models import saliency as jsal
from regen3d_tpu.pipeline import depth_distill as jdepth_distill
from regen3d_tpu.pipeline import phase1_segmentation as jp
from regen3d_tpu.pipeline import saliency_distill as jsd
from regen3d_tpu_torch.artifacts import finding_stem
from regen3d_tpu_torch.config import default_config
from regen3d_tpu_torch.models import depth_anything as tda
from regen3d_tpu_torch.models import detector as tdet
from regen3d_tpu_torch.models import saliency as tsal
from regen3d_tpu_torch.models.from_jax import (
    DEPTH_ANYTHING_CONV_TRANSPOSE,
    SALIENCY_CONV_TRANSPOSE,
    load_from_jax,
)
from regen3d_tpu_torch.ops import kmeans
from regen3d_tpu_torch.pipeline import depth as tdepth
from regen3d_tpu_torch.pipeline import phase1_segmentation as tp
from regen3d_tpu_torch.pipeline.detection import BoundingBox, DetectionResult
from regen3d_tpu_torch.pipeline.saliency_distill import SaliencyModel
from regen3d_tpu_torch.utils import image as timage
from test_torch_package import one_torch_thread  # noqa: F401
from test_torch_phase1 import _CountingJaxSam
from test_torch_sam import jax_tiny_sam, port_sam

ROOT = Path(__file__).resolve().parent.parent
SEED = 1234567                       # default_config's seed
LABELS = ["chair", "table", "lamp"]


def _no_cv2():
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "cv2", None)    # import cv2 → ImportError
    return mp


def _skill_room():
    """The verify skill's synthetic room: wall, floor band, two boxes."""
    img = np.empty((192, 256, 3), np.uint8)
    img[:] = (200, 196, 188)
    img[120:] = (110, 90, 70)
    img[70:140, 30:100] = (180, 40, 40)
    img[90:150, 150:230] = (40, 60, 170)
    return img


def _noisy_room(seed, h=960, w=1280):
    """A 960×1280 room of 8 boxes with uniform noise, from a seed."""
    rng = np.random.default_rng(seed)
    img = np.empty((h, w, 3), np.uint8)
    img[:] = (205, 200, 190)
    img[int(0.62 * h):] = (120, 95, 70)
    for i in range(8):
        x0, y0 = 40 + 155 * i, int(0.35 * h) + 40 * (i % 3)
        img[y0:y0 + 160 + 30 * (i % 2), x0:x0 + 110] = rng.integers(20, 235, 3)
    noise = rng.integers(-25, 26, img.shape)
    return np.clip(img.astype(np.int16) + noise, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("which", ["skill_room", "noisy_a", "noisy_b"])
def test_kmeans_is_scikit_learns(which):
    from sklearn.cluster import KMeans
    from sklearn.cluster._kmeans import _kmeans_plusplus

    image = {"skill_room": _skill_room, "noisy_a": lambda: _noisy_room(1),
             "noisy_b": lambda: _noisy_room(2)}[which]()
    feats, sub = tp.proposal_features(image)
    k = max(6, len(jdefault_config("output")["labels"]))
    with threadpool_limits(1):
        km = KMeans(n_clusters=k, n_init=4, random_state=SEED).fit(sub)
        want = km.predict(feats)
        # scikit-learn's four seeds, then its run from each
        x = sub - sub.mean(axis=0)
        rs = np.random.RandomState(SEED)
        seeds = [_kmeans_plusplus(x, k, np.einsum("ij,ij->i", x, x),
                                  np.ones(len(x), np.float32), rs)[1]
                 for _ in range(4)]
        runs = [KMeans(n_clusters=k, init=sub[s], n_init=1).fit(sub)
                for s in seeds]
    chosen = [i for i, r in enumerate(runs)
              if np.array_equal(r.cluster_centers_, km.cluster_centers_)]
    fit = kmeans.kmeans_fit(sub, k, SEED)
    assert all(np.array_equal(a, b) for a, b in zip(fit.init_indices, seeds))
    assert fit.best_init == chosen[0]
    np.testing.assert_array_equal(fit.centers, km.cluster_centers_)
    np.testing.assert_array_equal(fit.labels, km.labels_)
    got = kmeans.kmeans_predict(torch.from_numpy(feats), fit.centers).numpy()
    assert (got == want).mean() >= 0.999
    np.testing.assert_array_equal(got, want)
    # the proposer's findings, named as phase 1 names them
    with threadpool_limits(1):
        jdets = jp.cluster_proposals(image, num_regions=k, seed=SEED)
    tdets = tp.cluster_proposals(image, num_regions=k, seed=SEED,
                                 device="cpu")
    assert [finding_stem(d.label, d.mask_centroid) for d in tdets] == \
        [finding_stem(d.label, d.mask_centroid) for d in jdets]
    for a, b in zip(tdets, jdets):
        np.testing.assert_array_equal(a.mask, b.mask)
        assert a.score == b.score


def test_kmeans_seed_near_tie_moves_the_partition_little(monkeypatch):
    """Where a k-means++ draw lies within rounding of a step of the
    cumulative potential, another BLAS's last bit can pick the next sample
    (ROADMAP Queue 3 ak). On the flat synthetic room, every non-zero
    squared distance of the seeding one float32 step lower moves the
    first run's fifth seed from row 18968 to its neighbour 18969, and with
    it the sixth: the same run is chosen and 99.84% of the pixels keep
    their label (0.5% is the bound here); one step higher changes
    nothing."""
    feats, sub = tp.proposal_features(_skill_room())
    base = kmeans.kmeans_fit(sub, 6, SEED)
    labels = kmeans.kmeans_predict(torch.from_numpy(feats), base.centers)
    orig = kmeans._sq_distances
    for toward, moved_seeds in ((np.inf, 0), (-np.inf, 2)):
        monkeypatch.setattr(kmeans, "_sq_distances", lambda a, b: (
            lambda d: np.where(d > 0, np.nextafter(d, np.float32(toward)),
                               d))(orig(a, b)))
        fit = kmeans.kmeans_fit(sub, 6, SEED)
        monkeypatch.undo()
        moved = sum(int((a != b).sum()) for a, b in zip(base.init_indices,
                                                        fit.init_indices))
        assert moved == moved_seeds and fit.best_init == base.best_init
        agree = float((kmeans.kmeans_predict(torch.from_numpy(feats),
                                             fit.centers) == labels)
                      .double().mean())
        assert agree >= 0.995 and (agree == 1.0) == (moved == 0), agree


# --- the tiny models in f32 --------------------------------------------------

def _draw(shapes, seed):
    """Params for a tree of shapes from a numpy seed (no compile): kernels
    N(0, 1/fan_in), LayerNorm scales 1 + N(0, 0.1²), every other leaf
    N(0, 0.5²)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        x = rng.normal(size=leaf.shape)
        if name == "kernel":
            x = x / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "scale":
            x = 1.0 + 0.1 * x
        else:
            x = 0.5 * x
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def models():
    """JAX and port tiny detector, saliency net and Depth-Anything in f32
    with shared drawn weights (the JAX apply functions jitted once)."""
    jdc = dataclasses.replace(jdet.DetectorConfig.tiny(), dtype=jnp.float32)
    jdm = jdet.OpenVocabDetector(jdc)
    p_det = _draw(jax.eval_shape(
        jdm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        jnp.zeros((2, jdc.text_len), jnp.int32)), 1)
    # flax's logit scale and an objectness bias of 2, so that boxes pass
    # the default threshold 0.25
    p_det["params"]["logit_scale"] = np.float32(2.0)
    p_det["params"]["obj_head"]["bias"] = np.full(1, 2.0, np.float32)
    tdm = tdet.OpenVocabDetector(dataclasses.replace(
        tdet.DetectorConfig.tiny(), dtype=torch.float32), device="cpu")
    load_from_jax(tdm, p_det)

    jsc = dataclasses.replace(jsal.SaliencyConfig.tiny(), dtype=jnp.float32)
    p_sal = _draw(jax.eval_shape(jsal.SaliencyTransformer(jsc).init,
                                 jax.random.PRNGKey(0),
                                 jnp.zeros((1, 64, 64, 3))), 2)
    jsm = jsd.SaliencyModel(p_sal, jsc)
    tsm = tsal.SaliencyTransformer(dataclasses.replace(
        tsal.SaliencyConfig.tiny(), dtype=torch.float32), device="cpu")
    load_from_jax(tsm, p_sal, SALIENCY_CONV_TRANSPOSE)

    jac = dataclasses.replace(jda.DepthAnythingConfig.tiny(),
                              dtype=jnp.float32)
    jam = jda.DepthAnything(jac)
    p_da = _draw(jax.eval_shape(jam.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 56, 56, 3))), 3)
    tam = tda.DepthAnything(dataclasses.replace(
        tda.DepthAnythingConfig.tiny(), dtype=torch.float32), device="cpu")
    load_from_jax(tam, p_da, DEPTH_ANYTHING_CONV_TRANSPOSE)
    return dict(det=(jdm, p_det, tdm), sal=(jsm, SaliencyModel(tsm)),
                da=(jam, p_da, tam))


def _scene():
    image = np.full((96, 128, 3), 220, np.uint8)
    image[20:60, 10:50] = [200, 30, 30]
    image[30:80, 70:120] = [30, 30, 200]
    image[5:15, 60:120] = [40, 160, 60]
    return image


def test_detector_matches_jax(models):
    jdm, params, tdm = models["det"]
    image = _scene()
    want = jdm.detect(params, image, LABELS, 0.25)
    got = tdm.detect(image, LABELS, 0.25)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.label == w.label and abs(g.score - w.score) <= 1e-6
        np.testing.assert_allclose(
            [g.box.xmin, g.box.ymin, g.box.xmax, g.box.ymax],
            [w.box.xmin, w.box.ymin, w.box.xmax, w.box.ymax], atol=1e-3)
    # the raw heads, every patch and label
    c = tdm.cfg
    x = np.random.default_rng(4).random((1, 64, 64, 3)).astype(np.float32)
    tok = jdet.tokenize_bytes(LABELS, c.text_len)
    np.testing.assert_array_equal(tok, tdet.tokenize_bytes(LABELS, c.text_len))
    sj, bj = jdet._jitted_detector_apply(jdm)(params, jnp.asarray(x),
                                              jnp.asarray(tok))
    with torch.no_grad():
        st, bt = tdm(torch.from_numpy(x), torch.from_numpy(tok).long())
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=1e-5)


def test_saliency_matches_jax(models):
    jsm, tsm = models["sal"]
    image = _scene()
    want, got = jsm.saliency(image), tsm.saliency(image)
    assert got.shape == want.shape == image.shape[:2]
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    # the points it gives phase 1's second SAM pass
    from regen3d_tpu.pipeline.detection import points_saliency as jps
    from regen3d_tpu_torch.pipeline.detection import points_saliency as tps
    mask = np.zeros(image.shape[:2], bool)
    mask[20:60, 10:50] = True
    np.testing.assert_array_equal(tps(image, mask, 2, tsm),
                                  jps(image, mask, 2, jsm))


def test_depth_anything_matches_jax(models, tmp_path):
    jam, params, tam = models["da"]
    x = np.random.default_rng(5).random((1, 56, 56, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jam.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tam(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    # estimate_depth: the resize in, the normalisation, the resize out
    from regen3d_tpu.pipeline.depth import estimate_depth as jest
    image = _scene()
    np.testing.assert_allclose(tdepth.estimate_depth(image, tam),
                               jest(image, jam, params), atol=1e-5)


def _depth_anything_bf16_errors(params, x):
    """Mean |port − JAX's jitted bf16 apply| over max |JAX| for the port in
    bf16 and, as the control, in f32."""
    jam = jda.DepthAnything(jda.DepthAnythingConfig.tiny())
    want = np.asarray(jax.jit(jam.apply)(params, jnp.asarray(x)),
                      np.float32)
    err, ys = {}, {}
    for dt in (torch.bfloat16, torch.float32):
        tam = tda.DepthAnything(dataclasses.replace(
            tda.DepthAnythingConfig.tiny(), dtype=dt), device="cpu")
        load_from_jax(tam, params, DEPTH_ANYTHING_CONV_TRANSPOSE)
        with torch.no_grad():
            ys[dt] = tam(torch.from_numpy(x)).float().numpy()
        assert ys[dt].shape == want.shape and np.isfinite(ys[dt]).all()
        err[dt] = float(np.abs(ys[dt] - want).mean() / np.abs(want).max())
    return err, ys


def test_depth_anything_fixture():
    """The port in bf16 against the JAX package's jitted bf16 apply on the
    fixture's weights (the tiny model at PRNGKey(0)) and input, by the
    mean error over max |ref|: no further than the port in f32 lies from
    the same reference (measured 0.208% against the control's 0.259%),
    so the bf16 path rounds no worse than exact f32 arithmetic would.

    The committed fixture itself (that bf16 apply run eagerly; XLA rounds
    bf16 where its fusions end) is printed, not held: the JAX package's
    jitted bf16 misses it by 0.0226 (max |y| 1.44), its f32 by 0.0266,
    the port's bf16 by 0.0261, all above its atol 2e-4 (ROADMAP Queue 3
    am)."""
    d = np.load(ROOT / "tests" / "fixtures" / "activations"
                / "depth_anything.npz")
    params = jax.device_get(jax.jit(jda.DepthAnything(
        jda.DepthAnythingConfig.tiny()).init)(jax.random.PRNGKey(0),
                                              jnp.asarray(d["input_x"])))
    err, ys = _depth_anything_bf16_errors(params, d["input_x"])
    print("bf16 mean error / max|ref|:", err, "; max |port bf16 − fixture|:",
          float(np.abs(ys[torch.bfloat16] - d["expected_y"]).max()))
    assert err[torch.bfloat16] <= err[torch.float32], err


def test_depth_anything_bf16_mean_error(models):
    """As ``test_depth_anything_fixture`` on the drawn weights, whose
    LayerScale is not 1e-5, so the trunk's blocks count (measured 0.310%
    against the control's 0.438%)."""
    p_da = models["da"][1]
    x = np.random.default_rng(5).random((1, 56, 56, 3)).astype(np.float32)
    err, _ = _depth_anything_bf16_errors(p_da, x)
    assert err[torch.bfloat16] <= err[torch.float32], err


# --- export, run and the CLI ------------------------------------------------

def _pngs(root):
    return {p.relative_to(root): p for p in Path(root).rglob("*.png")
            if "output" in p.parts}


def _same_files(jroot, troot):
    jf, tf = _pngs(jroot), _pngs(troot)
    assert sorted(jf) == sorted(tf) and jf
    for rel in tf:
        np.testing.assert_array_equal(_read(tf[rel]),
                                      np.asarray(Image.open(jf[rel])),
                                      err_msg=str(rel))


def _read(path):
    """A PNG as PIL gives it: (H, W) for grey, (H, W, C) otherwise."""
    img = timage.read_png(str(path))[0]
    return img[..., 0] if img.shape[-1] == 1 else img


def test_export_findings_matches_jax(tmp_path):
    image = _skill_room()
    dets = []
    for i, (y0, y1, x0, x1) in enumerate([(70, 140, 30, 100),
                                          (90, 150, 150, 230),
                                          (0, 4, 250, 256)]):
        m = np.zeros(image.shape[:2], bool)
        m[y0:y1, x0:x1] = True
        m[y0 + 5, x0] = False
        dets.append(DetectionResult(0.9 - i / 10, LABELS[i],
                                    BoundingBox(x0, y0, x1, y1), mask=m))
    over = dict(banana_line_thickness=4, findings_padding=7)
    mp = _no_cv2()
    try:
        want = jp.export_findings(jdefault_config(str(tmp_path / "j" / "output"),
                                                  **over), image, dets)
    finally:
        mp.undo()
    got = tp.export_findings(default_config(str(tmp_path / "t" / "output"),
                                            **over), image, dets)
    assert got == want and len(got) == 3
    _same_files(tmp_path / "j", tmp_path / "t")
    lay = timage.segmentation_layout(image, dets[0].mask)
    np.testing.assert_array_equal(
        timage.extract_layout_panel(lay, image.shape[:2]),
        np.full_like(image, 255))


def _write_cfg(root, **over):
    (root / "src").mkdir(parents=True)
    values = dict(over, output="../output", input_image="../input.png")
    (root / "src" / "cfg.yaml").write_text(yaml.safe_dump(values))
    return str(root / "src" / "cfg.yaml")


def test_cli_runs_phase_1(tmp_path):
    """``-p 1`` through the JAX CLI and ``python -m regen3d_tpu_torch
    --device cpu`` on one PNG: the k-means proposer, the findings and the
    depth prior, the same files pixel for pixel."""
    cfgs = {}
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
        Image.fromarray(_skill_room()).save(tmp_path / name / "input.png")
        cfgs[name] = _write_cfg(tmp_path / name)
    mp = _no_cv2()
    try:
        with threadpool_limits(1):
            jorch.main(["-p", "1", "--config", cfgs["jax"]])
    finally:
        mp.undo()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-m", "regen3d_tpu_torch", "-p", "1", "--config",
         cfgs["port"], "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    _same_files(tmp_path / "jax", tmp_path / "port")
    found = list((tmp_path / "port" / "output" / "findings" / "fullSize")
                 .glob("*.png"))
    assert len(found) >= 4
    assert (tmp_path / "port" / "output" / "findings" / "depth.png").exists()


def test_run_with_models_matches_jax(models, tmp_path, monkeypatch):
    """``run`` with the tiny SAM, detector, saliency net (``point_method:
    saliency``, two passes) and Depth-Anything. The JAX package takes the
    last two only from checkpoints: its loaders are patched to return the
    same models."""
    jdm, p_det, tdm = models["det"]
    jsm, tsm = models["sal"]
    jam, p_da, tam = models["da"]
    jsam, p_sam = jax_tiny_sam()
    tsam = port_sam(p_sam)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    monkeypatch.setattr(jsd.SaliencyModel, "load",
                        classmethod(lambda cls, path: jsm))
    monkeypatch.setattr(jdepth_distill, "load_depth_checkpoint",
                        lambda path: (p_da, jam))
    over = dict(labels=LABELS, use_points=True, point_method="saliency",
                points_per_object=1, saliency_checkpoint=str(ckpt),
                depth_anything_checkpoint=str(ckpt))
    roots = {}
    for name in ("jax", "port"):
        roots[name] = tmp_path / name
        roots[name].mkdir()
        Image.fromarray(_scene()).save(roots[name] / "input.png")
    jcfg = jdefault_config(str(roots["jax"] / "output"),
                           input_image=str(roots["jax"] / "input.png"), **over)
    tcfg = default_config(str(roots["port"] / "output"),
                          input_image=str(roots["port"] / "input.png"), **over)
    mp = _no_cv2()
    try:
        want = jp.run(jcfg, sam=_CountingJaxSam(jsam), sam_params=p_sam,
                      detector=jdm, detector_params=p_det)
    finally:
        mp.undo()
    got = tp.run(tcfg, sam=tsam, detector=tdm, saliency_model=tsm,
                 depth_model=tam, device="cpu")
    assert got == want and len(got) >= 2
    jf, tf = _pngs(roots["jax"]), _pngs(roots["port"])
    assert sorted(jf) == sorted(tf)
    for rel in tf:
        a = _read(tf[rel]).astype(int)
        b = np.asarray(Image.open(jf[rel])).astype(int)
        assert a.shape == b.shape, rel
        if rel.name == "depth.png":
            assert np.abs(a - b).max() <= 1, rel
        else:
            assert (a != b).any(-1).mean() <= 5e-3, rel


def _jax_orbax_dirs(models, root):
    """The ``models`` fixture's drawn detector, saliency net and
    Depth-Anything written by the JAX package's writers (orbax, with their
    config sidecars): key → directory."""
    from regen3d_tpu.pipeline import detector_distill as jdetd

    _jdm, p_det, _ = models["det"]
    jsm, _ = models["sal"]
    _jam, p_da, _ = models["da"]
    dirs = {k: str(root / k) for k in ("detector_checkpoint",
                                       "saliency_checkpoint",
                                       "depth_anything_checkpoint")}
    jdetd.save_detector_checkpoint(dirs["detector_checkpoint"], p_det,
                                   jdet.DetectorConfig.tiny())
    jsd.save_saliency_checkpoint(dirs["saliency_checkpoint"], jsm.params,
                                 jsal.SaliencyConfig.tiny())
    jdepth_distill.save_depth_checkpoint(dirs["depth_anything_checkpoint"],
                                         p_da, jda.DepthAnythingConfig.tiny())
    return dirs


def test_cli_loads_the_checkpoint_keys(models, tmp_path):
    """``-p 1`` through the JAX CLI and ``python -m regen3d_tpu_torch
    --device cpu`` with ``detector_checkpoint``, ``saliency_checkpoint``
    (``point_method: saliency``) and ``depth_anything_checkpoint`` naming
    the orbax directories the JAX package wrote: the detector (f32 from its
    sidecar in both) finds the same boxes, so every finding's PNGs are the
    same pixel for pixel; depth.png, from the two packages' bf16
    Depth-Anything, within a mean of 0.7% of the range and 10 levels
    (ROADMAP Queue 3 af). The port's own directories of the same models
    give the port's files bit for bit."""
    dirs = _jax_orbax_dirs(models, tmp_path)
    over = dict(dirs, labels=LABELS, threshold=0.25, use_points=True,
                point_method="saliency")
    cfgs = {}
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
        Image.fromarray(_scene()).save(tmp_path / name / "input.png")
        cfgs[name] = _write_cfg(tmp_path / name, **over)
    mp = _no_cv2()
    try:
        jorch.main(["-p", "1", "--config", cfgs["jax"]])
    finally:
        mp.undo()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-m", "regen3d_tpu_torch", "-p", "1", "--config",
         cfgs["port"], "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "detector checkpoint" in out.stderr and \
        "Depth-Anything checkpoint" in out.stderr
    jf, tf = _pngs(tmp_path / "jax"), _pngs(tmp_path / "port")
    assert sorted(jf) == sorted(tf) and len(tf) >= 6
    for rel in tf:
        a = _read(tf[rel]).astype(int)
        b = np.asarray(Image.open(jf[rel])).astype(int)
        assert a.shape == b.shape, rel
        if rel.name == "depth.png":
            diff = np.abs(a - b)
            assert diff.mean() <= 0.007 * 255 and diff.max() <= 10, rel
        else:
            np.testing.assert_array_equal(a, b, err_msg=str(rel))

    # the port's own directories of the same models
    from regen3d_tpu_torch.pipeline import depth_distill as tdd
    from regen3d_tpu_torch.pipeline import detector_distill as tdetd
    own = {"detector_checkpoint": str(tmp_path / "own_det"),
           "saliency_checkpoint": str(tmp_path / "own_sal"),
           "depth_anything_checkpoint": str(tmp_path / "own_da")}
    tdetd.save_detector_checkpoint(own["detector_checkpoint"],
                                   tdetd.load_detector_checkpoint(
                                       dirs["detector_checkpoint"], "cpu"))
    from regen3d_tpu_torch.pipeline.saliency_distill import (
        save_saliency_checkpoint,
    )
    save_saliency_checkpoint(own["saliency_checkpoint"], SaliencyModel.load(
        dirs["saliency_checkpoint"], "cpu").model)
    tdd.save_depth_checkpoint(own["depth_anything_checkpoint"],
                              tdd.load_depth_checkpoint(
                                  dirs["depth_anything_checkpoint"], "cpu"))
    (tmp_path / "own").mkdir()
    Image.fromarray(_scene()).save(tmp_path / "own" / "input.png")
    stems = tp.run(default_config(str(tmp_path / "own" / "output"),
                                  input_image=str(tmp_path / "own"
                                                  / "input.png"),
                                  **dict(over, **own)), device="cpu")
    of = _pngs(tmp_path / "own")
    assert sorted(of) == sorted(tf) and len(tf) == 5 * len(stems) + 1
    for rel in of:
        np.testing.assert_array_equal(_read(of[rel]), _read(tf[rel]))


# --- refusals and fallbacks ---------------------------------------------------

@pytest.mark.parametrize("over,exc,match", [
    ({"interactive_edit": True}, NotImplementedError, "Queue 1 item 5"),
    ({"use_banana": False}, NotImplementedError, "Queue 1 item 5"),
    ({"depth_anything_checkpoint": "depth_anything_checkpoint"},
     ImportError, "tensorstore"),
    ({"detector_checkpoint": "detector_checkpoint"}, ImportError,
     "tensorstore")],
    ids=["editor", "upscaler", "depth_checkpoint", "detector_checkpoint"])
def test_run_refuses_what_is_not_ported(models, tmp_path, monkeypatch, over,
                                        exc, match):
    """Item 5's switches are refused before any work; an orbax checkpoint
    directory (written by the JAX package) where tensorstore is absent is
    refused naming it: the detector's before any work, Depth-Anything's
    where the JAX package loads it, after the findings."""
    Image.fromarray(_skill_room()).save(tmp_path / "input.png")
    if exc is ImportError:
        dirs = _jax_orbax_dirs(models, tmp_path / "ckpt")
        over = {k: dirs[v] for k, v in over.items()}
        monkeypatch.setitem(sys.modules, "tensorstore", None)
    cfg = default_config(str(tmp_path / "output"),
                         input_image=str(tmp_path / "input.png"), **over)
    with pytest.raises(exc, match=match):
        tp.run(cfg, device="cpu")
    findings = (tmp_path / "output" / "findings" / "fullSize")
    if "depth_anything_checkpoint" in over:
        assert len(list(findings.glob("*.png"))) >= 4
    else:   # refused before any work: nothing on the output bus
        assert not (tmp_path / "output" / "findings").exists()


def test_missing_checkpoints_fall_back(tmp_path):
    """Missing detector, saliency and depth checkpoints, and ``saliency``
    points without a model: clustering, max_distance and the depth prior,
    as in the JAX package."""
    Image.fromarray(_skill_room()).save(tmp_path / "input.png")
    gone = str(tmp_path / "missing")
    cfg = default_config(str(tmp_path / "output"),
                         input_image=str(tmp_path / "input.png"),
                         detector_checkpoint=gone, saliency_checkpoint=gone,
                         depth_anything_checkpoint=gone, use_points=True,
                         point_method="saliency")
    stems = tp.run(cfg, device="cpu")
    assert len(stems) >= 4
    prior = tdepth.estimate_depth(_skill_room())
    np.testing.assert_array_equal(
        _read(tmp_path / "output" / "findings" / "depth.png"),
        (prior * 255).astype(np.uint8))
