"""Port phase-1 serving vs the JAX package on the 96×128 scene of
``tests/test_models_sam.py`` with the tiny SAM in f32 (rel-pos tables drawn
from a seed, weights carried by ``from_jax``):

* the image resize alone against ``jax.image.resize`` (downscale, upscale
  and one of each per axis), atol 1e-5;
* ``detect_and_segment`` with one decoder pass and with two: the same
  detections, one encode on each side, decoder logits within 1e-4 of their
  largest value, and the same masks except where JAX's resized logit is
  within 1e-3 of 0 (there the sign is rounding);
* a checkpoint directory the port cannot read yet is refused, not
  replaced.
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regen3d_tpu.config import default_config
from regen3d_tpu.models import sam as js
from regen3d_tpu.pipeline import phase1_segmentation as jp
from regen3d_tpu_torch.models.layers import resize_bilinear
from regen3d_tpu_torch.pipeline import phase1_segmentation as tp
from regen3d_tpu_torch.pipeline.detection import BoundingBox, DetectionResult
from test_torch_package import one_torch_thread  # noqa: F401
from test_torch_sam import jax_tiny_sam, port_sam


@pytest.mark.parametrize("src,dst", [((96, 128), (64, 64)),
                                     ((16, 16), (96, 128)),
                                     ((60, 80), (64, 64))],
                         ids=["down", "up", "mixed"])
def test_resize_matches_jax_image_resize(src, dst):
    x = np.random.default_rng(src[0]).random((*src, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (*dst, 3), "bilinear")
    got = resize_bilinear(torch.from_numpy(x)[None], dst)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


class _CountingJaxSam:
    """The JAX SAM, each method jitted, with its encodes counted and its
    last decode kept."""

    def __init__(self, sam):
        self.sam, self.cfg = sam, sam.cfg
        self.encodes, self.last_decode = 0, None
        self._jitted = {}

    def apply(self, params, *args, method=None):
        if method not in self._jitted:
            self._jitted[method] = jax.jit(functools.partial(
                self.sam.apply, method=method))
        out = self._jitted[method](params, *args)
        if method is js.SAM.encode:
            self.encodes += 1
        elif method is js.SAM.decode:
            self.last_decode = out
        return out


@pytest.fixture(scope="module")
def scene():
    jm, params = jax_tiny_sam()
    model = port_sam(params)
    counts = {"encodes": 0, "last_decode": None}
    encode, decode = model.encode, model.decode

    def counted_encode(img):
        counts["encodes"] += 1
        return encode(img)

    def kept_decode(*args):
        counts["last_decode"] = decode(*args)
        return counts["last_decode"]

    model.encode, model.decode = counted_encode, kept_decode
    image = np.full((96, 128, 3), 220, np.uint8)
    image[20:60, 10:50] = [200, 30, 30]
    image[30:80, 70:120] = [30, 30, 200]
    return _CountingJaxSam(jm), params, model, counts, image


def _resized_best_logits(masks, iou, n, hw):
    masks, iou = np.asarray(masks), np.asarray(iou)
    return np.stack([np.asarray(jax.image.resize(
        masks[i, int(np.argmax(iou[i]))], hw, "bilinear")) for i in range(n)])


@pytest.mark.parametrize("use_points", [False, True],
                         ids=["boxes", "boxes_then_points"])
def test_detect_and_segment_matches_jax(scene, use_points, tmp_path):
    jsam, params, model, counts, image = scene
    cfg = default_config(str(tmp_path), use_points=use_points,
                         labels=["object"])
    enc0, counts["encodes"] = jsam.encodes, 0
    want = jp.detect_and_segment(cfg, image, sam=jsam, sam_params=params)
    got = tp.detect_and_segment(cfg, image, sam=model)
    assert jsam.encodes - enc0 == 1 and counts["encodes"] == 1
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        assert (g.label, g.score) == (w.label, w.score)
        assert (g.box.xmin, g.box.ymin, g.box.xmax, g.box.ymax) == \
            (w.box.xmin, w.box.ymin, w.box.xmax, w.box.ymax)
    # the last decode is the one whose masks were kept
    jm_, jiou = (np.asarray(a) for a in jsam.last_decode)
    tm_, tiou = (a.numpy() for a in counts["last_decode"])
    assert np.abs(tm_ - jm_).max() <= 1e-4 * np.abs(jm_).max()
    assert np.abs(tiou - jiou).max() <= 1e-4 * np.abs(jiou).max()
    logits = _resized_best_logits(jm_, jiou, len(want), image.shape[:2])
    sure = np.abs(logits) > 1e-3
    for g, w, s in zip(got, want, sure):
        np.testing.assert_array_equal(g.mask[s], w.mask[s])


def test_refuses_what_is_not_ported(scene, tmp_path, monkeypatch):
    """``detector_checkpoint`` and, for ``point_method: saliency``,
    ``saliency_checkpoint`` naming the port's directories load the models
    not passed in (on ``device``): the detections and both passes' masks
    are those of the same models passed directly. An orbax directory with
    tensorstore hidden is refused before any work, naming it; missing
    paths fall back as in the JAX package (test_torch_phase1_run.py)."""
    from regen3d_tpu_torch.models import detector as tdet
    from regen3d_tpu_torch.models import saliency as tsal
    from regen3d_tpu_torch.pipeline.detector_distill import (
        load_detector_checkpoint,
        save_detector_checkpoint,
    )
    from regen3d_tpu_torch.pipeline.saliency_distill import (
        SaliencyModel,
        save_saliency_checkpoint,
    )

    _jsam, _params, model, _counts, image = scene
    gen = torch.Generator().manual_seed(3)
    det = tdet.OpenVocabDetector(tdet.DetectorConfig.tiny(), device="cpu")
    tdet.init_flax_style_(det, gen)
    with torch.no_grad():       # an objectness bias that passes boxes
        det.obj_head.bias.fill_(4.0)
    save_detector_checkpoint(str(tmp_path / "det"), det)
    net = tsal.SaliencyTransformer(tsal.SaliencyConfig.tiny(), device="cpu")
    tsal.init_flax_style_(net, gen)
    save_saliency_checkpoint(str(tmp_path / "sal"), net)
    base = dict(labels=["object", "thing"], use_points=True,
                point_method="saliency", points_per_object=2)
    cfg = default_config(str(tmp_path), detector_checkpoint=str(
        tmp_path / "det"), saliency_checkpoint=str(tmp_path / "sal"),
        **base)
    got = tp.detect_and_segment(cfg, image, sam=model, device="cpu")
    want = tp.detect_and_segment(
        default_config(str(tmp_path), **base), image, sam=model,
        detector=load_detector_checkpoint(str(tmp_path / "det"), "cpu"),
        saliency_model=SaliencyModel.load(str(tmp_path / "sal"), "cpu"),
        device="cpu")
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.label, g.score) == (w.label, w.score)
        np.testing.assert_array_equal(g.mask, w.mask)

    from regen3d_tpu.models import detector as jdet
    from regen3d_tpu.pipeline.detector_distill import (
        save_detector_checkpoint as jsave,
    )
    dc = jdet.DetectorConfig.tiny()
    shapes = jax.eval_shape(jdet.OpenVocabDetector(dc).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                            jnp.zeros((2, dc.text_len), jnp.int32))
    jsave(str(tmp_path / "orbax"), jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes), dc)
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="tensorstore"):
        tp.detect_and_segment(default_config(
            str(tmp_path), detector_checkpoint=str(tmp_path / "orbax")),
            image, device="cpu")


def test_without_sam_boxes_become_masks(tmp_path):
    class Detector:
        def detect(self, image, labels, thr):
            return [DetectionResult(0.9, "a", BoundingBox(1.5, 2.0, 5.2, 6.0)),
                    DetectionResult(0.8, "b", BoundingBox(1.0, 2.0, 5.0, 6.0)),
                    DetectionResult(0.7, "c", BoundingBox(3.0, 3.0, 3.0, 7.0))]

    cfg = default_config(str(tmp_path))
    dets = tp.detect_and_segment(cfg, np.zeros((8, 8, 3), np.uint8),
                                 detector=Detector())
    # "b" overlaps "a" past the NMS threshold; "c" has an empty box
    assert [d.label for d in dets] == ["a"]
    assert dets[0].mask[2:6, 1:6].all() and dets[0].mask.sum() == 20
