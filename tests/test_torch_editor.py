"""The port's mask editor (``regen3d_tpu_torch/pipeline/{interactive,
editor_ui}.py``) against the JAX package's on the CPU.

* ``EditSession``'s verbs (± points, a mask from a box, merge, delete,
  overlap resolution, finish) without SAM: every mask equal to JAX's bit
  for bit after every verb, and the same detections; with the tiny SAM in
  f32 (shared drawn weights, one encode per session in both): masks equal
  but for pixels whose upsampled logit lies within rounding of 0.
* The HTTP editor driven by a stdlib client against both servers: the same
  replies to every verb (an unknown one 400, a failing one 500 with the
  error), the same page, ``/image.png`` and ``/state`` overlays decoded to
  the same pixels (the PNG bytes differ: the port's deflate is not
  Pillow's), and ``launch_editor`` returns the same detections.
"""

import base64
import io
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from regen3d_tpu.pipeline import detection as jdet
from regen3d_tpu.pipeline import editor_ui as jeu
from regen3d_tpu.pipeline import interactive as jint
from regen3d_tpu_torch.pipeline import detection as tdet
from regen3d_tpu_torch.pipeline import editor_ui as teu
from regen3d_tpu_torch.pipeline import interactive as tint
from test_torch_package import one_torch_thread  # noqa: F401
from test_torch_phase1 import _CountingJaxSam
from test_torch_sam import jax_tiny_sam, port_sam

# one editing session's verbs, as the page sends them
VERBS = [
    {"op": "add_point", "idx": 0, "x": 32, "y": 20, "positive": True},
    {"op": "new_from_box", "label": "table", "x0": 40.5, "y0": 30,
     "x1": 60, "y1": 45.7},
    {"op": "add_point", "idx": 2, "x": 50, "y": 40, "positive": False},
    {"op": "relabel", "idx": 2, "label": "desk"},
    {"op": "add_point", "idx": 1, "x": 6, "y": 40, "positive": True},
    {"op": "merge", "i": 0, "j": 1},
    {"op": "resolve_overlaps"},
    {"op": "new_from_box", "label": "rug", "x0": 2, "y0": 2, "x1": 9,
     "y1": 7},
    {"op": "delete", "idx": 2},
]


def _image():
    img = np.random.default_rng(0).integers(0, 256, (48, 64, 3), np.uint8)
    img[10:30, 10:30] = (200, 40, 40)
    return img


def _initial(pkg):
    box, det = (jdet.BoundingBox, jdet.DetectionResult) if pkg == "jax" \
        else (tdet.BoundingBox, tdet.DetectionResult)
    a = np.zeros((48, 64), bool)
    a[10:30, 10:30] = True
    b = np.zeros((48, 64), bool)
    b[25:47, 0:20] = True
    return [det(0.9, "chair", box(10, 10, 29, 29), a),
            det(0.7, "lamp", box(0, 25, 19, 46), b)]


def _apply(session, verb):
    """One verb on a session, as the HTTP handler applies it."""
    v = dict(verb)
    op = v.pop("op")
    if op == "relabel":
        session.masks[v["idx"]].label = v["label"]
    elif op == "add_point":
        session.add_point(v["idx"], v["x"], v["y"], v["positive"])
    elif op == "new_from_box":
        session.new_from_box(v.pop("label"), **v)
    elif op == "merge":
        session.merge(v["i"], v["j"])
    elif op == "delete":
        session.delete(v["idx"])
    else:
        session.resolve_overlaps()


def _same_detections(got, want):
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert (g.label, g.score) == (w.label, w.score)
        assert (g.box.xmin, g.box.ymin, g.box.xmax, g.box.ymax) == \
            (w.box.xmin, w.box.ymin, w.box.xmax, w.box.ymax)
        np.testing.assert_array_equal(g.mask, w.mask)


def test_weightless_session_is_jaxs_bit_for_bit():
    j = jint.EditSession(_image(), initial=_initial("jax"))
    t = tint.EditSession(_image(), initial=_initial("port"))
    for verb in VERBS:
        _apply(j, verb)
        _apply(t, verb)
        assert [m.label for m in t.masks] == [m.label for m in j.masks]
        for a, b in zip(t.masks, j.masks):
            np.testing.assert_array_equal(a.mask, b.mask, err_msg=str(verb))
            assert a.points == b.points
    _same_detections(t.finish(), j.finish())


def test_session_with_the_tiny_sam():
    """The same verbs through the tiny SAM in f32: one encode per session;
    masks equal but where the port's upsampled logit is within 1e-4 of
    its largest |logit| of 0 (and at most 0.5% of the image)."""
    jsam, params = jax_tiny_sam()
    counting = _CountingJaxSam(jsam)
    tsam = port_sam(params)
    encodes, logits = [], []
    encode = tsam.encode
    tsam.encode = lambda img: encodes.append(1) or encode(img)
    resize = tint.resize_bilinear

    def recorded(x, hw):
        out = resize(x, hw)
        logits.append(out[0, ..., 0])
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(tint, "resize_bilinear", recorded)
    try:
        j = jint.EditSession(_image(), sam=counting, sam_params=params,
                             initial=_initial("jax"))
        t = tint.EditSession(_image(), sam=tsam, initial=_initial("port"))
        for verb in VERBS:
            _apply(j, verb)
            _apply(t, verb)
            if verb["op"] not in ("add_point", "new_from_box"):
                continue
            # the mask this verb decoded, against its logits
            i = verb.get("idx", len(t.masks) - 1)
            off = t.masks[i].mask != j.masks[i].mask
            lg = logits[-1]
            assert off.mean() <= 5e-3, verb
            if off.any():
                assert float(lg[torch.from_numpy(off)].abs().max()) \
                    <= 1e-4 * float(lg.abs().max()), verb
    finally:
        mp.undo()
    assert counting.encodes == 1 and len(encodes) == 1
    # the encode's input, then three points and two boxes decoded
    assert len(logits) == 6
    assert len(t.finish()) == len(j.finish())


# --- the HTTP editor -------------------------------------------------------

def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def request(port, path, body=None):
    """(status, body bytes) of a GET, or of a POST of ``body`` as JSON; an
    HTTP error's status and body likewise."""
    url = f"http://127.0.0.1:{port}{path}"
    data = None if body is None else json.dumps(body).encode()
    rq = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(rq, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def wait_for(port, seconds=60.0):
    """Poll until a server answers on ``port``."""
    t_end = time.monotonic() + seconds
    while True:
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1):
                return
        except OSError:
            if time.monotonic() > t_end:
                raise
            time.sleep(0.05)


def drive(port, verbs):
    """Send each verb and then finish; returns the (status, JSON reply) of
    each and the /state after the verbs."""
    wait_for(port)
    replies = [request(port, "/op", v) for v in verbs]
    state = json.loads(request(port, "/state")[1])
    replies.append(request(port, "/op", {"op": "finish"}))
    return [(s, json.loads(b)) for s, b in replies], state


def _serve(launch, session, port):
    out = {}
    t = threading.Thread(target=lambda: out.update(
        result=launch(session, port=port)), daemon=True)
    t.start()
    return t, out


def _overlays(state):
    return [np.asarray(Image.open(io.BytesIO(base64.b64decode(m["overlay"]))))
            for m in state["masks"]]


def test_http_editor_matches_jaxs():
    verbs = VERBS + [{"op": "nope"}, {"op": "delete", "idx": 9}]
    ports, runs = {}, {}
    for pkg, launch, mod in (("jax", jeu.launch_editor, jint),
                             ("port", teu.launch_editor, tint)):
        ports[pkg] = free_port()
        session = mod.EditSession(_image(), initial=_initial(pkg))
        thread, out = _serve(launch, session, ports[pkg])
        wait_for(ports[pkg])
        page = request(ports[pkg], "/")
        png = request(ports[pkg], "/image.png")
        missing = request(ports[pkg], "/nothing")
        replies, state = drive(ports[pkg], verbs)
        thread.join(timeout=30)
        assert not thread.is_alive()
        runs[pkg] = dict(page=page, png=png, missing=missing, replies=replies,
                         state=state, result=out["result"])
    j, t = runs["jax"], runs["port"]
    assert t["page"] == j["page"] and t["page"][0] == 200
    assert t["missing"] == j["missing"] == (404, b"{}")
    assert t["png"][0] == 200 and t["png"][1][:4] == b"\x89PNG"
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(t["png"][1]))), _image())
    assert t["replies"] == j["replies"]
    assert [s for s, _ in t["replies"]][-3:] == [400, 500, 200]
    assert t["replies"][-1][1] == {"done": True}
    for key in ("width", "height"):
        assert t["state"][key] == j["state"][key]
    strip = lambda st: [{k: v for k, v in m.items() if k != "overlay"}
                        for m in st["masks"]]
    assert strip(t["state"]) == strip(j["state"])
    for a, b in zip(_overlays(t["state"]), _overlays(j["state"])):
        np.testing.assert_array_equal(a, b)
    _same_detections(t["result"], j["result"])
