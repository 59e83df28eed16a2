"""Phases 2 and 8 of the port against the JAX package on the CPU, and the
host codecs they use against Pillow, at tiny sizes (images of 32² to
128², scenes of a few hundred faces), inputs drawn with numpy from a seed.
Tolerances:

* the HDR codec: ``load_hdr`` bit for bit on an RLE and a flat file,
  ``save_hdr``'s bytes identical; BICUBIC (L, RGB, RGBA) and LANCZOS
  (RGBA with partial alpha) against Pillow bit for bit;
* ``tone_map`` and ``_load_scene_for_render`` (atlas, UVs, materials)
  within 1e-7; ``render_view`` on test_phase8_render.py's textured quad
  and HDRI cases: the hit mask identical and the linear image within 1e-5
  plus 1e-4 of the value (GGX's 1 − n·h²(1 − α²) cancels at a sharp
  highlight: at roughness 0.2, α² = 1.6e-3 turns n·h's rounding into 1e-4
  relative), but at pixel centres on a face's edge (within 1e-3 px: XLA
  on the CPU contracts the edge functions' products into fused
  multiply-adds and eager PyTorch rounds them one by one, so such a centre
  can fall in another face, or none, in each; ROADMAP Queue 3 ag), under
  1% of the pixels;
* phase 2: ``OfflineInpainter`` and ``prepare_for_3d`` pixels identical
  (OpenCV hidden from the JAX package, which then erodes with the same
  4-neighbour cross; ROADMAP Queue 3 t), and ``run`` end to end;
* phase 8's ``run`` on a tiny bus with ``render_pointclouds`` and
  ``render_GT`` on: every PNG within one level, blender_scene.npz within
  1e-6; ``-p 2`` and ``-p 8`` through both CLIs; the Blender branch with a
  fake ``blender`` on PATH in both packages;
* phase 3's generator on chip_smoke.py's bus picture as phase 2 prepares
  it (pixels identical in both packages and to the card's by hash), from
  the same noise: latents within 5e-2 of max |JAX|, the volume's minimum
  and maximum within 2e-3, a zero crossing in both or in neither.
"""

import os
import shutil
import stat
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from regen3d_tpu import config as jconfig
from regen3d_tpu import orchestrator as jorch
from regen3d_tpu.camera import lookat_camera as jlookat
from regen3d_tpu.pipeline import phase2_inpaint as jp2
from regen3d_tpu.pipeline import phase8_render as jp8
from regen3d_tpu.utils import image as jimage
from regen3d_tpu_torch import orchestrator
from regen3d_tpu_torch.artifacts import Artifacts, finding_stem
from regen3d_tpu_torch.camera import Camera, save_camera_npz
from regen3d_tpu_torch.config import default_config
from regen3d_tpu_torch.pipeline import phase2_inpaint as tp2
from regen3d_tpu_torch.pipeline import phase8_render as tp8
from regen3d_tpu_torch.transforms.conventions import p3d_to_blender
from regen3d_tpu_torch.utils import image as timage
from regen3d_tpu_torch.utils.glb import MeshData, SceneData, save_glb
from regen3d_tpu_torch.utils.ply import save_ply
from test_torch_package import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


def _no_cv2():
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "cv2", None)    # import cv2 → ImportError
    return mp


# --- codecs -----------------------------------------------------------------

def _rle_hdr(path, rgbe):
    """A new-style RLE Radiance file of (H, W, 4) uint8 RGBE: per scanline
    and channel, runs of equal bytes as runs and the rest as literals."""
    h, w = rgbe.shape[:2]
    out = bytearray(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
    out += f"-Y {h} +X {w}\n".encode()
    for y in range(h):
        out += bytes([2, 2, w >> 8, w & 255])
        for c in range(4):
            row, x = rgbe[y, :, c], 0
            while x < w:
                n = 1
                while x + n < w and row[x + n] == row[x] and n < 127:
                    n += 1
                if n >= 3:
                    out += bytes([128 + n, row[x]])
                    x += n
                else:
                    n = min(w - x, 128)
                    out += bytes([n]) + bytes(row[x:x + n])
                    x += n
    Path(path).write_bytes(bytes(out))


def test_hdr_codec_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    img = (np.abs(rng.normal(size=(6, 40, 3))) * 3).astype(np.float32)
    img[:, 10:30] = [0.5, 2.0, 7.0]                  # runs for the RLE
    img[2, 3] = 0.0
    jimage.save_hdr(str(tmp_path / "j.hdr"), img)
    timage.save_hdr(str(tmp_path / "t.hdr"), img)
    assert (tmp_path / "j.hdr").read_bytes() == (tmp_path / "t.hdr").read_bytes()
    for name in ("t.hdr", "rle.hdr"):
        if name == "rle.hdr":
            raw = np.frombuffer((tmp_path / "t.hdr").read_bytes()[-6 * 40 * 4:],
                                np.uint8).reshape(6, 40, 4)
            _rle_hdr(tmp_path / name, raw)
        got = timage.load_hdr(str(tmp_path / name))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jimage.load_hdr(str(tmp_path / name)))
    np.testing.assert_array_equal(timage.load_hdr(str(tmp_path / "rle.hdr")),
                                  timage.load_hdr(str(tmp_path / "t.hdr")))


def _partial_alpha(rng, h, w):
    rgba = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    rgba[..., 3] = np.where(rng.random((h, w)) < 0.2, 0,
                            np.where(rng.random((h, w)) < 0.3, 255,
                                     rgba[..., 3]))
    return rgba


@pytest.mark.parametrize("mode,hw", [("L", (37, 23)), ("RGB", (20, 70)),
                                     ("RGB", (90, 52)), ("RGBA", (33, 41)),
                                     ("LA", (25, 31))])
def test_bicubic_and_lanczos_match_pillow(mode, hw):
    rng = np.random.default_rng(1)
    c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    arr = (_partial_alpha(rng, 45, 60) if c == 4
           else rng.integers(0, 256, (45, 60, c)).astype(np.uint8))
    if c == 2:
        arr = _partial_alpha(rng, 45, 60)[..., 2:]
    if c == 1:
        arr = arr[..., 0]
    im = Image.fromarray(arr)
    assert im.mode == mode
    for filt, pil in (("bicubic", Image.BICUBIC), ("lanczos", Image.LANCZOS)):
        want = np.asarray(im.resize((hw[1], hw[0]), pil))
        np.testing.assert_array_equal(timage.resize_pil(arr, hw, filt), want)
    # Pillow's default filter for RGB is BICUBIC
    if mode == "RGB":
        np.testing.assert_array_equal(timage.resize_pil(arr, hw, "bicubic"),
                                      np.asarray(im.resize((hw[1], hw[0]))))


def test_png_bytes_decode_and_refuse_other_formats(tmp_path):
    rng = np.random.default_rng(2)
    arr = rng.integers(0, 256, (9, 13, 4)).astype(np.uint8)
    img, mode = timage.decode_png(timage.encode_png(arr))
    assert mode == "RGBA"
    np.testing.assert_array_equal(img, arr)
    import io
    buf = io.BytesIO()
    Image.fromarray(arr[..., :3]).save(buf, "JPEG")
    with pytest.raises(NotImplementedError, match="JPEG"):
        timage.decode_png(buf.getvalue(), "texture")
    path = tmp_path / "x.png"
    path.write_bytes(buf.getvalue())
    with pytest.raises(NotImplementedError, match="JPEG"):
        timage.load_image_rgb(str(path))


# --- phase 8's pieces --------------------------------------------------------

def test_tone_map_matches_jax():
    x = np.random.default_rng(3).uniform(0, 4, (16, 16, 3)).astype(np.float32)
    for args in ((0.4, 0.8, "Filmic", "Low Contrast"),
                 (0.0, 1.0, "Standard", "None"),
                 (1.0, 2.2, "Filmic", "Very High Contrast")):
        np.testing.assert_array_equal(tp8.tone_map(x, *args),
                                      jp8.tone_map(x, *args))


def _quad(tex=None, metallic=0.0, roughness=0.8, z=2.0, name="quad"):
    """test_phase8_render.py's unit quad at z, optionally textured."""
    v = np.asarray([[-1, -1, z], [1, -1, z], [1, 1, z], [-1, 1, z]],
                   np.float32)
    f = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    uv = np.asarray([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)
    return MeshData(name=name, vertices=v, faces=f, uvs=uv, metallic=metallic,
                    roughness=roughness,
                    texture_png=(timage.encode_png(tex) if tex is not None
                                 else None),
                    base_color=np.asarray([0.5, 0.5, 0.5, 1.0]))


def _box(center, size, n=3, name="box"):
    """A box of n×n quads a side, vertex-coloured."""
    g = np.linspace(-0.5, 0.5, n + 1)
    a, b = np.meshgrid(g, g, indexing="ij")
    q = np.arange((n + 1) ** 2).reshape(n + 1, n + 1)
    quads = np.concatenate([np.stack([q[:-1, :-1], q[1:, :-1], q[1:, 1:]], -1),
                            np.stack([q[:-1, :-1], q[1:, 1:], q[:-1, 1:]], -1)])
    verts, faces = [], []
    for axis in range(3):
        u, w = [k for k in range(3) if k != axis]
        for side in (-0.5, 0.5):
            p = np.empty((a.size, 3))
            p[:, axis], p[:, u], p[:, w] = side, a.ravel(), b.ravel()
            faces.append(quads.reshape(-1, 3) + sum(len(x) for x in verts))
            verts.append(p)
    v = (np.concatenate(verts) * size + center).astype(np.float32)
    col = np.concatenate([np.abs(np.sin(v * 3.0)), np.ones((len(v), 1))], -1)
    return MeshData(name=name, vertices=v,
                    faces=np.concatenate(faces).astype(np.int32),
                    vertex_colors=col.astype(np.float32),
                    metallic=0.6, roughness=0.3)


def _texture(rng, hw=(40, 24)):
    return rng.integers(0, 256, (*hw, 3)).astype(np.uint8)


def test_load_scene_for_render_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    p1, p2 = str(tmp_path / "a.glb"), str(tmp_path / "b.glb")
    q2 = _quad(_texture(rng, (64, 64)), name="q2")
    q2.uvs = q2.uvs * 1.3 - 0.1                   # off [0, 1]: clipped
    save_glb(p1, SceneData(meshes=[_quad(_texture(rng)), _box([0, 0, 3], 0.8)]))
    save_glb(p2, SceneData(meshes=[q2, _quad(name="plain")]))
    over = dict(metallic_strength=0.5, roughness_strength=2.0)
    for cfgs in ((None, None), (default_config(str(tmp_path / "o"), **over),
                                jconfig.default_config(str(tmp_path / "o"),
                                                       **over))):
        got = tp8._load_scene_for_render([p1, p2, "missing.glb"], cfgs[0],
                                         tile=32)
        ref = jp8._load_scene_for_render([p1, p2, "missing.glb"], cfgs[1],
                                         tile=32)
        for k in ("verts", "faces", "normals", "colors", "uvs", "tex_weight",
                  "metallic", "roughness", "atlas"):
            a, b = getattr(got, k), getattr(ref, k)
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_allclose(a, b, atol=1e-7, err_msg=k)
    assert tp8._load_scene_for_render([str(tmp_path / "none.glb")]) is None


def _port_cam(jc):
    f = lambda x: torch.from_numpy(np.array(x))
    return Camera(R=f(jc.R), T=f(jc.T), focal=f(jc.focal),
                  principal=f(jc.principal), image_size=jc.image_size)


def _jcam(res):
    return jlookat(np.zeros(3, np.float32), np.asarray([0, 0, 2.0], np.float32),
                   (res, res), focal_px=res * 0.8)


def _on_edges(jc, scene, pix):
    """Which pixel centres (N, 2) lie within 1e-3 px of a face's edge on
    the screen (f64)."""
    v = np.asarray(jc.view_to_screen(jc.world_to_view(scene.verts)),
                   np.float64)[:, :2]
    tri = v[scene.faces]
    a, b = tri, np.roll(tri, -1, axis=1)                 # (F, 3, 2) edges
    p = pix[:, None, None, :] + 0.5
    ab = b - a
    t = np.clip(((p - a) * ab).sum(-1) / np.maximum((ab * ab).sum(-1),
                                                    1e-12), 0, 1)
    d = np.linalg.norm(p - (a + t[..., None] * ab), axis=-1)
    return d.min(axis=(1, 2)) <= 1e-3


def _edge_mask(dump, tag, scene_paths):
    """(H, W): pixel centres of the render ``tag`` ("cam1", "cam2") within
    1e-3 px of an edge of the scenes' faces, the camera from the scene
    dump."""
    from regen3d_tpu.camera import Camera as JCamera

    hw = tuple(int(x) for x in dump[f"{tag}_image_size"])
    jc = JCamera(R=dump[f"{tag}_R"], T=dump[f"{tag}_T"],
                 focal=dump[f"{tag}_focal"],
                 principal=dump[f"{tag}_principal"], image_size=hw)
    scene = jp8._load_scene_for_render(scene_paths)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    pix = np.stack([xx.ravel(), yy.ravel()], -1).astype(np.float64)
    return _on_edges(jc, scene, pix).reshape(hw)


def _pngs_close(got_dir, want_dir, names, masks):
    """Each PNG within one level of the JAX package's but at the pixels of
    its edge mask (``masks`` by the name's camera tag), under 1% of them."""
    for n in names:
        got = timage.read_png(os.path.join(got_dir, n))[0].astype(int)
        want = np.asarray(Image.open(os.path.join(want_dir, n))).astype(int)
        assert got.shape == want.shape, n
        far = (np.abs(got - want) > 1).any(-1)
        mask = masks.get((n.split("_")[1], "cam2" if "cam2" in n else "cam1"))
        if mask is None:
            assert not far.any(), n
        else:
            assert not (far & ~mask).any() and far.mean() < 0.01, n


def _view_pair(scene_paths, res, tcfg=None, jcfg=None, env=None):
    tsc = tp8._load_scene_for_render(scene_paths, tcfg)
    jsc = jp8._load_scene_for_render(scene_paths, jcfg)
    jc = _jcam(res)
    img_t, hit_t = tp8.render_view(_port_cam(jc), tsc, tcfg, env=env)
    img_j, hit_j = jp8.render_view(jc, jsc, jcfg, env=env)
    img_j, hit_j = np.asarray(img_j), np.asarray(hit_j)
    close = np.abs(img_t - img_j) <= 1e-5 + 1e-4 * np.abs(img_j)
    other = (hit_t != hit_j) | ~close.all(-1)
    ys, xs = np.nonzero(other)
    assert _on_edges(jc, jsc, np.stack([xs, ys], -1).astype(np.float64)).all()
    assert other.mean() < 0.01
    return img_t, hit_t


def test_render_view_textured_quad_matches_jax(tmp_path):
    tex = np.zeros((64, 64, 3), np.uint8)
    tex[:32, :32], tex[:32, 32:] = (255, 0, 0), (0, 255, 0)
    tex[32:, :32], tex[32:, 32:] = (0, 0, 255), (255, 255, 0)
    p = str(tmp_path / "scene.glb")
    save_glb(p, SceneData(meshes=[_quad(tex, roughness=1.0),
                                  _box([0.4, 0.2, 1.6], 0.3)]))
    img, hit = _view_pair([p], 96)
    assert hit.sum() > 500 and np.isfinite(img).all()


@pytest.mark.parametrize("rot,white", [(0.0, False), (180.0, False),
                                       (30.0, True)])
def test_render_view_hdri_matches_jax(tmp_path, rot, white):
    env = np.zeros((16, 32, 3), np.float32)
    env[:, :16] = [3.0, 0.1, 0.1]
    env[:, 16:] = [0.1, 0.1, 3.0]
    env[:4] += 1.0
    p = str(tmp_path / "scene.glb")
    save_glb(p, SceneData(meshes=[_quad(metallic=0.7, roughness=0.2)]))
    over = dict(hdri_rotation=rot, hdri_strength=1.5, hdri_white_bg=white)
    img, hit = _view_pair(
        [p], 48, default_config(str(tmp_path / "o"), **over),
        jconfig.default_config(str(tmp_path / "o"), **over), env=env)
    assert (~hit).any()


# --- phase 2 ------------------------------------------------------------------

def _finding(rng, h=60, w=80):
    """An object on white: a noisy ellipse, a bright patch inside it."""
    yy, xx = np.mgrid[0:h, 0:w]
    inside = ((yy - 30) / 22.0) ** 2 + ((xx - 36) / 25.0) ** 2 < 1
    img = np.full((h, w, 3), 255, np.uint8)
    img[inside] = rng.integers(20, 200, (int(inside.sum()), 3))
    img[28:32, 30:40] = 250
    return img


def _phase2_inputs(root, rng):
    cfg = default_config(str(root / "output"),
                         input_image=str(root / "input.png"))
    art = Artifacts(cfg)
    os.makedirs(art.findings_fullsize, exist_ok=True)
    stems = [finding_stem("chair", (36, 30)), finding_stem("lamp", (50, 20)),
             finding_stem("floor", (40, 50))]
    for s in stems:
        timage.save_image(os.path.join(art.findings_fullsize, f"{s}.png"),
                          _finding(rng))
    room = rng.integers(0, 256, (40, 56, 3)).astype(np.uint8)
    timage.save_image(str(root / "input.png"), room)
    return stems


def test_offline_inpainter_and_prepare_for_3d_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    room = rng.integers(0, 256, (31, 47, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tp2.OfflineInpainter._empty_room(room),
                                  jp2.OfflineInpainter._empty_room(room))
    src = tmp_path / "obj.png"
    timage.save_image(str(src), _finding(rng))
    mp = _no_cv2()
    try:
        for size in (512, 64):
            jp2.prepare_for_3d(str(src), str(tmp_path / f"j{size}.png"),
                               size=size)
            tp2.prepare_for_3d(str(src), str(tmp_path / f"t{size}.png"),
                               size=size)
            want = np.asarray(Image.open(tmp_path / f"j{size}.png"))
            got, mode = timage.read_png(str(tmp_path / f"t{size}.png"))
            assert mode == "RGBA" and got.shape == (size, size, 4)
            np.testing.assert_array_equal(got, want)
            assert 0 < (got[..., 3] == 0).mean() < 1

        class Matting:                    # a matting model's interface
            @staticmethod
            def alpha(rgb):
                return rgb[..., 0].astype(np.float32) / 200.0 - 0.1

        jp2.prepare_for_3d(str(src), str(tmp_path / "jm.png"), size=48,
                           matting=Matting())
        tp2.prepare_for_3d(str(src), str(tmp_path / "tm.png"), size=48,
                           matting=Matting())
        np.testing.assert_array_equal(
            timage.read_png(str(tmp_path / "tm.png"))[0],
            np.asarray(Image.open(tmp_path / "jm.png")))
    finally:
        mp.undo()


def test_phase2_run_matches_jax(tmp_path, caplog):
    for name in ("jax", "port"):
        _phase2_inputs(tmp_path / name, np.random.default_rng(6))
    mp = _no_cv2()
    try:
        jdone = jp2.run(jconfig.default_config(
            str(tmp_path / "jax" / "output"),
            input_image=str(tmp_path / "jax" / "input.png")))
    finally:
        mp.undo()
    cfg = default_config(str(tmp_path / "port" / "output"),
                         input_image=str(tmp_path / "port" / "input.png"),
                         matting_checkpoint=str(tmp_path / "no_such_dir"))
    tdone = tp2.run(cfg)
    assert tdone == jdone and len(tdone) == 2        # the floor is skipped
    assert "matting_checkpoint" in caplog.text
    ja, ta = (Artifacts(default_config(str(tmp_path / n / "output")))
              for n in ("jax", "port"))
    for d in ("inpaint_dir", "prepped_dir"):
        names = sorted(os.listdir(getattr(ta, d)))
        assert names == sorted(os.listdir(getattr(ja, d)))
        assert len(names) == {"inpaint_dir": 3, "prepped_dir": 2}[d]
        for n in names:
            got, _ = timage.read_png(os.path.join(getattr(ta, d), n))
            want = np.asarray(Image.open(os.path.join(getattr(ja, d), n)))
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(timage.read_png(ta.empty_room)[0],
                                  np.asarray(Image.open(ja.empty_room)))
    # a matting checkpoint directory is refused
    with pytest.raises(NotImplementedError, match="Queue 1 item 1"):
        tp2.run(cfg.with_overrides(matting_checkpoint=str(tmp_path)))


# --- phase 8 end to end ---------------------------------------------------------

def _phase8_bus(root):
    """camera.npz (64 × 48, the P3D identity camera), combined_scene.glb (a
    textured quad and a box), ground_aligned.glb (a vertex-coloured floor
    and back wall), the backprojected cloud, a GT scene and an HDRI.
    Returns the config overrides."""
    rng = np.random.default_rng(7)
    art = Artifacts(default_config(str(root / "output")))
    save_camera_npz(art.camera_npz, p3d_to_blender(np.eye(3), np.zeros(3)),
                    40.0, (64, 48))
    os.makedirs(os.path.dirname(art.combined_scene_glb), exist_ok=True)
    q = _quad(_texture(rng), metallic=0.3, roughness=0.4, z=3.0)
    q.vertices = (q.vertices * [0.6, 0.6, 1.0] + [0.5, 0.2, 0.0]).astype(
        np.float32)
    save_glb(art.combined_scene_glb,
             SceneData(meshes=[q, _box([-0.4, -0.3, 2.4], 0.5)]))
    bg = []
    for k, (v0, du, dv) in enumerate((
            ([-3, -1, 1.0], [6, 0, 0], [0, 0, 5.0]),
            ([-3, -1, 6.0], [6, 0, 0], [0, 4.0, 0]))):
        a, b = np.meshgrid(np.linspace(0, 1, 7), np.linspace(0, 1, 7),
                           indexing="ij")
        v = (np.asarray(v0) + a.reshape(-1, 1) * du
             + b.reshape(-1, 1) * dv).astype(np.float32)
        qq = np.arange(49).reshape(7, 7)
        f = np.concatenate([np.stack([qq[:-1, :-1], qq[1:, :-1], qq[1:, 1:]], -1),
                            np.stack([qq[:-1, :-1], qq[1:, 1:], qq[:-1, 1:]], -1)])
        col = np.concatenate([rng.uniform(0.2, 0.9, (49, 3)),
                              np.ones((49, 1))], -1).astype(np.float32)
        bg.append(MeshData(name=f"bg{k}", vertices=v,
                           faces=f.reshape(-1, 3).astype(np.int32),
                           vertex_colors=col))
    os.makedirs(os.path.dirname(art.ground_aligned_glb), exist_ok=True)
    save_glb(art.ground_aligned_glb, SceneData(meshes=bg))
    pts = np.concatenate([rng.uniform([-1, -1, 2], [1, 1, 4], (300, 3))])
    save_ply(art.combined_scene_bp_ply, pts.astype(np.float32),
             colors=rng.integers(0, 256, (300, 3)).astype(np.uint8))
    save_glb(str(root / "gt.glb"),
             SceneData(meshes=[_box([-0.3, -0.3, 2.5], 0.6, name="gt")]))
    sky = np.zeros((16, 32, 3), np.float32)
    sky[:] = np.linspace(0.2, 3.0, 16)[:, None, None] * [0.6, 0.8, 1.0]
    timage.save_hdr(str(root / "sky.hdr"), sky)
    return dict(render_resolution=48, render_pointclouds=True, render_GT=True,
                GT_scene=str(root / "gt.glb"), hdri_path=str(root / "sky.hdr"),
                hdri_rotation=40.0, force_software_render=True)


@pytest.fixture(scope="module")
def phase8_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("p8")
    outs = {}
    for name in ("jax", "port"):
        over = _phase8_bus(base / name)
        if name == "jax":
            outs[name] = jp8.run(jconfig.default_config(
                str(base / name / "output"), **over))
        else:
            outs[name] = tp8.run(default_config(str(base / name / "output"),
                                                **over), device="cpu")
    return base, outs


def test_phase8_run_matches_jax(phase8_runs):
    base, outs = phase8_runs
    names = [os.path.basename(p) for p in outs["port"]]
    assert names == [os.path.basename(p) for p in outs["jax"]]
    assert {"render_cam1.png", "render_cam2.png", "render_pointcloud_cam1.png",
            "render_GT_PC_cam2.png"} <= set(names)
    arts = {n: Artifacts(default_config(str(base / n / "output")))
            for n in ("jax", "port")}
    pngs = sorted(os.listdir(arts["jax"].rendering_dir))
    assert pngs == sorted(os.listdir(arts["port"].rendering_dir))
    assert len(pngs) == 11
    dumps = [np.load(os.path.join(arts[n].temp, "blender_scene.npz"))
             for n in ("port", "jax")]
    scene = [arts["jax"].combined_scene_glb, arts["jax"].ground_aligned_glb]
    gt = [str(base / "jax" / "gt.glb")]
    masks = {(kind, tag): _edge_mask(dumps[1], tag, paths)
             for kind, paths in (("cam1.png", scene), ("cam1", scene),
                                 ("cam2.png", scene), ("GT", gt))
             for tag in ("cam1", "cam2")}
    for n in pngs:
        shape = timage.read_png(os.path.join(arts["port"].rendering_dir, n))[0].shape
        assert shape == (48, 48 if "cam2" in n else 64, 3), n
    _pngs_close(arts["port"].rendering_dir, arts["jax"].rendering_dir, pngs,
                masks)
    cam1 = timage.read_png(os.path.join(arts["port"].rendering_dir,
                                        "render_cam1_white_bg.png"))[0]
    assert (cam1 < 250).any(axis=-1).mean() > 0.3
    assert sorted(dumps[0].files) == sorted(dumps[1].files)
    for k in dumps[1].files:
        np.testing.assert_allclose(dumps[0][k], dumps[1][k], atol=1e-6,
                                   err_msg=k)


def _fake_blender(bindir):
    """A ``blender`` on PATH that writes the two renders it is asked for."""
    bindir.mkdir()
    exe = bindir / "blender"
    exe.write_text("#!/bin/sh\n"
                   "touch \"$REGEN3D_OUT/render_cam1.png\" "
                   "\"$REGEN3D_OUT/render_cam1_white_bg.png\"\n"
                   "echo \"$@\" > \"$REGEN3D_OUT/blender_args.txt\"\n")
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)


def test_blender_branch_with_a_fake_blender(tmp_path, monkeypatch):
    _fake_blender(tmp_path / "bin")
    monkeypatch.setenv("PATH", f"{tmp_path / 'bin'}:{os.environ['PATH']}")
    for name, mod, conf in (("jax", jp8, jconfig), ("port", tp8, None)):
        over = _phase8_bus(tmp_path / name)
        over["force_software_render"] = False
        cfg = (conf.default_config if conf else default_config)(
            str(tmp_path / name / "output"), **over)
        outs = mod.run(cfg) if conf else mod.run(cfg, device="cpu")
        art = Artifacts(default_config(str(tmp_path / name / "output")))
        assert [os.path.basename(p) for p in outs] == [
            "render_cam1.png", "render_cam1_white_bg.png"]
        args = Path(art.rendering_dir, "blender_args.txt").read_text().split()
        assert args[:2] == ["-b", "-P"] and args[2].endswith("render_scene.py")
        assert Path(args[2]).read_text() == jp8._BLENDER_SCRIPT
        assert not Path(art.rendering_dir, "render_cam2.png").exists()


def test_cli_runs_phases_2_and_8(tmp_path):
    """``-p 2`` and ``-p 8`` through the JAX CLI and
    ``python -m regen3d_tpu_torch --device cpu``: the same files."""
    for name in ("jax", "port"):
        root = tmp_path / name
        _phase2_inputs(root, np.random.default_rng(8))
        over = _phase8_bus(root)
        over.update(render_pointclouds=False, render_GT=False)
        (root / "src").mkdir()
        values = dict(over, output="../output", input_image="../input.png")
        (root / "src" / "cfg.yaml").write_text(yaml.safe_dump(values))
    mp = _no_cv2()
    try:
        jorch.main(["-p", "2", "8", "--config",
                    str(tmp_path / "jax" / "src" / "cfg.yaml")])
    finally:
        mp.undo()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-m", "regen3d_tpu_torch", "-p", "2", "8",
         "--config", str(tmp_path / "port" / "src" / "cfg.yaml"),
         "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    for sub in ("inpaint_nanoBanana", "prepped", "rendering"):
        jfiles = sorted(p.relative_to(tmp_path / "jax")
                        for p in (tmp_path / "jax").rglob("*.png")
                        if sub in str(p))
        tfiles = sorted(p.relative_to(tmp_path / "port")
                        for p in (tmp_path / "port").rglob("*.png")
                        if sub in str(p))
        assert jfiles == tfiles and jfiles, sub
        if sub != "rendering":
            for rel in tfiles:
                got = timage.read_png(str(tmp_path / "port" / rel))[0]
                np.testing.assert_array_equal(
                    got, np.asarray(Image.open(tmp_path / "jax" / rel)))
    art = Artifacts(default_config(str(tmp_path / "jax" / "output")))
    dump = np.load(os.path.join(art.temp, "blender_scene.npz"))
    scene = [art.combined_scene_glb, art.ground_aligned_glb]
    m1, m2 = (_edge_mask(dump, t, scene) for t in ("cam1", "cam2"))
    masks = {("cam1.png", "cam1"): m1, ("cam1", "cam1"): m1,
             ("cam2.png", "cam2"): m2}
    _pngs_close(art.rendering_dir,
                Artifacts(default_config(str(tmp_path / "port" / "output")))
                .rendering_dir, sorted(os.listdir(art.rendering_dir)), masks)


# --- phase 3 on phase 2's prepped picture of the bus --------------------------

# the sha256 of the bus's prepped picture's pixels (512² RGBA) as the CPU
# builds it; chip_smoke.py prints the card's where phase 3 leaves it the
# placeholder
BUS_PICTURE_SHA256 = \
    "c3a3bdf5a7bf313593b808614cad18d503da1f7a1e48d027c9a3cc6be92b2358"
# chip_smoke.JAX_MIN_SDF_ERR: the bound on the minimum SDF below
JAX_MIN_SDF_ERR = 2e-3


def test_bus_picture_generator_matches_jax(tmp_path, monkeypatch):
    """chip_smoke.py's bus built on the CPU; its picture's finding through
    both packages' ``prepare_for_3d`` (pixels identical); then the
    committed generator's chain at phase 3's defaults (64² condition
    image, 50 Euler steps, guidance 5) from the same N(0, 1) latents
    (numpy, the config's seed) in the JAX package (its plain attention)
    and in the port (CPU, the checkpoint's bf16), decoded two-level at
    128³ (256³, phase 3's, takes a minute here): latents within 5e-2 of
    max |JAX| (chip_smoke's bound on the card's against f32), the volumes'
    minimum and maximum within JAX_MIN_SDF_ERR, and a zero crossing in
    both or in neither. chip_smoke.py lets the card write phase 3's
    placeholder for an object only where the port's bf16 chain from the
    run's noise keeps its minimum |SDF| over that bound."""
    import hashlib

    import jax
    import jax.image as jimg
    import jax.numpy as jnp

    import regen3d_tpu.models.layers as jl
    import regen3d_tpu.ops.attention as ja
    from regen3d_tpu.models import shapevae as jsv
    from regen3d_tpu.models.dit import sample as jsample
    from regen3d_tpu.pipeline import phase3_assets as jp3
    from regen3d_tpu_torch.models import shapevae as tsv
    from regen3d_tpu_torch.models.dit import sample as tsample
    from regen3d_tpu_torch.models.layers import resize_bilinear
    from regen3d_tpu_torch.pipeline import phase3_assets as tp3

    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke

    chip_smoke.build_bus(tmp_path / "bus", "cpu")
    art = Artifacts(default_config(str(tmp_path / "bus" / "output")))
    stem = next(s for s in art.list_findings() if s.startswith("picture"))
    src = os.path.join(art.findings_fullsize, f"{stem}.png")
    tp2.prepare_for_3d(src, str(tmp_path / "t.png"))
    mp = _no_cv2()
    try:
        jp2.prepare_for_3d(src, str(tmp_path / "j.png"))
    finally:
        mp.undo()
    img = timage.read_png(str(tmp_path / "t.png"))[0]
    np.testing.assert_array_equal(img, np.asarray(Image.open(tmp_path / "j.png")))
    assert img.shape == (512, 512, 4)
    assert hashlib.sha256(img.tobytes()).hexdigest() == BUS_PICTURE_SHA256

    monkeypatch.setattr(jl, "flash_attention",
                        lambda q, k, v: ja.attention_reference(q, k, v))
    cfg = default_config(str(tmp_path / "out"))
    seed = int(cfg.get("seed", 1234567))
    jg = jp3.load_default_generator(jconfig.default_config(str(tmp_path / "j")))
    tg = tp3.load_default_generator(cfg, device="cpu")
    assert jg.trained and tg.trained
    x = img.astype(np.float32) / 255.0
    size = jg.image_size
    noise = np.random.default_rng(seed).standard_normal(
        (1, jg.dit_cfg.latent_tokens, jg.dit_cfg.latent_dim)).astype(np.float32)
    res, chunk = 128, 8192

    def jchain(params, im):
        lat = jsample(jg.dit, params["dit"], None,
                      jg.cond.apply(params["cond"], im), num_steps=50,
                      guidance_scale=5.0, latents=jnp.asarray(noise))
        return lat, jsv.decode_grid_hierarchical(
            jg.decoder, params["dec"], lat, resolution=res, chunk=chunk)

    jim = jimg.resize(jnp.asarray(x), (size, size, 4), "bilinear")[None]
    jlat, jh = jax.jit(jchain)(jg.params, jim)
    jvol = jsv.assemble_volume(*(np.asarray(a) for a in jh), res)[0]
    with torch.no_grad():
        tim = resize_bilinear(torch.from_numpy(x)[None], (size, size))
        tlat = tsample(tg.dit, tg.cond(tim), num_steps=50, guidance_scale=5.0,
                       latents=torch.from_numpy(noise))
        tvol = tsv.assemble_volume(*tsv.decode_grid_hierarchical(
            tg.decoder, tlat, resolution=res, chunk=chunk), res)[0]
    jlat = np.asarray(jlat, np.float32)
    assert (np.abs(tlat.float().numpy() - jlat).max()
            <= 5e-2 * np.abs(jlat).max())
    assert abs(float(tvol.min()) - float(jvol.min())) <= JAX_MIN_SDF_ERR
    assert abs(float(tvol.max()) - float(jvol.max())) <= JAX_MIN_SDF_ERR
    crossing = lambda v: float(v.min()) < 0 < float(v.max())
    assert crossing(tvol) == crossing(jvol)
