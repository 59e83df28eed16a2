"""The port's config, artifact layout and file IO against the JAX package.

Config and artifact paths must be identical; PLY and GLB files written by
one package must read back equal in the other (bit for bit: both are
numpy). The PNG codec is held against PIL both ways, bit for bit, over
every PNG row filter, and ``resize_nearest`` against ``Image.NEAREST``.
The masks of phases 5 and 6 go through it, so any difference would move
points between objects. The erosion and dilation are the JAX module's own
branches without OpenCV, which the test forces by hiding ``cv2``.
"""

import io
import re
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from regen3d_tpu import artifacts as jart
from regen3d_tpu import config as jconfig
from regen3d_tpu.utils import glb as jglb
from regen3d_tpu.utils import image as jimage
from regen3d_tpu.utils import ply as jply
from regen3d_tpu_torch import artifacts as tart
from regen3d_tpu_torch import config as tconfig
from regen3d_tpu_torch.utils import glb as tglb
from regen3d_tpu_torch.utils import image as timage
from regen3d_tpu_torch.utils import ply as tply

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "regen3d_tpu_torch"


def test_port_sources_import_no_jax_pil_cv2_or_yaml_at_top():
    """No module of the port imports jax or the JAX package anywhere, nor
    PIL, cv2 or yaml at module level (the card's machine has none of
    them); a function that needs one imports it inside itself."""
    banned_anywhere = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|regen3d_tpu)(\.|\s|$)")
    banned_top = re.compile(r"^(import|from)\s+(PIL|cv2|yaml)(\.|\s|$)")
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        for n, line in enumerate(path.read_text().splitlines(), 1):
            assert not banned_anywhere.match(line), f"{path}:{n}: {line}"
            assert not banned_top.match(line), f"{path}:{n}: {line}"


def _tree(cfg):
    return {k: cfg[k] for k in cfg}


def test_default_config_and_yaml_load_match(tmp_path):
    out = str(tmp_path / "output")
    over = dict(image_size_DR=512, sigma="5e-7", write_fit_gifs=False)
    j, t = jconfig.default_config(out, **over), tconfig.default_config(out, **over)
    assert _tree(j) == _tree(t)
    assert j.base_dir == t.base_dir and j.output_root == t.output_root
    src = tmp_path / "repo" / "src"
    src.mkdir(parents=True)
    text = ("output: ../output\nsigma: 5e-7\nimage_size_DR: 640\n"
            "labels: [chair, floor]\ncamera: ../output/pre_3D/camera.npz\n"
            "temp: ../tmp\n")
    (src / "config.yaml").write_text(text)
    j = jconfig.load_config(str(src / "config.yaml"), {"seed": 7})
    t = tconfig.load_config(str(src / "config.yaml"), {"seed": 7})
    assert _tree(j) == _tree(t) and t["sigma"] == 5e-7 and t["seed"] == 7
    for key in ("output", "temp", "camera", "vggt_cloud", "mask_folder"):
        assert j.path(key) == t.path(key), key


def test_artifact_paths_and_stems_identical(tmp_path):
    out = str(tmp_path / "output")
    ja = jart.Artifacts(jconfig.default_config(out))
    ta = tart.Artifacts(tconfig.default_config(out))
    props = [n for n, v in vars(jart.Artifacts).items()
             if isinstance(v, property)]
    assert len(props) > 30
    for name in props:
        assert getattr(ja, name) == getattr(ta, name), name
    assert ja.asset_glb("chair__(1, 2)") == ta.asset_glb("chair__(1, 2)")
    assert ja.fitted_glb("chair__(1, 2)") == ta.fitted_glb("chair__(1, 2)")
    for stem in ("chair__(12, 40)", "plant in pot__(-3, 7)", "floor", "a__(1,2"):
        assert jart.parse_finding_stem(stem) == tart.parse_finding_stem(stem)
    assert tart.finding_stem("lamp", (3.7, 9)) == jart.finding_stem("lamp", (3.7, 9))
    Path(ja.findings_fullsize).mkdir(parents=True)
    for s in ("b__(1, 1)", "a__(2, 2)"):
        (Path(ja.findings_fullsize) / f"{s}.png").write_bytes(b"")
    assert ja.list_findings() == ta.list_findings() == ["a__(2, 2)", "b__(1, 1)"]


@pytest.mark.parametrize("writer,reader", [(jply, tply), (tply, jply)])
def test_ply_written_by_one_reads_back_in_the_other(tmp_path, writer, reader):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    nrm = rng.normal(size=(300, 3)).astype(np.float32)
    col = rng.integers(0, 256, (300, 3)).astype(np.uint8)
    faces = rng.integers(0, 300, (50, 3)).astype(np.int32)
    writer.save_ply(str(tmp_path / "a.ply"), pts, normals=nrm, colors=col)
    writer.save_ply(str(tmp_path / "m.ply"), pts, faces=faces)
    a = reader.load_ply(str(tmp_path / "a.ply"))
    m = reader.load_ply(str(tmp_path / "m.ply"))
    np.testing.assert_array_equal(a.vertices, pts)
    np.testing.assert_array_equal(a.normals, nrm)
    np.testing.assert_array_equal(a.colors[:, :3], col)
    np.testing.assert_array_equal(m.faces, faces)


@pytest.mark.parametrize("writer,reader", [(jglb, tglb), (tglb, jglb)])
def test_glb_written_by_one_reads_back_in_the_other(tmp_path, writer, reader):
    rng = np.random.default_rng(1)
    meshes = [writer.MeshData(
        name=f"m{i}", vertices=rng.normal(size=(40, 3)).astype(np.float32),
        faces=rng.integers(0, 40, (30, 3)).astype(np.int32),
        base_color=np.asarray([0.2, 0.4, 0.6, 1.0])) for i in range(2)]
    writer.save_glb(str(tmp_path / "s.glb"), writer.SceneData(meshes=meshes))
    back = {m.name: m for m in reader.load_glb(str(tmp_path / "s.glb")).meshes}
    assert sorted(back) == ["m0", "m1"]
    for a in meshes:
        b = back[a.name]
        np.testing.assert_array_equal(a.vertices, b.vertices)
        np.testing.assert_array_equal(a.faces, b.faces)


def _filters_of(buf: bytes):
    """The row-filter bytes of an 8-bit PNG."""
    pos, idat, ihdr = 8, b"", None
    while pos < len(buf):
        (n,) = struct.unpack(">I", buf[pos:pos + 4])
        tag = buf[pos + 4:pos + 8]
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", buf[pos + 8:pos + 8 + n])
        elif tag == b"IDAT":
            idat += buf[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw.reshape(ihdr[1], -1)[:, 0].tolist())


MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_png_written_by_pil_reads_bit_for_bit(tmp_path, mode):
    rng = np.random.default_rng(2)
    c = MODES[mode]
    arr = rng.integers(0, 256, (61, 47, c), dtype=np.uint8)
    arr[:10] = 255                        # flat rows: Sub / Up filters
    arr[20:30] = np.arange(47, dtype=np.uint8)[None, :, None] * 5
    img = Image.fromarray(arr[..., 0] if c == 1 else arr, mode=mode)
    path = tmp_path / f"x_{mode}.png"
    img.save(path, optimize=True)         # PIL's adaptive filters
    assert _filters_of(path.read_bytes()) == {0, 1, 2, 3, 4}
    got, got_mode = timage.read_png(str(path))
    assert got_mode == mode
    np.testing.assert_array_equal(got, arr)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_png_written_by_the_port_reads_in_pil_bit_for_bit(tmp_path, mode):
    rng = np.random.default_rng(3)
    c = MODES[mode]
    arr = rng.integers(0, 256, (33, 70, c), dtype=np.uint8)
    arr = arr[..., 0] if c == 1 else arr
    timage.save_image(str(tmp_path / "y.png"), arr)
    back = Image.open(tmp_path / "y.png")
    assert back.mode == mode
    np.testing.assert_array_equal(np.asarray(back), arr)


def test_png_reader_refuses_what_it_does_not_read(tmp_path):
    Image.fromarray(np.zeros((4, 4), np.uint8)).convert("P").save(tmp_path / "p.png")
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(tmp_path / "i16.png")
    # the same file with IHDR's interlace byte set (PIL writes no Adam7)
    buf = io.BytesIO()
    Image.fromarray(np.zeros((8, 8), np.uint8)).save(buf, "PNG")
    png = bytearray(buf.getvalue())
    png[28] = 1
    png[29:33] = struct.pack(">I", zlib.crc32(bytes(png[12:29])) & 0xFFFFFFFF)
    (tmp_path / "il.png").write_bytes(bytes(png))
    for name in ("p.png", "i16.png", "il.png"):
        with pytest.raises(ValueError, match="unsupported PNG"):
            timage.read_png(str(tmp_path / name))
    with pytest.raises(ValueError):
        timage.save_image(str(tmp_path / "z.jpg"), np.zeros((2, 2), np.uint8))


def test_masks_and_findings_read_as_pil_converts_them(tmp_path):
    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
    rgb[rng.random((40, 50)) < 0.4] = 255
    rgb[:5, :5] = (250, 251, 249)         # just under white in one channel
    for mode, arr in (("RGB", rgb), ("RGBA", np.concatenate(
            [rgb, rng.integers(0, 256, (40, 50, 1), dtype=np.uint8)], -1)),
            ("L", rgb[..., 1]), ("LA", np.stack([rgb[..., 0], rgb[..., 2]], -1))):
        p = str(tmp_path / f"f_{mode}.png")
        Image.fromarray(arr, mode=mode).save(p)
        np.testing.assert_array_equal(timage.mask_from_finding(p),
                                       jimage.mask_from_finding(p))
        np.testing.assert_array_equal(timage.load_mask(p), jimage.load_mask(p))


@pytest.mark.parametrize("src,dst", [((96, 96), (1024, 1344)),
                                     ((960, 1280), (1024, 1344)),
                                     ((1280, 960), (1344, 1024)),
                                     ((97, 131), (40, 23))])
def test_resize_nearest_is_pils_nearest(src, dst):
    m = np.random.default_rng(5).random(src) > 0.5
    want = np.asarray(Image.fromarray(m).resize(dst[::-1], Image.NEAREST))
    np.testing.assert_array_equal(timage.resize_nearest(m, dst), want)


def test_erode_and_dilate_are_the_jax_branches_without_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)   # import cv2 → ImportError
    m = np.random.default_rng(6).random((50, 70)) > 0.3
    for px, it in ((4, 4), (1, 1), (2, 3)):
        np.testing.assert_array_equal(timage.erode_mask(m, px, it),
                                      jimage.erode_mask(m, px, it))
    for px in (1, 3):
        np.testing.assert_array_equal(timage.dilate_mask(m, px),
                                      jimage.dilate_mask(m, px))
    assert timage.mask_bbox(m) == jimage.mask_bbox(m)
