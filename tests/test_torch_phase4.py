"""Phase 4 of the port against the JAX package on the CPU.

- ``export_reconstruction`` in both packages on the same frames (a frame 0
  that is not the identity, and an empty-room frame): every text and PLY
  file byte for byte the same, the npz arrays equal (the zip members carry
  their write time, so the files are compared by content).
- ``run_vggt_inference`` at ``VGGTConfig.tiny()`` with the JAX package's
  weights carried by ``load_from_jax``, on a square and a non-square
  PNG at ``conf_thres_value`` 1.0 with a point cap that bites: points and
  cameras within rtol/atol 1e-4, the same rows kept.
- ``-p 4`` fails alike in both CLIs, with and without ``Use_VGGT`` (the
  DUSt3R phase), before anything is written.
- The alignments within 1e-10, ``matrix_to_qvec`` within 1e-6 and COLMAP
  ``read(write(x))``.
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

from regen3d_tpu import config as jconfig
from regen3d_tpu import orchestrator as jorch
from regen3d_tpu.models import vggt as jv
from regen3d_tpu.pipeline import phase4_camera as jp4
from regen3d_tpu_torch import orchestrator as torch_orch
from regen3d_tpu_torch.artifacts import Artifacts
from regen3d_tpu_torch.config import default_config
from regen3d_tpu_torch.models import vggt as tv
from regen3d_tpu_torch.models.from_jax import load_from_jax
from regen3d_tpu_torch.pipeline import phase4_camera as tp4
from regen3d_tpu_torch.utils.colmapio import ColmapReconstruction
from regen3d_tpu_torch.utils.image import save_image
from test_torch_package import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
SPARSE = ["cameras.txt", "images.txt", "points3D.txt", "image_list.txt",
          "points.ply", "points_emptyRoom_pre.ply", "points_emptyRoom.ply",
          "points_emptyRoom_aligned.ply"]


def _rot_x(th):
    return np.array([[1, 0, 0], [0, np.cos(th), -np.sin(th)],
                     [0, np.sin(th), np.cos(th)]])


def _frames(seed=11):
    """Two frames: the input with a non-identity pose (the JAX package's
    test_nonidentity_frame0_is_rebased_exact) and an empty room with
    colours, another pose and intrinsics."""
    rng = np.random.default_rng(seed)
    R0, t0 = _rot_x(0.4), np.array([0.3, -0.2, 0.5])
    pts0 = (rng.normal(size=(200, 3)) * 0.5 + [0, 0, 4.0] - t0) @ R0
    R1 = _rot_x(-0.25) @ np.array([[0.0, 0, 1], [0, 1, 0], [-1, 0, 0]])
    t1 = np.array([-0.1, 0.05, 0.2])
    pts1 = rng.uniform(-2, 2, (300, 3)) * [2.0, 1.0, 0.5] + [0, 0, 5.0]
    return {
        "in.png": dict(points=pts0, R=R0, t=t0, fx=400.0, fy=410.0,
                       cx=256.0, cy=192.0, width=512, height=384),
        "empty_room.png": dict(points=pts1, R=R1, t=t1, fx=395.5, fy=401.25,
                               cx=256.0, cy=192.0, width=512, height=384,
                               colors=rng.integers(0, 256, (300, 3),
                                                   dtype=np.uint8)),
    }


def _files(cfg, n_frames):
    """The artifact set's files: (byte-compared files, npz files)."""
    art = Artifacts(cfg)
    names = SPARSE if n_frames == 2 else SPARSE[:5]
    files = [os.path.join(art.colmap_sparse, n) for n in names]
    npz = [art.camera_npz] + ([art.camera_empty_npz] if n_frames == 2 else [])
    return files + [art.scene_cloud_ply], npz


@pytest.mark.parametrize("n_frames", [1, 2])
def test_export_reconstruction_matches_jax(tmp_path, n_frames):
    frames = dict(list(_frames().items())[:n_frames])
    jcfg = jconfig.default_config(str(tmp_path / "j" / "output"),
                                  vggt_scene_scale=2.0)
    tcfg = default_config(str(tmp_path / "t" / "output"),
                          vggt_scene_scale=2.0)
    jp4.export_reconstruction(jcfg, {k: dict(v) for k, v in frames.items()})
    tp4.export_reconstruction(tcfg, {k: dict(v) for k, v in frames.items()})
    (j_files, j_npz), (t_files, t_npz) = (_files(c, n_frames)
                                          for c in (jcfg, tcfg))
    for a, b in zip(j_files, t_files):
        assert Path(a).read_bytes() == Path(b).read_bytes(), b
    for a, b in zip(j_npz, t_npz):
        with np.load(a) as za, np.load(b) as zb:
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                assert za[k].dtype == zb[k].dtype, (b, k)
                np.testing.assert_array_equal(za[k], zb[k],
                                              err_msg=f"{b} {k}")
    assert os.path.exists(Artifacts(tcfg).camera_empty_npz) == (n_frames == 2)
    # the rebase: frame 0's camera.npz is R_fix up to the f32 rotation's
    # orthogonality, with a zero translation to f64 rounding
    with np.load(t_npz[0]) as z:
        ext = z["extrinsic"]
    from regen3d_tpu_torch.transforms.conventions import R_FIX_CV2BLENDER
    np.testing.assert_allclose(ext[:3, :3], R_FIX_CV2BLENDER, atol=1e-6)
    np.testing.assert_allclose(ext[:3, 3], 0.0, atol=1e-6)


def test_alignments_match_jax():
    rng = np.random.default_rng(4)
    tgt = rng.normal(size=(800, 3)) * [3.0, 1.0, 0.3]
    src = tgt @ _rot_x(0.7).T * 0.8 + [1.0, 2.0, 3.0]
    for j, t in ((jp4.align_pointclouds_obb, tp4.align_pointclouds_obb),
                 (jp4.align_pointclouds_pca, tp4.align_pointclouds_pca)):
        for a, b in zip(j(src, tgt), t(src, tgt)):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-10)


def test_matrix_to_qvec_matches_jax():
    rng = np.random.default_rng(2)
    for _ in range(20):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                       2 * (x * z + w * y)],
                      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                       2 * (y * z - w * x)],
                      [2 * (x * z - w * y), 2 * (y * z + w * x),
                       1 - 2 * (x * x + y * y)]])
        got, want = tp4.matrix_to_qvec(R), jp4.matrix_to_qvec(R)
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, want, atol=1e-6)


def test_colmap_read_inverts_write(tmp_path):
    frames = _frames()
    tp4.export_reconstruction(default_config(str(tmp_path / "output")),
                              {k: dict(v) for k, v in frames.items()})
    d = Artifacts(default_config(str(tmp_path / "output"))).colmap_sparse
    rec = ColmapReconstruction.read(d)
    rec.write(str(tmp_path / "again"))
    for name in ("cameras.txt", "images.txt", "points3D.txt"):
        assert ((tmp_path / "again" / name).read_bytes()
                == (Path(d) / name).read_bytes()), name
    assert len(rec.points) == 500 and rec.colors.dtype == np.uint8
    assert [im.name for im in rec.images.values()] == list(frames)
    np.testing.assert_allclose(rec.cameras[2].params,
                               [395.5, 401.25, 256.0, 192.0])
    # the image's pose comes back through the text's ten digits
    cam = rec.images[1].cam_from_world()
    np.testing.assert_allclose(cam[:, :3], np.eye(3), atol=1e-6)
    np.testing.assert_allclose(cam[:, 3], 0.0, atol=1e-6)


@pytest.fixture(scope="module")
def tiny_models():
    jc = dataclasses.replace(jv.VGGTConfig.tiny(), dtype=jnp.float32)
    tc = dataclasses.replace(tv.VGGTConfig.tiny(), dtype=torch.float32)
    jm = jv.VGGT(jc)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 2, 28, 28, 3)))
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.05 if path[-1].key in ("ls1", "ls2") else
        (x + 0.01 if "poseLN_modulation" in str(path) else x), params)
    tm = tv.VGGT(tc, device="cpu")
    load_from_jax(tm, jax.device_get(params))
    return jm, params, tm


def _pngs(root):
    rng = np.random.default_rng(7)
    sq, wide = str(root / "square.png"), str(root / "wide.png")
    save_image(sq, rng.integers(0, 256, (40, 40, 3)).astype(np.uint8))
    save_image(wide, rng.integers(0, 256, (30, 56, 3)).astype(np.uint8))
    return sq, wide


def test_run_vggt_inference_matches_jax(tmp_path, tiny_models):
    jm, params, tm = tiny_models
    paths = _pngs(tmp_path)
    over = dict(conf_thres_value=1.0, max_points_for_colmap=500)
    want = jp4.run_vggt_inference(
        jconfig.default_config(str(tmp_path / "j"), **over), params, jm,
        paths, resolution=28)
    got = tp4.run_vggt_inference(
        default_config(str(tmp_path / "t"), **over), tm, paths,
        resolution=28, device="cpu")
    assert list(got) == list(want) == ["square.png", "wide.png"]
    for name in want:
        w, g = want[name], got[name]
        # the wide image's pad rows are masked, and the cap bites on the
        # square one (784 model pixels)
        assert g["points"].shape == w["points"].shape
        assert len(g["points"]) == (500 if name == "square.png" else 420)
        np.testing.assert_allclose(g["points"], w["points"], rtol=1e-4,
                                   atol=1e-4, err_msg=name)
        for key in ("R", "t", "fx", "fy"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4, atol=1e-4,
                                       err_msg=f"{name} {key}")
        for key in ("cx", "cy", "width", "height"):
            assert g[key] == w[key], (name, key)


def _write_cfg(root, **over):
    values = dict(jconfig.default_config(str(root / "output"),
                                         input_image=str(root / "in.png"),
                                         **over))
    root.mkdir(parents=True, exist_ok=True)
    path = root / "cfg.yaml"
    path.write_text(yaml.safe_dump(values))
    save_image(str(root / "in.png"), np.full((32, 48, 3), 128, np.uint8))
    return str(path)


@pytest.mark.parametrize("use_vggt", [True, False])
def test_phase4_cli_fails_like_jax(tmp_path, use_vggt):
    """Without a model, -p 4 raises in both CLIs before writing anything,
    the same RuntimeError: with Use_VGGT the VGGT phase's, whose advice
    names the port's own loaders (models.weights, conversion.load_upstream)
    where the JAX package names its orbax reader, without it the DUSt3R
    phase's (phase4_dust3r), word for word."""
    j_cfg = _write_cfg(tmp_path / "j", Use_VGGT=use_vggt)
    t_cfg = _write_cfg(tmp_path / "t", Use_VGGT=use_vggt)
    with pytest.raises(RuntimeError, match="requires a") as j_err:
        jorch.main(["-p", "4", "--config", j_cfg])
    want = "requires a VGGT model" if use_vggt else \
        "dust3r phase 4 requires a model"
    with pytest.raises(RuntimeError, match=want) as t_err:
        torch_orch.main(["-p", "4", "--config", t_cfg, "--device", "cpu"])
    if use_vggt:
        head = "phase 4 requires a VGGT model + params (no pretrained weights"
        assert str(t_err.value).startswith(head)
        assert str(j_err.value).startswith(head)
        for name in ("models.weights.load_torch_file",
                     "conversion.load_upstream", "phase4_camera.run("):
            assert name in str(t_err.value)
    else:
        assert str(t_err.value) == str(j_err.value)
    for root in (tmp_path / "j", tmp_path / "t"):
        assert not (root / "output" / "pre_3D").exists()


def test_port_cli_routes_phase_4(tmp_path):
    """``python -m regen3d_tpu_torch -p 4`` reaches phase 4 and exits
    non-zero with the JAX package's message."""
    cfg = _write_cfg(tmp_path)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-m", "regen3d_tpu_torch", "-p", "4", "--config",
         cfg, "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert "phase 4 requires a VGGT model" in out.stderr
    assert "not ported yet" not in out.stderr
