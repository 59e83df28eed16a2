"""The port's parallel layer against the JAX package's (regen3d_tpu/
parallel/): the partition rules path for path and the placements they give
on the VGGT, SAM and DiT trees, make_mesh's split, the two fallbacks; the
dry run's four programs on 4 gloo ranks, as a (2, 2) and a (4, 1) mesh (the
sharded fit against JAX's ``fit_poses_sharded`` on the 8 virtual devices,
the tp VGGT forward and the fused scene step against JAX's one-device
programs, the dp × tp DiT step against JAX's ``train_step`` jitted over
the 8 virtual devices and against the port's unsharded step); phase 6's
choice of the sharded fit; the fleet (over two ranks in
test_torch_phase56.py); and the backward kernels' head widths
(ROADMAP Queue 3 be). Triangulated GT scenes (utils/synthgt) are held byte
for byte."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from regen3d_tpu.parallel import mesh as jmesh
from regen3d_tpu_torch.parallel import dryrun
from regen3d_tpu_torch.parallel import mesh as tmesh
from test_torch_package import one_torch_thread  # noqa: F401

SIZES = {"dp": 2, "tp": 4}


# ---------------------------------------------------------------------------
# rules and placements


def _jax_vggt():
    from regen3d_tpu.models.vggt import VGGT, VGGTConfig
    c = VGGTConfig.tiny()
    return jax.eval_shape(VGGT(c).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 1, c.image_size, c.image_size, 3)))


def _jax_sam():
    from regen3d_tpu.models import sam as js
    c = js.SamConfig.tiny()
    s = c.image_size
    return jax.eval_shape(js.SAM(c).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, s, s, 3)), jnp.zeros((1, 4, 2)),
                          -jnp.ones((1, 4)), jnp.zeros((1, 2, 2)))


def _jax_dit():
    from regen3d_tpu.models.dit import DiTConfig, ShapeDiT
    c = DiTConfig.tiny()
    return jax.eval_shape(ShapeDiT(c).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, c.latent_tokens, c.latent_dim)),
                          jnp.zeros((1,)), jnp.zeros((1, 16, c.cond_dim)))


def _port(family):
    if family == "vggt":
        from regen3d_tpu_torch.models.vggt import VGGT, VGGTConfig
        return VGGT(VGGTConfig.tiny(), device="cpu")
    if family == "sam":
        from regen3d_tpu_torch.models.sam import SAM, SamConfig
        return SAM(SamConfig.tiny(), device="cpu")
    from regen3d_tpu_torch.models.dit import DiTConfig, ShapeDiT
    return ShapeDiT(DiTConfig.tiny(), device="cpu")


def _jax_specs(shapes, mesh, rules=tuple(jmesh.DEFAULT_RULES)):
    """{flax path: the spec of JAX's shard_params placement} on ``mesh``,
    from zeros of the tree's shapes."""
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    placed = jmesh.shard_params(zeros, mesh, rules)
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]:
        path = "/".join(str(getattr(k, "key", k)) for k in kp)
        out[path.removeprefix("params/")] = (tuple(leaf.sharding.spec),
                                             leaf.ndim)
    return out


def _expected_placements(spec, ndim, axes=("dp", "tp")):
    """JAX's spec on flax's layout as torch placements: a 2-D kernel's
    axis d is the weight's axis 1 − d; no leaf of another rank shards."""
    out = []
    for a in axes:
        dims = [d for d, s in enumerate(spec) if s == a]
        if not dims:
            out.append(Replicate())
            continue
        assert ndim in (1, 2), (spec, ndim)
        out.append(Shard(1 - dims[0] if ndim == 2 else dims[0]))
    return tuple(out)


@pytest.mark.parametrize("family", ["vggt", "sam", "dit"])
def test_partition_rules_and_placements_match_jax(family):
    """Every leaf of the tree: the port's ``partition_spec_for`` is JAX's,
    and the placement the port plans on a (2, 4) mesh is the spec JAX's
    ``shard_params`` gives the leaf, mapped through the (out, in) layout."""
    shapes = {"vggt": _jax_vggt, "sam": _jax_sam, "dit": _jax_dit}[family]()
    want = _jax_specs(shapes, jmesh.make_mesh(8))
    plan = tmesh.plan_placements(_port(family), SIZES)
    assert sorted(p.path for p in plan.values()) == sorted(want)
    n_sharded = 0
    for name, pl in plan.items():
        assert tmesh.partition_spec_for(pl.path) == \
            tuple(jmesh.partition_spec_for(pl.path)), pl.path
        spec, ndim = want[pl.path]
        assert pl.placements == _expected_placements(spec, ndim), pl.path
        n_sharded += pl.sharded
    assert n_sharded >= {"vggt": 16, "sam": 8, "dit": 20}[family]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_mesh_split_is_jax(n):
    assert tmesh.mesh_shape(n) == tuple(jmesh.make_mesh(n).shape.values())
    assert tmesh.mesh_shape(n, tp=1) == (n, 1)


@pytest.mark.parametrize("case", ["rank", "divide"])
def test_fallbacks_are_jax(case):
    """A spec naming more axes than the leaf replicates; so does an axis
    the mesh does not divide (the tiny DiT, width 64, on tp = 3: the
    attention and MLP kernels replicate, the AdaLN kernels (576 and 128
    outputs) shard)."""
    rules = tuple(jmesh.DEFAULT_RULES)
    if case == "rank":
        rules = ((r"x_in/bias$", jmesh.P("tp", "tp")),) + rules
        t_rules = ((r"x_in/bias$", ("tp", "tp")),) + tuple(tmesh.DEFAULT_RULES)
        mesh, sizes = jmesh.make_mesh(8), SIZES
    else:
        t_rules = tuple(tmesh.DEFAULT_RULES)
        mesh, sizes = jmesh.make_mesh(3, tp=3), {"dp": 1, "tp": 3}
    want = _jax_specs(_jax_dit(), mesh, rules)
    plan = tmesh.plan_placements(_port("dit"), sizes, t_rules)
    for pl in plan.values():
        assert pl.placements == _expected_placements(*want[pl.path]), pl.path
    if case == "rank":
        assert plan["x_in.bias"].placements == (Replicate(), Replicate())
    else:
        assert plan["block0.adaLN.weight"].placements == \
            (Replicate(), Shard(0))
        assert plan["block0.attn.q.weight"].placements == \
            (Replicate(), Replicate())


def test_make_mesh_needs_a_process_group():
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh()


def test_make_mesh_is_made_once_per_group(tmp_path):
    """One mesh per process group and tp (phase 6 asks at every call); a
    group started after the last one ended gets a mesh of its own."""
    import torch.distributed as dist
    meshes = []
    for i in range(2):
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s{i}",
                                rank=0, world_size=1)
        try:
            m = tmesh.make_mesh()
            assert tmesh.make_mesh() is m and tmesh.make_mesh(tp=1) is not m
            assert m.mesh_dim_names == ("dp", "tp") and tuple(m.shape) == (1, 1)
            meshes.append(m)
        finally:
            dist.destroy_process_group()
    assert meshes[0] is not meshes[1]


def test_dryrun_refuses_several_ranks_on_the_card():
    with pytest.raises(SystemExit, match="no error bound"):
        dryrun.main(["2", "--device", "cuda"])


def test_head_blocked_qkv_round_trip():
    """The fused qkv placement: rank r's rows are q, k, v of its heads."""
    w = torch.arange(3 * 8 * 2, dtype=torch.float32).reshape(3 * 8, 2)
    hb = tmesh._head_blocked(w, 4)
    blocks = hb.reshape(4, 3, 2, 2)            # rank, q|k|v, 2 features
    for r in range(4):
        for i in range(3):
            torch.testing.assert_close(blocks[r, i], w[8 * i + 2 * r:
                                                       8 * i + 2 * r + 2])
    torch.testing.assert_close(tmesh._unhead_blocked(hb, 4), w)


# ---------------------------------------------------------------------------
# the dry run on 4 gloo ranks


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four programs on 4 spawned gloo ranks, as a (2, 2) and a (4, 1)
    mesh, and, while they run, the JAX package's references: its one-device
    VGGT forward on the program's frames (the weights the dry run draws
    without fixtures, the port's flax-style init from seed 0, in JAX's
    tree through the bridge; the ranks load them),
    its ``fit_poses_sharded`` over the 8 virtual devices at b = 3 and 5,
    its one-device scene step on the (2, 2) mesh's inputs, and its DiT
    ``train_step`` over the 8 devices (:func:`_jax_dit_step`) from the
    weights, batch and draws the ranks load."""
    from concurrent.futures import ThreadPoolExecutor

    from regen3d_tpu.models.vggt import VGGT, VGGTConfig
    from regen3d_tpu_torch.models import vggt as tvggt
    from regen3d_tpu_torch.models.from_jax import tree_from_model

    out = tmp_path_factory.mktemp("dryrun")
    fixtures = out / "fixtures"
    fixtures.mkdir()
    jc = dataclasses.replace(VGGTConfig(**_fields(dryrun.vggt_config)),
                             dtype=jnp.float32)
    jm = VGGT(jc)
    tm = tvggt.VGGT(dryrun.vggt_config(torch.float32), device="cpu")
    tvggt.init_flax_style_(tm, torch.Generator().manual_seed(0))
    torch.save(tm.state_dict(), str(fixtures / "vggt.pt"))
    params = jax.tree_util.tree_map(np.array, tree_from_model(tm))
    dit = _dit_fixtures(fixtures)
    # JAX's compiles release the interpreter: the references overlap
    with ThreadPoolExecutor(4) as pool:
        done = pool.submit(dryrun.spawn, 4, "cpu", str(out), tps=(2, 1),
                           fixtures=str(fixtures), timeout=240)
        refs = dict(
            vggt=pool.submit(jax.jit(jm.apply), params,
                             jnp.asarray(dryrun.vggt_images())),
            fit3=pool.submit(_jax_sharded_fit, 3),
            scene=pool.submit(_jax_scene_step, jm, params, 4),
            dit=pool.submit(_jax_dit_step, *dit))
        refs = {k: f.result() for k, f in refs.items()}
        refs["fit5"] = _jax_sharded_fit(5)
        done.result()
    return out, refs


def _fields(config):
    c = config(torch.float32)
    return {f.name: getattr(c, f.name) for f in dataclasses.fields(c)
            if f.name != "dtype"}


def _drawn(shapes, seed):
    """A flax tree of ``shapes`` drawn from a numpy seed without compiling
    an init: kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.1²), every
    other leaf N(0, 0.1²) (so that every gradient is non-zero)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        x = rng.normal(size=leaf.shape)
        name = path[-1].key
        x = x / np.sqrt(leaf.shape[0]) if name == "kernel" else \
            1.0 + 0.1 * x if name == "scale" else 0.1 * x
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _dit_fixtures(fixtures, b=8):
    """The dry run's DiT in f32 with its leaves drawn (:func:`_drawn`), a
    batch of b from another seed and the draws of a key whose condition
    drop takes some but not all of the batch; written as the ranks'
    ``dit.pt`` and ``dit_batch.npz``. Returns (model, params, key, x0,
    cond) for JAX."""
    from regen3d_tpu.models import dit as jd
    from regen3d_tpu_torch.models.from_jax import state_from_jax
    from test_torch_dit import jax_draws

    jc = dataclasses.replace(jd.DiTConfig(**_fields(dryrun.dit_config)),
                             dtype=jnp.float32)
    params = _drawn(jax.eval_shape(
        jd.ShapeDiT(jc).init, jax.random.PRNGKey(0),
        jnp.zeros((1, jc.latent_tokens, jc.latent_dim)), jnp.zeros((1,)),
        jnp.zeros((1, 16, jc.cond_dim))), 0)
    torch.save(state_from_jax(params), str(fixtures / "dit.pt"))
    rng = np.random.default_rng(1)
    x0 = rng.standard_normal((b, jc.latent_tokens, jc.latent_dim)).astype(
        np.float32)
    cond = rng.standard_normal((b, 16, jc.cond_dim)).astype(np.float32)
    key = jax.random.PRNGKey(103)
    t, eps, drop = jax_draws(key, x0)
    assert 0 < drop.sum() < b
    np.savez(fixtures / "dit_batch.npz", x0=x0, cond=cond, t=t, eps=eps,
             drop=drop)
    return jd.ShapeDiT(jc), params, key, x0, cond


def _jax_dit_step(jm, params, key, x0, cond):
    """``dryrun_multichip``'s program 1: JAX's ``train_step`` jitted over the
    8 virtual devices as a (2, 4) mesh, the parameters placed by
    ``shard_params`` and the batch by ``data_sharding``; as the port's names
    and layout ({'loss', 'grads', 'params'}). The gradients are the step's
    own, read off AdamW's first moment after the first step: μ = (1 −
    b1)·g, so g = μ / (1 − b1) to f32 rounding (a second, separately
    compiled gradient would double the test's cost)."""
    import optax

    from regen3d_tpu.parallel import train as jt
    from regen3d_tpu_torch.models.from_jax import state_from_jax

    mesh = jmesh.make_mesh(8)
    assert dict(mesh.shape) == {"dp": 2, "tp": 4}
    opt = jt.make_optimizer(dryrun.LR)
    placed = jmesh.shard_params(params, mesh)
    state = jt.TrainState(placed, opt.init(placed), jnp.zeros((), jnp.int32))
    batch = jt.data_sharding(mesh)
    step = jax.jit(lambda s, x, c: jt.train_step(jm, opt, s, key, x, c))
    state, loss = step(state, jax.device_put(x0, batch),
                       jax.device_put(cond, batch))
    adam = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda s: isinstance(
            s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 1 and int(adam[0].count) == 1
    grads = jax.tree_util.tree_map(lambda m: np.asarray(m) / np.float32(0.1),
                                   jax.device_get(adam[0].mu))
    return dict(loss=torch.tensor(float(loss)), grads=state_from_jax(grads),
                params=state_from_jax(jax.device_get(state.params)))


def _load(out, mesh, program):
    return dict(np.load(out / f"{mesh}_{program}.npz"))


def _jax_sharded_fit(b):
    """JAX's ``fit_poses_sharded`` over the 8 virtual devices on the dry
    run's problem of b objects."""
    from regen3d_tpu.camera import lookat_camera
    from regen3d_tpu.pipeline.pose_fit import (
        FitConfig,
        ObjectBatch,
        PoseParams,
        fit_poses_sharded,
    )

    h = 32
    pr = dryrun.pose_problem(b)
    batch = ObjectBatch(
        verts=jnp.asarray(pr["verts"]), verts_mask=jnp.ones((b, 8), bool),
        faces=jnp.asarray(pr["faces"]), faces_mask=jnp.ones((b, 8), bool),
        target_mask=jnp.ones((b, h, h), jnp.float32) * 0.5,
        target_points=jnp.asarray(pr["points"]),
        points_mask=jnp.ones((b, 16), bool),
        pivot_R=jnp.broadcast_to(jnp.eye(3), (b, 3, 3)),
        pivot_t=jnp.zeros((b, 3)), on_floor=jnp.zeros(b, bool),
        object_valid=jnp.ones(b, bool),
        bbox_lo=jnp.asarray([-2.0, -2.0, -2.0]),
        bbox_hi=jnp.asarray([2.0, 2.0, 2.0]))
    cam = lookat_camera(np.asarray([0, 0, -3.0], np.float32),
                        np.zeros(3, np.float32), (h, h), focal_px=40.0)
    cfg = FitConfig(image_hw=(h, h), max_iterations=3,
                    early_stop_min_iters=0, record_history=False,
                    face_chunk=8, point_chunk=16)
    return fit_poses_sharded(PoseParams.zeros(b), batch, cam, cfg,
                             jmesh.make_mesh(8, tp=1))


def _jax_scene_step(jm, params, k):
    """JAX's one-device scene step on the dry run's inputs of k objects."""
    from regen3d_tpu.pipeline.pose_fit import FitConfig
    from regen3d_tpu.pipeline.scene_step import scene_step

    sp = dryrun.scene_problem(k)
    fit = FitConfig(image_hw=(28, 28), sigma=1e-4, max_iterations=2,
                    early_stop_min_iters=2, record_history=False,
                    face_chunk=8, point_chunk=16)
    return scene_step(params, jm, jnp.asarray(sp["images"]),
                      jnp.asarray(sp["masks"]), jnp.asarray(sp["verts"]),
                      jnp.ones((k, 8), bool), jnp.asarray(sp["faces"]),
                      jnp.ones((k, 12), bool), fit, num_points=16)


@pytest.mark.parametrize("mesh", ["2x2", "4x1"])
def test_sharded_fit_matches_jax(ranks, mesh):
    """The dry run's fit at b = 3 (padded to 4 objects over dp = 2 and 4)
    against JAX's ``fit_poses_sharded`` over the 8 virtual devices (losses
    rtol 1e-4, translations rtol 1e-3, JAX's own bounds)."""
    out, refs = ranks
    ref = refs["fit3"]
    got = _load(out, mesh, "pose_fit_b3")
    assert int(got["num_iters"]) == int(ref.num_iters)
    np.testing.assert_allclose(got["losses"], np.asarray(ref.losses),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["translation"],
                               np.asarray(ref.params.translation),
                               rtol=1e-3, atol=1e-5)


def test_sharded_fit_at_five_objects_is_jax_to_one_adam_step(ranks):
    """JAX's dry-run size on the (4, 1) mesh, b = dp + 1 = 5 (padded to 8):
    the port's fit and JAX's part by up to 1.05e-4 in one translation
    (0.8%), the two packages' rounding of the saturated silhouette term's
    gradient (ROADMAP Queue 3 g, bg): held to g's one Adam step (atol
    5e-3), and the losses to JAX's rtol 1e-4."""
    out, refs = ranks
    ref = refs["fit5"]
    got = _load(out, "4x1", "pose_fit_b5")
    assert int(got["num_iters"]) == int(ref.num_iters)
    np.testing.assert_allclose(got["losses"], np.asarray(ref.losses),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["translation"],
                               np.asarray(ref.params.translation), atol=5e-3)


@pytest.mark.parametrize("mesh", ["2x2", "4x1"])
def test_tp_vggt_matches_jax(ranks, mesh):
    """The tp VGGT forward against JAX's one-device forward (depth and pose
    encoding rtol 1e-4, atol 1e-5)."""
    out, refs = ranks
    got = _load(out, mesh, "vggt")
    for k in ("depth", "pose_enc"):
        np.testing.assert_allclose(got[k], np.asarray(refs["vggt"][k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_scene_step_matches_jax(ranks):
    """The fused scene step over the (2, 2) mesh (tp VGGT, 4 objects over
    dp) against JAX's one-device step on JAX's dry-run inputs: depth rtol
    1e-4, atol 1e-5; posed vertices rtol 1e-3, atol 5e-3 (the fit
    amplifies the depth's rounding). The (4, 1) mesh's step is held to
    the port's one-device step by the ranks (the same bounds)."""
    out, refs = ranks
    ref = refs["scene"]
    got = _load(out, "2x2", "scene_step")
    np.testing.assert_allclose(got["depth"], np.asarray(ref.depth),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["verts_world"],
                               np.asarray(ref.verts_world), rtol=1e-3,
                               atol=5e-3)


def _dit_side(out, mesh, prefix):
    """One side of the ranks' DiT step ('' the sharded, 'ref_' the port's
    unsharded) as {'loss', 'grads', 'params'}."""
    t = {k: torch.from_numpy(v) for k, v in _load(out, mesh, "dit").items()}
    return dict(loss=t[f"{prefix}loss"],
                grads={k.split("/", 1)[1]: v for k, v in t.items()
                       if k.startswith(f"{prefix}grad/")},
                params={k.split("/", 1)[1]: v for k, v in t.items()
                        if k.startswith(f"{prefix}param/")})


@pytest.mark.parametrize("mesh", ["2x2", "4x1"])
def test_dit_step_matches_the_unsharded_step(ranks, mesh):
    """The dp × tp step against the unsharded one, from the rank's arrays:
    loss and gradients within 1e-5 of max |·|, parameters after one AdamW
    step within 2·lr, and within 1e-6 where |g| > 1e-4·max |g|."""
    out, _ = ranks
    ref, got = _dit_side(out, mesh, "ref_"), _dit_side(out, mesh, "")
    assert len(ref["grads"]) == len(got["grads"]) > 30
    errs = dryrun.check_dit(ref, got, exact=False)
    assert errs["grads"] > 0 or mesh == "4x1"    # the tp sums reorder


@pytest.mark.parametrize("mesh", ["2x2", "4x1"])
def test_dit_step_matches_jax(ranks, mesh):
    """The port's dp × tp step against JAX's ``train_step`` over a (2, 4)
    mesh of the 8 virtual devices (``dryrun_multichip``'s program 1), from
    the same weights, batch and draws: loss and every gradient within 1e-5
    of max |·|, parameters after one AdamW step within 2·lr, and within
    1e-6 where |g| > 1e-4·max |g|."""
    out, refs = ranks
    got, ref = _dit_side(out, mesh, ""), refs["dit"]
    assert sorted(got["grads"]) == sorted(ref["grads"])
    dryrun.check_dit(ref, got, exact=False)


def test_phase6_takes_the_sharded_fit_under_several_ranks(monkeypatch):
    import torch.distributed as dist

    from regen3d_tpu_torch.pipeline import phase6_pose

    assert phase6_pose.fit_path({}) == "padded"
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 4)
    assert phase6_pose.fit_path({}) == "sharded"
    assert phase6_pose.fit_path({"shard_pose_fit": False}) == "padded"
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 1)
    assert phase6_pose.fit_path({}) == "padded"


# ---------------------------------------------------------------------------
# the fleet


def test_shard_jobs_partitions_exactly():
    from regen3d_tpu.parallel.fleet import SceneJob as JJob
    from regen3d_tpu.parallel.fleet import shard_jobs as jshard
    from regen3d_tpu_torch.parallel.fleet import SceneJob, shard_jobs

    jobs = [SceneJob(f"s{i}", f"i{i}.png", f"o{i}") for i in range(7)]
    jjobs = [JJob(f"s{i}", f"i{i}.png", f"o{i}") for i in range(7)]
    for pcount in (1, 2, 3, 8):
        shards = [shard_jobs(jobs, p, pcount) for p in range(pcount)]
        ids = [j.scene_id for s in shards for j in s]
        assert sorted(ids) == sorted(j.scene_id for j in jobs), pcount
        assert len(ids) == len(set(ids)), pcount
        assert [[j.scene_id for j in s] for s in shards] == \
            [[j.scene_id for j in jshard(jjobs, p, pcount)]
             for p in range(pcount)]
    with pytest.raises(ValueError):
        shard_jobs(jobs, 2, 2)


def test_run_fleet_slices_and_isolates(tmp_path):
    """Injected process slicing runs only that rank's share (round robin);
    a scene with a missing input fails alone; without a process group the
    fleet is rank 0 of 1."""
    import os

    from regen3d_tpu_torch.parallel.fleet import SceneJob, run_fleet
    from regen3d_tpu_torch.utils.image import save_image

    img = np.full((32, 32, 3), 210, np.uint8)
    img[8:24, 8:24] = (170, 60, 40)
    jobs = []
    for i in range(3):
        p = str(tmp_path / f"scene{i}.png")
        save_image(p, img)
        jobs.append(SceneJob(f"s{i}", p, str(tmp_path / f"out{i}")))
    jobs[1] = SceneJob("bad", str(tmp_path / "missing.png"),
                       str(tmp_path / "out_bad"))
    r0 = run_fleet(jobs, phases=[1], process_index=0, process_count=2,
                   device="cpu")
    r1 = run_fleet(jobs, phases=[1], process_index=1, process_count=2,
                   device="cpu")
    assert [r.scene_id for r in r0] == ["s0", "s2"]
    assert [r.scene_id for r in r1] == ["bad"]
    assert all(r.ok for r in r0)
    assert not r1[0].ok and "missing.png" in r1[0].error
    assert [i for i in (0, 2) if os.path.isdir(
        str(tmp_path / f"out{i}" / "findings"))] == [0, 2]
    assert [r.scene_id for r in run_fleet(jobs[:1], phases=[1],
                                          device="cpu")] == ["s0"]


def test_run_fleet_refuses_a_sharded_fit_across_scenes(tmp_path,
                                                       monkeypatch):
    """Ranks of a fleet run different scenes: a scene that asks for
    ``shard_pose_fit`` fails alone, before any phase runs, naming the key;
    the others run with it set false. One rank leaves the key alone."""
    from regen3d_tpu_torch.parallel import fleet

    seen = []
    monkeypatch.setattr(fleet, "run_phases", lambda cfg, phases, device:
                        seen.append(cfg.get("shard_pose_fit")))
    jobs = [fleet.SceneJob("a", "a.png", str(tmp_path / "a")),
            fleet.SceneJob("b", "b.png", str(tmp_path / "b"),
                           overrides=dict(shard_pose_fit=True))]
    res = fleet.run_fleet(jobs, phases=[6], device="cpu")
    assert [r.ok for r in res] == [True, True] and seen == [None, True]
    seen.clear()
    res = fleet.run_fleet(jobs + jobs, phases=[6], process_index=0,
                          process_count=2, device="cpu")
    assert [(r.scene_id, r.ok) for r in res] == [("a", True), ("a", True)]
    assert seen == [False, False]
    res = fleet.run_fleet(jobs, phases=[6], process_index=1,
                          process_count=2, device="cpu")
    assert not res[0].ok and "shard_pose_fit" in res[0].error
    assert seen == [False, False]


# ---------------------------------------------------------------------------
# utils/synthgt


@pytest.mark.parametrize("masked", [False, True])
def test_triangulate_depth_frame_is_jax_byte_for_byte(tmp_path, masked):
    from regen3d_tpu.utils.synthgt import triangulate_depth_frame as jtri
    from regen3d_tpu_torch.utils.synthgt import triangulate_depth_frame

    rng = np.random.default_rng(3)
    h, w = 12, 16
    depth = 2.0 + rng.random((h, w)).astype(np.float32) * 0.1
    depth[3:8, 4:9] = 1.2                          # a foreground box
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    pts = np.stack([(u - w / 2) / 20 * depth, (v - h / 2) / 20 * depth,
                    depth], -1).reshape(-1, 3)
    frame = dict(points=pts, width=w, height=h)
    mask = np.zeros((h, w), bool)
    mask[2:10, 3:11] = True
    kw = dict(mask=mask) if masked else {}
    jtri(frame, str(tmp_path / "j.glb"), **kw)
    triangulate_depth_frame(frame, str(tmp_path / "t.glb"), **kw)
    assert (tmp_path / "t.glb").read_bytes() == \
        (tmp_path / "j.glb").read_bytes()


# ---------------------------------------------------------------------------
# ROADMAP Queue 3 be: the backward kernels' head widths


def _head_dims(model):
    from regen3d_tpu_torch.models.layers import Attention, FusedAttention
    dims = set()
    for mod in model.modules():
        if isinstance(mod, Attention):
            dims.add(mod.q.weight.shape[0] // mod.num_heads)
        elif isinstance(mod, FusedAttention):
            dims.add(mod.proj.weight.shape[0] // mod.num_heads)
    return dims


def test_runner_head_widths_have_backward_kernels():
    """The head widths the five runners train at their defaults (and the
    matting net at ``--base`` 4 and 8, the CPU recipe's) all have a
    backward kernel; ``_check_kernel_inputs`` takes D = 4 and 8."""
    from regen3d_tpu_torch import distill
    from regen3d_tpu_torch.models import detector, saliency, unet
    from regen3d_tpu_torch.models.depth_anything import DepthAnything
    from regen3d_tpu_torch.models.dit import ShapeDiT
    from regen3d_tpu_torch.ops import attention as att
    from regen3d_tpu_torch.pipeline import (
        depth_distill,
        detector_distill,
        saliency_distill,
        shape_distill,
    )

    d = {k: distill.parse([k, "--out", "x"]) for k in
         ("detector", "saliency", "depth", "matting")}
    dims = {
        "detector": _head_dims(detector.OpenVocabDetector(
            detector_distill.distill_config(d["detector"].size),
            device="meta")),
        "saliency": _head_dims(saliency.SaliencyTransformer(
            saliency_distill.small_config(d["saliency"].size),
            device="meta")),
        "depth": _head_dims(DepthAnything(
            depth_distill.micro_config(d["depth"].size), device="meta")),
        "matting": set().union(*(_head_dims(unet.MattingUNet(
            base=b, device="meta")) for b in (d["matting"].base, 8, 4))),
    }
    small = shape_distill.DistillConfig.small()
    dims["shape"] = set().union(*(_head_dims(m) for m in (
        small.cond_encoder("meta"), ShapeDiT(small.dit, device="meta"),
        shape_distill.ShapeEncoder(small.vae, device="meta"),
        shape_distill.ShapeDecoder(small.vae, device="meta"))))
    for kind, ds in dims.items():
        assert ds and ds <= set(att.KERNEL_HEAD_DIMS), (kind, ds)
    assert dims["matting"] == {32, 8, 4}
    for d in (4, 8):
        att._check_kernel_inputs("flash_bwd_dq", d, att.KERNEL_HEAD_DIMS, ())
