"""Port silhouettes vs the JAX package: bins, edge coefficients, the edge
tile function (plain version of the CUDA kernels) against the Pallas kernel
in interpret mode, the plain edge path and the streaming SoftRas; and the
kernels' exact cull (silhouette_cull_plain) against the plain versions.

Tolerances: f32 on both sides. Alpha atol 1e-5 (sum order over faces);
vertex gradients rtol 1e-3 / atol 2e-6, the bound the JAX package holds its
own Pallas gradients to (tests/test_pallas_rasterize.py). The cull is held
to bit equality: a culled pair must add exactly 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from regen3d_tpu.camera import Camera as JCamera
from regen3d_tpu.ops import pallas_rasterize as jpr
from regen3d_tpu.ops import rasterize as jr
from regen3d_tpu_torch.camera import Camera
from regen3d_tpu_torch.ops import rasterize as tr
from regen3d_tpu_torch.ops import silhouette_kernel as tk
from test_torch_package import one_torch_thread  # noqa: F401

H = W = 128


def _cams():
    jc = JCamera(R=jnp.eye(3), T=jnp.zeros(3), focal=jnp.asarray([128.0, 128.0]),
                 principal=jnp.asarray([W / 2.0, H / 2.0]), image_size=(H, W))
    tc = Camera(R=torch.eye(3), T=torch.zeros(3),
                focal=torch.tensor([128.0, 128.0]),
                principal=torch.tensor([W / 2.0, H / 2.0]), image_size=(H, W))
    return jc, tc


def _meshes(seed, b=2, n_faces=48):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(b, n_faces, 3, 3)).astype(np.float32) * 0.08
    v += rng.uniform(-0.5, 0.5, size=(b, n_faces, 1, 3)).astype(np.float32)
    v += np.asarray([0, 0, 2.5], np.float32)
    f = np.tile(np.arange(n_faces * 3, dtype=np.int32).reshape(-1, 3), (b, 1, 1))
    mask = rng.random((b, n_faces)) > 0.2
    return v.reshape(b, -1, 3), f, mask


def _screen(v):
    """The same screen vertices for both sides: at sigma 1e-5 one ulp of a
    vertex moves alpha by ~1e-5, so the projection is held apart (the
    gradient tests below go through both cameras)."""
    jc, _ = _cams()
    vs = np.stack([np.asarray(jc.view_to_screen(jnp.asarray(x))) for x in v])
    return vs, torch.from_numpy(vs)


@pytest.mark.parametrize("faces_per_tile,margin", [(16, 0.0), (48, 8.0)])
def test_bins_identical_including_ties(faces_per_tile, margin):
    v, f, mask = _meshes(0)
    vs_j, vs_t = _screen(v)
    idx_t, val_t = tr.compute_silhouette_bins(
        vs_t, torch.from_numpy(f), (H, W), 1e-5, torch.from_numpy(mask),
        tile=32, faces_per_tile=faces_per_tile, margin_px=margin)
    for b in range(v.shape[0]):
        idx_j, val_j = jr.compute_silhouette_bins(
            jnp.asarray(vs_j[b]), jnp.asarray(f[b]), (H, W), 1e-5,
            jnp.asarray(mask[b]), tile=32, faces_per_tile=faces_per_tile,
            margin_px=margin)
        np.testing.assert_array_equal(idx_t[b].numpy(), np.asarray(idx_j))
        np.testing.assert_array_equal(val_t[b].numpy(), np.asarray(val_j))
        if faces_per_tile == 16:
            # some bin is full, so which overlapping faces it keeps
            # depends on the tie order
            assert np.asarray(val_j).all(axis=1).any()


def test_face_edge_coeffs():
    rng = np.random.default_rng(1)
    tri = rng.normal(size=(64, 3, 2)).astype(np.float32)
    tri[0, 1] = tri[0, 0]                      # a degenerate edge
    want = np.asarray(jr.face_edge_coeffs(jnp.asarray(tri)))
    got = tr.face_edge_coeffs(torch.from_numpy(tri)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


# At sigma 1e-5, z = d·|d|/σ amplifies the last-bit difference of an edge
# value (a small difference of O(1) terms, which XLA may contract into an
# FMA) to ~2e-5 in alpha at a few pixels; the JAX package holds its own
# kernel to 1e-4 there (tests/test_pallas_rasterize.py).
SIGMA_ATOL = [(1e-5, 1e-4), (1e-4, 1e-5)]


@pytest.mark.parametrize("sigma,atol", SIGMA_ATOL)
def test_tile_function_forward_vs_pallas(sigma, atol):
    v, f, mask = _meshes(2)
    vs_j, vs_t = _screen(v)
    got = tk.soft_silhouette_edge_kernel(
        vs_t, torch.from_numpy(f), (H, W), sigma=sigma,
        faces_mask=torch.from_numpy(mask), faces_per_tile=48)
    for b in range(v.shape[0]):
        want = jpr.soft_silhouette_edge_pallas(
            jnp.asarray(vs_j[b]), jnp.asarray(f[b]), (H, W), sigma=sigma,
            faces_mask=jnp.asarray(mask[b]), faces_per_tile=48, interpret=True)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want), atol=atol)
    assert got.min() >= 0 and got.max() > 0.5


def test_tile_function_gradients_vs_pallas():
    v, f, _ = _meshes(3, n_faces=24)
    jc, tc = _cams()

    def loss_j(x, b):
        return jnp.mean(jpr.soft_silhouette_edge_pallas(
            jc.view_to_screen(x), jnp.asarray(f[b]), (H, W), sigma=1e-4,
            faces_per_tile=24, interpret=True))

    vt = torch.from_numpy(v).requires_grad_()
    alpha = tk.soft_silhouette_edge_kernel(
        tc.view_to_screen(vt), torch.from_numpy(f), (H, W), sigma=1e-4,
        faces_per_tile=24)
    alpha.mean((1, 2)).sum().backward()
    for b in range(v.shape[0]):
        want = np.asarray(jax.grad(loss_j)(jnp.asarray(v[b]), b))
        np.testing.assert_allclose(vt.grad[b].numpy(), want, atol=2e-6,
                                   rtol=1e-3)


def test_plain_backward_routes_ties_left_to_right():
    """Equal edge values send the gradient to the first of them."""
    k = 8
    coeffs = torch.zeros(1, 3 * k, 3)
    coeffs[0, :, 2] = 0.01                    # three equal edges per face
    valid = torch.zeros(1, k)
    valid[0, 0] = 1.0
    nvalid = torch.tensor([1], dtype=torch.int32)
    uv = torch.zeros(1, 2)
    g = torch.ones(1, tk.P)
    dc = tk.silhouette_tiles_bwd(nvalid, coeffs, valid, uv, g, 1e4, 0.01)
    assert dc[0, 0, 2] != 0
    assert torch.all(dc[0, k] == 0) and torch.all(dc[0, 2 * k] == 0)
    assert torch.all(dc[0, 1:k] == 0)


@pytest.mark.parametrize("sigma,atol", SIGMA_ATOL)
def test_plain_edge_path_matches_jax(sigma, atol):
    v, f, mask = _meshes(4)
    vs_j, vs_t = _screen(v)
    got = tr.soft_silhouette_edge(vs_t, torch.from_numpy(f), (H, W),
                                  sigma=sigma, faces_mask=torch.from_numpy(mask),
                                  tile=32, faces_per_tile=48)
    for b in range(v.shape[0]):
        want = jr.soft_silhouette_edge(
            jnp.asarray(vs_j[b]), jnp.asarray(f[b]), (H, W), sigma=sigma,
            faces_mask=jnp.asarray(mask[b]), tile=32, faces_per_tile=48)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want), atol=atol)


def test_streaming_soft_silhouette_forward_and_gradient():
    hw = (40, 48)
    v, f, mask = _meshes(5, n_faces=20)
    jc = JCamera(R=jnp.eye(3), T=jnp.zeros(3), focal=jnp.asarray([40.0, 40.0]),
                 principal=jnp.asarray([24.0, 20.0]), image_size=hw)
    tc = Camera(R=torch.eye(3), T=torch.zeros(3), focal=torch.tensor([40.0, 40.0]),
                principal=torch.tensor([24.0, 20.0]), image_size=hw)
    target = (np.random.default_rng(6).random(hw) > 0.5).astype(np.float32)

    def loss_j(x, b):
        a = jr.soft_silhouette(jc.view_to_screen(x), jnp.asarray(f[b]), hw,
                               sigma=1e-4, faces_mask=jnp.asarray(mask[b]),
                               chunk=8)
        return jnp.sum(a * target), a

    vt = torch.from_numpy(v).requires_grad_()
    a_t = tr.soft_silhouette(tc.view_to_screen(vt), torch.from_numpy(f), hw,
                             sigma=1e-4, faces_mask=torch.from_numpy(mask),
                             chunk=8)
    (a_t * torch.from_numpy(target)).sum().backward()
    for b in range(v.shape[0]):
        (_, a_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(
            jnp.asarray(v[b]), b)
        np.testing.assert_allclose(a_t[b].detach().numpy(), np.asarray(a_j),
                                   atol=1e-5)
        np.testing.assert_allclose(vt.grad[b].numpy(), np.asarray(g_j),
                                   rtol=1e-3, atol=1e-4)


# ---- the kernels' exact cull -------------------------------------------


def test_cut_gives_exact_zeros():
    """At and below Z_CUT, f32 exp, softplus and sigmoid are exactly 0, in
    torch's functions and in the kernels' forms; an edge value of −r gives
    z ≤ Z_CUT at the σ the fits use."""
    z = torch.tensor([tk.Z_CUT, tk.Z_CUT - 0.5, -110.0, -1e3, -1e30,
                      -float("inf")], dtype=torch.float32)
    for out in (torch.exp(z), F.softplus(z), torch.sigmoid(z),
                torch.clamp(z, min=0) + torch.log1p(torch.exp(-z.abs())),
                1.0 / (1.0 + torch.exp(-z))):
        assert torch.all(out == 0), out
    # just above the cut the terms are not all 0: the cut is not loose
    assert F.softplus(torch.tensor(-100.0)) > 0
    for sigma in (5e-7, 1e-5, 1e-4, 1e-2):
        inv_sigma, _ = tk.tile_consts((1024, 1024), sigma)
        r = tk.silhouette_cull_radius(inv_sigma)
        d = -r * torch.tensor([1.0, 1.5, 4.0, 1e3], dtype=torch.float32)
        zr = d * d.abs() * np.float32(inv_sigma)
        assert torch.all(zr <= tk.Z_CUT), (sigma, zr)
        # r is within 0.2% of the exact radius: the cull is tight
        assert r < 1.002 * np.sqrt(-tk.Z_CUT / inv_sigma)


def _fwd_plain_keeping(nvalid, coeffs, valid, tile_uv, inv_sigma, ndc, keep):
    """silhouette_tiles_fwd_plain with the pairs that ``keep`` drops set to
    0 before the sum over faces."""
    n, k = valid.shape
    pu, pv = tk._base_pix(ndc, coeffs.device)
    kp = keep[:, :, tk.pixel_blocks()]
    acc = torch.zeros(n, tk.P)
    rows = torch.nonzero(nvalid > 0).flatten()
    for s in range(0, rows.numel(), tk._PLAIN_BLOCKS):
        r = rows[s:s + tk._PLAIN_BLOCKS]
        e = tk._edges(coeffs[r], tile_uv[r % tile_uv.shape[0]], pu, pv)
        dmin = torch.minimum(e[:, :k], torch.minimum(e[:, k:2 * k],
                                                     e[:, 2 * k:]))
        z = dmin * dmin.abs() * inv_sigma
        contrib = valid[r][:, :, None] * F.softplus(z)
        acc[r] = -torch.where(kp[r], contrib, torch.zeros_like(contrib)).sum(1)
    return acc


def _bwd_plain_keeping(nvalid, coeffs, valid, tile_uv, g, inv_sigma, ndc,
                       keep):
    """silhouette_tiles_bwd_plain with the pairs that ``keep`` drops set to
    0 before the routing and the sums over pixels."""
    n, k = valid.shape
    pu, pv = tk._base_pix(ndc, coeffs.device)
    kp = keep[:, :, tk.pixel_blocks()]
    dc = torch.zeros_like(coeffs)
    rows = torch.nonzero(nvalid > 0).flatten()
    for s in range(0, rows.numel(), tk._PLAIN_BLOCKS):
        r = rows[s:s + tk._PLAIN_BLOCKS]
        uv = tile_uv[r % tile_uv.shape[0]]
        e = tk._edges(coeffs[r], uv, pu, pv)
        e0, e1, e2 = e[:, :k], e[:, k:2 * k], e[:, 2 * k:]
        dmin = torch.minimum(e0, torch.minimum(e1, e2))
        z = dmin * dmin.abs() * inv_sigma
        sv = (g[r][:, None, :] * (-torch.sigmoid(z))
              * (2.0 * dmin.abs() * inv_sigma) * valid[r][:, :, None])
        sv = torch.where(kp[r], sv, torch.zeros_like(sv))
        m0 = (e0 == dmin).float()
        m1 = torch.where(e1 == dmin, 1.0 - m0, torch.zeros_like(m0))
        m2 = torch.clamp(1.0 - m0 - m1, min=0.0)
        S = torch.cat([sv * m0, sv * m1, sv * m2], 1)
        rowsum = S.sum(-1)
        du = (S * pu).sum(-1) + uv[:, None, 0] * rowsum
        dv = (S * pv).sum(-1) + uv[:, None, 1] * rowsum
        dc[r] = torch.stack([du, dv, rowsum], -1)
    return dc


def _cull_batch(sigma, k=48):
    """Tile inputs at 128² for two objects of slivers (long, thin, with an
    acute tip whose corner sector reaches far: beyond the tip both long
    edges are within a pixel over tens of pixels) and small random faces,
    binned with a 32-px margin, plus one object whose faces have two equal
    edges (a tie at every pixel, routed to the first) and a third edge far
    inside."""
    rng = np.random.default_rng(7)
    b = 2
    tris = []
    for _ in range(b):
        for i in range(k):
            c = rng.uniform(10, 118, 2)
            if i % 2 == 0:
                ang = rng.uniform(0, 2 * np.pi)
                length, half = rng.uniform(20, 60), rng.uniform(0.2, 1.0)
                dv = np.array([np.cos(ang), np.sin(ang)])
                nv = np.array([-dv[1], dv[0]])
                tris.append([c, c + length * dv + half * nv,
                             c + length * dv - half * nv])
            else:
                tris.append(list(c + rng.normal(size=(3, 2)) * 6))
    tri = np.asarray(tris, np.float32).reshape(b, k * 3, 2)
    vs = torch.from_numpy(np.concatenate(
        [tri, np.full((b, k * 3, 1), 2.5, np.float32)], -1))
    faces = torch.arange(k * 3, dtype=torch.int32).reshape(k, 3)
    faces = faces[None].expand(b, k, 3).contiguous()
    bins = tr.compute_silhouette_bins(vs, faces, (H, W), sigma, tile=32,
                                      faces_per_tile=k, margin_px=32.0)
    co, nvalid, va, uv = tk.edge_tile_inputs(vs, faces, (H, W), sigma,
                                             faces_per_tile=k, bins=bins)
    # the tie object: edges 0 and 1 one line through or near the tile
    t = uv.shape[0]
    ang = rng.uniform(0, 2 * np.pi, (t, k))
    ab = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    centre = uv.numpy()[:, None, :] + rng.uniform(-0.1, 0.6, (t, k, 2))
    c = -(ab * centre).sum(-1, dtype=np.float32)
    line = np.concatenate([ab, c[..., None]], -1).astype(np.float32)
    far = np.broadcast_to(np.float32([0.0, 0.0, 1.0]), line.shape)
    tie = torch.from_numpy(np.concatenate([line, line, far], 1).copy())
    co = torch.cat([co, tie])
    va = torch.cat([va, torch.ones(t, k)])
    nvalid = torch.cat([nvalid, torch.full((t,), k, dtype=torch.int32)])
    g = torch.from_numpy(rng.normal(size=(co.shape[0], tk.P))
                         .astype(np.float32))
    return co, nvalid, va, uv, g


@pytest.mark.parametrize("sigma", [5e-7, 1e-4])
def test_cull_leaves_plain_versions_bit_identical(sigma):
    """Zeroing the pairs silhouette_cull_plain drops leaves the plain
    forward's acc and the plain backward's dc bit for bit unchanged, while
    it drops most pairs."""
    co, nvalid, va, uv, g = _cull_batch(sigma)
    consts = tk.tile_consts((H, W), sigma)
    keep = tk.silhouette_cull_plain(nvalid, co, va, uv, *consts)
    assert keep.shape == (co.shape[0], va.shape[1], 16)
    share = float(keep.sum()) / float((va > 0).sum() * 16)
    assert 0.01 < share < 0.5, share
    acc = tk.silhouette_tiles_fwd_plain(nvalid, co, va, uv, *consts)
    assert torch.equal(_fwd_plain_keeping(nvalid, co, va, uv, *consts, keep),
                       acc)
    dc = tk.silhouette_tiles_bwd_plain(nvalid, co, va, uv, g, *consts)
    assert torch.equal(_bwd_plain_keeping(nvalid, co, va, uv, g, *consts,
                                          keep), dc)
    # the tie object's gradient reaches edge 0 and never edge 1
    k = va.shape[1]
    tie = dc[-uv.shape[0]:]
    assert bool((tie[:, :k] != 0).any()) and bool((tie[:, k:] == 0).all())
    assert acc.min() < -1.0 and bool((acc[:-uv.shape[0]] < 0).any())


@pytest.mark.parametrize("sigma", [5e-7, 1e-4])
def test_cull_with_half_the_radius_changes_acc(sigma):
    """The negative control: the same check with the radius halved drops
    pairs whose terms are not 0, so acc changes."""
    co, nvalid, va, uv, _ = _cull_batch(sigma)
    consts = tk.tile_consts((H, W), sigma)
    r = tk.silhouette_cull_radius(consts[0])
    keep = tk.silhouette_cull_plain(nvalid, co, va, uv, *consts,
                                    radius=r / np.float32(2))
    acc = tk.silhouette_tiles_fwd_plain(nvalid, co, va, uv, *consts)
    assert not torch.equal(
        _fwd_plain_keeping(nvalid, co, va, uv, *consts, keep), acc)


@pytest.mark.parametrize("sigma", [5e-7, 1e-4])
def test_cull_keeps_every_live_pair(sigma):
    """chip_smoke's pair count on the CPU: every pair with z > Z_CUT lies in
    a kept block (sil_pairs raises otherwise), and the kept pairs are fewer
    than the binned ones."""
    import chip_smoke

    co, nvalid, va, uv, _ = _cull_batch(sigma)
    pairs = chip_smoke.sil_pairs(tk, nvalid, co, va, uv,
                                 *tk.tile_consts((H, W), sigma))
    assert 0 < pairs["live"] <= pairs["kept"] < pairs["binned"]
    assert pairs["binned"] == int((va != 0).sum()) * tk.P
    assert 0 < pairs["block_faces"] <= va.shape[1]
    assert 0 < pairs["row_pairs"] <= pairs["kept"]
    assert nvalid[pairs["busiest"]] > 0
