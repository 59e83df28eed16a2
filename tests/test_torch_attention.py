"""Port flash attention (plain versions of the CUDA kernels) vs the JAX
Pallas kernels in interpret mode: ragged Sq/Sk including S = 2, head dims 64
and 128 (VGGT) and 32 and 16 (SAM's mask decoder: 11 prompt tokens against
image tokens and back), f32, atol 1e-5. The backward (the autograd Function
with the dq and dkv kernels' plain versions) against ``jax.grad`` through
the Pallas custom VJP and against torch autograd of ``attention_reference``,
atol = rtol = 5e-4 as the JAX package's own gradient test; the same for
the grid-bias op over all five arguments, dbias_h and dbias_w compared apart
from dq. Also the kernel wrapper's refusals on the CPU side, and the bounds
``chip_smoke.fwd_error``, ``chip_smoke.bwd_error`` and
``chip_smoke.gb_bwd_error`` hold the card's forward kernel and its flash and
grid-bias backward kernels to, pinned from both sides with torch models of
their bf16 rounding."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

from regen3d_tpu.ops.attention import flash_attention as jax_flash
from regen3d_tpu.ops.attention import flash_attention_grid_bias
from regen3d_tpu_torch.ops.attention import (
    attention_abs_terms_reference,
    attention_reference,
    flash_attention,
    flash_attention_fwd,
    flash_attention_grid_bias as port_grid_bias,
    flash_attention_grid_bias_fwd,
    flash_bwd_abs_terms_reference,
    flash_bwd_dkv_reference,
    flash_bwd_dq_reference,
    grid_bias_abs_terms_reference,
    grid_bias_bwd_abs_terms_reference,
    grid_bias_bwd_dkv_reference,
    grid_bias_bwd_dq_reference,
    grid_bias_reference,
)
from test_torch_package import one_torch_thread  # noqa: F401
from test_torch_sam import _grid_problem


@pytest.mark.parametrize("sq,sk,d", [(37, 37, 64), (40, 37, 128), (2, 2, 128),
                                     (5, 2, 64), (11, 11, 32), (11, 70, 16),
                                     (70, 11, 16)])
def test_flash_attention_matches_pallas(sq, sk, d):
    rng = np.random.default_rng(sq * 100 + sk + d)
    q = rng.normal(size=(2, 3, sq, d)).astype(np.float32)
    k = rng.normal(size=(2, 3, sk, d)).astype(np.float32)
    v = rng.normal(size=(2, 3, sk, d)).astype(np.float32)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                interpret=True))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_lse_is_the_row_logsumexp():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 9, 64)).astype(np.float32))
               for _ in range(3))
    o, lse = flash_attention_fwd(q, k, v, scale=0.3)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * 0.3
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1))
    torch.testing.assert_close(o, torch.softmax(logits, -1) @ v)
    torch.testing.assert_close(attention_reference(q, k, v, 0.3)[0], o)


def test_rejects_mismatched_shapes():
    q = torch.zeros(1, 2, 4, 64)
    with pytest.raises(ValueError, match="shapes"):
        flash_attention(q, torch.zeros(1, 2, 4, 32), torch.zeros(1, 2, 4, 32))


@pytest.mark.parametrize("sq,sk,d,bq,bk", [(24, 24, 16, 8, 8),
                                           (33, 19, 16, 16, 8)])
def test_flash_backward_matches_jax_grad(sq, sk, d, bq, bk):
    """The first case is the JAX package's own gradient test's shape; the
    second is unaligned, Sq != Sk, with padded q and kv tiles on the JAX
    side (the port's kernels mask instead)."""
    rng = np.random.default_rng(sq + sk)
    q, k, v = (rng.normal(size=(1, 2, s, d)).astype(np.float32)
               for s in (sq, sk, sk))

    def f(q, k, v):
        return jnp.sum(jax_flash(q, k, v, None, bq, bk, True) ** 2)

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o, lse = flash_attention_fwd(tq, tk, tv)
    (o ** 2).sum().backward()
    for got, w, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=5e-4,
                                   rtol=5e-4, err_msg=name)
    # the Function's backward is exactly the two plain versions
    with torch.no_grad():
        g = 2 * o
        delta = (o * g).sum(-1)
        scale = d ** -0.5
        dq = flash_bwd_dq_reference(tq, tk, tv, g, lse, delta, scale)
        dk, dv = flash_bwd_dkv_reference(tq, tk, tv, g, lse, delta, scale)
    for got, ref in ((tq.grad, dq), (tk.grad, dk), (tv.grad, dv)):
        torch.testing.assert_close(got, ref, atol=0, rtol=0)


def test_flash_backward_matches_torch_autograd_of_reference():
    """A non-contiguous upstream gradient (a transposed view), as the
    attention layers' head merge gives it."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 3, s, 32))
                                .astype(np.float32)).requires_grad_()
               for s in (21, 40, 40))
    w = torch.from_numpy(rng.normal(size=(2, 21, 3, 32)).astype(np.float32))

    def loss(o):
        return (o.transpose(1, 2) * w).sum()

    loss(flash_attention(q, k, v)).backward()
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    loss(attention_reference(q, k, v)[0]).backward()
    for a, t, name in zip(got, (q, k, v), "qkv"):
        np.testing.assert_allclose(a.numpy(), t.grad.numpy(), atol=5e-4,
                                   rtol=5e-4, err_msg=name)


def test_lse_is_not_differentiable():
    q = torch.zeros(1, 1, 3, 16, requires_grad=True)
    _, lse = flash_attention_fwd(q, q, q)
    assert not lse.requires_grad


@pytest.mark.parametrize("b,h,kh,kw,d,block_q", [(2, 3, 4, 8, 8, 8),
                                                 (2, 2, 14, 14, 8, 64)])
def test_grid_bias_backward_matches_jax_grad(b, h, kh, kw, d, block_q):
    """The first case is the JAX package's own five-argument gradient test's
    shape; the second the 14×14 window, padded on the JAX side. The bias
    gradients are compared on their own: they sum the unscaled ds, dq takes
    the scale, and a kernel that scaled both would be off by 8^-½ here."""
    args = _grid_problem(np.random.default_rng(kh * kw), b, h, kh, kw, d)

    def f(*a):
        return jnp.sum(flash_attention_grid_bias(*a, kw, None, block_q,
                                                 True) ** 2)

    want = jax.grad(f, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(a)
                                                  for a in args))
    ts_ = [torch.from_numpy(a).requires_grad_() for a in args]
    o, lse = flash_attention_grid_bias_fwd(*ts_, kw)
    (o ** 2).sum().backward()
    for t, w, name in zip(ts_, want, ["q", "k", "v", "bias_h", "bias_w"]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=5e-4,
                                   rtol=5e-4, err_msg=name)
    # the plain version's dbias is ds summed unscaled
    with torch.no_grad():
        g = 2 * o
        _, dbh, dbw = grid_bias_bwd_dq_reference(
            *ts_, kw, g, lse, (o * g).sum(-1), d ** -0.5)
    torch.testing.assert_close(ts_[3].grad, dbh, atol=0, rtol=0)
    torch.testing.assert_close(ts_[4].grad, dbw, atol=0, rtol=0)


def test_grid_bias_backward_matches_torch_autograd_of_reference():
    args = [torch.from_numpy(a).requires_grad_() for a in _grid_problem(
        np.random.default_rng(4), 1, 2, 3, 7, 16)]
    w = torch.from_numpy(np.random.default_rng(5).normal(
        size=(1, 2, 21, 16)).astype(np.float32))
    (port_grid_bias(*args, 7) * w).sum().backward()
    got = [t.grad.clone() for t in args]
    for t in args:
        t.grad = None
    (grid_bias_reference(*args, 7)[0] * w).sum().backward()
    for a, t, name in zip(got, args, ["q", "k", "v", "bias_h", "bias_w"]):
        np.testing.assert_allclose(a.numpy(), t.grad.numpy(), atol=5e-4,
                                   rtol=5e-4, err_msg=name)


# (B, H, Sq, Sk, D): four 64-key tiles and a ragged 129-key tail; 11 queries
# over 200 keys, as few terms in dk and dv as SAM's decoder gives them
BOUND_SHAPES = [(1, 2, 256, 256, 64), (1, 2, 256, 129, 32),
                (1, 2, 11, 200, 16)]


def _bwd_problem(shape, seed):
    """bf16 q, k, v, g; the f32 lse and delta the backward kernels get."""
    rng = np.random.default_rng(seed)
    b, h, sq, sk, d = shape
    q, k, v, g = (torch.from_numpy(rng.normal(size=(b, h, n, d))
                                   .astype(np.float32)).to(torch.bfloat16)
                  for n in (sq, sk, sk, sq))
    o, lse = attention_reference(q.float(), k.float(), v.float())
    delta = (o.to(torch.bfloat16).float() * g.float()).sum(-1)
    return q, k, v, g, lse, delta, d ** -0.5


def _rounded_backward(q, k, v, g, lse, delta, scale, fault=None):
    """(dq, dk, dv) as the tensor-core kernels round them: logits and sums
    in f64 (another summation order than the f32 plain versions), p and
    scale·ds rounded to bf16 before the second products, the outputs to
    bf16. ``fault`` makes a broken kernel: "drop_key_tile" leaves keys
    64-127 out of dq, "drop_query_tile" queries 64-127 out of dk,
    "scale_twice" scales ds twice."""
    f64 = [t.double() for t in (q, k, v, g)]
    q, k, v, g = f64
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    p = torch.exp(s - lse.double()[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", g, v)
    ds = p * (dp - delta.double()[..., None]) * scale
    if fault == "scale_twice":
        ds = ds * scale
    p, ds = (t.to(torch.bfloat16).double() for t in (p, ds))
    ds_q, ds_k = ds.clone(), ds.clone()
    if fault == "drop_key_tile":
        ds_q[..., 64:128] = 0
    if fault == "drop_query_tile":
        ds_k[..., 64:128, :] = 0
    out = (torch.einsum("bhqk,bhkd->bhqd", ds_q, k),
           torch.einsum("bhqk,bhqd->bhkd", ds_k, q),
           torch.einsum("bhqk,bhqd->bhkd", p, g))
    return [t.to(torch.bfloat16) for t in out]


def _plain_and_terms(args):
    refs = (flash_bwd_dq_reference(*args),) + flash_bwd_dkv_reference(*args)
    return refs, flash_bwd_abs_terms_reference(*args)


@pytest.mark.parametrize("shape", BOUND_SHAPES)
def test_backward_bound_admits_the_kernels_rounding(shape):
    """A kernel that rounds as the tensor-core kernels do passes the card's
    bound against the f32 plain versions, at every output; Σ|terms| is at
    least |Σ terms| elementwise."""
    args = _bwd_problem(shape, sum(shape))
    refs, terms = _plain_and_terms(args)
    for name, got, ref, term in zip(("dq", "dk", "dv"),
                                    _rounded_backward(*args), refs, terms):
        assert bool((term >= ref.abs() * (1 - 1e-5) - 1e-7).all()), name
        chip_smoke.bwd_error(got, ref, term, f"{shape} {name}")


@pytest.mark.parametrize("fault,out", [("drop_key_tile", 0),
                                       ("drop_query_tile", 1),
                                       ("scale_twice", 0),
                                       ("scale_twice", 1)])
@pytest.mark.parametrize("shape", BOUND_SHAPES[:2])
def test_backward_bound_refuses_a_broken_kernel(shape, fault, out):
    """A dropped 64-row tile or a scale applied twice fails the bound."""
    args = _bwd_problem(shape, sum(shape))
    refs, terms = _plain_and_terms(args)
    got = _rounded_backward(*args, fault=fault)
    with pytest.raises(AssertionError, match="over its bound"):
        chip_smoke.bwd_error(got[out], refs[out], terms[out], fault)


# key grids of the grid-bias bound's checks, two heads of SAM-H's 80: 64 and
# 256 keys, and a 4 × 24 grid, whose kw neither is 64 nor divides it
GB_BOUND_GRIDS = [(8, 8), (16, 16), (4, 24)]
GB_OUTPUTS = ("dq", "dbias_h", "dbias_w", "dk", "dv")


def _gb_bwd_problem(kh, kw, seed):
    """bf16 q, k, v, g; f32 bias factors, lse and delta, as the grid-bias
    backward kernels get them."""
    rng = np.random.default_rng(seed)
    q, k, v, bias_h, bias_w = _grid_problem(rng, 1, 2, kh, kw, 80)
    g = rng.normal(size=q.shape).astype(np.float32)
    q, k, v, g = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, g))
    bias_h, bias_w = torch.from_numpy(bias_h), torch.from_numpy(bias_w)
    o, lse = grid_bias_reference(q.float(), k.float(), v.float(), bias_h,
                                 bias_w, kw)
    delta = (o.to(torch.bfloat16).float() * g.float()).sum(-1)
    return q, k, v, bias_h, bias_w, kw, g, lse, delta, 80 ** -0.5


def _rounded_gb_backward(q, k, v, bias_h, bias_w, kw, g, lse, delta, scale,
                         fault=None):
    """(dq, dbias_h, dbias_w, dk, dv) as the tensor-core grid-bias pair
    rounds them: logits and sums in f64, the bias gradients summed from the
    unrounded ds, p and scale·ds rounded to bf16 before the second products,
    dq, dk and dv to bf16. ``fault`` makes a broken kernel: "drop_key_tile"
    leaves keys 64-127 out of dq, "drop_query_tile" queries 64-127 out of
    dk, "double_scale" takes 2·scale for ds, "shift_dbias_h" moves dbias_h
    by one key-grid row."""
    q, k, v, g = (t.double() for t in (q, k, v, g))
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    s = (torch.einsum("bhqd,bhkd->bhqk", q, k) * scale).reshape(
        b, h, sq, sk // kw, kw) + bias_h.double()[..., :, None] \
        + bias_w.double()[..., None, :]
    p = torch.exp(s.reshape(b, h, sq, sk) - lse.double()[..., None])
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", g, v)
              - delta.double()[..., None])
    grid = ds.reshape(b, h, sq, sk // kw, kw)
    dbh, dbw = grid.sum(-1), grid.sum(-2)
    if fault == "shift_dbias_h":
        dbh = torch.roll(dbh, 1, -1)
    ds = ds * (2 * scale if fault == "double_scale" else scale)
    p, ds = (t.to(torch.bfloat16).double() for t in (p, ds))
    ds_q, ds_k = ds.clone(), ds.clone()
    if fault == "drop_key_tile":
        ds_q[..., 64:128] = 0
    if fault == "drop_query_tile":
        ds_k[..., 64:128, :] = 0
    return (torch.einsum("bhqk,bhkd->bhqd", ds_q, k).to(torch.bfloat16),
            dbh.float(), dbw.float(),
            torch.einsum("bhqk,bhqd->bhkd", ds_k, q).to(torch.bfloat16),
            torch.einsum("bhqk,bhqd->bhkd", p, g).to(torch.bfloat16))


def _gb_plain_and_terms(args):
    refs = grid_bias_bwd_dq_reference(*args) + \
        grid_bias_bwd_dkv_reference(*args)
    terms = dict(zip(("dq", "dk", "dv"),
                     grid_bias_bwd_abs_terms_reference(*args)))
    return dict(zip(GB_OUTPUTS, refs)), terms


@pytest.mark.parametrize("grid", GB_BOUND_GRIDS)
def test_grid_bias_bound_admits_the_kernels_rounding(grid):
    """A kernel that rounds as the tensor-core grid-bias pair does passes
    the card's bound against the f32 plain versions at every output: dq, dk
    and dv under bwd_error's, the f32 bias gradients under 2e-4·max|ref|;
    Σ|terms| is at least |Σ terms| elementwise."""
    args = _gb_bwd_problem(*grid, sum(grid))
    refs, terms = _gb_plain_and_terms(args)
    for name, got in zip(GB_OUTPUTS, _rounded_gb_backward(*args)):
        if name in terms:
            assert bool((terms[name] >= refs[name].abs() * (1 - 1e-5)
                         - 1e-7).all()), name
        chip_smoke.gb_bwd_error(got, refs[name], f"{grid} {name}",
                                terms.get(name))


def test_grid_bias_terms_without_a_bias_are_the_flash_terms():
    args = list(_gb_bwd_problem(4, 24, 1))
    args[3], args[4] = torch.zeros_like(args[3]), torch.zeros_like(args[4])
    q, k, v, _, _, kw, g, _, delta, scale = args
    _, lse = attention_reference(q.float(), k.float(), v.float())
    args[7] = lse
    want = flash_bwd_abs_terms_reference(q, k, v, g, lse, delta, scale)
    for got, w in zip(grid_bias_bwd_abs_terms_reference(*args), want):
        torch.testing.assert_close(got, w)


@pytest.mark.parametrize("fault,out,factor", [("drop_key_tile", "dq", 50),
                                              ("drop_query_tile", "dk", 50),
                                              ("double_scale", "dq", 50),
                                              ("double_scale", "dk", 50),
                                              ("shift_dbias_h", "dbias_h",
                                               1000)])
def test_grid_bias_bound_refuses_a_broken_kernel(fault, out, factor):
    """At the 16 × 16 grid each fault fails its output's bound by at least
    ``factor`` at its worst element: a dropped 64-key tile in dq (106×
    measured), a dropped 64-query tile in dk (92×), a doubled scale (104×
    in dq, 106× in dk) by 50×; dbias_h shifted by one key-grid row (5085×)
    by 1000×. The rounding model passes at 0.42-0.57 of the bound."""
    args = _gb_bwd_problem(16, 16, 32)
    refs, terms = _gb_plain_and_terms(args)
    got = dict(zip(GB_OUTPUTS, _rounded_gb_backward(*args, fault=fault)))
    with pytest.raises(AssertionError, match="over its bound") as err:
        chip_smoke.gb_bwd_error(got[out], refs[out], fault, terms.get(out))
    worst = float(re.search(r"([\d.]+)× at worst", str(err.value)).group(1))
    assert worst >= factor, str(err.value)


# (B, H, Sq, Sk, D) and key grid of the forward bound's checks: two keys at
# D = 128 (VGGT's camera trunk), the mask decoder's 11 tokens against 70 keys
# (split across the warps) and back, SAM-H's head dim at a 4 × 24 grid
# (kw neither 64 nor dividing it) and an 8 × 8 one, the saliency net's
# D = 96 over a ragged 150 keys and its decode's single key at D = 64
FWD_BOUND_CASES = [((1, 2, 2, 2, 128), None), ((1, 2, 11, 70, 16), None),
                   ((1, 2, 70, 11, 16), None), ((1, 2, 96, 96, 80), (4, 24)),
                   ((1, 2, 64, 64, 80), (8, 8)), ((1, 2, 150, 150, 96), None),
                   ((1, 6, 196, 1, 64), None)]


def _fwd_problem(shape, grid, seed):
    """bf16 q, k, v and, for a (kh, kw) key grid, f32 bias factors drawn
    N(0, 0.5²) as chip_smoke.py draws them; with the f32 plain (o, lse) and
    Σ|terms| of o."""
    rng = np.random.default_rng(seed)
    b, h, sq, sk, d = shape
    q, k, v = (torch.from_numpy(rng.normal(size=(b, h, n, d))
                                .astype(np.float32)).to(torch.bfloat16)
               for n in (sq, sk, sk))
    up = (q.float(), k.float(), v.float())
    if grid is None:
        bias = None
        (o, lse), terms = attention_reference(*up), \
            attention_abs_terms_reference(*up)
    else:
        kh, kw = grid
        bh_, bw_ = (torch.from_numpy(0.5 * rng.normal(size=(b, h, sq, n))
                                     .astype(np.float32)) for n in (kh, kw))
        bias = (bh_[..., :, None] + bw_[..., None, :]).reshape(b, h, sq, sk)
        (o, lse), terms = grid_bias_reference(*up, bh_, bw_, kw), \
            grid_bias_abs_terms_reference(*up, bh_, bw_, kw)
    return (q, k, v, d ** -0.5, bias), (o, lse, terms)


def _rounded_forward(q, k, v, scale, bias=None, fault=None):
    """(o, lse) as the tensor-core forward kernel rounds them: logits and
    sums in f64; the online softmax over 64-key tiles, and for Sq ≤ 16 with
    more than one tile over the four warps' tiles (tile t to warp t % 4)
    with their (m, l, o) combined at the end; p rounded to bf16 per tile
    under the running max; l sums the unrounded p; o rounded to bf16.
    ``fault`` makes a broken kernel: "drop_key_tile" leaves keys 0-63 out,
    "double_scale" takes 2·scale, "no_rescale" never rescales o by alpha,
    "lse_log2" returns lse in log₂."""
    q, k, v = (t.double() for t in (q, k, v))
    if fault == "double_scale":
        scale = 2 * scale
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if bias is not None:
        s = s + bias.double()
    sq, sk = s.shape[-2:]
    nt = -(-sk // 64)
    warps = 4 if sq <= 16 and nt > 1 else 1
    parts = []
    for w in range(warps):
        m = torch.full(s.shape[:-1], -torch.inf, dtype=torch.float64)
        l = torch.zeros_like(m)
        acc = torch.zeros(*s.shape[:-1], v.shape[-1], dtype=torch.float64)
        for t in range(w, nt, warps):
            st, vt = s[..., 64 * t:64 * t + 64], v[..., 64 * t:64 * t + 64, :]
            if fault == "drop_key_tile" and t == 0:
                continue
            m_new = torch.maximum(m, st.amax(-1))
            base = torch.where(m_new == -torch.inf, 0.0, m_new)
            alpha = torch.exp(m - base)
            p = torch.exp(st - base[..., None])
            l = l * alpha + p.sum(-1)
            if fault != "no_rescale":
                acc = acc * alpha[..., None]
            acc = acc + p.to(torch.bfloat16).double() @ vt
            m = m_new
        parts.append((m, l, acc))
    mx = torch.stack([p[0] for p in parts]).amax(0)
    f = [torch.exp(p[0] - mx) for p in parts]
    l = sum(p[1] * fw for p, fw in zip(parts, f))
    acc = sum(p[2] * fw[..., None] for p, fw in zip(parts, f))
    lse = mx + torch.log(l)
    if fault == "lse_log2":
        lse = lse / np.log(2.0)
    return (acc / l[..., None]).to(torch.bfloat16), lse.float()


@pytest.mark.parametrize("shape,grid", FWD_BOUND_CASES)
def test_forward_bound_admits_the_kernels_rounding(shape, grid):
    """A kernel that rounds as the tensor-core forward does passes the
    card's bound against the f32 plain version; Σ|terms| is at least |o|
    elementwise."""
    args, (o_ref, lse_ref, terms) = _fwd_problem(shape, grid, sum(shape))
    assert bool((terms >= o_ref.abs() * (1 - 1e-5) - 1e-7).all())
    o, lse = _rounded_forward(*args)
    chip_smoke.fwd_error(o, o_ref, terms, lse, lse_ref, f"{shape} {grid}")


def test_forward_bound_needs_the_terms():
    """The bound of the f32 CUDA-core kernel, 2⁻⁸·|o_ref| + 2e-3, does not
    admit p's rounding to bf16 where few keys carry o: over the mask
    decoder's 11 keys the rounding model exceeds it (1.25-1.31× over three
    seeds) and passes the bound with the terms."""
    shape = (8, 8, 1024, 11, 16)
    args, (o_ref, lse_ref, terms) = _fwd_problem(shape, None, sum(shape))
    o, lse = _rounded_forward(*args)
    assert float(((o.float() - o_ref).abs()
                  / (2.0 ** -8 * o_ref.abs() + 2e-3)).max()) > 1.1
    chip_smoke.fwd_error(o, o_ref, terms, lse, lse_ref, str(shape))


def test_split_keys_combine_as_one_pass():
    """Splitting the keys across the four warps changes only where p is
    rounded: o within a bf16 step of the one-pass model, lse to 1e-6."""
    args, _ = _fwd_problem((1, 2, 11, 300, 16), None, 7)
    o_split, lse_split = _rounded_forward(*args)
    q, k, v, scale, _ = args
    pad = torch.zeros(1, 2, 5, 16, dtype=torch.bfloat16)
    o_one, lse_one = _rounded_forward(torch.cat([q, pad], 2), k, v, scale)
    o_one, lse_one = o_one[..., :11, :], lse_one[..., :11]
    torch.testing.assert_close(lse_split, lse_one, atol=1e-6, rtol=0)
    torch.testing.assert_close(o_split.float(), o_one.float(), atol=8e-3,
                               rtol=2 ** -7)


@pytest.mark.parametrize("fault", ["drop_key_tile", "double_scale",
                                   "no_rescale", "lse_log2"])
@pytest.mark.parametrize("shape,grid", [((1, 2, 70, 200, 32), None),
                                        ((1, 2, 96, 96, 80), (4, 24))])
def test_forward_bound_refuses_a_broken_kernel(shape, grid, fault):
    """Each fault fails the bound by at least 10× at its worst element, at
    four key tiles without the bias and two with it (a missing rescale only
    shows where a later tile raises a row's max)."""
    args, (o_ref, lse_ref, terms) = _fwd_problem(shape, grid, sum(shape))
    o, lse = _rounded_forward(*args, fault=fault)
    with pytest.raises(AssertionError, match="over its bound") as err:
        chip_smoke.fwd_error(o, o_ref, terms, lse, lse_ref, fault)
    worst = float(re.search(r"([\d.]+)× at worst", str(err.value)).group(1))
    assert worst >= 10, str(err.value)


def test_grid_bias_forward_terms_without_a_bias_are_the_flash_terms():
    args, _ = _fwd_problem((1, 2, 40, 96, 80), None, 3)
    q, k, v = (t.float() for t in args[:3])
    zeros = [torch.zeros(1, 2, 40, n) for n in (4, 24)]
    torch.testing.assert_close(
        grid_bias_abs_terms_reference(q, k, v, *zeros, 24),
        attention_abs_terms_reference(q, k, v))
