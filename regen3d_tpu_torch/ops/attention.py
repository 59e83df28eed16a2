"""Flash attention on the CUDA kernels, forward and backward (counterparts of
regen3d_tpu/ops/attention.py::flash_attention and
::flash_attention_grid_bias with their custom VJPs).

q, k, v are (B, H, S, D). Both ops are ``torch.autograd.Function``s.

* :func:`flash_attention_fwd` launches ``csrc/flash_fwd.cu``'s kernel
  forward and, under autograd, ``csrc/flash_bwd.cu``'s dq and dkv kernels
  backward (bf16 in and out, tensor cores with f32 accumulation, p (and
  scale·ds backward) rounded to bf16 before the second products; the
  forward at D ∈ {8, 16, 32, 64, 96, 128}, the backward at D ∈ {16, 32,
  64, 128}).
* :func:`flash_attention_grid_bias_fwd` launches the same forward kernel
  with SAM's factored key-grid bias and ``csrc/flash_bwd.cu``'s grid-bias
  dq and dkv kernels backward (the same tensor-core design, the dq kernel
  also summing the bias gradients from the f32 ds; f32 bias factors and
  bias gradients, D = 80).

The backward follows the JAX package's: delta = Σ_d o·g in f32 (plain
torch, outside the kernels, as JAX computes it), then the dq kernel gridded
over q tiles and the dkv kernel gridded over kv tiles, both recomputing the
probabilities from the forward's row logsumexp; dq, dk and dv are rounded
to the input dtype. On CPU tensors every step runs its plain O(Sq·Sk)
version (:func:`attention_reference`, :func:`grid_bias_reference` and the
``*_bwd_*_reference`` functions); on CUDA tensors each launches its kernel
or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from regen3d_tpu_torch import kernels

KERNEL_HEAD_DIMS = (16, 32, 64, 128)   # both directions
# 96: the saliency net's; 8: the random-init tiny generator's condition
# encoder (computed at width 16 in shared memory, csrc/flash_fwd.cu)
FWD_KERNEL_HEAD_DIMS = (8, 16, 32, 64, 96, 128)
GB_KERNEL_HEAD_DIMS = (80,)          # SAM-H; the JAX package runs no other


def attention_reference(q, k, v, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain attention in f32 → (o (B, H, Sq, D) in q.dtype, lse (B, H, Sq) f32)."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None])
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(q.dtype), lse


def grid_bias_reference(q, k, v, bias_h, bias_w, kw: int,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain attention with the factored key-grid bias materialised in f32,
    as the JAX package's oracle builds it → (o in q.dtype, lse f32)."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    logits = _grid_logits(q, k, bias_h, bias_w, kw, scale)
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None])
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(q.dtype), lse


def attention_abs_terms_reference(q, k, v, scale: Optional[float] = None
                                  ) -> torch.Tensor:
    """Σ|terms| of each element of o in f32: Σ_k p·|v| (B, H, Sq, D), the
    plain product on magnitudes. The forward kernel rounds p to bf16 before
    p·v, which moves each term by a fraction of its magnitude;
    chip_smoke.py's bound on the kernel is a fraction of these sums."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, -1),
                        v.float().abs())


def grid_bias_abs_terms_reference(q, k, v, bias_h, bias_w, kw: int,
                                  scale: Optional[float] = None
                                  ) -> torch.Tensor:
    """Σ|terms| of each element of the grid-bias forward's o in f32, as
    :func:`attention_abs_terms_reference` with the factored bias in the
    logits."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    logits = _grid_logits(q, k, bias_h, bias_w, kw, scale)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, -1),
                        v.float().abs())


def _grid_logits(q, k, bias_h, bias_w, kw, scale):
    """scale·q·kᵀ + bias_h[q, k / kw] + bias_w[q, k % kw], f32 (B, H, Sq, Sk)."""
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    return (logits.reshape(b, h, sq, sk // kw, kw)
            + bias_h.float()[..., :, None]
            + bias_w.float()[..., None, :]).reshape(b, h, sq, sk)


def _probs_and_ds(q, k, v, g, lse, delta, scale, bias=None):
    """(p, ds) in f32 recomputed from the saved lse, as the backward kernels
    do: p = exp(s − lse), ds = p·(g·vᵀ − delta), unscaled. ``bias`` is
    ``(bias_h, bias_w, kw)`` for the grid-bias op."""
    if bias is None:
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    else:
        s = _grid_logits(q, k, *bias, scale)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", g.float(), v.float())
    return p, p * (dp - delta[..., None])


def flash_bwd_dq_reference(q, k, v, g, lse, delta, scale: float
                           ) -> torch.Tensor:
    """dq = ds·k·scale in f32: the plain version of the dq kernel."""
    _, ds = _probs_and_ds(q, k, v, g, lse, delta, scale)
    return torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale


def flash_bwd_dkv_reference(q, k, v, g, lse, delta, scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) = (dsᵀ·q·scale, pᵀ·g) in f32: the plain version of the dkv
    kernel."""
    p, ds = _probs_and_ds(q, k, v, g, lse, delta, scale)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, g.float())
    return dk, dv


def _abs_terms(p, ds, q, k, g, scale):
    ds = (ds * scale).abs()
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k.float().abs()),
            torch.einsum("bhqk,bhqd->bhkd", ds, q.float().abs()),
            torch.einsum("bhqk,bhqd->bhkd", p, g.float().abs()))


def flash_bwd_abs_terms_reference(q, k, v, g, lse, delta, scale: float
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Σ|terms| of each element of dq, dk and dv in f32: the plain products
    on magnitudes, Σ_k |scale·ds|·|k|, Σ_q |scale·ds|·|q| and Σ_q p·|g|. The
    dq and dkv kernels round p and scale·ds to bf16 before these products,
    which moves each term by a fraction of its magnitude; chip_smoke.py's
    bound on the kernels is a fraction of these sums."""
    p, ds = _probs_and_ds(q, k, v, g, lse, delta, scale)
    return _abs_terms(p, ds, q, k, g, scale)


def grid_bias_bwd_abs_terms_reference(q, k, v, bias_h, bias_w, kw: int, g,
                                      lse, delta, scale: float
                                      ) -> Tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor]:
    """Σ|terms| of each element of the grid-bias pair's dq, dk and dv in
    f32, as :func:`flash_bwd_abs_terms_reference` with the factored bias in
    the logits."""
    p, ds = _probs_and_ds(q, k, v, g, lse, delta, scale,
                          (bias_h, bias_w, kw))
    return _abs_terms(p, ds, q, k, g, scale)


def grid_bias_bwd_dq_reference(q, k, v, bias_h, bias_w, kw: int, g, lse,
                               delta, scale: float
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """(dq, dbias_h, dbias_w) in f32: the plain version of the grid-bias dq
    kernel. The bias gradients sum the UNSCALED ds (the bias enters the
    logits unscaled); dq takes the scale."""
    _, ds = _probs_and_ds(q, k, v, g, lse, delta, scale,
                          (bias_h, bias_w, kw))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
    grid = ds.reshape(*ds.shape[:-1], -1, kw)
    return dq, grid.sum(-1), grid.sum(-2)


def grid_bias_bwd_dkv_reference(q, k, v, bias_h, bias_w, kw: int, g, lse,
                                delta, scale: float
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) in f32: the plain version of the grid-bias dkv kernel."""
    p, ds = _probs_and_ds(q, k, v, g, lse, delta, scale,
                          (bias_h, bias_w, kw))
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, g.float())
    return dk, dv


def _check_kernel_inputs(what, d, head_dims, tensors) -> None:
    """Raise unless every (name, tensor, dtype) is a contiguous CUDA tensor
    of its dtype and the head dim has a kernel."""
    for name, t, dtype in tensors:
        if t.device.type != "cuda" or t.dtype != dtype:
            raise ValueError(f"{what}: {name} must be a CUDA {dtype} tensor, "
                             f"got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    if d not in head_dims:
        raise ValueError(f"{what}: head dim {d} not in {head_dims}")


def _bf16_named(**ts):
    return tuple((name, t, torch.bfloat16) for name, t in ts.items())


def _f32_named(**ts):
    return tuple((name, t, torch.float32) for name, t in ts.items())


def _launch(lib: str, fn: str, counter: str, *args) -> None:
    """Call a C entry point (tensors passed by data pointer), check its
    launch and count it."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    err = getattr(kernels.lib(lib), fn)(
        *(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
        kernels.stream_ptr(dev))
    kernels.check(err, counter)
    kernels.LAUNCHES[counter] += 1


def _delta(o, g) -> torch.Tensor:
    """delta = Σ_d o·g in f32 (B, H, Sq)."""
    return (o.float() * g.float()).sum(-1)


def _flash_fwd(q, k, v, s):
    if q.device.type == "cpu":
        return attention_reference(q, k, v, s)
    b, h, sq, d = q.shape
    _check_kernel_inputs("flash_attention", d, FWD_KERNEL_HEAD_DIMS,
                         _bf16_named(q=q, k=k, v=v))
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", "flash_fwd_bf16", "flash_fwd", q, k, v, o, lse,
            b * h, sq, k.shape[2], d, float(s))
    return o, lse


def flash_bwd_dq(q, k, v, g, lse, delta, scale: float) -> torch.Tensor:
    """dq in q's dtype from the saved lse and delta: the dq kernel for CUDA
    tensors (q, k, v, g bf16; lse, delta f32), the plain version for CPU
    tensors."""
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, g, lse, delta, scale).to(q.dtype)
    b, h, sq, d = q.shape
    _check_kernel_inputs("flash_bwd_dq", d, KERNEL_HEAD_DIMS,
                         _bf16_named(q=q, k=k, v=v, g=g)
                         + _f32_named(lse=lse, delta=delta))
    dq = torch.empty_like(q)
    _launch("flash_bwd", "flash_bwd_dq_bf16", "flash_bwd_dq", q, k, v, g,
            lse, delta, dq, b * h, sq, k.shape[2], d, float(scale))
    return dq


def flash_bwd_dkv(q, k, v, g, lse, delta, scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) in k's dtype: the dkv kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if q.device.type == "cpu":
        dk, dv = flash_bwd_dkv_reference(q, k, v, g, lse, delta, scale)
        return dk.to(k.dtype), dv.to(v.dtype)
    b, h, sq, d = q.shape
    _check_kernel_inputs("flash_bwd_dkv", d, KERNEL_HEAD_DIMS,
                         _bf16_named(q=q, k=k, v=v, g=g)
                         + _f32_named(lse=lse, delta=delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd", "flash_bwd_dkv_bf16", "flash_bwd_dkv", q, k, v, g,
            lse, delta, dk, dv, b * h, sq, k.shape[2], d, float(scale))
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward saves q, k, v, o and lse, as JAX's ``_flash_vjp_fwd``."""

    @staticmethod
    def forward(ctx, q, k, v, s):
        o, lse = _flash_fwd(q, k, v, s)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = s
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        g = g.contiguous()
        delta = _delta(o, g)
        dq = flash_bwd_dq(q, k, v, g, lse, delta, ctx.scale)
        dk, dv = flash_bwd_dkv(q, k, v, g, lse, delta, ctx.scale)
        return dq, dk, dv, None


def flash_attention_fwd(q, k, v, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse), differentiable in q, k and v (lse is not): the CUDA
    kernels for CUDA tensors, the plain versions for CPU tensors."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    s = scale if scale is not None else 1.0 / (d ** 0.5)
    return _FlashAttention.apply(q, k, v, s)


def flash_attention(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """Fused attention: q, k, v (B, H, S, D) → (B, H, Sq, D)."""
    return flash_attention_fwd(q, k, v, scale)[0]


def _gb_fwd(q, k, v, bias_h, bias_w, kw, s):
    if q.device.type == "cpu":
        return grid_bias_reference(q, k, v, bias_h, bias_w, kw, s)
    b, h, sq, d = q.shape
    _check_kernel_inputs("flash_attention_grid_bias", d, GB_KERNEL_HEAD_DIMS,
                         _bf16_named(q=q, k=k, v=v)
                         + _f32_named(bias_h=bias_h, bias_w=bias_w))
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", "flash_gb_fwd_bf16", "flash_gb_fwd", q, k, v,
            bias_h, bias_w, o, lse, *_gb_dims(q, k, kw, s))
    return o, lse


def grid_bias_bwd_dq(q, k, v, bias_h, bias_w, kw: int, g, lse, delta,
                     scale: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq in q's dtype, dbias_h, dbias_w in the biases' dtype): the
    grid-bias dq kernel for CUDA tensors (q, k, v, g bf16; biases, lse,
    delta f32), the plain version for CPU tensors."""
    if q.device.type == "cpu":
        dq, dbh, dbw = grid_bias_bwd_dq_reference(q, k, v, bias_h, bias_w, kw,
                                                  g, lse, delta, scale)
        return dq.to(q.dtype), dbh.to(bias_h.dtype), dbw.to(bias_w.dtype)
    _check_gb_bwd("grid_bias_bwd_dq", q, k, v, bias_h, bias_w, g, lse, delta)
    dq = torch.empty_like(q)
    dbh, dbw = torch.empty_like(bias_h), torch.empty_like(bias_w)
    _launch("flash_bwd", "flash_gb_bwd_dq_bf16", "flash_gb_bwd_dq", q, k,
            v, bias_h, bias_w, g, lse, delta, dq, dbh, dbw,
            *_gb_dims(q, k, kw, scale))
    return dq, dbh, dbw


def grid_bias_bwd_dkv(q, k, v, bias_h, bias_w, kw: int, g, lse, delta,
                      scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) in k's dtype: the grid-bias dkv kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if q.device.type == "cpu":
        dk, dv = grid_bias_bwd_dkv_reference(q, k, v, bias_h, bias_w, kw, g,
                                             lse, delta, scale)
        return dk.to(k.dtype), dv.to(v.dtype)
    _check_gb_bwd("grid_bias_bwd_dkv", q, k, v, bias_h, bias_w, g, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd", "flash_gb_bwd_dkv_bf16", "flash_gb_bwd_dkv", q, k,
            v, bias_h, bias_w, g, lse, delta, dk, dv,
            *_gb_dims(q, k, kw, scale))
    return dk, dv


def _check_gb_bwd(what, q, k, v, bias_h, bias_w, g, lse, delta) -> None:
    _check_kernel_inputs(what, q.shape[-1], GB_KERNEL_HEAD_DIMS,
                         _bf16_named(q=q, k=k, v=v, g=g)
                         + _f32_named(bias_h=bias_h, bias_w=bias_w, lse=lse,
                                      delta=delta))


def _gb_dims(q, k, kw, scale):
    """bh, sq, sk, kh, kw, d, scale as the grid-bias entry points take them."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    return b * h, sq, sk, sk // kw, kw, d, float(scale)


class _FlashAttentionGridBias(torch.autograd.Function):
    """Forward saves q, k, v, both bias factors, o and lse, as JAX's
    ``_gb_vjp_fwd``."""

    @staticmethod
    def forward(ctx, q, k, v, bias_h, bias_w, kw, s):
        o, lse = _gb_fwd(q, k, v, bias_h, bias_w, kw, s)
        ctx.save_for_backward(q, k, v, bias_h, bias_w, o, lse)
        ctx.kw, ctx.scale = kw, s
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, bias_h, bias_w, o, lse = ctx.saved_tensors
        g = g.contiguous()
        delta = _delta(o, g)
        dq, dbh, dbw = grid_bias_bwd_dq(q, k, v, bias_h, bias_w, ctx.kw, g,
                                        lse, delta, ctx.scale)
        dk, dv = grid_bias_bwd_dkv(q, k, v, bias_h, bias_w, ctx.kw, g, lse,
                                   delta, ctx.scale)
        return dq, dk, dv, dbh, dbw, None, None


def flash_attention_grid_bias_fwd(q, k, v, bias_h, bias_w, kw: int,
                                  scale: Optional[float] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of attention whose keys form a (kh, kw) grid (Sk = kh·kw):
    logits[q, (m, n)] = scale·q·k + bias_h[q, m] + bias_w[q, n], with
    bias_h (B, H, Sq, kh) and bias_w (B, H, Sq, kw). Differentiable in q, k,
    v, bias_h and bias_w. The CUDA kernels for CUDA tensors (q, k, v bf16,
    biases f32), the plain versions for CPU tensors."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if (k.shape != (b, h, sk, d) or v.shape != k.shape or kw <= 0
            or sk % kw):
        raise ValueError(f"flash_attention_grid_bias: shapes {tuple(q.shape)}"
                         f", {tuple(k.shape)}, {tuple(v.shape)} with kw={kw}")
    kh = sk // kw
    if bias_h.shape != (b, h, sq, kh) or bias_w.shape != (b, h, sq, kw):
        raise ValueError(f"flash_attention_grid_bias: bias shapes "
                         f"{tuple(bias_h.shape)}, {tuple(bias_w.shape)} for "
                         f"a ({kh}, {kw}) key grid")
    s = scale if scale is not None else 1.0 / (d ** 0.5)
    return _FlashAttentionGridBias.apply(q, k, v, bias_h, bias_w, kw, s)


def flash_attention_grid_bias(q, k, v, bias_h, bias_w, kw: int,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Fused attention with the factored key-grid bias → (B, H, Sq, D)."""
    return flash_attention_grid_bias_fwd(q, k, v, bias_h, bias_w, kw,
                                         scale)[0]


def multihead_attention(x_q, x_kv, w_q, w_k, w_v, w_o, num_heads: int,
                        b_q=None, b_k=None, b_v=None, b_o=None
                        ) -> torch.Tensor:
    """Projection + flash attention + output projection.

    x_q (B, Sq, E), x_kv (B, Sk, E); weights (E, E) in flax's (in, out)
    layout. Each projection accumulates in f32, adds its bias and rounds to
    the input's dtype, as the JAX function's ``preferred_element_type``
    product does."""
    b, sq, e = x_q.shape
    hd = e // num_heads

    def proj(x, w, bias):
        y = torch.einsum("bse,ef->bsf", x.float(), w.float())
        if bias is not None:
            y = y + bias.float()
        return y.to(x.dtype)

    def heads(t):
        return t.reshape(b, -1, num_heads, hd).transpose(1, 2).contiguous()

    q = heads(proj(x_q, w_q, b_q))
    k = heads(proj(x_kv, w_k, b_k))
    v = heads(proj(x_kv, w_v, b_v))
    o = flash_attention(q, k, v).transpose(1, 2).reshape(b, sq, e)
    return proj(o, w_o, b_o)
