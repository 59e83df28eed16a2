"""Flash-attention forward on the CUDA kernels (counterparts of
regen3d_tpu/ops/attention.py::flash_attention and
::flash_attention_grid_bias, forward only).

q, k, v are (B, H, S, D). On CUDA tensors :func:`flash_attention_fwd`
launches ``csrc/flash_fwd.cu`` (bf16 in and out, f32 accumulation,
D ∈ {16, 32, 64, 128}) and :func:`flash_attention_grid_bias_fwd` launches
``csrc/flash_gb_fwd.cu`` (the same with SAM's factored key-grid bias, f32
bias factors, D = 80). On CPU tensors each runs its plain
O(S²) version, :func:`attention_reference` and :func:`grid_bias_reference`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from regen3d_tpu_torch import kernels

KERNEL_HEAD_DIMS = (16, 32, 64, 128)
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


def _check_kernel_inputs(what, d, head_dims, tensors) -> None:
    """Raise unless every (name, tensor, dtype) is a contiguous CUDA tensor
    of its dtype, the head dim has a kernel, and no input wants a gradient
    (the backward kernels are not ported)."""
    for name, t, dtype in tensors:
        if t.device.type != "cuda" or t.dtype != dtype:
            raise ValueError(f"{what}: {name} must be a CUDA {dtype} tensor, "
                             f"got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    if d not in head_dims:
        raise ValueError(f"{what}: head dim {d} not in {head_dims}")
    if torch.is_grad_enabled() and any(t.requires_grad for _, t, _ in tensors):
        raise NotImplementedError(f"{what}: the backward kernels are not "
                                  "ported; run under torch.no_grad()")


def flash_attention_fwd(q, k, v, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. Forward only: the backward kernels are not ported yet."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    s = scale if scale is not None else 1.0 / (d ** 0.5)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, s)
    _check_kernel_inputs("flash_attention", d, KERNEL_HEAD_DIMS,
                         (("q", q, torch.bfloat16), ("k", k, torch.bfloat16),
                          ("v", v, torch.bfloat16)))
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = kernels.lib("flash_fwd").flash_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b * h, sq, sk, d, float(s),
        kernels.stream_ptr(q.device))
    kernels.check(err, "flash_fwd")
    kernels.LAUNCHES["flash_fwd"] += 1
    return o, lse


def flash_attention(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """Fused attention: q, k, v (B, H, S, D) → (B, H, Sq, D)."""
    return flash_attention_fwd(q, k, v, scale)[0]


def grid_bias_reference(q, k, v, bias_h, bias_w, kw: int,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain attention with the factored key-grid bias materialised in f32,
    as the JAX package's oracle builds it → (o in q.dtype, lse f32)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    kh = sk // kw
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    logits = (logits.reshape(b, h, sq, kh, kw) + bias_h.float()[..., :, None]
              + bias_w.float()[..., None, :]).reshape(b, h, sq, sk)
    lse = torch.logsumexp(logits, dim=-1)
    p = torch.exp(logits - lse[..., None])
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(q.dtype), lse


def flash_attention_grid_bias_fwd(q, k, v, bias_h, bias_w, kw: int,
                                  scale: Optional[float] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of attention whose keys form a (kh, kw) grid (Sk = kh·kw):
    logits[q, (m, n)] = scale·q·k + bias_h[q, m] + bias_w[q, n], with
    bias_h (B, H, Sq, kh) and bias_w (B, H, Sq, kw). The CUDA kernel for
    CUDA tensors (q, k, v bf16, biases f32), the plain version for CPU
    tensors. Forward only."""
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
    if q.device.type == "cpu":
        return grid_bias_reference(q, k, v, bias_h, bias_w, kw, s)
    _check_kernel_inputs(
        "flash_attention_grid_bias", d, GB_KERNEL_HEAD_DIMS,
        (("q", q, torch.bfloat16), ("k", k, torch.bfloat16),
         ("v", v, torch.bfloat16), ("bias_h", bias_h, torch.float32),
         ("bias_w", bias_w, torch.float32)))
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = kernels.lib("flash_gb_fwd").flash_gb_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_h.data_ptr(),
        bias_w.data_ptr(), o.data_ptr(), lse.data_ptr(), b * h, sq, sk, kh,
        kw, d, float(s), kernels.stream_ptr(q.device))
    kernels.check(err, "flash_gb_fwd")
    kernels.LAUNCHES["flash_gb_fwd"] += 1
    return o, lse


def flash_attention_grid_bias(q, k, v, bias_h, bias_w, kw: int,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Fused attention with the factored key-grid bias → (B, H, Sq, D)."""
    return flash_attention_grid_bias_fwd(q, k, v, bias_h, bias_w, kw,
                                         scale)[0]
