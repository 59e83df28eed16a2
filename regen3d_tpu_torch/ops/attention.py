"""Flash-attention forward on the CUDA kernel (counterpart of
regen3d_tpu/ops/attention.py::flash_attention, forward only).

q, k, v are (B, H, S, D). On CUDA tensors :func:`flash_attention_fwd`
launches ``csrc/flash_fwd.cu`` (bf16 in and out, f32 accumulation,
D ∈ {64, 128}); on CPU tensors it runs :func:`attention_reference`, the
plain O(S²) version of the same function.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from regen3d_tpu_torch import kernels

KERNEL_HEAD_DIMS = (64, 128)


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
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention: {name} must be a CUDA bf16 "
                             f"tensor, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in "
                         f"{KERNEL_HEAD_DIMS}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError("flash_attention: the backward kernels are "
                                  "not ported; run under torch.no_grad()")
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
