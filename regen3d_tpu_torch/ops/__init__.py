"""Geometry and attention ops of the port."""

import contextlib

import torch


def clip(x: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """``jnp.clip``: max with ``lo``, then min with ``hi``. At a bound the
    gradient is split in half, as JAX gives it, where ``torch.clamp`` passes
    all of it: silhouette alphas sit exactly on the 1 − 1e-7 clip bound
    inside objects, so the two differ there."""
    if lo is not None:
        x = torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype, device=x.device))
    if hi is not None:
        x = torch.minimum(x, torch.as_tensor(hi, dtype=x.dtype, device=x.device))
    return x


@contextlib.contextmanager
def full_f32():
    """No TF32 in matmuls or convolutions: the silhouette backward, the
    fit's sums and the kNN distance expansion are specified at full f32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
