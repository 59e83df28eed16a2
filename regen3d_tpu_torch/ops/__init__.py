"""Geometry and attention ops of the port."""

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
