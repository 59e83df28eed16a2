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


def scatter_add_rows(base: torch.Tensor, idx: torch.Tensor,
                     src: torch.Tensor) -> torch.Tensor:
    """``base.index_add(0, idx, src)`` with the additions in a fixed order,
    on every device: row ``i`` of the result is ``base[i]`` followed by the
    rows ``src[j]`` with ``idx[j] == i`` in increasing ``j``, summed from
    the left. The keys are sorted stably and each destination's run is
    summed by ``torch.segment_reduce``, which adds a segment serially (on
    the card, a thread per output element) without atomics: CUDA's
    ``index_add_`` and the accumulating ``index_put_`` of an indexing
    backward add in no fixed order, so a fit through them did not repeat
    bit for bit. On the CPU the result equals ``index_add`` bit for bit.

    base (N, ...), idx (M,) integer in [0, N), src (M, ...) → (N, ...)."""
    n = base.shape[0]
    keys = torch.cat([torch.arange(n, device=idx.device), idx.long()])
    keys, order = torch.sort(keys, stable=True)
    rows = torch.cat([base.reshape(n, -1), src.reshape(src.shape[0], -1)])
    offsets = torch.searchsorted(
        keys, torch.arange(n + 1, device=keys.device))
    out = torch.segment_reduce(rows[order], "sum", offsets=offsets,
                               unsafe=True)
    return out.reshape(base.shape)


class _TakeRows(torch.autograd.Function):
    """``x[idx]`` along dim 0 whose backward is :func:`scatter_add_rows`."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.shape = x.shape
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        zero = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        return scatter_add_rows(zero, idx, g), None


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``x[idx]`` (idx any shape, int) → idx.shape + x.shape[1:], with a
    backward that adds in a fixed order (:func:`scatter_add_rows`)."""
    out = _TakeRows.apply(x, idx.reshape(-1).long())
    return out.reshape(*idx.shape, *x.shape[1:])
