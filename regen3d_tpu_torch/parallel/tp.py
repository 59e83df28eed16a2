"""Tensor-parallel projections and the collectives between them.

The JAX package shards a projection's kernel over the mesh's ``tp`` axis
and leaves the collectives to GSPMD. The port places the parameters with
``parallel/mesh.shard_params`` and computes each sharded ``Dense`` on the
rank's own shard, as Megatron-LM pairs its projections:

* a **column** projection (the kernel's output features over the group)
  returns this rank's output features; its input is replicated, so the
  backward sums the input's gradient over the group (:func:`copy_to`);
* a **row** projection (the kernel's input features over the group) takes
  this rank's input features (or slices them off a replicated input) and
  sums the partial products over the group (:func:`reduce_from`), whose
  backward passes the replicated gradient on unchanged. Its bias, held
  whole on every rank, is added by rank 0 of the group alone, inside the
  same product as on one device;
* a column projection whose consumer is not a row projection gathers its
  output features (:func:`gather_from`; the backward keeps this rank's
  slice of the replicated gradient).

So between a column projection and its row partner every tensor is local
(the attention's heads, the MLP's hidden features), and the flash kernels
receive plain tensors of this rank's heads. A group of one rank computes
the unsharded function bit for bit: each collective would then be a copy
and is skipped, and each product is the same call on the same tensors.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True, eq=False)
class TPLayout:
    """How a module's parameter is split over one process group.

    ``role`` is ``"col"`` or ``"row"`` for a ``Dense`` (its output or input
    features over the group) or ``"partial"`` for a parameter applied to
    this rank's heads only (an RMSNorm over the head dim), whose gradient
    sums over the group. ``gather`` (column only): all-gather the output
    features."""

    role: str
    group: dist.ProcessGroup
    rank: int
    size: int
    gather: bool = False


class _CopyTo(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if dist.get_world_size(ctx.group) == 1:
            return g, None
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    """Sum over the group forward; the backward passes the gradient on."""

    @staticmethod
    def forward(ctx, x, group):
        if dist.get_world_size(group) == 1:
            return x.view_as(x)
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    """All-gather of the last axis forward, in rank order; the backward
    keeps this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        n = dist.get_world_size(group)
        ctx.rank, ctx.width = dist.get_rank(group), x.shape[-1]
        if n == 1:
            return x.view_as(x)
        parts = [torch.empty_like(x.contiguous()) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, -1)

    @staticmethod
    def backward(ctx, g):
        if ctx.rank == 0 and g.shape[-1] == ctx.width:
            return g, None
        lo = ctx.rank * ctx.width
        return g[..., lo:lo + ctx.width].contiguous(), None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, group) -> torch.Tensor:
    return _GatherFrom.apply(x, group)


def linear(tp: TPLayout, x: torch.Tensor, w: torch.Tensor,
           b: torch.Tensor | None) -> torch.Tensor:
    """``F.linear`` of a sharded ``Dense``: ``w`` is this rank's shard
    (out, in) and ``b`` its bias (the local slice, or whole)."""
    g = tp.group
    if tp.role == "col":
        n = w.shape[0]
        if b is not None and b.shape[0] != n:        # a replicated bias
            b = copy_to(b, g)[tp.rank * n:(tp.rank + 1) * n]
        y = F.linear(copy_to(x, g), w, b)
        return gather_from(y, g) if tp.gather else y
    n = w.shape[1]
    if x.shape[-1] != n:                             # a replicated input
        x = copy_to(x, g)[..., tp.rank * n:(tp.rank + 1) * n]
    if b is not None:
        b = copy_to(b, g) * (1.0 if tp.rank == 0 else 0.0)
    return reduce_from(F.linear(x, w, b), g)
