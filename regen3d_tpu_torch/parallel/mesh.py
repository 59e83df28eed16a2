"""Device mesh and parameter partition rules (counterpart of
regen3d_tpu/parallel/mesh.py).

The JAX package names a ('dp', 'tp') ``jax.sharding.Mesh`` and places each
parameter by its flax path; GSPMD inserts the collectives. The port builds a
``torch.distributed`` ``DeviceMesh`` over the ranks of a process group the
caller started (NCCL on the card, gloo on the CPU) and places each
parameter by the same rules, read off the same flax path (the weight
bridge's name map, ``models/from_jax``):

* the mesh spans every rank of the group; its axes are always ('dp', 'tp');
* ``DEFAULT_RULES`` and :func:`partition_spec_for` are the JAX package's: a
  spec is a tuple of mesh axis names or ``None``, one per axis of the flax
  leaf, and the first matching rule wins;
* the spec is written on flax's layout. ``layers.Dense`` stores torch's
  (out, in), so ``(None, 'tp')`` on a kernel is ``Shard(0)`` of ``weight``
  over 'tp' and ``('tp', None)`` is ``Shard(1)``;
* JAX's two fallbacks hold: a spec naming more axes than the leaf has
  replicates, and so does an axis the mesh does not divide. An attention's
  projections also replicate where the axis does not divide its heads, so
  that each rank holds whole heads;
* a parameter keeps one plain tensor per rank, its local shard, and the
  plan records its DTensor placements (:func:`dtensor` wraps it as the
  DTensor it is a shard of). The optimizer, the flash kernels and every
  replicated layer therefore run as on one device; the sharded ``Dense``
  layers compute through ``parallel/tp``;
* a fused qkv kernel sharded over its output (``attn/qkv``) is placed
  head-blocked: rank r holds the q, k and v columns of its own heads, where
  a contiguous shard of JAX's layout would cut across the q | k | v thirds.
  This is how the port realises JAX's ``P(None, 'tp')`` on that kernel: a
  divergence of layout, not of function (ROADMAP Queue 3).

Sharded paths need a process group and say so; nothing here starts one.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# torch.distributed.tensor (DTensor, Placement, Shard, Replicate) is
# imported where it is used: it takes about a second to import, and every
# model module imports this package through parallel/tp.py
Spec = Tuple[Optional[str], ...]

# matched (first hit wins) against the '/'-joined flax parameter path:
#   q/k/v, qkv and fc1 kernels shard their output features (column);
#   proj and fc2 kernels shard their input features (row);
#   everything else replicates.
DEFAULT_RULES: List[Tuple[str, Spec]] = [
    (r"(attn|cross|gather|query_cross)/(q|k|v)/kernel$", (None, "tp")),
    (r"(attn|cross|gather|query_cross)/(q|k|v)/bias$", ("tp",)),
    (r"(attn|cross|gather|query_cross)/proj/kernel$", ("tp", None)),
    # fused-qkv ViT blocks (VGGT aggregator/backbone, SAM encoder): column
    # parallel on the fused output, row parallel on the out-projection
    (r"attn/qkv/kernel$", (None, "tp")),
    (r"attn/qkv/bias$", ("tp",)),
    (r"mlp/fc1/kernel$", (None, "tp")),
    (r"mlp/fc1/bias$", ("tp",)),
    (r"mlp/fc2/kernel$", ("tp", None)),
    (r"(t_mlp)/fc1/kernel$", (None, "tp")),
    (r"(t_mlp)/fc1/bias$", ("tp",)),
    (r"(t_mlp)/fc2/kernel$", ("tp", None)),
    (r"adaLN(_out)?/kernel$", (None, "tp")),
    (r"adaLN(_out)?/bias$", ("tp",)),
]


def partition_spec_for(path: str,
                       rules: Sequence[Tuple[str, Spec]] = tuple(DEFAULT_RULES)
                       ) -> Spec:
    for pattern, spec in rules:
        if re.search(pattern, path):
            return tuple(spec)
    return ()


def mesh_shape(n: int, tp: Optional[int] = None) -> Tuple[int, int]:
    """(dp, tp) for ``n`` devices, JAX's rule: ``tp`` defaults to 4 where
    it divides n, else 2 where it divides n, else 1; dp gets the rest."""
    if tp is None:
        tp = next((c for c in (4, 2) if n % c == 0 and n >= c), 1)
    if tp <= 0 or n % tp:
        raise ValueError(f"tp={tp} does not divide {n} devices")
    return n // tp, tp


# the mesh of the running process group: phase 6 asks for one at every call
# and init_device_mesh makes new communicators each time
_MESHES: Dict[Tuple[int, Optional[int]], Tuple[object, object]] = {}


def make_mesh(tp: Optional[int] = None):
    """A ('dp', 'tp') ``DeviceMesh`` over every rank of the running process
    group (``cuda`` under NCCL, ``cpu`` under gloo), ``tp`` as in
    :func:`mesh_shape`. A group of one rank gives a 1 × 1 mesh: the same
    program runs unchanged. The mesh is made once per process group and
    ``tp``. Raises without a process group: start one with
    ``torch.distributed.init_process_group``."""
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh: no torch.distributed process group; "
                           "start one (init_process_group) on every rank")
    world = dist.group.WORLD
    group, mesh = _MESHES.get((id(world), tp), (None, None))
    if group is world:
        return mesh
    for key in [k for k, (g, _) in _MESHES.items() if g is not world]:
        del _MESHES[key]                    # meshes of groups since ended
    dp, tpn = mesh_shape(dist.get_world_size(), tp)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = init_device_mesh(device_type, (dp, tpn),
                            mesh_dim_names=("dp", "tp"))
    # the group is held with its mesh, so its id is not reused while cached
    _MESHES[(id(world), tp)] = (world, mesh)
    return mesh


@dataclasses.dataclass(frozen=True)
class ParamPlacement:
    """Where one parameter lives: its flax path and its DTensor placements
    on the mesh (on torch's layout), one per mesh axis."""

    path: str
    placements: Tuple["Placement", ...]

    @property
    def sharded(self) -> bool:
        from torch.distributed.tensor import Shard

        return any(isinstance(p, Shard) for p in self.placements)


def _flax_to_torch_axes(module: torch.nn.Module, leaf: str, ndim: int
                        ) -> Tuple[int, ...]:
    """For each axis of the flax leaf, the axis of the torch parameter that
    holds it (the bridge's layout rules, ``models/from_jax``)."""
    from regen3d_tpu_torch.models.layers import ConvTranspose

    if leaf == "kernel" and ndim == 2:
        return (1, 0)                       # (in, out) → (out, in)
    if leaf == "kernel" and ndim == 4:
        if isinstance(module, ConvTranspose):
            return (2, 3, 0, 1)             # (H, W, I, O) → (I, O, H, W)
        return (2, 3, 1, 0)                 # (H, W, I, O) → (O, I, H, W)
    return tuple(range(ndim))


def _fallback(spec: Spec, shape: Sequence[int], sizes: Mapping[str, int]
              ) -> Spec:
    """JAX's two fallbacks: a spec naming more axes than the leaf has
    replicates; an axis the mesh does not divide replicates."""
    if len([s for s in spec if s is not None]) > len(shape) \
            or len(spec) > len(shape):
        return ()
    return tuple(None if s is None or shape[d] % sizes[s] else s
                 for d, s in enumerate(spec))


def plan_placements(model: torch.nn.Module, sizes: Mapping[str, int],
                    rules: Sequence[Tuple[str, Spec]] = tuple(DEFAULT_RULES)
                    ) -> Dict[str, ParamPlacement]:
    """Every parameter of ``model`` (by its torch name) → its placement on a
    mesh of axis ``sizes`` (e.g. {'dp': 2, 'tp': 4}), without a process
    group: the rules on the flax path, the fallbacks, an attention's
    projections replicated where an axis does not divide its heads, and a
    ``Dense``'s bias replicated where its kernel is."""
    from torch.distributed.tensor import Replicate, Shard

    from regen3d_tpu_torch.models.from_jax import _flax_leaf
    from regen3d_tpu_torch.models.layers import (
        Attention,
        Dense,
        FusedAttention,
    )

    axes = tuple(sizes)
    plan = {}
    for name, p in model.named_parameters():
        path, t = _flax_leaf(model, name, p.detach(), frozenset())
        owner = model.get_submodule(name.rsplit(".", 1)[0]) \
            if "." in name else model
        spec = _fallback(partition_spec_for("/".join(path), rules),
                         t.shape, sizes)
        to_torch = _flax_to_torch_axes(owner, path[-1], t.ndim)
        placements = []
        for axis in axes:
            dims = [to_torch[d] for d, s in enumerate(spec) if s == axis]
            placements.append(Shard(dims[0]) if dims else Replicate())
        plan[name] = ParamPlacement("/".join(path), tuple(placements))

    def replicate(n):
        plan[n] = ParamPlacement(plan[n].path, (Replicate(),) * len(axes))

    for mname, mod in model.named_modules():
        if isinstance(mod, (Attention, FusedAttention)):
            leaves = [f"{mname}.{c}.{leaf}".lstrip(".")
                      for c in ("q", "k", "v", "qkv", "proj")
                      for leaf in ("weight", "bias")]
            leaves = [n for n in leaves if n in plan]
            used = {a for n in leaves
                    for a, x in zip(axes, plan[n].placements)
                    if isinstance(x, Shard)}
            if any(mod.num_heads % sizes[a] for a in used):
                for n in leaves:
                    replicate(n)
    for mname, mod in model.named_modules():
        # a Dense whose kernel replicates computes whole: so is its bias
        bias = f"{mname}.bias".lstrip(".")
        if isinstance(mod, Dense) and bias in plan \
                and not plan[f"{mname}.weight".lstrip(".")].sharded:
            replicate(bias)
    return plan


def _local_block(t: torch.Tensor, placements, mesh) -> torch.Tensor:
    from torch.distributed.tensor import Shard

    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = mesh.size(i)
            w = t.shape[pl.dim] // n
            t = t.narrow(pl.dim, mesh.get_local_rank(i) * w, w)
    return t.contiguous()


def _head_blocked(w: torch.Tensor, n: int) -> torch.Tensor:
    """A fused qkv weight (3·E, in) or bias (3·E,) reordered so that its
    n contiguous row blocks are each [q | k | v] of one block of heads."""
    e = w.shape[0] // 3
    return w.reshape(3, n, e // n, *w.shape[1:]).transpose(0, 1).reshape(
        w.shape)


def _unhead_blocked(w: torch.Tensor, n: int) -> torch.Tensor:
    e = w.shape[0] // 3
    return w.reshape(n, 3, e // n, *w.shape[1:]).transpose(0, 1).reshape(
        w.shape)


def shard_params(model: torch.nn.Module, mesh,
                 rules: Sequence[Tuple[str, Spec]] = tuple(DEFAULT_RULES)
                 ) -> Dict[str, ParamPlacement]:
    """Place ``model``'s parameters on ``mesh`` by the partition rules, in
    place: each sharded parameter keeps this rank's shard, each sharded
    ``Dense`` gets its column or row layout, and the q/k norms of an
    attention whose heads are split sum their gradients over the group.
    Returns the plan (:func:`plan_placements`)."""
    from torch.distributed.tensor import Shard

    from regen3d_tpu_torch.models.layers import (
        Attention,
        Dense,
        FusedAttention,
        Mlp,
    )
    from regen3d_tpu_torch.parallel.tp import TPLayout

    axes = mesh.mesh_dim_names
    plan = plan_placements(model, {a: mesh.size(i)
                                   for i, a in enumerate(axes)}, rules)
    # (consumer Dense, its producers) pairs whose features stay local
    pairs = []
    for mname, mod in model.named_modules():
        if isinstance(mod, Mlp):
            pairs.append((mod.fc2, [mod.fc1]))
        elif isinstance(mod, Attention):
            pairs.append((mod.proj, [mod.q, mod.k, mod.v]))
        elif isinstance(mod, FusedAttention):
            pairs.append((mod.proj, [mod.qkv]))

    names = {id(p): n for n, p in model.named_parameters()}

    def layout(mod: Dense):
        """(role, mesh axis index) of a Dense from its weight's placement."""
        name = names[id(mod.weight)]
        shards = [(i, pl.dim) for i, pl in
                  enumerate(plan[name].placements) if isinstance(pl, Shard)]
        if not shards:
            return None
        if len(shards) > 1:
            raise NotImplementedError(f"{name} is sharded over two mesh axes")
        i, dim = shards[0]
        if mod.bias is not None:
            bias = plan[name[:-len("weight")] + "bias"].placements
            if dim == 1 and any(isinstance(pl, Shard) for pl in bias):
                raise NotImplementedError(f"{name}: a row projection with a "
                                          f"sharded bias")
        return ("col" if dim == 0 else "row"), i

    local_pairs = {}
    for consumer, producers in pairs:
        c = layout(consumer)
        ps = [layout(p) for p in producers]
        if c is not None and c[0] == "row" and all(
                p == ("col", c[1]) for p in ps):
            local_pairs[id(consumer)] = producers

    fused_heads = {id(m.qkv) for m in model.modules()
                   if isinstance(m, FusedAttention)
                   and id(m.proj) in local_pairs}
    paired = {id(p) for ps in local_pairs.values() for p in ps}
    for mname, mod in model.named_modules():
        if isinstance(mod, Dense):
            lay = layout(mod)
            if lay is None:
                continue
            role, i = lay
            group = mesh.get_group(i)
            mod.tp = TPLayout(role, group, mesh.get_local_rank(i),
                              mesh.size(i),
                              gather=role == "col" and id(mod) not in paired)
            for leaf in ("weight", "bias"):
                p = getattr(mod, leaf)
                if p is None:
                    continue
                pl = plan[f"{mname}.{leaf}".lstrip(".")].placements
                data = p.data
                if id(mod) in fused_heads:
                    data = _head_blocked(data, mesh.size(i))
                p.data = _local_block(data, pl, mesh)
        elif isinstance(mod, Attention) and mod.q_norm is not None \
                and id(mod.proj) in local_pairs:
            i = layout(mod.proj)[1]
            for norm in (mod.q_norm, mod.k_norm):
                norm.tp = TPLayout("partial", mesh.get_group(i),
                                   mesh.get_local_rank(i), mesh.size(i))
    return plan


def dtensor(param: torch.Tensor, placement: ParamPlacement, mesh):
    """A rank's shard of a parameter as the DTensor it is part of (the fused
    qkv leaves in their head-blocked order)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(param.detach(), mesh, placement.placements,
                              run_check=False)


def full_state_dict(model: torch.nn.Module, plan: Dict[str, ParamPlacement],
                    mesh, grads: bool = False) -> Dict[str, torch.Tensor]:
    """Every parameter (or, with ``grads``, its gradient) whole, on every
    rank, in the unsharded layout: the inverse of :func:`shard_params`'s
    placement. A collective: every rank of the mesh calls it."""
    from regen3d_tpu_torch.models.layers import Dense, FusedAttention

    fused = {id(m.qkv) for m in model.modules()
             if isinstance(m, FusedAttention) and m.qkv.tp is not None
             and not m.qkv.tp.gather}
    owners = {id(getattr(m, leaf)): m for m in model.modules()
              if isinstance(m, Dense)
              for leaf in ("weight", "bias") if getattr(m, leaf) is not None}
    out = {}
    for name, p in model.named_parameters():
        t = p.grad if grads else p
        if t is None:
            continue
        pl = plan[name]
        if pl.sharded:
            t = dtensor(t, pl, mesh).full_tensor()
            owner = owners.get(id(p))
            if owner is not None and id(owner) in fused:
                t = _unhead_blocked(t, owner.tp.size)
        out[name] = t.detach()
    return out
