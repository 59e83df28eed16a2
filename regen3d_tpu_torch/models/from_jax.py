"""Carry the flax parameter tree of ``regen3d_tpu.models.vggt.VGGT`` into the
port's :class:`~regen3d_tpu_torch.models.vggt.VGGT` state dict.

The port names its submodules after the flax tree, so the map is
mechanical: path ``a/b/c/leaf`` → ``a.b.c.leaf`` with

* ``Dense.kernel (in, out)`` → ``Linear.weight (out, in)``;
* ``Conv.kernel (H, W, I, O)`` → ``Conv2d.weight (O, I, H, W)``;
* ``LayerNorm.scale`` → ``weight``; every other leaf keeps its name.

Takes numpy arrays (``jax.device_get`` of the tree) and imports no JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def vggt_state_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax VGGT params (with or without the top ``params`` level) → state
    dict for ``VGGT.load_state_dict(..., strict=True)``. Raises on a leaf it
    cannot place."""
    if set(params) == {"params"}:
        params = params["params"]
    state = {}
    for path, arr in _flatten(params).items():
        *mods, leaf = path
        if leaf == "kernel" and arr.ndim == 2:
            leaf, arr = "weight", arr.T
        elif leaf == "kernel" and arr.ndim == 4:
            leaf, arr = "weight", arr.transpose(3, 2, 0, 1)
        elif leaf == "kernel":
            raise ValueError(f"unexpected kernel rank at {'/'.join(path)}")
        elif leaf == "scale":
            leaf = "weight"
        name = ".".join([*mods, leaf])
        if name in state:
            raise ValueError(f"two flax leaves map to {name}")
        state[name] = torch.from_numpy(np.array(arr))
    return state


def load_vggt_from_jax(model: torch.nn.Module, params: Mapping) -> None:
    """Load a flax tree into ``model``; every leaf must be used exactly once
    and every model parameter must be set (``strict=True``)."""
    model.load_state_dict(vggt_state_from_jax(params), strict=True)
