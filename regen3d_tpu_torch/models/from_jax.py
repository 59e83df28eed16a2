"""Carry a flax parameter tree of the JAX package's models into the port's
state dicts: ``regen3d_tpu.models.vggt.VGGT`` → :class:`~regen3d_tpu_torch.
models.vggt.VGGT`, ``regen3d_tpu.models.sam.SAM`` →
:class:`~regen3d_tpu_torch.models.sam.SAM` and
``regen3d_tpu.models.dit.ShapeDiT`` →
:class:`~regen3d_tpu_torch.models.dit.ShapeDiT`,
``regen3d_tpu.models.lpips.LPIPS`` →
:class:`~regen3d_tpu_torch.models.lpips.LPIPS`, and phase 3's generator:
``regen3d_tpu.pipeline.phase3_assets.CondEncoder`` →
:class:`~regen3d_tpu_torch.pipeline.phase3_assets.CondEncoder` and
``regen3d_tpu.models.shapevae.{ShapeEncoder,ShapeDecoder}`` →
:mod:`regen3d_tpu_torch.models.shapevae`, and phase 1's detector, saliency
net and Depth-Anything (``regen3d_tpu.models.{detector,saliency,
depth_anything}`` → their namesakes in :mod:`regen3d_tpu_torch.models`).

The port names its submodules after the flax tree, so the map is
mechanical: path ``a/b/c/leaf`` → ``a.b.c.leaf`` with

* ``Dense.kernel (in, out)`` → ``Linear.weight (out, in)``;
* ``Conv.kernel (H, W, I, O)`` → ``Conv2d.weight (O, I, H, W)`` (the
  condition encoder's ``patch/proj``: (8, 8, 4, 256) → (256, 4, 8, 8));
* ``ConvTranspose.kernel (H, W, I, O)`` → ``ConvTranspose2d.weight
  (I, O, H, W)`` with the taps mirrored: flax does not flip the kernel,
  torch does (see ``layers.ConvTranspose``). Which 4-D kernels are
  transposed convolutions is named per model, since the shapes cannot tell
  (where I = O a Conv rule would load mirrored taps in silence);
* ``LayerNorm.scale`` and ``RMSNorm.scale`` → ``weight``;
* ``Embed.embedding`` (the detector's ``byte_embed``) → ``Embedding.weight``
  (both (vocabulary, width)); every other leaf
  (``bias``, ``latent_pos``, ``latent_queries``, ``inst_gate{i}``, SAM's
  tables) keeps its name.

Takes numpy arrays (``jax.device_get`` of the tree) and imports no JAX.
:func:`tree_from_model` is the inverse: a port module's parameters as the
flax tree (the upstream-layout round trips of ``models/conversion.py``
start from it).
"""

from __future__ import annotations

from typing import Any, Dict, FrozenSet, Mapping

import numpy as np
import torch

# module names of the transposed convolutions, per model
SAM_CONV_TRANSPOSE = frozenset({"up1", "up2"})
SALIENCY_CONV_TRANSPOSE = frozenset({"up8", "up4"})
DEPTH_ANYTHING_CONV_TRANSPOSE = frozenset({"resize0", "resize1"})


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def state_from_jax(params: Mapping,
                   conv_transpose: FrozenSet[str] = frozenset()
                   ) -> Dict[str, torch.Tensor]:
    """flax params (with or without the top ``params`` level) → state dict
    for ``load_state_dict(..., strict=True)``. A 4-D kernel whose module is
    named in ``conv_transpose`` takes the ConvTranspose rule. Raises on a
    leaf it cannot place."""
    if set(params) == {"params"}:
        params = params["params"]
    state = {}
    for path, arr in _flatten(params).items():
        *mods, leaf = path
        if leaf == "kernel" and arr.ndim == 2:
            leaf, arr = "weight", arr.T
        elif leaf == "kernel" and arr.ndim == 4 and mods[-1] in conv_transpose:
            leaf, arr = "weight", arr[::-1, ::-1].transpose(2, 3, 0, 1)
        elif leaf == "kernel" and arr.ndim == 4:
            leaf, arr = "weight", arr.transpose(3, 2, 0, 1)
        elif leaf == "kernel":
            raise ValueError(f"unexpected kernel rank at {'/'.join(path)}")
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        name = ".".join([*mods, leaf])
        if name in state:
            raise ValueError(f"two flax leaves map to {name}")
        state[name] = torch.from_numpy(np.array(arr))
    return state


def load_from_jax(model: torch.nn.Module, params: Mapping,
                  conv_transpose: FrozenSet[str] = frozenset()) -> None:
    """Load a flax tree into ``model``; every leaf must be used exactly once
    and every model parameter must be set (``strict=True``).
    ``conv_transpose`` names the model's transposed convolutions
    (``SAM_CONV_TRANSPOSE``, ``SALIENCY_CONV_TRANSPOSE``,
    ``DEPTH_ANYTHING_CONV_TRANSPOSE``). f32 leaves load into f32
    parameters and are cast where a parameter is stored in another
    dtype."""
    model.load_state_dict(state_from_jax(params, conv_transpose), strict=True)


def _flax_leaf(model: torch.nn.Module, name: str, t: torch.Tensor,
               conv_transpose: FrozenSet[str]):
    """The inverse of ``state_from_jax``'s rule for one state-dict entry:
    (flax path, tensor in flax layout)."""
    *mods, leaf = name.split(".")
    if leaf == "weight":
        owner = model.get_submodule(".".join(mods))
        if isinstance(owner, torch.nn.Embedding):
            leaf = "embedding"
        elif t.ndim == 2:
            leaf, t = "kernel", t.T
        elif t.ndim == 4 and mods[-1] in conv_transpose:
            leaf, t = "kernel", t.permute(2, 3, 0, 1).flip(0, 1)
        elif t.ndim == 4:
            leaf, t = "kernel", t.permute(2, 3, 1, 0)
        elif t.ndim == 1:
            leaf = "scale"
        else:
            raise ValueError(f"unexpected weight rank at {name}")
    return tuple(mods) + (leaf,), t


def tree_from_model(model: torch.nn.Module,
                    conv_transpose: FrozenSet[str] = frozenset()
                    ) -> Dict[str, Any]:
    """``model``'s state dict as the flax tree ``{"params": ...}`` that
    ``load_from_jax`` would load back into it exactly: numpy arrays (bf16
    widened to f32; kernels are transposed views, and an f32 parameter on
    the CPU shares its memory), or, for parameters on the ``meta``
    device, meta tensors that carry only the shapes."""
    from regen3d_tpu_torch.models.weights import to_numpy, unflatten_tree

    flat = {}
    for name, t in model.state_dict().items():
        path, t = _flax_leaf(model, name, t, conv_transpose)
        flat[path] = t if t.is_meta else to_numpy(t)
    return {"params": unflatten_tree(flat)}
