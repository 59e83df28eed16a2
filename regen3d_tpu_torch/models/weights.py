"""Checkpoint I/O: upstream torch files → the flax-path trees the weight
bridge loads, and checkpoint directories (counterpart of
regen3d_tpu/models/weights.py).

A *tree* is a nested dict of numpy arrays keyed by the flax module path,
top ``params`` level included, as the JAX package's loaders return it;
``models/from_jax.load_from_jax`` takes it into a port module.

Two kinds of checkpoint directory are read by :func:`load_checkpoint`:

* **orbax** (``manifest.ocdbt`` present): what the JAX package's
  ``save_checkpoint`` writes (OCDBT, zarr arrays). Read through the
  ``tensorstore`` package, imported where it is needed: the tree paths come
  from ``_METADATA``'s ``tree_metadata`` keys (tuple strings parsed with
  ``ast.literal_eval``) and each leaf is the zarr array
  ``<level>.<level>...`` (zarr v3 where ``use_zarr3`` is true);
* **the port's** (``params.pt`` present): :func:`save_checkpoint`'s, one
  ``torch.save`` of a flat dict keyed by the flax path joined by ``/``
  (``"params/a/b/kernel"``), read with ``weights_only=True``. It needs only
  torch; orbax is a JAX library, so this is what the port writes.

Either kind may hold a ``config.json`` sidecar, which the checkpoint's
loader (``pipeline/*_distill.py``, ``pipeline/matting.py``) reads.

bf16 leaves come back as f32 numpy arrays (numpy has no bf16 of its own):
the widening is exact, and loading into a bf16 parameter rounds back to the
same value.
"""

from __future__ import annotations

import ast
import json
import logging
import os
import re
import shutil
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

log = logging.getLogger(__name__)

PORT_FILE = "params.pt"
ORBAX_MANIFEST = "manifest.ocdbt"

# A rule: (regex over torch keys, fn(torch_key, match) -> flax path tuple,
#          fn(array) -> array)
Rule = Tuple[str, Callable[..., Any], Optional[Callable]]


# The layout changes return views: the bridge (from_jax.state_from_jax)
# undoes each one, so a checkpoint's tensors reach the module with one
# contiguous copy and no transposing copy.

def t2j_linear(w: np.ndarray) -> np.ndarray:
    """torch nn.Linear weight (out, in) → flax Dense kernel (in, out)."""
    return w.T


def t2j_conv(w: np.ndarray) -> np.ndarray:
    """torch Conv2d (out, in, kh, kw) → flax Conv (kh, kw, in, out)."""
    return np.transpose(w, (2, 3, 1, 0))


def t2j_convtranspose(w: np.ndarray) -> np.ndarray:
    """torch ConvTranspose2d (in, out, kh, kw) → flax (kh, kw, in, out)."""
    return np.transpose(w, (2, 3, 0, 1))


def to_numpy(v) -> np.ndarray:
    """A tensor or array → numpy on the host; bf16 (and any other dtype
    numpy lacks) widened to f32, which is exact (on the tensor's device,
    before the copy to the host)."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2):
            v = v.float()
        return v.cpu().numpy()
    a = np.asarray(v)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        return a.astype(np.float32)
    return a


def convert_state_dict(
    state: Mapping[str, Any],
    rules: List[Rule],
    strict: bool = False,
    unmapped_out: Optional[List[str]] = None,
) -> Dict[str, Any]:
    """Apply mapping rules to a torch state dict, build a nested flax tree
    under ``params``.

    The first rule whose regex matches a key wins. Its path_fn returns ONE
    path tuple (the transform, if any, maps the array to that leaf), a LIST
    of path tuples (the transform returns a matching list of arrays: an
    upstream fused qkv split into q, k and v) or None, which drops the key
    and counts it as mapped. Keys no rule matches are logged, raise
    ``KeyError`` under ``strict`` and are appended to ``unmapped_out``
    when it is given (gate on that list, not on the log)."""
    out: Dict[str, Any] = {}
    unused = []

    def put(path, arr):
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = arr

    for key, val in state.items():
        arr = to_numpy(val)
        matched = False
        for pattern, path_fn, transform in rules:
            m = re.match(pattern, key)
            if not m:
                continue
            path = path_fn(key, m)
            if path is None:
                pass  # explicit drop
            elif isinstance(path, list):
                for p, a in zip(path, transform(arr)):
                    put(p, a)
            else:
                put(path, transform(arr) if transform is not None else arr)
            matched = True
            break
        if not matched:
            unused.append(key)
    if unmapped_out is not None:
        unmapped_out.extend(unused)
    if unused:
        msg = f"{len(unused)} unmapped torch keys (e.g. {unused[:5]})"
        if strict:
            raise KeyError(msg)
        log.warning(msg)
    return {"params": out}


def flatten_tree(tree: Mapping, prefix: Tuple[str, ...] = ()
                 ) -> Dict[Tuple[str, ...], Any]:
    """Nested dict → {path tuple: leaf}."""
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(flatten_tree(v, prefix + (str(k),)))
        else:
            flat[prefix + (str(k),)] = v
    return flat


def unflatten_tree(flat: Mapping[Tuple[str, ...], Any]) -> Dict[str, Any]:
    """{path tuple: leaf} → nested dict."""
    out: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf
    return out


def verify_tree_shapes(converted: Mapping, reference: Mapping) -> List[str]:
    """Compare a converted tree against a reference tree of the target
    architecture (leaves need only ``.shape``); returns human-readable
    mismatches, empty when every reference leaf is present with its
    shape."""
    conv = flatten_tree(converted)
    errors = []
    for path, leaf in flatten_tree(reference).items():
        name = "/".join(path)
        if path not in conv:
            errors.append(f"missing: {name}")
        elif tuple(conv[path].shape) != tuple(leaf.shape):
            errors.append(f"shape {name}: {tuple(conv[path].shape)} vs "
                          f"{tuple(leaf.shape)}")
    return errors


def load_torch_file(path: str) -> Dict[str, np.ndarray]:
    """A ``.pt``/``.pth``/``.safetensors`` file → {key: numpy array}.

    A torch file holding a module is read through its ``state_dict``, and a
    single wrapper (``state_dict``, ``params_ema`` or ``params``: lightning,
    BasicSR's RealESRGAN) is unwrapped where the file holds at most three
    entries. Entries that are not tensors are skipped. bf16 tensors (FLUX
    ships bf16) are widened to f32 through torch, since numpy has no bf16;
    ``.safetensors`` needs the ``safetensors`` package."""
    if path.endswith(".safetensors"):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise ImportError(f"{path}: reading .safetensors needs the "
                              "safetensors package") from e
        sd = load_file(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        for wrapper in ("state_dict", "params_ema", "params"):
            if (wrapper in sd and isinstance(sd[wrapper], dict)
                    and len(sd) <= 3):
                sd = sd[wrapper]
                break
    return {k: to_numpy(v) for k, v in sd.items()
            if isinstance(v, torch.Tensor)}


# --- checkpoint directories ---------------------------------------------------

def checkpoint_kind(path: str) -> Optional[str]:
    """"port", "orbax" or None for a directory that is neither."""
    if os.path.isfile(os.path.join(path, PORT_FILE)):
        return "port"
    if os.path.isfile(os.path.join(path, ORBAX_MANIFEST)):
        return "orbax"
    return None


def save_checkpoint(path: str, tree: Mapping) -> None:
    """Write ``tree`` (nested dicts of numpy arrays or tensors) as the
    port's checkpoint directory: ``<path>/params.pt``, a flat dict of CPU
    tensors keyed by the ``/``-joined flax path. As orbax's ``force=True``
    save does, an existing checkpoint directory at ``path`` (either kind,
    its sidecar with it) is replaced; a directory holding anything else
    raises."""
    path = os.path.abspath(path)
    if os.path.isdir(path) and os.listdir(path):
        if checkpoint_kind(path) is None:
            raise FileExistsError(f"{path}: not a checkpoint directory; "
                                  "refusing to replace it")
        shutil.rmtree(path)
    os.makedirs(path, exist_ok=True)
    flat = {}
    for p, leaf in flatten_tree(tree).items():
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu().contiguous()
        else:
            a = np.asarray(leaf)
            t = (torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
                 if a.dtype.name == "bfloat16"
                 else torch.from_numpy(np.ascontiguousarray(a)))
        flat["/".join(p)] = t.clone()
    tmp = os.path.join(path, PORT_FILE + ".tmp")
    torch.save(flat, tmp)
    os.replace(tmp, os.path.join(path, PORT_FILE))


def _load_port(path: str) -> Dict[str, Any]:
    flat = torch.load(os.path.join(path, PORT_FILE), map_location="cpu",
                      weights_only=True)
    return unflatten_tree({tuple(k.split("/")): to_numpy(v)
                           for k, v in flat.items()})


def _load_orbax(path: str) -> Dict[str, Any]:
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError(
            f"{path}: an orbax checkpoint directory ({ORBAX_MANIFEST}); "
            "reading it needs the tensorstore package. Convert it with the "
            "JAX package installed, or write the port's kind "
            f"({PORT_FILE}) with models.weights.save_checkpoint") from e
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    driver = "zarr3" if meta.get("use_zarr3", False) else "zarr"
    kvstore = {"driver": "ocdbt", "base": "file://" + path + "/"}
    flat = {}
    for key, entry in meta["tree_metadata"].items():
        tree_path = tuple(str(k) for k in ast.literal_eval(key))
        value = entry.get("value_metadata", {})
        if value.get("skip_deserialize", False):
            continue
        arr = ts.open({"driver": driver, "kvstore": kvstore,
                       "path": ".".join(tree_path)},
                      open=True, read=True).result().read().result()
        flat[tree_path] = to_numpy(np.asarray(arr))
    return unflatten_tree(flat)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A checkpoint directory of either kind (see the module docstring) →
    the nested numpy tree its writer saved, top ``params`` level included.
    A missing directory, or one of neither kind, raises
    ``FileNotFoundError`` (as orbax's reader does), the latter naming both
    kinds."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"{path}: no checkpoint directory")
    kind = checkpoint_kind(path)
    if kind == "port":
        return _load_port(path)
    if kind == "orbax":
        return _load_orbax(path)
    raise FileNotFoundError(
        f"{path}: not a checkpoint directory: neither the port's "
        f"({PORT_FILE}, written by models.weights.save_checkpoint) nor "
        f"orbax's ({ORBAX_MANIFEST}, written by the JAX package)")


def write_config_json(path: str, cfg) -> None:
    """The ``config.json`` sidecar of a model's checkpoint: its config
    dataclass without ``dtype``, as the JAX package's writers dump it."""
    import dataclasses

    d = dataclasses.asdict(cfg)
    d.pop("dtype", None)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(d, f)


def read_config_json(path: str) -> Optional[Dict[str, Any]]:
    """The sidecar's dict, or None where the directory has none."""
    cfg_path = os.path.join(path, "config.json")
    if not os.path.isfile(cfg_path):
        return None
    with open(cfg_path) as f:
        return json.load(f)


def load_model(model: torch.nn.Module, path: str,
               conv_transpose=frozenset()) -> torch.nn.Module:
    """Load the checkpoint directory ``path`` (either kind) into ``model``
    through ``from_jax.load_from_jax`` (strict: every leaf used once, every
    parameter set); returns ``model``."""
    from regen3d_tpu_torch.models.from_jax import load_from_jax

    load_from_jax(model, load_checkpoint(path), conv_transpose)
    return model


def save_model(path: str, model: torch.nn.Module, cfg=None,
               conv_transpose=frozenset()) -> None:
    """Write ``model``'s parameters as the port's checkpoint directory (the
    flax tree ``from_jax.tree_from_model`` gives), with ``cfg``'s
    ``config.json`` sidecar when one is given."""
    from regen3d_tpu_torch.models.from_jax import tree_from_model

    save_checkpoint(path, tree_from_model(model, conv_transpose))
    if cfg is not None:
        write_config_json(path, cfg)
