"""The distilled shape generator's checkpoint: its configuration and its
``.npz`` reader and writer (counterpart of the loader half of
regen3d_tpu/pipeline/shape_distill.py; the trainers are ROADMAP Queue 1's
trainer item).

The checkpoint is one ``.npz``: every leaf of the condition encoder's, the
shape DiT's and the SDF decoder's flax trees under ``"<part>:<path>"``
(``cond``, ``dit``, ``dec``; the path's levels joined by ``/``), the first
two in f16 and the decoder in f32, and a ``__config__`` entry holding the
configuration as JSON bytes. Reading casts every leaf to f32, as the JAX
package does, and carries the trees into the port's modules through
``models/from_jax.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Mapping

import numpy as np

from regen3d_tpu_torch.models.dit import DiTConfig, ShapeDiT
from regen3d_tpu_torch.models.from_jax import load_from_jax
from regen3d_tpu_torch.models.shapevae import ShapeDecoder, ShapeVAEConfig
from regen3d_tpu_torch.pipeline.phase3_assets import AssetGenerator, CondEncoder

PARTS = ("cond", "dit", "dec")


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    dit: DiTConfig
    vae: ShapeVAEConfig
    cond_depth: int
    cond_heads: int
    cond_patch: int
    image_size: int

    @classmethod
    def small(cls) -> "DistillConfig":
        """The committed checkpoint's scale (~10 M parameters)."""
        dit = DiTConfig(latent_tokens=64, latent_dim=16, width=256, depth=6,
                        num_heads=8, cond_dim=256)
        vae = ShapeVAEConfig(latent_tokens=64, latent_dim=16, width=256,
                             enc_depth=2, dec_depth=4, num_heads=8,
                             num_freqs=8)
        return cls(dit=dit, vae=vae, cond_depth=2, cond_heads=8,
                   cond_patch=8, image_size=64)

    @classmethod
    def micro(cls) -> "DistillConfig":
        """CPU-test scale."""
        dit = DiTConfig(latent_tokens=16, latent_dim=8, width=64, depth=2,
                        num_heads=4, cond_dim=64)
        vae = ShapeVAEConfig(latent_tokens=16, latent_dim=8, width=64,
                             enc_depth=1, dec_depth=2, num_heads=4,
                             num_freqs=6)
        return cls(dit=dit, vae=vae, cond_depth=1, cond_heads=4,
                   cond_patch=8, image_size=32)

    def cond_encoder(self, device="cuda") -> CondEncoder:
        """The condition encoder, computing in the DiT's dtype."""
        return CondEncoder(width=self.dit.cond_dim, depth=self.cond_depth,
                           num_heads=self.cond_heads, patch=self.cond_patch,
                           dtype=self.dit.dtype, device=device)

    def with_dtype(self, dtype) -> "DistillConfig":
        """The same generator computing in ``dtype`` (f32 for the plain
        reference of a bf16 run)."""
        return dataclasses.replace(
            self, dit=dataclasses.replace(self.dit, dtype=dtype),
            vae=dataclasses.replace(self.vae, dtype=dtype))


def build_generator(cfg: DistillConfig, cond_params: Mapping,
                    dit_params: Mapping, dec_params: Mapping,
                    device="cuda") -> AssetGenerator:
    """The trained generator on ``device`` from its three flax trees (numpy
    leaves); every leaf must be used once."""
    cond = cfg.cond_encoder(device)
    dit = ShapeDiT(cfg.dit, device=device)
    decoder = ShapeDecoder(cfg.vae, device=device)
    for module, params in ((cond, cond_params), (dit, dit_params),
                           (decoder, dec_params)):
        load_from_jax(module, params)
    return AssetGenerator(dit_cfg=cfg.dit, vae_cfg=cfg.vae, cond=cond,
                          dit=dit, decoder=decoder,
                          image_size=cfg.image_size, trained=True)


def _flatten(tree: Mapping, prefix: str, dtype) -> Dict[str, np.ndarray]:
    """{"<prefix>:<a>/<b>/...": leaf in ``dtype``} in sorted key order."""
    out = {}
    for key in sorted(tree):
        value = tree[key]
        path = f"{prefix}/{key}" if ":" in prefix else f"{prefix}:{key}"
        if isinstance(value, Mapping):
            out.update(_flatten(value, path, dtype))
        else:
            out[path] = np.asarray(value, dtype)
    return out


def _unflatten(npz, prefix: str) -> Dict:
    """The nested tree of one part, every leaf cast to f32."""
    out: Dict = {}
    for key in npz.files:
        if not key.startswith(prefix + ":"):
            continue
        node = out
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(npz[key], np.float32)
    return out


def _config_dict(c) -> Dict:
    return {k: v for k, v in dataclasses.asdict(c).items() if k != "dtype"}


def save_generator(path: str, cfg: DistillConfig, params: Mapping) -> None:
    """One ``.npz`` from {"cond", "dit", "dec"} flax trees: f16 leaves for
    the first two, f32 for the decoder (its values place the iso-surface),
    and the JSON configuration."""
    meta = {"dit": _config_dict(cfg.dit), "vae": _config_dict(cfg.vae),
            "cond_depth": cfg.cond_depth, "cond_heads": cfg.cond_heads,
            "cond_patch": cfg.cond_patch, "image_size": cfg.image_size}
    blobs = {}
    for name in ("cond", "dit"):
        blobs.update(_flatten(params[name], name, np.float16))
    blobs.update(_flatten(params["dec"], "dec", np.float32))
    blobs["__config__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **blobs)


def load_params(path: str):
    """(DistillConfig, {"cond", "dit", "dec"}: f32 flax trees) of a
    checkpoint."""
    with np.load(path) as npz:
        meta = json.loads(bytes(npz["__config__"]).decode())
        params = {name: _unflatten(npz, name) for name in PARTS}
    cfg = DistillConfig(
        dit=DiTConfig(**meta["dit"]), vae=ShapeVAEConfig(**meta["vae"]),
        cond_depth=int(meta["cond_depth"]), cond_heads=int(meta["cond_heads"]),
        cond_patch=int(meta["cond_patch"]),
        image_size=int(meta["image_size"]))
    return cfg, params


def load_generator(path: str, device="cuda") -> AssetGenerator:
    """The serving generator of a distilled ``.npz``, on ``device``."""
    cfg, params = load_params(path)
    return build_generator(cfg, params["cond"], params["dit"], params["dec"],
                           device=device)
