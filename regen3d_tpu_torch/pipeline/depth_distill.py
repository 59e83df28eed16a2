"""The Depth-Anything checkpoint's writer and loader (counterpart of
``save_depth_checkpoint`` and ``load_depth_checkpoint`` of
regen3d_tpu/pipeline/depth_distill.py; the trainer is ROADMAP Queue 1
item 8). The checkpoint is a directory of either kind
``models/weights.py`` reads, with a ``config.json`` sidecar of the
``DepthAnythingConfig`` (without its dtype) that ``pipeline/depth.py``'s
``depth_anything_checkpoint`` honours.
"""

from __future__ import annotations

from regen3d_tpu_torch.models.depth_anything import (
    DepthAnything,
    DepthAnythingConfig,
)
from regen3d_tpu_torch.models.from_jax import DEPTH_ANYTHING_CONV_TRANSPOSE
from regen3d_tpu_torch.models.weights import (
    load_model,
    read_config_json,
    save_model,
)


def save_depth_checkpoint(path: str, model: DepthAnything) -> None:
    """``model``'s weights as the port's checkpoint directory, with its
    config as the sidecar."""
    save_model(path, model, model.cfg, DEPTH_ANYTHING_CONV_TRANSPOSE)


def load_depth_checkpoint(path: str, device="cuda") -> DepthAnything:
    """→ Depth-Anything with the checkpoint's weights, on ``device``, at
    the sidecar's config (``out_idx`` and ``out_channels`` back to tuples)
    or, without one, ``DepthAnythingConfig.small()`` (the ViT-S widths a
    converted checkpoint has). A missing directory raises
    ``FileNotFoundError``."""
    d = read_config_json(path)
    if d is not None:
        d["out_idx"] = tuple(d["out_idx"])
        d["out_channels"] = tuple(d["out_channels"])
        cfg = DepthAnythingConfig(**d)
    else:
        cfg = DepthAnythingConfig.small()
    return load_model(DepthAnything(cfg, device=device), path,
                      DEPTH_ANYTHING_CONV_TRANSPOSE)
