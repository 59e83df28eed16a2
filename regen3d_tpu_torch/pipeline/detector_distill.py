"""The distilled detector's checkpoint: its writer and loader
(counterpart of ``save_detector_checkpoint`` and
``load_detector_checkpoint`` of regen3d_tpu/pipeline/detector_distill.py;
the trainer is ROADMAP Queue 1 item 8).

A checkpoint is a directory of either kind ``models/weights.py`` reads (the
JAX package's orbax one or the port's), with a ``config.json`` sidecar
holding the ``DetectorConfig`` without its dtype.
"""

from __future__ import annotations

import torch

from regen3d_tpu_torch.models.detector import DetectorConfig, OpenVocabDetector
from regen3d_tpu_torch.models.weights import (
    load_model,
    read_config_json,
    save_model,
)


def save_detector_checkpoint(path: str, model: OpenVocabDetector) -> None:
    """``model``'s weights as the port's checkpoint directory, with its
    config as the sidecar (the JAX writer takes the params and the config;
    the port's module carries both)."""
    save_model(path, model, model.cfg)


def load_detector_checkpoint(path: str, device="cuda") -> OpenVocabDetector:
    """→ the detector with the checkpoint's weights, on ``device``. With a
    ``config.json`` sidecar the config is its dict; the JAX loader computes
    it in f32, and so does the port on the CPU, while on the card it
    computes in bf16, the type the flash kernel takes (ROADMAP Queue 3
    au). Without a sidecar, ``DetectorConfig()``. A missing directory
    raises ``FileNotFoundError``."""
    d = read_config_json(path)
    if d is None:
        cfg = DetectorConfig()
    else:
        on_cpu = torch.device(device).type == "cpu"
        cfg = DetectorConfig(**d, dtype=torch.float32 if on_cpu
                             else torch.bfloat16)
    return load_model(OpenVocabDetector(cfg, device=device), path)
