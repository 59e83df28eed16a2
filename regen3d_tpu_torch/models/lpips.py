"""LPIPS perceptual metric: the AlexNet trunk and the five linear
calibration heads (counterpart of regen3d_tpu/models/lpips.py; the
reference's ``lpips.LPIPS(net='alex')``, run_eval.py:174-197).

Takes NHWC images in [0, 1] as the JAX module does and runs NCHW inside;
the trunk's max pools take no padding (flax's ``VALID``), each ``lin{i}`` is
a 1×1 convolution without bias. Convolutions run without TF32. Weights load
from the JAX package's tree with ``models/from_jax.load_from_jax``;
at random init the metric is still a deep-feature distance.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from regen3d_tpu_torch.models.layers import lecun_normal_
from regen3d_tpu_torch.ops import full_f32

# (name, in, out, kernel, stride, padding) of torchvision's AlexNet features
_TRUNK = (("conv1", 3, 64, 11, 4, 2), ("conv2", 64, 192, 5, 1, 2),
          ("conv3", 192, 384, 3, 1, 1), ("conv4", 384, 256, 3, 1, 1),
          ("conv5", 256, 256, 3, 1, 1))
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


class AlexFeatures(nn.Module):
    """torchvision-AlexNet feature trunk; returns the 5 tap activations."""

    def __init__(self, device="cuda"):
        super().__init__()
        for name, c_in, c_out, k, s, p in _TRUNK:
            self.add_module(name, nn.Conv2d(c_in, c_out, k, stride=s,
                                            padding=p, device=device))

    def forward(self, x):  # (B, 3, H, W)
        taps = []
        x = F.relu(self.conv1(x))
        taps.append(x)
        x = F.max_pool2d(x, 3, 2)
        x = F.relu(self.conv2(x))
        taps.append(x)
        x = F.max_pool2d(x, 3, 2)
        for name in ("conv3", "conv4", "conv5"):
            x = F.relu(getattr(self, name)(x))
            taps.append(x)
        return taps


class LPIPS(nn.Module):
    """Full metric: normalized feature differences × learned linear heads,
    averaged over positions and summed over the five taps."""

    def __init__(self, device="cuda"):
        super().__init__()
        self.alex = AlexFeatures(device)
        for i, (_n, _i, c, *_rest) in enumerate(_TRUNK):
            self.add_module(f"lin{i}", nn.Conv2d(c, 1, 1, bias=False,
                                                 device=device))

    def forward(self, a, b):  # (B, H, W, 3) in [0, 1] each
        mean = torch.tensor(_MEAN, device=a.device)
        std = torch.tensor(_STD, device=a.device)
        with full_f32():
            fa = self.alex(((a - mean) / std).permute(0, 3, 1, 2))
            fb = self.alex(((b - mean) / std).permute(0, 3, 1, 2))
            total = 0.0
            for i, (xa, xb) in enumerate(zip(fa, fb)):
                na = xa / torch.clamp_min(
                    torch.linalg.norm(xa, dim=1, keepdim=True), 1e-10)
                nb = xb / torch.clamp_min(
                    torch.linalg.norm(xb, dim=1, keepdim=True), 1e-10)
                lin = getattr(self, f"lin{i}")(((na - nb) ** 2))
                total = total + lin.abs().mean()
        return total


@torch.no_grad()
def init_flax_style_(model: LPIPS, generator: torch.Generator) -> None:
    """The JAX module's init from a seeded generator: lecun-normal
    (truncated) trunk kernels, zero biases, each head constant 1/C."""
    for name, c_in, _c, k, *_rest in _TRUNK:
        conv = getattr(model.alex, name)
        w = torch.empty(conv.weight.shape)
        lecun_normal_(w, c_in * k * k, generator)
        conv.weight.copy_(w)
        conv.bias.zero_()
    for i, (_n, _i, c, *_rest) in enumerate(_TRUNK):
        getattr(model, f"lin{i}").weight.fill_(1.0 / c)


def make_lpips_fn(model: LPIPS):
    """lpips(a, b) → scalar tensor for phase 9; (H, W, 3) or (B, H, W, 3)
    images in [0, 1] on the model's device."""

    @torch.no_grad()
    def fn(a, b):
        if a.ndim == 3:
            a, b = a[None], b[None]
        return model(a, b)

    return fn
