"""Diffusion upscalers, phase 1's non-banana path (counterpart of
regen3d_tpu/pipeline/upscale.py).

``run`` writes every cropped finding, square-padded and upscaled ×4, then
resized to 512² with LANCZOS, to ``findings/upscaled/cropped/`` (phase 3's
input when ``findings/banana/prepped/`` is absent). As in the JAX package,
no config key loads upscaler weights, so the CLI's ``use_banana: false``
upscales with LANCZOS ×4 (ROADMAP Queue 3 az); the models run from Python:

* :class:`Upscaler`, the SD-x4 upscaler's recipe: DDIM
  (``models/unet.ddim_sample``, the config's ``num_inference_steps`` and
  ``guidance_scale``) over a ``UNet`` at the ×4 target's latent grid
  (target / 8), conditioned by channel concat on the low-res image,
  bilinearly upsampled ×4 and then shrunk (antialiased) to the latent
  grid; decoded by either VAE (``models/vae.AutoencoderKL`` or
  ``models/sd_vae.SDAutoencoderKL``). ``UNetConfig()`` pools three times,
  so a crop side must be a multiple of 16 (Queue 3 ay);
* :class:`FluxUpscaler`: the control image's VAE latent (``encode``
  returning (mean, logvar), as ``SDAutoencoderKL``'s does), patchified
  2×2 into tokens, is the condition of ``models/dit.sample``, whose result
  is unpatchified and decoded. ``sample`` draws its start from the model's
  ``latent_tokens`` and ``latent_dim``: a ``ShapeDiT`` sized to the tokens
  serves, a ``FluxTransformer`` (no ``latent_dim``) raises
  ``AttributeError`` as in the JAX package (Queue 3 ax).

The models live where they were built; random draws come from a
``torch.Generator`` seeded with the config's ``seed`` on the model's device,
or from the noise passed in. PNGs go through the port's own codec and
Pillow-exact LANCZOS (``utils/image.py``): no PIL.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Mapping, Optional

import numpy as np
import torch

from regen3d_tpu_torch.models.layers import resize_bilinear
from regen3d_tpu_torch.utils.image import resize_pil

log = logging.getLogger(__name__)


def _lanczos_x4(image: np.ndarray) -> np.ndarray:
    h, w = image.shape[:2]
    return resize_pil(image, (h * 4, w * 4), "lanczos")


def _to_signed_unit(image: np.ndarray, dev) -> torch.Tensor:
    """(H, W, 3) uint8 → (1, H, W, 3) f32 in [−1, 1]: x / 127.5 − 1."""
    x = torch.from_numpy(np.ascontiguousarray(image)).to(dev).float()[None]
    return x / torch.tensor(127.5, device=dev) - 1.0


def _to_uint8(rgb: torch.Tensor) -> np.ndarray:
    """(1, H, W, 3) in [−1, 1] → uint8: (x + 1)·127.5 clipped to [0, 255]
    and truncated."""
    out = torch.clamp((rgb[0].float() + 1.0) * 127.5, 0, 255)
    return out.cpu().numpy().astype(np.uint8)


def _generator(cfg: Mapping, dev) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(
        int(cfg.get("seed", 1234567)))


@dataclasses.dataclass
class Upscaler:
    """The SD-x4 upscaler: a ``models/unet.UNet`` and a VAE; without both,
    LANCZOS ×4."""

    unet: Optional[torch.nn.Module] = None
    vae: Optional[torch.nn.Module] = None

    @property
    def has_weights(self) -> bool:
        return self.unet is not None and self.vae is not None

    @torch.no_grad()
    def upscale(self, image: np.ndarray, cfg: Mapping,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> np.ndarray:
        """(H, W, 3) uint8 → (4H, 4W, 3) uint8. The DDIM starts from
        ``noise`` (1, H/2, W/2, 4), else from N(0, 1) drawn from
        ``generator`` (default: seeded with the config's ``seed``)."""
        if not self.has_weights:
            return _lanczos_x4(image)
        from regen3d_tpu_torch.models.unet import ddim_sample

        h, w = image.shape[:2]
        lh, lw = h * 4 // 8, w * 4 // 8
        pools = len(self.unet.cfg.mults) - 1
        if lh % 2 ** pools or lw % 2 ** pools:
            raise ValueError(
                f"Upscaler: the {h}×{w} crop's {lh}×{lw} latent grid does not "
                f"pool {pools} times; crop sides must be multiples of "
                f"{2 ** (pools + 1)}")
        dev = next(self.unet.parameters()).device
        if noise is None and generator is None:
            generator = _generator(cfg, dev)
        # the x4 upscaler denoises at the target's latent grid, conditioned
        # on the upsampled low-res image concatenated channel-wise
        cond = resize_bilinear(_to_signed_unit(image, dev), (h * 4, w * 4))
        z = ddim_sample(
            self.unet, (1, lh, lw, 4),
            cond_img=resize_bilinear(cond, (lh, lw)),
            num_steps=int(cfg.get("num_inference_steps", 50)),
            guidance_scale=float(cfg.get("guidance_scale", 5.0)),
            generator=generator, x0=noise)
        return _to_uint8(self.vae.decode(z))


@dataclasses.dataclass
class FluxUpscaler:
    """The FLUX ControlNet upscaler's recipe (reference
    ``model_name="FLUX"``): a flow transformer over 2×2-patchified VAE
    latents conditioned on the control image's latent tokens, integrated by
    ``models/dit.sample``; without a transformer and a VAE, LANCZOS ×4."""

    dit: Optional[torch.nn.Module] = None
    vae: Optional[torch.nn.Module] = None
    patch: int = 2

    @property
    def has_weights(self) -> bool:
        return self.dit is not None and self.vae is not None

    @torch.no_grad()
    def upscale(self, image: np.ndarray, cfg: Mapping,
                generator: Optional[torch.Generator] = None,
                latents: Optional[torch.Tensor] = None) -> np.ndarray:
        """(H, W, 3) uint8 → (4H, 4W, 3) uint8; ``sample`` starts from
        ``latents``, else from N(0, 1) drawn from ``generator`` (default:
        seeded with the config's ``seed``)."""
        if not self.has_weights:
            return _lanczos_x4(image)
        from regen3d_tpu_torch.models.dit import sample as flow_sample

        h, w = image.shape[:2]
        dev = next(self.vae.parameters()).device
        if latents is None and generator is None:
            generator = _generator(cfg, dev)
        ctrl = resize_bilinear(_to_signed_unit(image, dev), (h * 4, w * 4))
        z_ctrl, _ = self.vae.encode(ctrl)
        p = self.patch
        b, lh, lw, c4 = z_ctrl.shape
        toks = z_ctrl.reshape(b, lh // p, p, lw // p, p, c4).permute(
            0, 1, 3, 2, 4, 5).reshape(b, -1, p * p * c4)
        lat = flow_sample(
            self.dit, toks, num_steps=int(cfg.get("num_inference_steps", 5)),
            guidance_scale=float(cfg.get("guidance_scale", 3.5)),
            latents=latents, generator=generator)
        z = lat.reshape(b, lh // p, lw // p, p, p, c4).permute(
            0, 1, 3, 2, 4, 5).reshape(b, lh, lw, c4)
        return _to_uint8(self.vae.decode(z))


def make_upscaler(cfg: Mapping):
    """The reference's Upscaler(model_name) switch:
    ``upscaler_model_name: SD | FLUX``, weightless."""
    name = str(cfg.get("upscaler_model_name", "SD")).upper()
    if name == "FLUX":
        return FluxUpscaler()
    if name == "SD":
        return Upscaler()
    raise ValueError(
        f"upscaler_model_name must be 'SD' or 'FLUX', got {name}")


def square_pad(image: np.ndarray, fill: int = 255) -> np.ndarray:
    """Pad to a square on a white canvas, centred (the reference's prep)."""
    h, w = image.shape[:2]
    side = max(h, w)
    canvas = np.full((side, side, image.shape[2]), fill, image.dtype)
    y0 = (side - h) // 2
    x0 = (side - w) // 2
    canvas[y0:y0 + h, x0:x0 + w] = image
    return canvas


def run(cfg: Mapping, upscaler=None) -> int:
    """Upscale every cropped finding → ``findings/upscaled/cropped``
    (512², LANCZOS); returns the count. Without ``upscaler``, the config's
    weightless one."""
    from regen3d_tpu_torch.artifacts import Artifacts
    from regen3d_tpu_torch.utils.image import load_image_rgb, save_image

    art = Artifacts(cfg)
    upscaler = upscaler or make_upscaler(cfg)
    out_dir = os.path.join(art.findings, "upscaled", "cropped")
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for stem in art.list_findings(full_size=False):
        img = load_image_rgb(os.path.join(art.findings_cropped, f"{stem}.png"),
                             max_side=None)
        up = upscaler.upscale(square_pad(img), cfg)
        save_image(os.path.join(out_dir, f"{stem}.png"),
                   resize_pil(up, (512, 512), "lanczos"))
        n += 1
    log.info("upscale: %d crops → %s (weights=%s)", n, out_dir,
             upscaler.has_weights)
    return n
