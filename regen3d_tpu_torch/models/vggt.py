"""VGGT-family geometry transformer (counterpart of regen3d_tpu/models/vggt.py).

images (B, F, H, W, 3) in [0, 1] → {pose_enc (B, F, 9), depth (B, F, H, W),
depth_conf (B, F, H, W)}. Same structure and submodule names as the flax
model: a DINOv2-style backbone (``aggregator.patch_embed``), alternating
frame / global attention blocks whose [frame ‖ global] outputs are the
heads' taps, an AdaLN-modulated iterative camera head and a DPT depth head.
Every attention runs on ``ops/attention.flash_attention``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from regen3d_tpu_torch.models.layers import (
    Conv,
    Dense,
    LayerNorm,
    Mlp,
    PatchEmbed,
    ViTBlock,
    lecun_normal_,
    posemb_sincos_2d,
    resize_bilinear,
)


@dataclasses.dataclass(frozen=True)
class VGGTConfig:
    image_size: int = 518
    patch: int = 14
    width: int = 1024
    depth: int = 24            # alternating frame/global layer pairs
    num_heads: int = 16
    backbone_depth: int = 24   # DINOv2-L backbone blocks
    num_register_tokens: int = 4
    camera_iterations: int = 4
    camera_trunk_depth: int = 4
    dpt_features: int = 256
    dpt_out_channels: Tuple[int, int, int, int] = (256, 512, 1024, 1024)
    # FastVGGT-style training-free token merging for the GLOBAL attention
    # blocks (PAPERS.md: arXiv 2509.02560): the fraction of non-reference
    # patch tokens merged into their most similar reference token before
    # global attention and copied back after. 0 disables. No weight changes.
    token_merge_ratio: float = 0.0
    dtype: torch.dtype = torch.bfloat16

    @property
    def grid(self) -> int:
        return self.image_size // self.patch

    @classmethod
    def tiny(cls) -> "VGGTConfig":
        return cls(image_size=28, patch=14, width=64, depth=2, num_heads=4,
                   backbone_depth=2, num_register_tokens=1,
                   camera_iterations=2, camera_trunk_depth=1,
                   dpt_features=32, dpt_out_channels=(32, 32, 64, 64))


_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


class DinoBackbone(nn.Module):
    """Patch conv, cls token, pos embed, LayerScale blocks, final norm;
    returns the patch tokens (B, h·w, width) and the grid (h, w)."""

    def __init__(self, c: VGGTConfig, device="cuda"):
        super().__init__()
        self.cfg = c
        self.patch_embed = PatchEmbed(c.patch, c.width, dtype=c.dtype,
                                      device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.width, device=device))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, 1 + c.grid * c.grid, c.width, device=device))
        for i in range(c.backbone_depth):
            self.add_module(f"block{i}", ViTBlock(
                c.width, c.num_heads, layer_scale=True, dtype=c.dtype,
                device=device))
        self.norm = LayerNorm(c.width, dtype=c.dtype, device=device)

    def forward(self, images):  # (B, H, W, 3)
        c = self.cfg
        mean = torch.tensor(_MEAN, device=images.device)
        std = torch.tensor(_STD, device=images.device)
        x, (gh, gw) = self.patch_embed(((images - mean) / std).to(c.dtype))
        b = x.shape[0]
        x = torch.cat([self.cls_token.to(c.dtype).expand(b, 1, c.width), x], 1)
        x = x + self.pos_embed.to(c.dtype)
        for i in range(c.backbone_depth):
            x = getattr(self, f"block{i}")(x)
        return self.norm(x)[:, 1:], (gh, gw)


def _merge_global_tokens(g, f, n_tok, n_special, r):
    """FastVGGT-style bipartite merge for one batch element.

    g (f·n_tok, D): frame-0 tokens are destinations; the r most-redundant
    non-reference PATCH tokens (highest cosine similarity to any
    destination) are averaged into their best destination; special tokens
    and the remaining sources pass through. The order is ``jnp``'s: a
    stable ascending sort of the scores, ties of the argmax to the first
    destination. Returns (compact (f·n_tok − r, D), info for
    :func:`_unmerge_global_tokens`)."""
    d = g.shape[-1]
    dst = g[:n_tok]
    src = g[n_tok:].reshape(f - 1, n_tok, d)
    src_spec = src[:, :n_special].reshape(-1, d)
    src_patch = src[:, n_special:].reshape(-1, d)          # (M, D)
    m = src_patch.shape[0]

    a = src_patch / torch.clamp(
        torch.linalg.norm(src_patch, dim=-1, keepdim=True), min=1e-6)
    bb = dst / torch.clamp(torch.linalg.norm(dst, dim=-1, keepdim=True),
                           min=1e-6)
    sim = (a @ bb.T).float()                               # (M, n_tok)
    best = torch.argmax(sim, dim=-1)                       # (M,)
    score = torch.amax(sim, dim=-1)
    order = torch.argsort(score, stable=True)              # ascending
    kept_idx = order[:m - r]
    merged_idx = order[m - r:]
    merged_mask = torch.zeros(m, dtype=g.dtype, device=g.device)
    merged_mask[merged_idx] = 1.0

    # one-hot by comparison: F.one_hot checks its classes on the host,
    # a synchronization in every global block
    onehot = (best[:, None] == torch.arange(n_tok, device=g.device)).to(
        g.dtype) * merged_mask[:, None]
    counts = torch.sum(onehot, dim=0)                      # (n_tok,)
    dst_new = (dst + onehot.T @ src_patch) / (1.0 + counts)[:, None]

    compact = torch.cat([dst_new, src_spec, src_patch[kept_idx]], dim=0)
    return compact, (best, kept_idx, merged_idx)


def _unmerge_global_tokens(out, info, f, n_tok, n_special):
    """Inverse of :func:`_merge_global_tokens`: merged sources take their
    destination token's output (the FastVGGT copy-back)."""
    best, kept_idx, merged_idx = info
    d = out.shape[-1]
    n_spec_all = (f - 1) * n_special
    out_dst = out[:n_tok]
    out_spec = out[n_tok:n_tok + n_spec_all]
    out_kept = out[n_tok + n_spec_all:]
    m = kept_idx.shape[0] + merged_idx.shape[0]
    patch = torch.zeros(m, d, dtype=out.dtype, device=out.device)
    patch[kept_idx] = out_kept
    patch[merged_idx] = out_dst[best[merged_idx]]
    src = torch.cat([out_spec.reshape(f - 1, n_special, d),
                     patch.reshape(f - 1, -1, d)], dim=1)
    return torch.cat([out_dst, src.reshape(-1, d)], dim=0)


class Aggregator(nn.Module):
    """Alternating frame/global attention; returns per-layer taps
    [frame_out ‖ global_out] (B, F, N, 2·width) and the patch grid. With
    ``token_merge_ratio`` > 0 and several frames, each global block attends
    over the merged compact sequence (FastVGGT), whose length is no
    multiple of the flash kernel's tiles."""

    def __init__(self, c: VGGTConfig, device="cuda"):
        super().__init__()
        self.cfg = c
        self.patch_embed = DinoBackbone(c, device=device)
        self.camera_token = nn.Parameter(torch.zeros(2, 1, c.width,
                                                     device=device))
        self.register_token = nn.Parameter(
            torch.zeros(2, c.num_register_tokens, c.width, device=device))
        for i in range(c.depth):
            self.add_module(f"frame_block{i}", ViTBlock(
                c.width, c.num_heads, dtype=c.dtype, device=device))
            self.add_module(f"global_block{i}", ViTBlock(
                c.width, c.num_heads, dtype=c.dtype, device=device))

    def forward(self, images):  # (B, F, H, W, 3)
        c = self.cfg
        b, f = images.shape[:2]
        x, (gh, gw) = self.patch_embed(images.reshape(b * f, *images.shape[2:]))
        x = x + posemb_sincos_2d(gh, gw, c.width, x.device)[None].to(c.dtype)
        n = x.shape[1]
        # per-frame special tokens: row 0 = query frame, row 1 = the rest
        fidx = torch.clamp(torch.arange(f, device=x.device), max=1)
        extra = torch.cat([self.camera_token, self.register_token], 1)[fidx]
        extra = extra[None].expand(b, *extra.shape).to(c.dtype)
        x = torch.cat([extra, x.reshape(b, f, n, c.width)], 2)
        n_tok = x.shape[2]
        n_special = 1 + c.num_register_tokens
        r = int(c.token_merge_ratio * (f - 1) * (n_tok - n_special))
        taps: List[torch.Tensor] = []
        for i in range(c.depth):
            h = getattr(self, f"frame_block{i}")(x.reshape(b * f, n_tok, c.width))
            frame_out = h.reshape(b, f, n_tok, c.width)
            g = frame_out.reshape(b, f * n_tok, c.width)
            block = getattr(self, f"global_block{i}")
            if r > 0 and f > 1:
                # global attention on the compact set; merged tokens copy
                # their destination's output back
                merged = [_merge_global_tokens(t, f, n_tok, n_special, r)
                          for t in g]
                out = block(torch.stack([cm for cm, _ in merged]))
                g = torch.stack([
                    _unmerge_global_tokens(o, info, f, n_tok, n_special)
                    for o, (_, info) in zip(out, merged)])
            else:
                g = block(g)
            x = g.reshape(b, f, n_tok, c.width)
            taps.append(torch.cat([frame_out, x], -1))
        return taps, (gh, gw)


class CameraHead(nn.Module):
    """Camera tokens (B, F, 2·width) → pose encoding [t, quat xyzw, fov_h,
    fov_w] (B, F, 9) by iterative AdaLN-modulated refinement."""

    def __init__(self, c: VGGTConfig, device="cuda"):
        super().__init__()
        self.cfg = c
        d = 2 * c.width
        self.token_norm = LayerNorm(d, dtype=c.dtype, device=device)
        self.embed_pose = Dense(9, d, dtype=c.dtype, device=device)
        self.poseLN_modulation = Dense(d, 3 * d, dtype=c.dtype, device=device)
        for i in range(c.camera_trunk_depth):
            self.add_module(f"trunk{i}", ViTBlock(d, c.num_heads, dtype=c.dtype,
                                                  device=device))
        self.trunk_norm = LayerNorm(d, dtype=c.dtype, device=device)
        self.adaln_norm = LayerNorm(d, affine=False, dtype=c.dtype,
                                    device=device)
        self.pose_branch = Mlp(d, d // 2, out=9, dtype=torch.float32,
                               device=device)

    def forward(self, cam_tokens):
        c = self.cfg
        b, f = cam_tokens.shape[:2]
        h0 = self.token_norm(cam_tokens)
        base = torch.tensor([0, 0, 0, 0, 0, 0, 1, 0.8, 0.8],
                            device=cam_tokens.device)
        enc = torch.zeros(b, f, 9, device=cam_tokens.device) + base
        for _ in range(c.camera_iterations):
            mod = self.poseLN_modulation(
                F.silu(self.embed_pose(enc.to(c.dtype))))
            shift, scale, gate = torch.chunk(mod, 3, dim=-1)
            z = self.adaln_norm(h0) * (1 + scale) + shift
            z = h0 + gate * z
            for i in range(c.camera_trunk_depth):
                z = getattr(self, f"trunk{i}")(z)
            z = self.trunk_norm(z)
            enc = enc + self.pose_branch(z.float())
        return enc


def pose_encoding_to_camera(enc: torch.Tensor, image_hw: Tuple[int, int]
                            ) -> Dict[str, torch.Tensor]:
    """absT_quaR_FoV encoding (..., 9) → OpenCV world→cam R, t and
    intrinsics fx, fy, cx, cy (quaternion scalar-last, fov_h first)."""
    from regen3d_tpu_torch.transforms.rotations import quat_to_matrix

    t = enc[..., 0:3]
    q = enc[..., 3:7]
    fov = enc[..., 7:9]
    R = quat_to_matrix(q[..., [3, 0, 1, 2]])
    h, w = image_hw
    fy = (h / 2.0) / torch.tan(torch.clamp(fov[..., 0], 1e-3, 3.0) / 2.0)
    fx = (w / 2.0) / torch.tan(torch.clamp(fov[..., 1], 1e-3, 3.0) / 2.0)
    return {"R": R, "t": t, "fx": fx, "fy": fy,
            "cx": torch.full_like(fx, w / 2.0),
            "cy": torch.full_like(fy, h / 2.0)}


class ResidualConvUnit(nn.Module):
    """DPT fusion unit: x + conv2(relu(conv1(relu(x))))."""

    def __init__(self, ch, dtype, device="cuda"):
        super().__init__()
        self.conv1 = Conv(ch, ch, 3, dtype=dtype, device=device)
        self.conv2 = Conv(ch, ch, 3, dtype=dtype, device=device)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class DPTHead(nn.Module):
    """DPT dense head: 4 taps → projections → resize pyramid → refinenet
    fusion → output convs → (value, confidence) at the input resolution."""

    SCALES = (4.0, 2.0, 1.0, 0.5)

    def __init__(self, c: VGGTConfig, out_channels: int = 1, device="cuda"):
        super().__init__()
        self.cfg = c
        self.out_channels = out_channels
        fe = c.dpt_features
        for i, ch in enumerate(c.dpt_out_channels):
            self.add_module(f"project{i}", Conv(2 * c.width, ch, 1,
                                                dtype=c.dtype, device=device))
            self.add_module(f"layer{i + 1}_rn", Conv(ch, fe, 3, bias=False,
                                                     dtype=c.dtype,
                                                     device=device))
            self.add_module(f"refinenet{i + 1}",
                            ResidualConvUnit(fe, c.dtype, device=device))
        self.output_conv1 = Conv(fe, fe // 2, 3, dtype=c.dtype, device=device)
        self.output_conv2a = Conv(fe // 2, 32, 3, dtype=c.dtype, device=device)
        self.output_conv2b = Conv(32, out_channels + 1, 1, dtype=torch.float32,
                                  device=device)

    def forward(self, taps, grid_hw, out_hw):
        gh, gw = grid_hw
        outs = []
        for i, t in enumerate(taps):
            patch = t[:, :, -(gh * gw):, :]
            x = patch.reshape(-1, gh, gw, patch.shape[-1])
            x = getattr(self, f"project{i}")(x)
            s = self.SCALES[i]
            x = resize_bilinear(x, (max(1, int(gh * s)), max(1, int(gw * s))))
            outs.append(getattr(self, f"layer{i + 1}_rn")(x))
        path = None
        for i in (3, 2, 1, 0):
            x = outs[i]
            if path is not None:
                x = x + resize_bilinear(path, x.shape[1:3])
            path = getattr(self, f"refinenet{i + 1}")(x)
        h = self.output_conv1(path)
        h = resize_bilinear(h, out_hw)
        h = F.relu(self.output_conv2a(h))
        out = self.output_conv2b(h)
        value = out[..., :self.out_channels]
        conf = 1.0 + F.softplus(out[..., self.out_channels:])
        return value, conf


class VGGT(nn.Module):
    """images (B, F, H, W, 3) → {pose_enc, depth, depth_conf}."""

    def __init__(self, c: VGGTConfig, device="cuda"):
        super().__init__()
        self.cfg = c
        self.aggregator = Aggregator(c, device=device)
        self.camera_head = CameraHead(c, device=device)
        self.depth_head = DPTHead(c, 1, device=device)

    def forward(self, images):
        b, f, h, w = images.shape[:4]
        taps_all, grid_hw = self.aggregator(images)
        k = len(taps_all)
        taps = [taps_all[max(0, (k * i) // 4 - 1)] for i in (1, 2, 3, 4)]
        cam_tokens = taps_all[-1][:, :, 0, :].float()
        pose_enc = self.camera_head(cam_tokens)
        depth, depth_conf = self.depth_head(taps, grid_hw, (h, w))
        depth = F.softplus(depth.float())
        return {"pose_enc": pose_enc,
                "depth": depth.reshape(b, f, h, w),
                "depth_conf": depth_conf.float().reshape(b, f, h, w)}


def init_flax_style_(model: nn.Module, generator: torch.Generator) -> None:
    """Random init from ``generator`` with the flax initializer families the
    JAX model uses, so deep random stacks stay finite: lecun-normal
    (truncated) Dense/Conv kernels, zero biases, LayerNorm ones/zeros,
    LayerScale 1e-5, zero-init ``poseLN_modulation``, zero cls token and
    N(0, 0.02) position embedding and camera/register tokens."""
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, (Dense, Conv)):
                if name.endswith("poseLN_modulation"):
                    mod.weight.zero_()
                else:
                    lecun_normal_(mod.weight, mod.weight[0].numel(), generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, LayerNorm) and mod.weight is not None:
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, ViTBlock) and mod.ls1 is not None:
                mod.ls1.fill_(1e-5)
                mod.ls2.fill_(1e-5)
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "cls_token":
                p.zero_()
            elif leaf in ("pos_embed", "camera_token", "register_token"):
                p.normal_(0.0, 0.02, generator=generator)


def unproject_depth(depth: torch.Tensor, camera: Dict[str, torch.Tensor],
                    frame: int = 0) -> torch.Tensor:
    """Depth (H, W) + decoded camera → world point map (H, W, 3), OpenCV:
    x_cam = K⁻¹·(u, v, 1)·z, world = Rᵀ(x_cam − t)."""
    h, w = depth.shape
    vv, uu = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=depth.device) + 0.5,
                            torch.arange(w, dtype=torch.float32,
                                         device=depth.device) + 0.5,
                            indexing="ij")
    fx, fy = camera["fx"][frame], camera["fy"][frame]
    cx, cy = camera["cx"][frame], camera["cy"][frame]
    cam_pts = torch.stack([(uu - cx) / fx * depth, (vv - cy) / fy * depth,
                           depth], -1)
    return (cam_pts - camera["t"][frame]) @ camera["R"][frame]
