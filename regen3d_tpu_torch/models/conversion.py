"""Upstream checkpoint key layouts: the rule tables of the port's model
families, their inverses, and the one road from an upstream state dict
into a port module (counterpart of regen3d_tpu/models/conversion.py, whose
tables this module copies rule for rule and in order: the first matching
regex wins).

Per family:

  * ``rules()``: the torch-key → flax-path table
    (``models.weights.convert_state_dict`` format);
  * ``tiny_model(generator)``: the port's module at its ``tiny()`` config,
    f32, on the CPU, initialised from the generator (the shape oracle);
  * ``invert(path, arr)``: the INVERSE map from a flax path to the upstream
    torch key (and the inverse transposition), which builds an
    upstream-layout state dict from a tree (:func:`upstream_state`).

:func:`load_upstream` converts an upstream state dict (strict: every key
mapped or explicitly dropped) and loads it with
``from_jax.load_from_jax``, naming the family's transposed convolutions.
Upstream ConvTranspose weights therefore go ``t2j_convtranspose`` → flax
layout → the bridge's tap mirror (ROADMAP Queue 3 k), once.
:func:`selftest` round-trips a tiny model: its tree → upstream state dict →
``convert_state_dict`` → ``verify_tree_shapes``.

STATUS per family (how literally the upstream key layout is transcribed):
  exact        — transcribed from the public checkpoint's key schema
  provisional  — structurally complete, key names best-effort pending a
                 checkpoint to diff against
  diverged     — the architecture differs from the upstream model on
                 purpose (see the model's docstring), so no key mapping can
                 exist; ``rules()`` raises

Upstream-only tensors the design drops (SAM's mask-prompt downscaler, DPT's
learned resize convs in VGGT) are matched by explicit DROP rules so
conversions report zero unmapped keys.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, FrozenSet, List, Mapping, Tuple

import numpy as np
import torch

from regen3d_tpu_torch.models.from_jax import (
    DEPTH_ANYTHING_CONV_TRANSPOSE,
    SALIENCY_CONV_TRANSPOSE,
    SAM_CONV_TRANSPOSE,
    load_from_jax,
    tree_from_model,
)
from regen3d_tpu_torch.models.weights import (
    convert_state_dict,
    flatten_tree,
    t2j_conv,
    t2j_convtranspose,
    t2j_linear,
    verify_tree_shapes,
)


# inverse transforms (flax → torch layout), for synthetic-state generation
def j2t_linear(w):
    return np.ascontiguousarray(np.asarray(w).T)


def j2t_conv(w):
    return np.ascontiguousarray(np.transpose(np.asarray(w), (3, 2, 0, 1)))


def j2t_convtranspose(w):
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 3, 0, 1)))


# ndim-guarded transforms: combined weight|bias rules must leave 1-D biases
# untouched (torch biases never need transposition)
def T_LIN(a):
    return t2j_linear(a) if a.ndim == 2 else a


def T_CONV(a):
    return t2j_conv(a) if a.ndim == 4 else a


def T_CONVT(a):
    return t2j_convtranspose(a) if a.ndim == 4 else a


def _split3(transform):
    """Upstream fused qkv → our separate q/k/v (same transform each)."""
    def f(arr):
        parts = np.split(np.asarray(arr), 3, axis=0)  # torch rows = out dim
        return [transform(p) if transform else p for p in parts]
    return f


def _drop(pattern: str):
    return (pattern, lambda k, m: None, None)

@dataclasses.dataclass
class Family:
    name: str
    status: str                      # exact | provisional | diverged
    rules: Callable[[], list]
    tiny_model: Callable[[torch.Generator], torch.nn.Module]
    invert: Callable[[Tuple[str, ...], np.ndarray], Any]
    # invert returns one of:
    #   (torch_key, torch_array)
    #   ("MERGE3", torch_key, part_index('q'|'k'|'v'), torch_array)
    #   ("MERGE_ROWS", torch_key_fmt, row_index, torch_array)
    #   "SKIP" (a twin leaf another leaf already emitted)
    #   list of the above
    extra_torch_keys: Callable[[], Dict[str, np.ndarray]] = lambda: {}
    # the module names of the model's transposed convolutions
    conv_transpose: FrozenSet[str] = frozenset()


# ---------------------------------------------------------------------------
# helpers shared by rule tables
# ---------------------------------------------------------------------------

def _ln(path_prefix):
    """LayerNorm weight/bias mapping closure."""
    def f(m):
        return path_prefix(m) + ("scale" if m.group("wb") == "weight"
                                 else "bias",)
    return f


def _vit_block_rules(torch_prefix: str, path_of: Callable[[Any], tuple],
                     fused: bool = True, layer_scale: bool = False) -> list:
    """Rules for one family of torch-ViT blocks (timm/DINOv2 layout:
    norm1/attn.qkv/attn.proj/norm2/mlp.fc1/mlp.fc2 [+ ls1/ls2 gamma]) onto
    our ViTBlock path layout. ``path_of(m)`` maps the regex match to our
    block path tuple."""
    P = torch_prefix
    r = []
    r.append((rf"{P}\.norm(?P<n>[12])\.(?P<wb>weight|bias)",
              lambda k, m: path_of(m) + (f"norm{m.group('n')}",
                                         "scale" if m.group("wb") == "weight"
                                         else "bias"), None))
    if fused:
        r.append((rf"{P}\.attn\.qkv\.weight",
                  lambda k, m: path_of(m) + ("attn", "qkv", "kernel"),
                  T_LIN))
        r.append((rf"{P}\.attn\.qkv\.bias",
                  lambda k, m: path_of(m) + ("attn", "qkv", "bias"), None))
    r.append((rf"{P}\.attn\.proj\.weight",
              lambda k, m: path_of(m) + ("attn", "proj", "kernel"),
              T_LIN))
    r.append((rf"{P}\.attn\.proj\.bias",
              lambda k, m: path_of(m) + ("attn", "proj", "bias"), None))
    r.append((rf"{P}\.mlp\.fc(?P<n>[12])\.weight",
              lambda k, m: path_of(m) + ("mlp", f"fc{m.group('n')}",
                                         "kernel"), T_LIN))
    r.append((rf"{P}\.mlp\.fc(?P<n>[12])\.bias",
              lambda k, m: path_of(m) + ("mlp", f"fc{m.group('n')}", "bias"),
              None))
    if layer_scale:
        r.append((rf"{P}\.ls(?P<n>[12])\.gamma",
                  lambda k, m: path_of(m) + (f"ls{m.group('n')}",), None))
    return r


def _invert_vit_block(block_path: Tuple[str, ...], torch_prefix: str,
                      path: Tuple[str, ...], arr) -> Optional[tuple]:
    """Inverse of _vit_block_rules for a single leaf under block_path."""
    rel = path[len(block_path):]
    if rel[0] in ("norm1", "norm2"):
        return (f"{torch_prefix}.{rel[0]}."
                f"{'weight' if rel[1] == 'scale' else 'bias'}", np.asarray(arr))
    if rel[0] == "attn":
        nm = {"kernel": "weight", "bias": "bias"}[rel[2]]
        a = j2t_linear(arr) if rel[2] == "kernel" else np.asarray(arr)
        return (f"{torch_prefix}.attn.{rel[1]}.{nm}", a)
    if rel[0] == "mlp":
        nm = {"kernel": "weight", "bias": "bias"}[rel[2]]
        a = j2t_linear(arr) if rel[2] == "kernel" else np.asarray(arr)
        return (f"{torch_prefix}.mlp.{rel[1]}.{nm}", a)
    if rel[0] in ("ls1", "ls2"):
        return (f"{torch_prefix}.{rel[0]}.gamma", np.asarray(arr))
    return None



# ---------------------------------------------------------------------------
# SAM (facebook sam_vit_h_4b8939.pth key schema) — exact
# ---------------------------------------------------------------------------

def sam_rules() -> list:
    r = []
    # --- image encoder -----------------------------------------------------
    r.append((r"image_encoder\.patch_embed\.proj\.weight",
              lambda k, m: ("image_encoder", "patch_embed", "kernel"),
              T_CONV))
    r.append((r"image_encoder\.patch_embed\.proj\.bias",
              lambda k, m: ("image_encoder", "patch_embed", "bias"), None))
    r.append((r"image_encoder\.pos_embed",
              lambda k, m: ("image_encoder", "pos_embed"), None))
    blk = lambda m: ("image_encoder", f"block{m.group('i')}")
    r += _vit_block_rules(r"image_encoder\.blocks\.(?P<i>\d+)", blk,
                          fused=True)
    # SAM mlp uses lin1/lin2 naming instead of fc1/fc2
    r.append((r"image_encoder\.blocks\.(?P<i>\d+)\.mlp\.lin(?P<n>[12])\.weight",
              lambda k, m: blk(m) + ("mlp", f"fc{m.group('n')}", "kernel"),
              T_LIN))
    r.append((r"image_encoder\.blocks\.(?P<i>\d+)\.mlp\.lin(?P<n>[12])\.bias",
              lambda k, m: blk(m) + ("mlp", f"fc{m.group('n')}", "bias"),
              None))
    r.append((r"image_encoder\.blocks\.(?P<i>\d+)\.attn\.rel_pos_(?P<hw>[hw])",
              lambda k, m: blk(m) + ("attn", f"rel_pos_{m.group('hw')}"),
              None))
    neck = {"0": ("neck1", "kernel"), "2": ("neck2", "kernel")}
    r.append((r"image_encoder\.neck\.(?P<i>[02])\.weight",
              lambda k, m: ("image_encoder",) + neck[m.group("i")], T_CONV))
    neck_ln = {"1": "neck_ln1", "3": "neck_ln2"}
    r.append((r"image_encoder\.neck\.(?P<i>[13])\.(?P<wb>weight|bias)",
              lambda k, m: ("image_encoder", neck_ln[m.group("i")],
                            "scale" if m.group("wb") == "weight" else "bias"),
              None))
    # --- prompt encoder ----------------------------------------------------
    r.append((r"prompt_encoder\.pe_layer\.positional_encoding_gaussian_matrix",
              lambda k, m: ("prompt_encoder", "pe_gauss"), None))
    r.append((r"prompt_encoder\.point_embeddings\.(?P<i>[0-3])\.weight",
              lambda k, m: ("prompt_encoder", f"point_embed{m.group('i')}"),
              lambda a: a.reshape(-1)))
    r.append((r"prompt_encoder\.not_a_point_embed\.weight",
              lambda k, m: ("prompt_encoder", "not_a_point"),
              lambda a: a.reshape(-1)))
    # we never take dense mask prompts (phase 1 prompts with boxes/points):
    r.append(_drop(r"prompt_encoder\.no_mask_embed\..*"))
    r.append(_drop(r"prompt_encoder\.mask_downscaling\..*"))
    # --- mask decoder ------------------------------------------------------
    attn_name = {"self_attn": "self", "cross_attn_token_to_image": "t2i",
                 "cross_attn_image_to_token": "i2t"}
    r.append((r"mask_decoder\.transformer\.layers\.(?P<i>\d+)\."
              r"(?P<a>self_attn|cross_attn_token_to_image|"
              r"cross_attn_image_to_token)\.(?P<p>[qkv])_proj\.(?P<wb>weight|bias)",
              lambda k, m: ("mask_decoder", f"block{m.group('i')}",
                            f"{attn_name[m.group('a')]}_{m.group('p')}",
                            "kernel" if m.group("wb") == "weight" else "bias"),
              T_LIN)),
    r.append((r"mask_decoder\.transformer\.layers\.(?P<i>\d+)\."
              r"(?P<a>self_attn|cross_attn_token_to_image|"
              r"cross_attn_image_to_token)\.out_proj\.(?P<wb>weight|bias)",
              lambda k, m: ("mask_decoder", f"block{m.group('i')}",
                            f"{attn_name[m.group('a')]}_out",
                            "kernel" if m.group("wb") == "weight" else "bias"),
              T_LIN))
    r.append((r"mask_decoder\.transformer\.layers\.(?P<i>\d+)\."
              r"norm(?P<n>[1-4])\.(?P<wb>weight|bias)",
              lambda k, m: ("mask_decoder", f"block{m.group('i')}",
                            f"ln{m.group('n')}",
                            "scale" if m.group("wb") == "weight" else "bias"),
              None))
    r.append((r"mask_decoder\.transformer\.layers\.(?P<i>\d+)\."
              r"mlp\.lin(?P<n>[12])\.(?P<wb>weight|bias)",
              lambda k, m: ("mask_decoder", f"block{m.group('i')}", "mlp",
                            f"fc{m.group('n')}",
                            "kernel" if m.group("wb") == "weight" else "bias"),
              T_LIN))
    r.append((r"mask_decoder\.transformer\.final_attn_token_to_image\."
              r"(?P<p>[qkv])_proj\.(?P<wb>weight|bias)",
              lambda k, m: ("mask_decoder", f"final_{m.group('p')}",
                            "kernel" if m.group("wb") == "weight" else "bias"),
              T_LIN))
    r.append((r"mask_decoder\.transformer\.final_attn_token_to_image\."
              r"out_proj\.(?P<wb>weight|bias)",
              lambda k, m: ("mask_decoder", "final_out",
                            "kernel" if m.group("wb") == "weight" else "bias"),
              T_LIN))
    r.append((r"mask_decoder\.transformer\.norm_final_attn\.(?P<wb>weight|bias)",
              lambda k, m: ("mask_decoder", "norm_final",
                            "scale" if m.group("wb") == "weight" else "bias"),
              None))
    r.append((r"mask_decoder\.iou_token\.weight",
              lambda k, m: ("mask_decoder", "iou_token"), None))
    r.append((r"mask_decoder\.mask_tokens\.weight",
              lambda k, m: ("mask_decoder", "mask_tokens"), None))
    ups = {"0": "up1", "3": "up2"}
    r.append((r"mask_decoder\.output_upscaling\.(?P<i>[03])\.weight",
              lambda k, m: ("mask_decoder", ups[m.group("i")], "kernel"),
              T_CONVT))
    r.append((r"mask_decoder\.output_upscaling\.(?P<i>[03])\.bias",
              lambda k, m: ("mask_decoder", ups[m.group("i")], "bias"), None))
    r.append((r"mask_decoder\.output_upscaling\.1\.(?P<wb>weight|bias)",
              lambda k, m: ("mask_decoder", "up_ln",
                            "scale" if m.group("wb") == "weight" else "bias"),
              None))
    r.append((r"mask_decoder\.output_hypernetworks_mlps\.(?P<m>\d+)\."
              r"layers\.(?P<l>[0-2])\.(?P<wb>weight|bias)",
              lambda k, m: ("mask_decoder", f"hyper{m.group('m')}",
                            f"lin{m.group('l')}",
                            "kernel" if m.group("wb") == "weight" else "bias"),
              T_LIN))
    r.append((r"mask_decoder\.iou_prediction_head\.layers\.(?P<l>[0-2])\."
              r"(?P<wb>weight|bias)",
              lambda k, m: ("mask_decoder", "iou_head", f"lin{m.group('l')}",
                            "kernel" if m.group("wb") == "weight" else "bias"),
              T_LIN))
    return r


def _sam_invert(path, arr):
    a = np.asarray(arr)
    wb = {"kernel": "weight", "scale": "weight", "bias": "bias"}
    if path[0] == "image_encoder":
        if path[1] == "patch_embed":
            return (f"image_encoder.patch_embed.proj.{wb[path[2]]}",
                    j2t_conv(a) if path[2] == "kernel" else a)
        if path[1] == "pos_embed":
            return ("image_encoder.pos_embed", a)
        if path[1].startswith("block"):
            i = path[1][5:]
            rel = path[2:]
            if rel[0] in ("norm1", "norm2"):
                return (f"image_encoder.blocks.{i}.{rel[0]}.{wb[rel[1]]}", a)
            if rel[0] == "attn" and rel[1].startswith("rel_pos"):
                return (f"image_encoder.blocks.{i}.attn.{rel[1]}", a)
            if rel[0] == "attn":
                return (f"image_encoder.blocks.{i}.attn.{rel[1]}.{wb[rel[2]]}",
                        j2t_linear(a) if rel[2] == "kernel" else a)
            if rel[0] == "mlp":
                n = rel[1][2]
                return (f"image_encoder.blocks.{i}.mlp.lin{n}.{wb[rel[2]]}",
                        j2t_linear(a) if rel[2] == "kernel" else a)
        if path[1] in ("neck1", "neck2"):
            idx = "0" if path[1] == "neck1" else "2"
            return (f"image_encoder.neck.{idx}.weight", j2t_conv(a))
        if path[1] in ("neck_ln1", "neck_ln2"):
            idx = "1" if path[1] == "neck_ln1" else "3"
            return (f"image_encoder.neck.{idx}.{wb[path[2]]}", a)
    if path[0] == "prompt_encoder":
        if path[1] == "pe_gauss":
            return ("prompt_encoder.pe_layer."
                    "positional_encoding_gaussian_matrix", a)
        if path[1].startswith("point_embed"):
            return (f"prompt_encoder.point_embeddings.{path[1][-1]}.weight",
                    a.reshape(1, -1))
        if path[1] == "not_a_point":
            return ("prompt_encoder.not_a_point_embed.weight",
                    a.reshape(1, -1))
    if path[0] == "mask_decoder":
        name_attn = {"self": "self_attn", "t2i": "cross_attn_token_to_image",
                     "i2t": "cross_attn_image_to_token"}
        if path[1].startswith("block"):
            i = path[1][5:]
            rel = path[2:]
            if rel[0].startswith("ln"):
                return (f"mask_decoder.transformer.layers.{i}."
                        f"norm{rel[0][2]}.{wb[rel[1]]}", a)
            if rel[0] == "mlp":
                n = rel[1][2]
                return (f"mask_decoder.transformer.layers.{i}.mlp."
                        f"lin{n}.{wb[rel[2]]}",
                        j2t_linear(a) if rel[2] == "kernel" else a)
            base, part = rel[0].rsplit("_", 1)
            proj = "out_proj" if part == "out" else f"{part}_proj"
            return (f"mask_decoder.transformer.layers.{i}."
                    f"{name_attn[base]}.{proj}.{wb[rel[1]]}",
                    j2t_linear(a) if rel[1] == "kernel" else a)
        if path[1].startswith("final_"):
            part = path[1][6:]
            proj = "out_proj" if part == "out" else f"{part}_proj"
            return (f"mask_decoder.transformer.final_attn_token_to_image."
                    f"{proj}.{wb[path[2]]}",
                    j2t_linear(a) if path[2] == "kernel" else a)
        if path[1] == "norm_final":
            return (f"mask_decoder.transformer.norm_final_attn.{wb[path[2]]}",
                    a)
        if path[1] == "iou_token":
            return ("mask_decoder.iou_token.weight", a)
        if path[1] == "mask_tokens":
            return ("mask_decoder.mask_tokens.weight", a)
        if path[1] in ("up1", "up2"):
            idx = "0" if path[1] == "up1" else "3"
            return (f"mask_decoder.output_upscaling.{idx}.{wb[path[2]]}",
                    j2t_convtranspose(a) if path[2] == "kernel" else a)
        if path[1] == "up_ln":
            return (f"mask_decoder.output_upscaling.1.{wb[path[2]]}", a)
        if path[1].startswith("hyper"):
            mi = path[1][5:]
            li = path[2][3]
            return (f"mask_decoder.output_hypernetworks_mlps.{mi}."
                    f"layers.{li}.{wb[path[3]]}",
                    j2t_linear(a) if path[3] == "kernel" else a)
        if path[1] == "iou_head":
            li = path[2][3]
            return (f"mask_decoder.iou_prediction_head.layers.{li}."
                    f"{wb[path[3]]}",
                    j2t_linear(a) if path[3] == "kernel" else a)
    return None


def _sam_extra():
    """Upstream-only tensors our design drops (exercises the DROP rules)."""
    return {
        "prompt_encoder.no_mask_embed.weight": np.zeros((1, 32), np.float32),
        "prompt_encoder.mask_downscaling.0.weight":
            np.zeros((4, 1, 2, 2), np.float32),
    }


# ---------------------------------------------------------------------------
# VGGT (facebook/VGGT-1B) — exact (module graph); DPT learned resize convs
# are replaced by parameter-free bilinear (DROP rules; see models/vggt.py)
# ---------------------------------------------------------------------------

def vggt_rules() -> list:
    r = []
    A = r"aggregator\.patch_embed"
    r.append((rf"{A}\.patch_embed\.proj\.weight",
              lambda k, m: ("aggregator", "patch_embed", "patch_embed",
                            "proj", "kernel"), T_CONV))
    r.append((rf"{A}\.patch_embed\.proj\.bias",
              lambda k, m: ("aggregator", "patch_embed", "patch_embed",
                            "proj", "bias"), None))
    r.append((rf"{A}\.cls_token",
              lambda k, m: ("aggregator", "patch_embed", "cls_token"), None))
    r.append((rf"{A}\.pos_embed",
              lambda k, m: ("aggregator", "patch_embed", "pos_embed"), None))
    r += _vit_block_rules(
        rf"{A}\.blocks\.(?P<i>\d+)",
        lambda m: ("aggregator", "patch_embed", f"block{m.group('i')}"),
        fused=True, layer_scale=True)
    r.append((rf"{A}\.norm\.(?P<wb>weight|bias)",
              lambda k, m: ("aggregator", "patch_embed", "norm",
                            "scale" if m.group("wb") == "weight" else "bias"),
              None))
    # register/mask tokens DINOv2 ships but VGGT's patch_embed may retain:
    r.append(_drop(rf"{A}\.register_tokens"))
    r.append(_drop(rf"{A}\.mask_token"))

    for kind in ("frame", "global"):
        r += _vit_block_rules(
            rf"aggregator\.{kind}_blocks\.(?P<i>\d+)",
            lambda m, kind=kind: ("aggregator", f"{kind}_block{m.group('i')}"),
            fused=True)
    r.append((r"aggregator\.camera_token",
              lambda k, m: ("aggregator", "camera_token"),
              lambda a: a.reshape(a.shape[-3], a.shape[-2], a.shape[-1])))
    r.append((r"aggregator\.register_token",
              lambda k, m: ("aggregator", "register_token"),
              lambda a: a.reshape(a.shape[-3], a.shape[-2], a.shape[-1])))

    C = r"camera_head"
    r.append((rf"{C}\.token_norm\.(?P<wb>weight|bias)",
              lambda k, m: ("camera_head", "token_norm",
                            "scale" if m.group("wb") == "weight" else "bias"),
              None))
    r.append((rf"{C}\.embed_pose\.(?P<wb>weight|bias)",
              lambda k, m: ("camera_head", "embed_pose",
                            "kernel" if m.group("wb") == "weight" else "bias"),
              T_LIN))
    r.append((rf"{C}\.poseLN_modulation\.1\.(?P<wb>weight|bias)",
              lambda k, m: ("camera_head", "poseLN_modulation",
                            "kernel" if m.group("wb") == "weight" else "bias"),
              T_LIN))
    r += _vit_block_rules(
        rf"{C}\.trunk\.(?P<i>\d+)",
        lambda m: ("camera_head", f"trunk{m.group('i')}"), fused=True)
    r.append((rf"{C}\.trunk_norm\.(?P<wb>weight|bias)",
              lambda k, m: ("camera_head", "trunk_norm",
                            "scale" if m.group("wb") == "weight" else "bias"),
              None))
    r.append((rf"{C}\.pose_branch\.fc(?P<n>[12])\.(?P<wb>weight|bias)",
              lambda k, m: ("camera_head", "pose_branch", f"fc{m.group('n')}",
                            "kernel" if m.group("wb") == "weight" else "bias"),
              T_LIN))

    D = r"depth_head"
    r.append((rf"{D}\.projects\.(?P<i>[0-3])\.(?P<wb>weight|bias)",
              lambda k, m: ("depth_head", f"project{m.group('i')}",
                            "kernel" if m.group("wb") == "weight" else "bias"),
              T_CONV))
    r.append((rf"{D}\.scratch\.layer(?P<i>[1-4])_rn\.weight",
              lambda k, m: ("depth_head", f"layer{m.group('i')}_rn",
                            "kernel"), T_CONV))
    r.append((rf"{D}\.scratch\.refinenet(?P<i>[1-4])\.resConfUnit2\."
              r"conv(?P<n>[12])\.(?P<wb>weight|bias)",
              lambda k, m: ("depth_head", f"refinenet{m.group('i')}",
                            f"conv{m.group('n')}",
                            "kernel" if m.group("wb") == "weight" else "bias"),
              T_CONV))
    r.append(_drop(rf"{D}\.scratch\.refinenet[1-4]\.resConfUnit1\..*"))
    r.append(_drop(rf"{D}\.resize_layers\..*"))  # bilinear in our design
    r.append((rf"{D}\.scratch\.output_conv1\.(?P<wb>weight|bias)",
              lambda k, m: ("depth_head", "output_conv1",
                            "kernel" if m.group("wb") == "weight" else "bias"),
              T_CONV))
    out2 = {"0": "output_conv2a", "2": "output_conv2b"}
    r.append((rf"{D}\.scratch\.output_conv2\.(?P<i>[02])\.(?P<wb>weight|bias)",
              lambda k, m: ("depth_head", out2[m.group("i")],
                            "kernel" if m.group("wb") == "weight" else "bias"),
              T_CONV))
    # heads we don't build yet (point/track heads are optional in the ref):
    r.append(_drop(r"point_head\..*"))
    r.append(_drop(r"track_head\..*"))
    return r


def _vggt_invert(path, arr):
    a = np.asarray(arr)
    wb = {"kernel": "weight", "scale": "weight", "bias": "bias"}
    if path[0] == "aggregator":
        if path[1] == "patch_embed":
            rel = path[2:]
            if rel[0] == "patch_embed":
                return (f"aggregator.patch_embed.patch_embed.proj.{wb[rel[2]]}",
                        j2t_conv(a) if rel[2] == "kernel" else a)
            if rel[0] in ("cls_token", "pos_embed"):
                return (f"aggregator.patch_embed.{rel[0]}", a)
            if rel[0] == "norm":
                return (f"aggregator.patch_embed.norm.{wb[rel[1]]}", a)
            if rel[0].startswith("block"):
                i = rel[0][5:]
                return _invert_vit_block(
                    ("aggregator", "patch_embed", rel[0]),
                    f"aggregator.patch_embed.blocks.{i}", path, a)
        if path[1].startswith(("frame_block", "global_block")):
            kind = "frame" if path[1].startswith("frame") else "global"
            i = path[1][len(kind) + 6:]
            return _invert_vit_block(("aggregator", path[1]),
                                     f"aggregator.{kind}_blocks.{i}", path, a)
        if path[1] == "camera_token":
            return ("aggregator.camera_token", a[None])
        if path[1] == "register_token":
            return ("aggregator.register_token", a[None])
    if path[0] == "camera_head":
        if path[1] in ("token_norm", "trunk_norm"):
            return (f"camera_head.{path[1]}.{wb[path[2]]}", a)
        if path[1] == "embed_pose":
            return (f"camera_head.embed_pose.{wb[path[2]]}",
                    j2t_linear(a) if path[2] == "kernel" else a)
        if path[1] == "poseLN_modulation":
            return (f"camera_head.poseLN_modulation.1.{wb[path[2]]}",
                    j2t_linear(a) if path[2] == "kernel" else a)
        if path[1].startswith("trunk"):
            i = path[1][5:]
            return _invert_vit_block(("camera_head", path[1]),
                                     f"camera_head.trunk.{i}", path, a)
        if path[1] == "pose_branch":
            return (f"camera_head.pose_branch.{path[2]}.{wb[path[3]]}",
                    j2t_linear(a) if path[3] == "kernel" else a)
    if path[0] == "depth_head":
        if path[1].startswith("project"):
            return (f"depth_head.projects.{path[1][7:]}.{wb[path[2]]}",
                    j2t_conv(a) if path[2] == "kernel" else a)
        if path[1].endswith("_rn"):
            return (f"depth_head.scratch.{path[1]}.weight", j2t_conv(a))
        if path[1].startswith("refinenet"):
            return (f"depth_head.scratch.{path[1]}.resConfUnit2."
                    f"{path[2]}.{wb[path[3]]}",
                    j2t_conv(a) if path[3] == "kernel" else a)
        if path[1] == "output_conv1":
            return (f"depth_head.scratch.output_conv1.{wb[path[2]]}",
                    j2t_conv(a) if path[2] == "kernel" else a)
        if path[1] in ("output_conv2a", "output_conv2b"):
            idx = "0" if path[1].endswith("a") else "2"
            return (f"depth_head.scratch.output_conv2.{idx}.{wb[path[2]]}",
                    j2t_conv(a) if path[2] == "kernel" else a)
    return None


def _vggt_extra():
    return {
        "depth_head.resize_layers.0.weight": np.zeros((8, 8, 2, 2),
                                                      np.float32),
        "depth_head.scratch.refinenet1.resConfUnit1.conv1.weight":
            np.zeros((8, 8, 3, 3), np.float32),
        "aggregator.patch_embed.register_tokens": np.zeros((1, 4, 64),
                                                           np.float32),
        "aggregator.patch_embed.mask_token": np.zeros((1, 64), np.float32),
    }


# ---------------------------------------------------------------------------
# dust3r (naver/DUSt3R_ViTLarge_BaseDecoder_512_linear) — exact
# ---------------------------------------------------------------------------

def dust3r_rules() -> list:
    r = []
    r.append((r"patch_embed\.proj\.weight",
              lambda k, m: ("patch", "proj", "kernel"), T_CONV))
    r.append((r"patch_embed\.proj\.bias",
              lambda k, m: ("patch", "proj", "bias"), None))
    # encoder blocks: upstream FUSED qkv → our separate q/k/v (split rule)
    r.append((r"enc_blocks\.(?P<i>\d+)\.attn\.qkv\.weight",
              lambda k, m: [(f"enc{m.group('i')}", "attn", p, "kernel")
                            for p in ("q", "k", "v")], _split3(T_LIN)))
    r.append((r"enc_blocks\.(?P<i>\d+)\.attn\.qkv\.bias",
              lambda k, m: [(f"enc{m.group('i')}", "attn", p, "bias")
                            for p in ("q", "k", "v")], _split3(None)))
    r.append((r"enc_blocks\.(?P<i>\d+)\.attn\.proj\.(?P<wb>weight|bias)",
              lambda k, m: (f"enc{m.group('i')}", "attn", "proj",
                            "kernel" if m.group("wb") == "weight" else "bias"),
              T_LIN))
    r.append((r"enc_blocks\.(?P<i>\d+)\.norm(?P<n>[12])\.(?P<wb>weight|bias)",
              lambda k, m: (f"enc{m.group('i')}", f"norm{m.group('n')}",
                            "scale" if m.group("wb") == "weight" else "bias"),
              None))
    r.append((r"enc_blocks\.(?P<i>\d+)\.mlp\.fc(?P<n>[12])\.(?P<wb>weight|bias)",
              lambda k, m: (f"enc{m.group('i')}", "mlp", f"fc{m.group('n')}",
                            "kernel" if m.group("wb") == "weight" else "bias"),
              T_LIN))
    r.append((r"enc_norm\.(?P<wb>weight|bias)",
              lambda k, m: ("enc_norm",
                            "scale" if m.group("wb") == "weight" else "bias"),
              None))
    r.append((r"decoder_embed\.(?P<wb>weight|bias)",
              lambda k, m: ("decoder_embed",
                            "kernel" if m.group("wb") == "weight" else "bias"),
              T_LIN))

    def dec(which, our):
        rr = []
        P = rf"dec_blocks{'' if which == 1 else '2'}\.(?P<i>\d+)"
        rr.append((rf"{P}\.attn\.qkv\.weight",
                   lambda k, m: [(f"{our}{m.group('i')}", "attn", p, "kernel")
                                 for p in ("q", "k", "v")],
                   _split3(T_LIN)))
        rr.append((rf"{P}\.attn\.qkv\.bias",
                   lambda k, m: [(f"{our}{m.group('i')}", "attn", p, "bias")
                                 for p in ("q", "k", "v")], _split3(None)))
        rr.append((rf"{P}\.attn\.proj\.(?P<wb>weight|bias)",
                   lambda k, m: (f"{our}{m.group('i')}", "attn", "proj",
                                 "kernel" if m.group("wb") == "weight"
                                 else "bias"), T_LIN))
        proj_map = {"projq": "q", "projk": "k", "projv": "v", "proj": "proj"}
        rr.append((rf"{P}\.cross_attn\.(?P<p>projq|projk|projv|proj)\."
                   r"(?P<wb>weight|bias)",
                   lambda k, m: (f"{our}{m.group('i')}", "cross_attn",
                                 proj_map[m.group("p")],
                                 "kernel" if m.group("wb") == "weight"
                                 else "bias"), T_LIN))
        rr.append((rf"{P}\.norm(?P<n>[123])\.(?P<wb>weight|bias)",
                   lambda k, m: (f"{our}{m.group('i')}", f"norm{m.group('n')}",
                                 "scale" if m.group("wb") == "weight"
                                 else "bias"), None))
        rr.append((rf"{P}\.norm_y\.(?P<wb>weight|bias)",
                   lambda k, m: (f"{our}{m.group('i')}", "norm_y",
                                 "scale" if m.group("wb") == "weight"
                                 else "bias"), None))
        rr.append((rf"{P}\.mlp\.fc(?P<n>[12])\.(?P<wb>weight|bias)",
                   lambda k, m: (f"{our}{m.group('i')}", "mlp",
                                 f"fc{m.group('n')}",
                                 "kernel" if m.group("wb") == "weight"
                                 else "bias"), T_LIN))
        return rr

    r += dec(1, "dec1_")
    r += dec(2, "dec2_")
    r.append((r"dec_norm\.(?P<wb>weight|bias)",
              lambda k, m: [("dec_norm1",
                             "scale" if m.group("wb") == "weight" else "bias"),
                            ("dec_norm2",
                             "scale" if m.group("wb") == "weight" else "bias")],
              lambda a: [a, a]))  # upstream shares one final decoder norm
    r.append((r"downstream_head(?P<n>[12])\.proj\.(?P<wb>weight|bias)",
              lambda k, m: (f"head{m.group('n')}", "proj",
                            "kernel" if m.group("wb") == "weight" else "bias"),
              T_LIN))
    r.append(_drop(r"mask_token"))
    return r


def _dust3r_invert(path, arr):
    a = np.asarray(arr)
    wb = {"kernel": "weight", "scale": "weight", "bias": "bias"}
    if path[0] == "patch":
        return (f"patch_embed.proj.{wb[path[2]]}",
                j2t_conv(a) if path[2] == "kernel" else a)
    if path[0].startswith("enc") and path[0] != "enc_norm":
        i = path[0][3:]
        P = f"enc_blocks.{i}"
        if path[1] == "attn" and path[2] in ("q", "k", "v"):
            t = j2t_linear(a) if path[3] == "kernel" else a
            return ("MERGE3", f"{P}.attn.qkv.{wb[path[3]]}", path[2], t)
        if path[1] == "attn":
            return (f"{P}.attn.proj.{wb[path[3]]}",
                    j2t_linear(a) if path[3] == "kernel" else a)
        if path[1].startswith("norm"):
            return (f"{P}.{path[1]}.{wb[path[2]]}", a)
        if path[1] == "mlp":
            return (f"{P}.mlp.{path[2]}.{wb[path[3]]}",
                    j2t_linear(a) if path[3] == "kernel" else a)
    if path[0] == "enc_norm":
        return (f"enc_norm.{wb[path[1]]}", a)
    if path[0] == "decoder_embed":
        return (f"decoder_embed.{wb[path[1]]}",
                j2t_linear(a) if path[1] == "kernel" else a)
    if path[0].startswith(("dec1_", "dec2_")):
        which = "" if path[0][3] == "1" else "2"
        i = path[0][5:]
        P = f"dec_blocks{which}.{i}"
        if path[1] == "attn" and path[2] in ("q", "k", "v"):
            t = j2t_linear(a) if path[3] == "kernel" else a
            return ("MERGE3", f"{P}.attn.qkv.{wb[path[3]]}", path[2], t)
        if path[1] == "attn":
            return (f"{P}.attn.proj.{wb[path[3]]}",
                    j2t_linear(a) if path[3] == "kernel" else a)
        if path[1] == "cross_attn":
            p = {"q": "projq", "k": "projk", "v": "projv",
                 "proj": "proj"}[path[2]]
            return (f"{P}.cross_attn.{p}.{wb[path[3]]}",
                    j2t_linear(a) if path[3] == "kernel" else a)
        if path[1].startswith("norm"):
            return (f"{P}.{path[1]}.{wb[path[2]]}", a)
        if path[1] == "mlp":
            return (f"{P}.mlp.{path[2]}.{wb[path[3]]}",
                    j2t_linear(a) if path[3] == "kernel" else a)
    if path[0] in ("dec_norm1", "dec_norm2"):
        # both our decoder norms come from the single upstream dec_norm;
        # emit it once (from dec_norm1) and skip the twin
        if path[0] == "dec_norm1":
            return (f"dec_norm.{wb[path[1]]}", a)
        return "SKIP"
    if path[0] in ("head1", "head2"):
        n = path[0][4]
        return (f"downstream_head{n}.proj.{wb[path[2]]}",
                j2t_linear(a) if path[2] == "kernel" else a)
    return None


# ---------------------------------------------------------------------------
# LPIPS (richzhang/PerceptualSimilarity lpips_alex) — exact
# ---------------------------------------------------------------------------

def lpips_rules() -> list:
    conv_map = {"0": "conv1", "3": "conv2", "6": "conv3", "8": "conv4",
                "10": "conv5"}
    r = []
    r.append((r"(?:net\.)?features\.(?P<i>0|3|6|8|10)\.(?P<wb>weight|bias)",
              lambda k, m: ("alex", conv_map[m.group("i")],
                            "kernel" if m.group("wb") == "weight" else "bias"),
              T_CONV))
    # lpips release stores heads as lin{i}.model.1 (1x1 conv, no bias)
    r.append((r"lins?\.?(?P<i>[0-4])\.model\.1\.weight|"
              r"lin(?P<j>[0-4])\.model\.1\.weight",
              lambda k, m: (f"lin{m.group('i') or m.group('j')}", "kernel"),
              T_CONV))
    return r


def _lpips_invert(path, arr):
    a = np.asarray(arr)
    inv_conv = {"conv1": "0", "conv2": "3", "conv3": "6", "conv4": "8",
                "conv5": "10"}
    if path[0] == "alex":
        wb = "weight" if path[2] == "kernel" else "bias"
        return (f"features.{inv_conv[path[1]]}.{wb}",
                j2t_conv(a) if path[2] == "kernel" else a)
    if path[0].startswith("lin"):
        return (f"{path[0]}.model.1.weight", j2t_conv(a))
    return None


# ---------------------------------------------------------------------------
# Hunyuan3D-2 shape DiT + VAE — PROVISIONAL key naming (structurally
# complete vs our arch; upstream hy3dgen key schema to be diffed when a
# checkpoint is available — tracked in ROADMAP item 5)
# ---------------------------------------------------------------------------

def dit_rules() -> list:
    r = []
    lin = lambda path: lambda k, m: path(m) + (
        ("kernel" if m.group("wb") == "weight" else "bias"),)
    r.append((r"x_in\.(?P<wb>weight|bias)", lin(lambda m: ("x_in",)),
              T_LIN))
    r.append((r"latent_pos", lambda k, m: ("latent_pos",), None))
    r.append((r"t_mlp\.fc(?P<n>[12])\.(?P<wb>weight|bias)",
              lin(lambda m: ("t_mlp", f"fc{m.group('n')}")), T_LIN))
    r.append((r"cond_in\.(?P<wb>weight|bias)", lin(lambda m: ("cond_in",)),
              T_LIN))
    r.append((r"cond_norm\.(?P<wb>weight|bias)",
              lambda k, m: ("cond_norm", "scale" if m.group("wb") == "weight"
                            else "bias"), None))
    P = r"blocks\.(?P<i>\d+)"
    blk = lambda m: (f"block{m.group('i')}",)
    r.append((rf"{P}\.adaLN\.(?P<wb>weight|bias)",
              lin(lambda m: blk(m) + ("adaLN",)), T_LIN))
    for att in ("attn", "cross"):
        r.append((rf"{P}\.{att}\.(?P<p>[qkv]|proj)\.(?P<wb>weight|bias)",
                  lin(lambda m, att=att: blk(m) + (att, m.group("p"))),
                  T_LIN))
        r.append((rf"{P}\.{att}\.(?P<p>[qk])_norm\.weight",
                  lambda k, m, att=att: blk(m) + (att, f"{m.group('p')}_norm",
                                                  "scale"), None))
    r.append((rf"{P}\.mlp\.fc(?P<n>[12])\.(?P<wb>weight|bias)",
              lin(lambda m: blk(m) + ("mlp", f"fc{m.group('n')}")),
              T_LIN))
    r.append((r"adaLN_out\.(?P<wb>weight|bias)",
              lin(lambda m: ("adaLN_out",)), T_LIN))
    r.append((r"x_out\.(?P<wb>weight|bias)", lin(lambda m: ("x_out",)),
              T_LIN))
    return r


def _dit_invert(path, arr):
    a = np.asarray(arr)
    wb = {"kernel": "weight", "scale": "weight", "bias": "bias"}
    if path[0] == "latent_pos":
        return ("latent_pos", a)
    if path[0] in ("x_in", "cond_in", "adaLN_out", "x_out"):
        return (f"{path[0]}.{wb[path[1]]}",
                j2t_linear(a) if path[1] == "kernel" else a)
    if path[0] == "cond_norm":
        return (f"cond_norm.{wb[path[1]]}", a)
    if path[0] == "t_mlp":
        return (f"t_mlp.{path[1]}.{wb[path[2]]}",
                j2t_linear(a) if path[2] == "kernel" else a)
    if path[0].startswith("block"):
        i = path[0][5:]
        rel = path[1:]
        if rel[0] == "adaLN":
            return (f"blocks.{i}.adaLN.{wb[rel[1]]}",
                    j2t_linear(a) if rel[1] == "kernel" else a)
        if rel[0] in ("attn", "cross"):
            if rel[1].endswith("_norm"):
                return (f"blocks.{i}.{rel[0]}.{rel[1]}.weight", a)
            return (f"blocks.{i}.{rel[0]}.{rel[1]}.{wb[rel[2]]}",
                    j2t_linear(a) if rel[2] == "kernel" else a)
        if rel[0] == "mlp":
            return (f"blocks.{i}.mlp.{rel[1]}.{wb[rel[2]]}",
                    j2t_linear(a) if rel[2] == "kernel" else a)
    return None


def shapevae_rules() -> list:
    lin = lambda path: lambda k, m: path(m) + (
        ("kernel" if m.group("wb") == "weight" else "bias"),)
    ln = lambda path: lambda k, m: path(m) + (
        ("scale" if m.group("wb") == "weight" else "bias"),)
    r = []
    for side, names in (("encoder", ("point_in", "out")),
                        ("decoder", ("lat_in", "query_in", "sdf_out"))):
        for n in names:
            r.append((rf"{side}\.{n}\.(?P<wb>weight|bias)",
                      lin(lambda m, side=side, n=n: (side, n)), T_LIN))
    r.append((r"encoder\.latent_queries",
              lambda k, m: ("encoder", "latent_queries"), None))
    for side in ("encoder", "decoder"):
        for att in ("gather", "query_cross"):
            r.append((rf"{side}\.{att}\.(?P<p>[qkv]|proj)\.(?P<wb>weight|bias)",
                      lin(lambda m, side=side, att=att:
                          (side, att, m.group("p"))), T_LIN))
        for norm in ("gather_norm", "out_norm", "q_norm", "o_norm"):
            r.append((rf"{side}\.{norm}\.(?P<wb>weight|bias)",
                      ln(lambda m, side=side, norm=norm: (side, norm)), None))
    P = r"(?P<side>encoder|decoder)\.blocks\.(?P<i>\d+)"
    blk = lambda m: (m.group("side"), f"block{m.group('i')}")
    r.append((rf"{P}\.attn\.(?P<p>[qkv]|proj)\.(?P<wb>weight|bias)",
              lin(lambda m: blk(m) + ("attn", m.group("p"))), T_LIN))
    r.append((rf"{P}\.norm(?P<n>[12])\.(?P<wb>weight|bias)",
              ln(lambda m: blk(m) + (f"norm{m.group('n')}",)), None))
    r.append((rf"{P}\.mlp\.fc(?P<n>[12])\.(?P<wb>weight|bias)",
              lin(lambda m: blk(m) + ("mlp", f"fc{m.group('n')}")),
              T_LIN))
    r.append((r"decoder\.mlp\.fc(?P<n>[12])\.(?P<wb>weight|bias)",
              lin(lambda m: ("decoder", "mlp", f"fc{m.group('n')}")),
              T_LIN))
    return r


def _shapevae_invert(path, arr):
    a = np.asarray(arr)
    wb = {"kernel": "weight", "scale": "weight", "bias": "bias"}
    side = path[0]
    rel = path[1:]
    if rel[0] == "latent_queries":
        return (f"{side}.latent_queries", a)
    if rel[0].startswith("block"):
        i = rel[0][5:]
        sub = rel[1:]
        if sub[0] == "attn":
            return (f"{side}.blocks.{i}.attn.{sub[1]}.{wb[sub[2]]}",
                    j2t_linear(a) if sub[2] == "kernel" else a)
        if sub[0].startswith("norm"):
            return (f"{side}.blocks.{i}.{sub[0]}.{wb[sub[1]]}", a)
        if sub[0] == "mlp":
            return (f"{side}.blocks.{i}.mlp.{sub[1]}.{wb[sub[2]]}",
                    j2t_linear(a) if sub[2] == "kernel" else a)
    if rel[0] in ("gather", "query_cross"):
        return (f"{side}.{rel[0]}.{rel[1]}.{wb[rel[2]]}",
                j2t_linear(a) if rel[2] == "kernel" else a)
    if rel[0] in ("gather_norm", "out_norm", "q_norm", "o_norm"):
        return (f"{side}.{rel[0]}.{wb[rel[1]]}", a)
    if rel[0] == "mlp":
        return (f"{side}.mlp.{rel[1]}.{wb[rel[2]]}",
                j2t_linear(a) if rel[2] == "kernel" else a)
    if rel[0] in ("point_in", "out", "lat_in", "query_in", "sdf_out"):
        return (f"{side}.{rel[0]}.{wb[rel[1]]}",
                j2t_linear(a) if rel[1] == "kernel" else a)
    return None


# ---------------------------------------------------------------------------
# Depth-Anything-V2 (depth-anything/Depth-Anything-V2-Small, the phase-1
# depth.png model — global_utils.py:400-418). Upstream schema: DINOv2
# trunk under `pretrained.*` (timm block layout + LayerScale), DPT head
# under `depth_head.*` (projects / resize_layers / scratch.layer_rn /
# scratch.refinenet{n}.resConfUnit / output_conv). Exact.
# ---------------------------------------------------------------------------

def depth_anything_rules() -> list:
    def conv(path):
        return lambda k, m: path(m) + (
            "kernel" if m.group("wb") == "weight" else "bias",)

    r = [
        (r"pretrained\.cls_token", lambda k, m: ("cls_token",), None),
        (r"pretrained\.pos_embed", lambda k, m: ("pos_embed",), None),
        _drop(r"pretrained\.mask_token"),
        (r"pretrained\.patch_embed\.proj\.(?P<wb>weight|bias)",
         conv(lambda m: ("patch_embed", "proj")), T_CONV),
        (r"pretrained\.norm\.(?P<wb>weight|bias)",
         lambda k, m: ("norm", "scale" if m.group("wb") == "weight"
                       else "bias"), None),
        (r"depth_head\.projects\.(?P<i>[0-3])\.(?P<wb>weight|bias)",
         conv(lambda m: (f"project{m.group('i')}",)), T_CONV),
        (r"depth_head\.resize_layers\.(?P<i>[01])\.(?P<wb>weight|bias)",
         conv(lambda m: (f"resize{m.group('i')}",)), T_CONVT),
        (r"depth_head\.resize_layers\.3\.(?P<wb>weight|bias)",
         conv(lambda m: ("resize3",)), T_CONV),
        (r"depth_head\.scratch\.layer(?P<n>[1-4])_rn\.weight",
         lambda k, m: (f"layer{m.group('n')}_rn", "kernel"), T_CONV),
        (r"depth_head\.scratch\.refinenet(?P<n>[1-4])\."
         r"resConfUnit(?P<u>[12])\.conv(?P<c>[12])\.(?P<wb>weight|bias)",
         conv(lambda m: (f"refinenet{m.group('n')}",
                         f"resConfUnit{m.group('u')}",
                         f"conv{m.group('c')}")), T_CONV),
        (r"depth_head\.scratch\.refinenet(?P<n>[1-4])\.out_conv\."
         r"(?P<wb>weight|bias)",
         conv(lambda m: (f"refinenet{m.group('n')}", "out_conv")), T_CONV),
        (r"depth_head\.scratch\.output_conv1\.(?P<wb>weight|bias)",
         conv(lambda m: ("output_conv1",)), T_CONV),
        (r"depth_head\.scratch\.output_conv2\.0\.(?P<wb>weight|bias)",
         conv(lambda m: ("output_conv2a",)), T_CONV),
        (r"depth_head\.scratch\.output_conv2\.2\.(?P<wb>weight|bias)",
         conv(lambda m: ("output_conv2b",)), T_CONV),
    ]
    r += _vit_block_rules(r"pretrained\.blocks\.(?P<i>\d+)",
                          lambda m: (f"block{m.group('i')}",),
                          fused=True, layer_scale=True)
    return r


def _depth_anything_invert(path, arr):
    a = np.asarray(arr)
    wb = {"kernel": "weight", "scale": "weight", "bias": "bias"}
    if path[0] == "cls_token":
        return ("pretrained.cls_token", a)
    if path[0] == "pos_embed":
        return ("pretrained.pos_embed", a)
    if path[0] == "patch_embed":
        return (f"pretrained.patch_embed.proj.{wb[path[-1]]}",
                j2t_conv(a) if path[-1] == "kernel" else a)
    if path[0] == "norm":
        return (f"pretrained.norm.{wb[path[-1]]}", a)
    if path[0].startswith("block"):
        i = path[0][5:]
        return _invert_vit_block((path[0],), f"pretrained.blocks.{i}",
                                 path, arr)
    if path[0].startswith("project"):
        return (f"depth_head.projects.{path[0][7:]}.{wb[path[-1]]}",
                j2t_conv(a) if path[-1] == "kernel" else a)
    if path[0].startswith("resize"):
        i = path[0][6:]
        if i in ("0", "1"):
            return (f"depth_head.resize_layers.{i}.{wb[path[-1]]}",
                    j2t_convtranspose(a) if path[-1] == "kernel" else a)
        return (f"depth_head.resize_layers.{i}.{wb[path[-1]]}",
                j2t_conv(a) if path[-1] == "kernel" else a)
    if path[0].endswith("_rn"):
        return (f"depth_head.scratch.{path[0]}.weight", j2t_conv(a))
    if path[0].startswith("refinenet"):
        sub = (f"{path[1]}.{path[2]}" if len(path) == 4 else path[1])
        return (f"depth_head.scratch.{path[0]}.{sub}.{wb[path[-1]]}",
                j2t_conv(a) if path[-1] == "kernel" else a)
    if path[0] == "output_conv1":
        return (f"depth_head.scratch.output_conv1.{wb[path[-1]]}",
                j2t_conv(a) if path[-1] == "kernel" else a)
    if path[0] == "output_conv2a":
        return (f"depth_head.scratch.output_conv2.0.{wb[path[-1]]}",
                j2t_conv(a) if path[-1] == "kernel" else a)
    if path[0] == "output_conv2b":
        return (f"depth_head.scratch.output_conv2.2.{wb[path[-1]]}",
                j2t_conv(a) if path[-1] == "kernel" else a)
    return None


# ---------------------------------------------------------------------------
# diverged families: detector (Grounding-DINO → OWL-style; deformable
# attention has no TPU-native equivalent, models/detector.py docstring),
# saliency (2.4k-LoC VST → compact T2T encoder + saliency token), matting
# (rembg U²-Net nested RSU blocks → plain MattingUNet). No key mapping can
# be faithful; parity arrives by distillation or training.
# ---------------------------------------------------------------------------

def _diverged_rules(name: str, upstream: str):
    def rules():
        raise NotImplementedError(
            f"family '{name}' intentionally diverges from upstream "
            f"{upstream} (TPU-first redesign; see the model docstring). "
            "There is no checkpoint key mapping. Quality-parity paths: "
            "(a) distill against recorded upstream activations "
            "(conversion.check_activation_fixture fixtures), or (b) train "
            "natively with parallel/train.py.")
    return rules


def _no_invert(path, arr):
    return None


# ---------------------------------------------------------------------------
# midi — the ShapeDiT with MIDI-style cross-instance attention blocks
# (run_midi.py:36-43): the dit table plus the inst_norm/inst_attn/inst_gate
# leaves, so a multi-instance checkpoint maps onto the baseline adapter
# ---------------------------------------------------------------------------

def midi_rules() -> list:
    lin = lambda path: lambda k, m: path(m) + (
        ("kernel" if m.group("wb") == "weight" else "bias"),)
    r = dit_rules()
    P = r"inst_blocks\.(?P<i>\d+)"
    r.append((rf"{P}\.attn\.(?P<p>[qkv]|proj)\.(?P<wb>weight|bias)",
              lin(lambda m: (f"inst_attn{m.group('i')}", m.group("p"))),
              T_LIN))
    r.append((rf"{P}\.attn\.(?P<p>[qk])_norm\.weight",
              lambda k, m: (f"inst_attn{m.group('i')}",
                            f"{m.group('p')}_norm", "scale"), None))
    r.append((rf"{P}\.gate", lambda k, m: (f"inst_gate{m.group('i')}",),
              None))
    return r


def _midi_invert(path, arr):
    a = np.asarray(arr)
    wb = {"kernel": "weight", "scale": "weight", "bias": "bias"}
    if path[0].startswith("inst_attn"):
        i = path[0][9:]
        if path[1].endswith("_norm"):
            return (f"inst_blocks.{i}.attn.{path[1]}.weight", a)
        return (f"inst_blocks.{i}.attn.{path[1]}.{wb[path[2]]}",
                j2t_linear(a) if path[2] == "kernel" else a)
    if path[0].startswith("inst_gate"):
        return (f"inst_blocks.{path[0][9:]}.gate", a)
    return _dit_invert(path, arr)


# ---------------------------------------------------------------------------
# SD UNet + VAE (diffusers UNet2DConditionModel / AutoencoderKL layouts) —
# exact. One table serves the SD-x4 upscaler, Marigold's intrinsics/normals
# UNets, and the multiview texgen UNet (models/sd_unet.py docstring).
# ---------------------------------------------------------------------------

_RES_SUB = {"norm1": ("norm1",), "conv1": ("conv1",),
            "time_emb_proj": ("time_emb_proj",), "norm2": ("norm2",),
            "conv2": ("conv2",), "conv_shortcut": ("conv_shortcut",)}


def _sd_resnet_rules(torch_prefix: str, path_of) -> list:
    r = []
    r.append((rf"{torch_prefix}\.(?P<s>norm1|norm2)\.(?P<wb>weight|bias)",
              lambda k, m: path_of(m) + (m.group("s"),
                                         "scale" if m.group("wb") == "weight"
                                         else "bias"), None))
    r.append((rf"{torch_prefix}\.(?P<s>conv1|conv2|conv_shortcut)\."
              r"(?P<wb>weight|bias)",
              lambda k, m: path_of(m) + (m.group("s"),
                                         "kernel" if m.group("wb") == "weight"
                                         else "bias"), T_CONV))
    r.append((rf"{torch_prefix}\.time_emb_proj\.(?P<wb>weight|bias)",
              lambda k, m: path_of(m) + ("time_emb_proj",
                                         "kernel" if m.group("wb") == "weight"
                                         else "bias"), T_LIN))
    return r


def _sd_attn_rules(torch_prefix: str, path_of) -> list:
    """Transformer2DModel rules: norm/proj_in/proj_out +
    transformer_blocks.0.{norm1-3, attn1/attn2 (to_q/to_k/to_v/to_out.0),
    ff.net.0.proj, ff.net.2}."""
    r = []
    r.append((rf"{torch_prefix}\.norm\.(?P<wb>weight|bias)",
              lambda k, m: path_of(m) + ("norm",
                                         "scale" if m.group("wb") == "weight"
                                         else "bias"), None))
    r.append((rf"{torch_prefix}\.(?P<s>proj_in|proj_out)\.(?P<wb>weight|bias)",
              lambda k, m: path_of(m) + (m.group("s"),
                                         "kernel" if m.group("wb") == "weight"
                                         else "bias"), T_LIN))
    B = rf"{torch_prefix}\.transformer_blocks\.0"
    r.append((rf"{B}\.norm(?P<n>[123])\.(?P<wb>weight|bias)",
              lambda k, m: path_of(m) + ("transformer_blocks_0",
                                         f"norm{m.group('n')}",
                                         "scale" if m.group("wb") == "weight"
                                         else "bias"), None))
    r.append((rf"{B}\.attn(?P<n>[12])\.to_(?P<p>[qkv])\.weight",
              lambda k, m: path_of(m) + ("transformer_blocks_0",
                                         f"attn{m.group('n')}",
                                         f"to_{m.group('p')}", "kernel"),
              T_LIN))
    r.append((rf"{B}\.attn(?P<n>[12])\.to_out\.0\.(?P<wb>weight|bias)",
              lambda k, m: path_of(m) + ("transformer_blocks_0",
                                         f"attn{m.group('n')}", "to_out_0",
                                         "kernel" if m.group("wb") == "weight"
                                         else "bias"), T_LIN))
    r.append((rf"{B}\.ff\.net\.0\.proj\.(?P<wb>weight|bias)",
              lambda k, m: path_of(m) + ("transformer_blocks_0", "ff",
                                         "net_0_proj",
                                         "kernel" if m.group("wb") == "weight"
                                         else "bias"), T_LIN))
    r.append((rf"{B}\.ff\.net\.2\.(?P<wb>weight|bias)",
              lambda k, m: path_of(m) + ("transformer_blocks_0", "ff",
                                         "net_2",
                                         "kernel" if m.group("wb") == "weight"
                                         else "bias"), T_LIN))
    return r


def sd_unet_rules() -> list:
    r = []
    r.append((r"conv_in\.(?P<wb>weight|bias)",
              lambda k, m: ("conv_in", "kernel" if m.group("wb") == "weight"
                            else "bias"), T_CONV))
    r.append((r"time_embedding\.linear_(?P<n>[12])\.(?P<wb>weight|bias)",
              lambda k, m: (f"time_embedding_linear_{m.group('n')}",
                            "kernel" if m.group("wb") == "weight" else "bias"),
              T_LIN))
    r.append((r"class_embedding\.weight",
              lambda k, m: ("class_embedding", "embedding"), None))
    r += _sd_resnet_rules(
        r"down_blocks\.(?P<i>\d+)\.resnets\.(?P<j>\d+)",
        lambda m: (f"down_{m.group('i')}_resnet_{m.group('j')}",))
    r += _sd_attn_rules(
        r"down_blocks\.(?P<i>\d+)\.attentions\.(?P<j>\d+)",
        lambda m: (f"down_{m.group('i')}_attn_{m.group('j')}",))
    r.append((r"down_blocks\.(?P<i>\d+)\.downsamplers\.0\.conv\."
              r"(?P<wb>weight|bias)",
              lambda k, m: (f"down_{m.group('i')}_downsample",
                            "kernel" if m.group("wb") == "weight" else "bias"),
              T_CONV))
    r += _sd_resnet_rules(r"mid_block\.resnets\.(?P<j>[01])",
                          lambda m: (f"mid_resnet_{m.group('j')}",))
    r += _sd_attn_rules(r"mid_block\.attentions\.0",
                        lambda m: ("mid_attn_0",))
    r += _sd_resnet_rules(
        r"up_blocks\.(?P<i>\d+)\.resnets\.(?P<j>\d+)",
        lambda m: (f"up_{m.group('i')}_resnet_{m.group('j')}",))
    r += _sd_attn_rules(
        r"up_blocks\.(?P<i>\d+)\.attentions\.(?P<j>\d+)",
        lambda m: (f"up_{m.group('i')}_attn_{m.group('j')}",))
    r.append((r"up_blocks\.(?P<i>\d+)\.upsamplers\.0\.conv\."
              r"(?P<wb>weight|bias)",
              lambda k, m: (f"up_{m.group('i')}_upsample",
                            "kernel" if m.group("wb") == "weight" else "bias"),
              T_CONV))
    r.append((r"conv_norm_out\.(?P<wb>weight|bias)",
              lambda k, m: ("conv_norm_out",
                            "scale" if m.group("wb") == "weight" else "bias"),
              None))
    r.append((r"conv_out\.(?P<wb>weight|bias)",
              lambda k, m: ("conv_out",
                            "kernel" if m.group("wb") == "weight" else "bias"),
              T_CONV))
    return r


def _sd_unet_invert(path, arr):
    a = np.asarray(arr)
    wb = {"kernel": "weight", "scale": "weight", "bias": "bias"}

    def resnet_inv(prefix, rel):
        sub = rel[0]
        if sub in ("norm1", "norm2"):
            return (f"{prefix}.{sub}.{wb[rel[1]]}", a)
        if sub in ("conv1", "conv2", "conv_shortcut"):
            return (f"{prefix}.{sub}.{wb[rel[1]]}",
                    j2t_conv(a) if rel[1] == "kernel" else a)
        if sub == "time_emb_proj":
            return (f"{prefix}.time_emb_proj.{wb[rel[1]]}",
                    j2t_linear(a) if rel[1] == "kernel" else a)
        return None

    def attn_inv(prefix, rel):
        sub = rel[0]
        if sub == "norm":
            return (f"{prefix}.norm.{wb[rel[1]]}", a)
        if sub in ("proj_in", "proj_out"):
            return (f"{prefix}.{sub}.{wb[rel[1]]}",
                    j2t_linear(a) if rel[1] == "kernel" else a)
        if sub == "transformer_blocks_0":
            s2 = rel[1]
            if s2.startswith("norm"):
                return (f"{prefix}.transformer_blocks.0.{s2}.{wb[rel[2]]}", a)
            if s2 in ("attn1", "attn2"):
                p = rel[2]
                if p == "to_out_0":
                    return (f"{prefix}.transformer_blocks.0.{s2}.to_out.0."
                            f"{wb[rel[3]]}",
                            j2t_linear(a) if rel[3] == "kernel" else a)
                return (f"{prefix}.transformer_blocks.0.{s2}.{p}.weight",
                        j2t_linear(a))
            if s2 == "ff":
                nm = {"net_0_proj": "net.0.proj", "net_2": "net.2"}[rel[2]]
                return (f"{prefix}.transformer_blocks.0.ff.{nm}.{wb[rel[3]]}",
                        j2t_linear(a) if rel[3] == "kernel" else a)
        return None

    p0 = path[0]
    if p0 == "conv_in" or p0 == "conv_out":
        return (f"{p0}.{wb[path[1]]}", j2t_conv(a) if path[1] == "kernel"
                else a)
    if p0 == "conv_norm_out":
        return (f"conv_norm_out.{wb[path[1]]}", a)
    if p0.startswith("time_embedding_linear_"):
        return (f"time_embedding.linear_{p0[-1]}.{wb[path[1]]}",
                j2t_linear(a) if path[1] == "kernel" else a)
    if p0 == "class_embedding":
        return ("class_embedding.weight", a)
    import re as _re
    m = _re.match(r"(down|up)_(\d+)_resnet_(\d+)$", p0)
    if m:
        return resnet_inv(f"{m.group(1)}_blocks.{m.group(2)}.resnets."
                          f"{m.group(3)}", path[1:])
    m = _re.match(r"(down|up)_(\d+)_attn_(\d+)$", p0)
    if m:
        return attn_inv(f"{m.group(1)}_blocks.{m.group(2)}.attentions."
                        f"{m.group(3)}", path[1:])
    m = _re.match(r"(down|up)_(\d+)_(downsample|upsample)$", p0)
    if m:
        kind = "downsamplers" if m.group(3) == "downsample" else "upsamplers"
        return (f"{m.group(1)}_blocks.{m.group(2)}.{kind}.0.conv."
                f"{wb[path[1]]}", j2t_conv(a) if path[1] == "kernel" else a)
    m = _re.match(r"mid_resnet_([01])$", p0)
    if m:
        return resnet_inv(f"mid_block.resnets.{m.group(1)}", path[1:])
    if p0 == "mid_attn_0":
        return attn_inv("mid_block.attentions.0", path[1:])
    return None


def sd_vae_rules() -> list:
    r = []
    for side in ("encoder", "decoder"):
        S = side
        r.append((rf"{S}\.conv_in\.(?P<wb>weight|bias)",
                  lambda k, m, S=S: (S, "conv_in",
                                     "kernel" if m.group("wb") == "weight"
                                     else "bias"), T_CONV))
        # VAE resnets have no time embedding
        r.append((rf"{S}\.(?P<blk>down_blocks\.(?P<i>\d+)|mid_block)\."
                  r"resnets\.(?P<j>\d+)\.(?P<s>norm[12])\.(?P<wb>weight|bias)",
                  lambda k, m, S=S: (S, _vae_block_name(m),
                                     m.group("s"),
                                     "scale" if m.group("wb") == "weight"
                                     else "bias"), None))
        r.append((rf"{S}\.(?P<blk>down_blocks\.(?P<i>\d+)|mid_block)\."
                  r"resnets\.(?P<j>\d+)\.(?P<s>conv[12]|conv_shortcut)\."
                  r"(?P<wb>weight|bias)",
                  lambda k, m, S=S: (S, _vae_block_name(m), m.group("s"),
                                     "kernel" if m.group("wb") == "weight"
                                     else "bias"), T_CONV))
        r.append((rf"{S}\.(?P<blk>up_blocks\.(?P<i>\d+))\.resnets\."
                  r"(?P<j>\d+)\.(?P<s>norm[12])\.(?P<wb>weight|bias)",
                  lambda k, m, S=S: (S, f"up_{m.group('i')}_resnet_"
                                     f"{m.group('j')}", m.group("s"),
                                     "scale" if m.group("wb") == "weight"
                                     else "bias"), None))
        r.append((rf"{S}\.(?P<blk>up_blocks\.(?P<i>\d+))\.resnets\."
                  r"(?P<j>\d+)\.(?P<s>conv[12]|conv_shortcut)\."
                  r"(?P<wb>weight|bias)",
                  lambda k, m, S=S: (S, f"up_{m.group('i')}_resnet_"
                                     f"{m.group('j')}", m.group("s"),
                                     "kernel" if m.group("wb") == "weight"
                                     else "bias"), T_CONV))
        r.append((rf"{S}\.down_blocks\.(?P<i>\d+)\.downsamplers\.0\.conv\."
                  r"(?P<wb>weight|bias)",
                  lambda k, m, S=S: (S, f"down_{m.group('i')}_downsample",
                                     "kernel" if m.group("wb") == "weight"
                                     else "bias"), T_CONV))
        r.append((rf"{S}\.up_blocks\.(?P<i>\d+)\.upsamplers\.0\.conv\."
                  r"(?P<wb>weight|bias)",
                  lambda k, m, S=S: (S, f"up_{m.group('i')}_upsample",
                                     "kernel" if m.group("wb") == "weight"
                                     else "bias"), T_CONV))
        r.append((rf"{S}\.mid_block\.attentions\.0\.group_norm\."
                  r"(?P<wb>weight|bias)",
                  lambda k, m, S=S: (S, "mid_attn", "group_norm",
                                     "scale" if m.group("wb") == "weight"
                                     else "bias"), None))
        r.append((rf"{S}\.mid_block\.attentions\.0\.to_(?P<p>[qkv])\."
                  r"(?P<wb>weight|bias)",
                  lambda k, m, S=S: (S, "mid_attn", f"to_{m.group('p')}",
                                     "kernel" if m.group("wb") == "weight"
                                     else "bias"), T_LIN))
        r.append((rf"{S}\.mid_block\.attentions\.0\.to_out\.0\."
                  r"(?P<wb>weight|bias)",
                  lambda k, m, S=S: (S, "mid_attn", "to_out_0",
                                     "kernel" if m.group("wb") == "weight"
                                     else "bias"), T_LIN))
        r.append((rf"{S}\.conv_norm_out\.(?P<wb>weight|bias)",
                  lambda k, m, S=S: (S, "conv_norm_out",
                                     "scale" if m.group("wb") == "weight"
                                     else "bias"), None))
        r.append((rf"{S}\.conv_out\.(?P<wb>weight|bias)",
                  lambda k, m, S=S: (S, "conv_out",
                                     "kernel" if m.group("wb") == "weight"
                                     else "bias"), T_CONV))
    r.append((r"(?P<q>quant_conv|post_quant_conv)\.(?P<wb>weight|bias)",
              lambda k, m: (m.group("q"),
                            "kernel" if m.group("wb") == "weight" else "bias"),
              T_CONV))
    return r


def _vae_block_name(m) -> str:
    if m.group("blk") == "mid_block":
        return f"mid_resnet_{m.group('j')}"
    return f"down_{m.group('i')}_resnet_{m.group('j')}"


def _sd_vae_invert(path, arr):
    a = np.asarray(arr)
    wb = {"kernel": "weight", "scale": "weight", "bias": "bias"}
    import re as _re
    if path[0] in ("quant_conv", "post_quant_conv"):
        return (f"{path[0]}.{wb[path[1]]}",
                j2t_conv(a) if path[1] == "kernel" else a)
    side = path[0]
    p1 = path[1]
    if p1 in ("conv_in", "conv_out"):
        return (f"{side}.{p1}.{wb[path[2]]}",
                j2t_conv(a) if path[2] == "kernel" else a)
    if p1 == "conv_norm_out":
        return (f"{side}.conv_norm_out.{wb[path[2]]}", a)
    m = _re.match(r"mid_resnet_([01])$", p1)
    if m:
        prefix = f"{side}.mid_block.resnets.{m.group(1)}"
        s = path[2]
        return (f"{prefix}.{s}.{wb[path[3]]}",
                j2t_conv(a) if path[3] == "kernel" and s.startswith("conv")
                else a)
    if p1 == "mid_attn":
        s = path[2]
        if s == "group_norm":
            return (f"{side}.mid_block.attentions.0.group_norm."
                    f"{wb[path[3]]}", a)
        nm = "to_out.0" if s == "to_out_0" else s
        return (f"{side}.mid_block.attentions.0.{nm}.{wb[path[3]]}",
                j2t_linear(a) if path[3] == "kernel" else a)
    m = _re.match(r"(down|up)_(\d+)_resnet_(\d+)$", p1)
    if m:
        prefix = (f"{side}.{m.group(1)}_blocks.{m.group(2)}.resnets."
                  f"{m.group(3)}")
        s = path[2]
        return (f"{prefix}.{s}.{wb[path[3]]}",
                j2t_conv(a) if path[3] == "kernel" and s.startswith("conv")
                else a)
    m = _re.match(r"(down|up)_(\d+)_(downsample|upsample)$", p1)
    if m:
        kind = "downsamplers" if m.group(3) == "downsample" else "upsamplers"
        return (f"{side}.{m.group(1)}_blocks.{m.group(2)}.{kind}.0.conv."
                f"{wb[path[2]]}", j2t_conv(a) if path[2] == "kernel" else a)
    return None


# ---------------------------------------------------------------------------
# RealESRGAN x4plus (RRDBNet) — the Hunyuan3D-2.1 texture upscaler
# (run_hunyuan21.py:112). Upstream BasicSR key schema:
#   conv_first / body.{i}.rdb{j}.conv{k} / conv_body / conv_up1 / conv_up2
#   / conv_hr / conv_last, each .weight/.bias. Checkpoints store the net
#   under 'params_ema' (the rules take the key with or without it).
# ---------------------------------------------------------------------------

def esrgan_rules() -> list:
    def conv(path):
        return lambda k, m: path(m) + (
            "kernel" if m.group("wb") == "weight" else "bias",)
    r = []
    r.append((r"(?:params_ema\.)?body\.(?P<i>\d+)\.rdb(?P<j>[123])\."
              r"conv(?P<c>[1-5])\.(?P<wb>weight|bias)",
              conv(lambda m: (f"body_{m.group('i')}", f"rdb{m.group('j')}",
                              f"conv{m.group('c')}")), T_CONV))
    r.append((r"(?:params_ema\.)?(?P<n>conv_first|conv_body|conv_up1|"
              r"conv_up2|conv_hr|conv_last)\.(?P<wb>weight|bias)",
              conv(lambda m: (m.group("n"),)), T_CONV))
    return r


def _esrgan_invert(path, arr):
    a = np.asarray(arr)
    wb = "weight" if path[-1] == "kernel" else "bias"
    t = j2t_conv(a) if path[-1] == "kernel" else a
    if path[0].startswith("body_"):
        i = path[0][5:]
        return (f"body.{i}.{path[1]}.{path[2]}.{wb}", t)
    return (f"{path[0]}.{wb}", t)


# ---------------------------------------------------------------------------
# flux — FLUX.1 MMDiT (diffusers FluxTransformer2DModel layout), the
# reference's FLUX upscaler backbone (src/segmentation/upscaler.py:26-39)
# ---------------------------------------------------------------------------

def flux_rules() -> list:
    lin = lambda path: lambda k, m: path(m) + (
        ("kernel" if m.group("wb") == "weight" else "bias"),)
    r = []
    for tk, ours in (("x_embedder", "x_in"), ("context_embedder", "cond_in"),
                     ("proj_out", "proj_out")):
        r.append((rf"{tk}\.(?P<wb>weight|bias)",
                  lin(lambda m, ours=ours: (ours,)), T_LIN))
    for tk, ours in (("timestep_embedder", ("t_in", "t_out")),
                     ("guidance_embedder", ("g_in", "g_out")),
                     ("text_embedder", ("p_in", "p_out"))):
        r.append((rf"time_text_embed\.{tk}\.linear_(?P<n>[12])"
                  rf"\.(?P<wb>weight|bias)",
                  lin(lambda m, ours=ours: (ours[int(m.group("n")) - 1],)),
                  T_LIN))
    r.append((r"norm_out\.linear\.(?P<wb>weight|bias)",
              lin(lambda m: ("norm_out_lin",)), T_LIN))

    D = r"transformer_blocks\.(?P<i>\d+)"
    blk = lambda m: (f"double{m.group('i')}",)
    r.append((rf"{D}\.norm1\.linear\.(?P<wb>weight|bias)",
              lin(lambda m: blk(m) + ("mod_img",)), T_LIN))
    r.append((rf"{D}\.norm1_context\.linear\.(?P<wb>weight|bias)",
              lin(lambda m: blk(m) + ("mod_txt",)), T_LIN))
    r.append((rf"{D}\.attn\.to_(?P<p>[qkv])\.(?P<wb>weight|bias)",
              lin(lambda m: blk(m) + ("attn", m.group("p"))), T_LIN))
    r.append((rf"{D}\.attn\.norm_(?P<p>[qk])\.weight",
              lambda k, m: blk(m) + ("attn", f"{m.group('p')}_norm",
                                     "scale"), None))
    r.append((rf"{D}\.attn\.add_(?P<p>[qkv])_proj\.(?P<wb>weight|bias)",
              lin(lambda m: blk(m) + ("attn_add", f"add_{m.group('p')}")),
              T_LIN))
    r.append((rf"{D}\.attn\.norm_added_(?P<p>[qk])\.weight",
              lambda k, m: blk(m) + ("attn_add", f"add_{m.group('p')}_norm",
                                     "scale"), None))
    r.append((rf"{D}\.attn\.to_out\.0\.(?P<wb>weight|bias)",
              lin(lambda m: blk(m) + ("out",)), T_LIN))
    r.append((rf"{D}\.attn\.to_add_out\.(?P<wb>weight|bias)",
              lin(lambda m: blk(m) + ("add_out",)), T_LIN))
    r.append((rf"{D}\.ff\.net\.0\.proj\.(?P<wb>weight|bias)",
              lin(lambda m: blk(m) + ("ff", "fc1")), T_LIN))
    r.append((rf"{D}\.ff\.net\.2\.(?P<wb>weight|bias)",
              lin(lambda m: blk(m) + ("ff", "fc2")), T_LIN))
    r.append((rf"{D}\.ff_context\.net\.0\.proj\.(?P<wb>weight|bias)",
              lin(lambda m: blk(m) + ("ff_txt", "fc1")), T_LIN))
    r.append((rf"{D}\.ff_context\.net\.2\.(?P<wb>weight|bias)",
              lin(lambda m: blk(m) + ("ff_txt", "fc2")), T_LIN))

    S = r"single_transformer_blocks\.(?P<i>\d+)"
    sblk = lambda m: (f"single{m.group('i')}",)
    r.append((rf"{S}\.norm\.linear\.(?P<wb>weight|bias)",
              lin(lambda m: sblk(m) + ("mod",)), T_LIN))
    r.append((rf"{S}\.attn\.to_(?P<p>[qkv])\.(?P<wb>weight|bias)",
              lin(lambda m: sblk(m) + ("attn", m.group("p"))), T_LIN))
    r.append((rf"{S}\.attn\.norm_(?P<p>[qk])\.weight",
              lambda k, m: sblk(m) + ("attn", f"{m.group('p')}_norm",
                                      "scale"), None))
    r.append((rf"{S}\.proj_mlp\.(?P<wb>weight|bias)",
              lin(lambda m: sblk(m) + ("proj_mlp",)), T_LIN))
    r.append((rf"{S}\.proj_out\.(?P<wb>weight|bias)",
              lin(lambda m: sblk(m) + ("proj_out",)), T_LIN))
    return r


def _flux_invert(path, arr):
    a = np.asarray(arr)
    wb = {"kernel": "weight", "bias": "bias"}
    top = {"x_in": "x_embedder", "cond_in": "context_embedder",
           "proj_out": "proj_out"}
    emb = {"t_in": ("timestep_embedder", 1), "t_out": ("timestep_embedder", 2),
           "g_in": ("guidance_embedder", 1), "g_out": ("guidance_embedder", 2),
           "p_in": ("text_embedder", 1), "p_out": ("text_embedder", 2)}
    if path[0] in top:
        return (f"{top[path[0]]}.{wb[path[1]]}",
                j2t_linear(a) if path[1] == "kernel" else a)
    if path[0] in emb:
        name, n = emb[path[0]]
        return (f"time_text_embed.{name}.linear_{n}.{wb[path[1]]}",
                j2t_linear(a) if path[1] == "kernel" else a)
    if path[0] == "norm_out_lin":
        return (f"norm_out.linear.{wb[path[1]]}",
                j2t_linear(a) if path[1] == "kernel" else a)
    if path[0].startswith("double"):
        i = path[0][6:]
        P = f"transformer_blocks.{i}"
        rel = path[1:]
        tl = lambda: j2t_linear(a) if rel[-1] == "kernel" else a
        if rel[0] == "mod_img":
            return (f"{P}.norm1.linear.{wb[rel[1]]}", tl())
        if rel[0] == "mod_txt":
            return (f"{P}.norm1_context.linear.{wb[rel[1]]}", tl())
        if rel[0] == "attn":
            if rel[1].endswith("_norm"):
                return (f"{P}.attn.norm_{rel[1][0]}.weight", a)
            return (f"{P}.attn.to_{rel[1]}.{wb[rel[2]]}", tl())
        if rel[0] == "attn_add":
            if rel[1].endswith("_norm"):
                return (f"{P}.attn.norm_added_{rel[1][4]}.weight", a)
            return (f"{P}.attn.{rel[1]}_proj.{wb[rel[2]]}", tl())
        if rel[0] == "out":
            return (f"{P}.attn.to_out.0.{wb[rel[1]]}", tl())
        if rel[0] == "add_out":
            return (f"{P}.attn.to_add_out.{wb[rel[1]]}", tl())
        if rel[0] == "ff":
            net = "net.0.proj" if rel[1] == "fc1" else "net.2"
            return (f"{P}.ff.{net}.{wb[rel[2]]}", tl())
        if rel[0] == "ff_txt":
            net = "net.0.proj" if rel[1] == "fc1" else "net.2"
            return (f"{P}.ff_context.{net}.{wb[rel[2]]}", tl())
    if path[0].startswith("single"):
        i = path[0][6:]
        P = f"single_transformer_blocks.{i}"
        rel = path[1:]
        tl = lambda: j2t_linear(a) if rel[-1] == "kernel" else a
        if rel[0] == "mod":
            return (f"{P}.norm.linear.{wb[rel[1]]}", tl())
        if rel[0] == "attn":
            if rel[1].endswith("_norm"):
                return (f"{P}.attn.norm_{rel[1][0]}.weight", a)
            return (f"{P}.attn.to_{rel[1]}.{wb[rel[2]]}", tl())
        if rel[0] in ("proj_mlp", "proj_out"):
            return (f"{P}.{rel[0]}.{wb[rel[1]]}", tl())
    return None


# ---------------------------------------------------------------------------
# the port's modules at their tiny configs (f32, CPU, from a generator)
# ---------------------------------------------------------------------------

def _f32(cfg):
    return dataclasses.replace(cfg, dtype=torch.float32)


def _sam_tiny(gen):
    from regen3d_tpu_torch.models import sam
    m = sam.SAM(_f32(sam.SamConfig.tiny()), device="cpu")
    sam.init_flax_style_(m, gen)
    return m


def _vggt_tiny(gen):
    from regen3d_tpu_torch.models import vggt
    m = vggt.VGGT(_f32(vggt.VGGTConfig.tiny()), device="cpu")
    vggt.init_flax_style_(m, gen)
    return m


def _dust3r_tiny(gen):
    from regen3d_tpu_torch.models import dust3r
    m = dust3r.AsymmetricCroCo3DStereo(_f32(dust3r.Dust3rConfig.tiny()),
                                       device="cpu")
    dust3r.init_flax_style_(m, gen)
    return m


def _lpips_tiny(gen):
    from regen3d_tpu_torch.models import lpips
    m = lpips.LPIPS(device="cpu")
    lpips.init_flax_style_(m, gen)
    return m


def _dit_tiny(gen, cross_instance=False):
    from regen3d_tpu_torch.models import dit
    c = dataclasses.replace(_f32(dit.DiTConfig.tiny()),
                            cross_instance=cross_instance)
    m = dit.ShapeDiT(c, device="cpu")
    dit.init_flax_style_(m, gen)
    return m


def shapevae_module(cfg, device="cuda") -> torch.nn.Module:
    """The shape VAE's two halves under one module, as the ``shapevae``
    family's tree holds them: ``encoder`` and ``decoder``."""
    from regen3d_tpu_torch.models.shapevae import ShapeDecoder, ShapeEncoder
    return torch.nn.ModuleDict({"encoder": ShapeEncoder(cfg, device=device),
                                "decoder": ShapeDecoder(cfg, device=device)})


def _shapevae_tiny(gen):
    from regen3d_tpu_torch.models.layers import init_flax_layers_
    from regen3d_tpu_torch.models.shapevae import ShapeVAEConfig
    m = shapevae_module(_f32(ShapeVAEConfig.tiny()), device="cpu")
    init_flax_layers_(m, gen)
    with torch.no_grad():
        m["encoder"].latent_queries.normal_(0.0, 0.02, generator=gen)
    return m


def _depth_anything_tiny(gen):
    from regen3d_tpu_torch.models import depth_anything as da
    m = da.DepthAnything(_f32(da.DepthAnythingConfig.tiny()), device="cpu")
    da.init_flax_style_(m, gen)
    return m


def _detector_tiny(gen):
    from regen3d_tpu_torch.models import detector
    m = detector.OpenVocabDetector(_f32(detector.DetectorConfig.tiny()),
                                   device="cpu")
    detector.init_flax_style_(m, gen)
    return m


def _saliency_tiny(gen):
    from regen3d_tpu_torch.models import saliency
    m = saliency.SaliencyTransformer(_f32(saliency.SaliencyConfig.tiny()),
                                     device="cpu")
    saliency.init_flax_style_(m, gen)
    return m


def _matting_tiny(gen):
    from regen3d_tpu_torch.models.unet import MattingUNet, init_flax_style_
    m = MattingUNet(base=8, dtype=torch.float32, device="cpu")
    init_flax_style_(m, gen)
    return m


def _sd_unet_tiny(gen):
    from regen3d_tpu_torch.models import sd_unet
    m = sd_unet.SDUNet(_f32(sd_unet.SDUNetConfig.tiny(class_embeddings=4)),
                       device="cpu")
    sd_unet.init_flax_style_(m, gen)
    return m


def _sd_vae_tiny(gen):
    from regen3d_tpu_torch.models import sd_unet, sd_vae
    m = sd_vae.SDAutoencoderKL(_f32(sd_vae.SDVAEConfig.tiny()), device="cpu")
    sd_unet.init_flax_style_(m, gen)
    return m


def _esrgan_tiny(gen):
    from regen3d_tpu_torch.models import esrgan
    m = esrgan.RRDBNet(esrgan.ESRGANConfig.tiny(), device="cpu")
    esrgan.init_flax_style_(m, gen)
    return m


def _flux_tiny(gen):
    from regen3d_tpu_torch.models import flux
    m = flux.FluxTransformer(_f32(flux.FluxConfig.tiny()), device="cpu")
    flux.init_flax_style_(m, gen)
    return m


# ---------------------------------------------------------------------------
# registry + self-test
# ---------------------------------------------------------------------------

FAMILIES: Dict[str, Family] = {
    "depth_anything": Family("depth_anything", "exact",
                             depth_anything_rules, _depth_anything_tiny,
                             _depth_anything_invert,
                             conv_transpose=DEPTH_ANYTHING_CONV_TRANSPOSE),
    "detector": Family("detector", "diverged",
                       _diverged_rules("detector",
                                       "IDEA-Research/grounding-dino-base"),
                       _detector_tiny, _no_invert),
    "saliency": Family("saliency", "diverged",
                       _diverged_rules("saliency", "VST (vst_main)"),
                       _saliency_tiny, _no_invert,
                       conv_transpose=SALIENCY_CONV_TRANSPOSE),
    "matting": Family("matting", "diverged",
                      _diverged_rules("matting", "rembg u2net"),
                      _matting_tiny, _no_invert),
    "sam": Family("sam", "exact", sam_rules, _sam_tiny, _sam_invert,
                  _sam_extra, conv_transpose=SAM_CONV_TRANSPOSE),
    "vggt": Family("vggt", "exact", vggt_rules, _vggt_tiny, _vggt_invert,
                   _vggt_extra),
    "dust3r": Family("dust3r", "exact", dust3r_rules, _dust3r_tiny,
                     _dust3r_invert),
    "lpips": Family("lpips", "exact", lpips_rules, _lpips_tiny,
                    _lpips_invert),
    "dit": Family("dit", "provisional", dit_rules, _dit_tiny, _dit_invert),
    "shapevae": Family("shapevae", "provisional", shapevae_rules,
                       _shapevae_tiny, _shapevae_invert),
    # ShapeDiT + MIDI cross-instance attention (baseline_midi adapter)
    "midi": Family("midi", "provisional", midi_rules,
                   lambda gen: _dit_tiny(gen, cross_instance=True),
                   _midi_invert),
    "sd_unet": Family("sd_unet", "exact", sd_unet_rules, _sd_unet_tiny,
                      _sd_unet_invert),
    "sd_vae": Family("sd_vae", "exact", sd_vae_rules, _sd_vae_tiny,
                     _sd_vae_invert),
    # Marigold's intrinsics/normals UNets are UNet2DConditionModels: the
    # sd_unet table under another name, as in the JAX package
    "marigold": Family("marigold", "exact", sd_unet_rules, _sd_unet_tiny,
                       _sd_unet_invert),
    "esrgan": Family("esrgan", "exact", esrgan_rules, _esrgan_tiny,
                     _esrgan_invert),
    # FLUX.1's MMDiT (the FLUX upscaler's transformer): provisional, as in
    # the JAX package; numerics await a real checkpoint
    "flux": Family("flux", "provisional", flux_rules, _flux_tiny,
                   _flux_invert),
}


def tiny_init(family: str, seed: int = 0) -> Dict[str, Any]:
    """The flax tree of ``family``'s tiny port module, initialised from a
    CPU generator seeded with ``seed``."""
    fam = FAMILIES[family]
    model = fam.tiny_model(torch.Generator().manual_seed(seed))
    return tree_from_model(model, fam.conv_transpose)


def upstream_state(family: str, tree: Mapping) -> Dict[str, np.ndarray]:
    """A flax tree of ``family`` (top ``params`` level optional) → the
    upstream-layout state dict its rule table converts back to it, the
    upstream-only keys the rules drop (``extra_torch_keys``) included."""
    fam = FAMILIES[family]
    state: Dict[str, np.ndarray] = {}
    merges3: Dict[str, Dict[str, np.ndarray]] = {}
    missing = []
    for path, arr in flatten_tree(tree).items():
        p = path[1:] if path[0] == "params" else path
        res = fam.invert(p, np.asarray(arr))
        if res is None:
            missing.append("/".join(p))
            continue
        if isinstance(res, str) and res == "SKIP":
            continue
        items = res if isinstance(res, list) else [res]
        for item in items:
            if item[0] == "MERGE3":
                _, key, part, a = item
                merges3.setdefault(key, {})[part] = a
            elif item[0] == "MERGE_ROWS":
                _, fmt, row, a = item
                state[fmt.format(row=row)] = a
            else:
                key, a = item
                state[key] = a
    for key, parts in merges3.items():
        state[key] = np.concatenate([parts["q"], parts["k"], parts["v"]],
                                    axis=0)
    if missing:
        raise AssertionError(
            f"{family}: inverse map misses {len(missing)} leaves, e.g. "
            f"{missing[:8]}")
    state.update(fam.extra_torch_keys())
    return state


def synthetic_state(family: str, seed: int = 0
                    ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """An upstream-layout state dict built from the tiny port module (the
    rule table's inverse); returns (state_dict, init_tree)."""
    init = tiny_init(family, seed)
    return upstream_state(family, init), init


def selftest(family: str) -> List[str]:
    """Round-trip completeness check; returns verify errors (empty = OK).

    Diverged families have no rule table by design: selftest proves their
    tiny module builds."""
    fam = FAMILIES[family]
    if fam.status == "diverged":
        fam.tiny_model(torch.Generator().manual_seed(0))
        return []
    state, init = synthetic_state(family)
    tree = convert_state_dict(state, fam.rules(), strict=True)
    return verify_tree_shapes(tree, init)


def load_upstream(family: str, state: Mapping[str, Any],
                  model: torch.nn.Module) -> None:
    """An upstream state dict (torch keys; numpy arrays or tensors, e.g.
    from ``models.weights.load_torch_file``) → ``model``, a port module of
    ``family`` at the checkpoint's config (for ``shapevae``,
    :func:`shapevae_module`). Every key must map or be an explicit drop
    (``KeyError`` otherwise), and every parameter of ``model`` must be set
    exactly once."""
    fam = FAMILIES[family]
    tree = convert_state_dict(state, fam.rules(), strict=True)
    load_from_jax(model, tree, fam.conv_transpose)
