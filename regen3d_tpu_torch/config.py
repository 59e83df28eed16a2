"""Configuration system.

The reference uses a single flat 416-line YAML (`src/config.yaml`) read with
`yaml.safe_load` (reference: src/utils/global_utils.py:464-476) and every
consumer calls `config.get(key, default)` with defaults duplicated (and
sometimes inconsistent) at each call site.

Here the schema is the SAME flat key set — existing reference config files
load unchanged — but defaults are centralized in ``DEFAULTS`` (one source of
truth), values are validated on access by type, and relative paths are
resolved against the config file's directory (the reference resolves them
against each phase script's cwd, which is always a sibling of the config —
same net result, without the per-phase cwd coupling).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, Mapping, Optional

# ---------------------------------------------------------------------------
# Centralized defaults for the reference schema (reference: src/config.yaml).
# Keys not listed here are still allowed (passthrough), but listed keys get
# consistent defaults everywhere instead of call-site duplication.
# ---------------------------------------------------------------------------
DEFAULTS: Dict[str, Any] = {
    # --- general -----------------------------------------------------------
    "logging": "INFO",
    "input_image": "../input_images/2400.jpg",
    "GT_scene": None,
    "use_3d_front": False,
    "device": "tpu:0",          # reference default is "cuda:0"; we run on TPU
    "device_global": "tpu:0",
    "use_all_available_cuda": False,   # kept for schema compat; mesh replaces it
    "jobs_per_gpu": 1,
    "seed": 1234567,
    "output": "../output",
    "temp": "../tmp",
    # --- phase 1: segmentation --------------------------------------------
    "upscale_input_image": False,
    "labels": ["chair", "table", "sofa", "plant in pot", "lamp", "floor"],
    "polygon_refinement": False,
    "threshold": 0.25,
    "iou_threshold": 0.5,
    "detector_id": "IDEA-Research/grounding-dino-base",
    "segmenter_id": "facebook/sam-vit-huge",
    "output_seg": "../output/findings",
    "output_seg_banana": "../output/findings/banana",
    "depth_scene": "../output/findings/depth.png",
    "depth_large_model": True,
    # converted Depth-Anything-V2 orbax checkpoint (conversion family
    # `depth_anything`); empty = analytic depth prior fallback
    "depth_anything_checkpoint": "",
    "use_points": False,
    "point_method": "max_distance",
    # distilled (or converted) open-vocab detector for phase 1
    # (scripts/distill_detector.py); empty = clustering fallback
    "detector_checkpoint": "",
    # distilled (or converted) saliency net for point_method: saliency
    # (scripts/distill_saliency.py); empty = max_distance fallback
    "saliency_checkpoint": "",
    # distilled MattingUNet for phase-2 prep (scripts/distill_matting.py);
    # empty = white-threshold matting fallback
    "matting_checkpoint": "",
    "matting_base": 32,
    "scale_bounding_boxes": 1.01,
    "findings_padding": 5,
    "banana_line_thickness": 3,
    "banana_offset_px": 5,
    "banana_line_color": [255, 0, 0],
    "dim_background": False,
    "dim_factor": 0.35,
    "dim_color": [100, 100, 100],
    "banana_bbox_thickness": 2,
    "banana_bbox_color": [255, 0, 0],
    "banana_bbox_padding": 6,
    "use_bbox_as_input": False,
    # --- phase 2: generative inpainting ------------------------------------
    "genai_temperature": 1.0,
    "genai_top_p": 0.95,
    "genai_temperature_emptyRoom": 0.5,
    "use_banana": True,
    # human-in-the-loop mask editor (reference: segmentation.py:1132-1143;
    # served by the stdlib HTTP UI in pipeline/editor_ui.py)
    "interactive_edit": False,
    "editor_port": 7860,
    "editor_open_browser": False,
    "use_AQ": True,
    "model_id": "gemini-2.5-flash-image-preview",
    "keep_existing_banans": False,
    "keep_existing_empty_rooms": True,
    "banana_inpainting_prompt": (
        "Extract this red marked {object}.\n"
        "Create a single render of it with a white background.\n"
    ),
    "prompt_empty_room": (
        "Remove ALL objects and furniture.\n"
        "I want a single empty room.\n"
        "No chairs, tables, lamps, dresser, kitchen parts etc.\n"
        "Just give me back the same room but EMPTY.\n"
        "Same light, same perspective, same walls, floor and ceiling.\n"
    ),
    "prompt_AQ": (
        'Here is the UI of an application.\n'
        'We want an amodal render of the single object "{object}" that needs '
        'to be extracted,\nreplacing the "Extracted Object" panel on the '
        'right, with the completed amodal object on a white background.\n'
        'Keep the rest of the image the same.\n'
    ),
    "output_inp_banana": "../output/findings/banana/inpaint_nanoBanana",
    "prepped_for_hunyuan": "../output/findings/banana/prepped",
    # --- phase 1 alt: diffusion upscaler ------------------------------------
    "guidance_scale": 5.0,
    "num_inference_steps": 50,
    "upscaler_model_name": "SD",
    "size": 400,
    # --- phase 3: image→3D assets -------------------------------------------
    "input_folder_hy": "../output/findings/upscaled/cropped/",
    "output_folder_hy": "../output/3D/",
    "mini": False,
    "num_inf_steps_hy": 50,
    "octree_resolution_hy": 256,
    "num_chunks_hy": 16000,
    "remesh": False,
    "remesh_target_num_faces": 50000,
    "use_hunyuan21": False,
    # Hunyuan3D-2.1 variant knobs (reference config.yaml:176-192)
    "enable_texture_hy21": True,
    "steps_hy21": 30,
    "guidance_scale_hy21": 5.0,
    "octree_resolution_hy21": 256,
    "num_chunks_hy21": 8000,
    "max_num_view_hy21": 6,
    "resolution_hy21": 512,
    "realesrgan_ckpt_path": "",
    # --- phase 4: camera + point cloud --------------------------------------
    "image_size": 1024,
    "tmp_dir": "../output/pre_3D",
    "Use_VGGT": True,
    "camera": "../output/pre_3D/camera.npz",
    "vggt_cloud": "../output/pre_3D/scene_vggt.ply",
    "output_vggt": "../output/vggt/sparse",
    "vggt_scene_scale": 2.0,
    "use_ba": False,
    "max_query_pts": 4096,
    "query_frame_num": 8,
    "fine_tracking": True,
    "max_reproj_error": 8.0,
    "vis_thresh": 0.2,
    "shared_camera": False,
    "camera_type": "SIMPLE_PINHOLE",
    "conf_thres_value": 1.0,
    "max_points_for_colmap": 10_000_000,
    # --- phase 5: point-cloud extraction -------------------------------------
    "filter_vggt_quantile": True,
    "quantile_value": 0.02,
    "filter_vggt_dbscan": False,
    "dbscan_eps": 0.1,
    "dbscan_min_points": 10,
    "mask_shrink_pixels": 4,
    "mask_shrink_iterations": 4,
    "debug_save": False,
    "mask_folder": "../output/masks",
    "output_ply": "../output/pointclouds/",
    # --- phase 6: differentiable-rendering pose fit ---------------------------
    "Use_VGGT_depth": True,
    "set_no_initial_rotation": True,
    "use_rotation_grid_search": True,
    "grid_rotation_steps": 8,
    "glb_output_folder": "../output/glb/",
    "image_size_DR": 1024,
    "show_plot": False,
    "ignore_classes": ["wall", "floor", "ceiling", "door", "window"],
    "full_size": "../output/findings/fullSize/",
    "set_depth_multiplier": 10,
    "pre_scale_factor": 100,
    "regularize_depth": False,
    "sigma": 5e-7,
    "gamma": 5e-7,
    "random_init_pose": False,
    "use_5DOF": True,
    # labels usually on the floor (reference: pose_matching_planar.py:1024-1027)
    "floor_object_names": ["chair", "sofa", "table", "couch", "bed",
                           "cabinet", "desk", "sideboard", "dresser", "plant"],
    "silhoutte_loss": 0.1,       # (sic — reference key spelling)
    "loss_3d": 0.1,
    "loss_bbox": 0.01,
    "background_bbox_extents": -0.02,
    "rotation_speed_mult": 8.0,
    "depth_warmup_iters": 100,
    "learning_rate": 0.005,
    "max_iterations": 300,
    "early_stop_grad_threshold": 0.005,
    "early_stop_min_iterations": 200,
    "camera_znear": 0.1,
    "camera_zfar": 50.0,
    # --- phase 7: scene optimization -----------------------------------------
    "roughness": 0.5,
    "metallic": 0.2,
    "metallic_aluminium": 0.95,
    "roughness_aluminium": 0.025,
    "albedo_aluminium": [0.65, 0.65, 0.65, 1.0],
    "list_aluminium_scene": [],
    "use_icp": True,
    "num_samples": 60000,
    "icp_max_iterations": 200,
    "icp_estimate_scale": False,
    "glb_scene_path": "../output/glb/scene/combined_scene.glb",
    "ply_scene_bp_path": "../output/pointclouds/scene/combined_scene_bp.ply",
    "ply_pred_points": "../output/pointclouds/scene/pred_points.ply",
    "ply_gt_points": "../output/pointclouds/scene/gt_points.ply",
    "out_pc_meshed": "../output/pointclouds/meshed/",
    "background_mesh_depth": 10,
    "point_search_radius": 0.05,
    "max_ground_matching_iterations": 20,
    "background_remesh_percentage": 0.0,
    # --- phase 8: rendering ---------------------------------------------------
    "output_render": "../output/rendering/",
    "hdri_path": None,
    "hdri_strength": 1.0,
    "hdri_rotation": 130,
    "hdri_white_bg": False,
    "render_pc": False,
    "render_GT": False,
    "blender_render_samples": 8,
    "use_baked_image_only": True,
    "roughness_strength": 0.65,
    "metallic_strength": 0.15,
    "normal_strength": 0.05,
    "look": "Medium Contrast",
    "view_transform": "Filmic",
    "exposure": 0.4,
    "gamma": 0.8,
    # --- phase 9: evaluation ---------------------------------------------------
    "predicted_image": "../output/rendering/render_cam1_white_bg.png",
    "eval_output_dir": "../output/evaluation/",
    "Use_MIDI": False,
    # MIDI baseline knobs (reference config.yaml:400-414)
    "use_latest_glb": False,
    "glb_scene_path_midi": "../output/glb/scene/combined_scene_midi.glb",
    "midi_output": "../output/midi/",
    "midi_tmp": "../tmp/midi/",
    "detect_threshold": 0.2,
    "seg_mode": "label",
    "num_inference_steps_midi": 50,
    "guidance_scale_midi": 7.0,
    "run_texture": False,
    # DPA baseline (reference run_dpa.py:20-53; stage dirs under dpa_output)
    "Use_DPA": False,
    "dpa_output": "../output/dpa/",
    "dpa_iterations": 60,
}

_FLOAT_RE = __import__("re").compile(r"^[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+$")


def _coerce_scalar(v: Any) -> Any:
    """YAML 1.1 parses exponents without a dot ('5e-7') as strings
    (the reference config uses that spelling at config.yaml:307-308);
    coerce them back to float."""
    if isinstance(v, str) and _FLOAT_RE.match(v):
        return float(v)
    return v


_PATH_KEYS = frozenset(
    k
    for k, v in DEFAULTS.items()
    if isinstance(v, str) and ("/" in v or v.endswith((".png", ".npz", ".ply", ".glb")))
) | {"input_image", "GT_scene", "hdri_path", "config_path", "image_url", "3d_front_scene"}


@dataclass
class Config(Mapping):
    """Flat, reference-schema-compatible config with centralized defaults.

    Behaves like the reference's plain dict (``cfg["key"]``, ``cfg.get``),
    plus: path resolution against the config file location via
    :meth:`path`, and attribute access for readability.
    """

    values: Dict[str, Any] = field(default_factory=dict)
    base_dir: str = "."

    # -- Mapping protocol ----------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        if key in self.values:
            return _coerce_scalar(self.values[key])
        if key in DEFAULTS:
            return DEFAULTS[key]
        raise KeyError(key)

    def __iter__(self) -> Iterator[str]:
        seen = set()
        for k in self.values:
            seen.add(k)
            yield k
        for k in DEFAULTS:
            if k not in seen:
                yield k

    def __len__(self) -> int:
        return len(set(self.values) | set(DEFAULTS))

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default

    def __getattr__(self, key: str) -> Any:
        # dataclass fields resolve normally; anything else is a config key.
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    # -- helpers ---------------------------------------------------------------
    def path(self, key: str, default: Optional[str] = None) -> Optional[str]:
        """Resolve a path-valued key against the config file's directory.

        The reference runs each phase with cwd set to the phase's source dir
        (a sibling of src/config.yaml) so "../output" means "<repo>/output";
        resolving against the config dir reproduces that layout exactly.
        """
        raw = self.get(key, default)
        if raw is None:
            return None
        raw = str(raw)
        if os.path.isabs(raw):
            return raw
        # Canonical "../output/..." layout always anchors at the (possibly
        # overridden/absolute) output root. For the reference's own configs
        # (output: "../output") this equals base_dir resolution; for configs
        # that set an absolute `output` it keeps every artifact under it
        # instead of silently splitting the tree across two roots.
        if raw.startswith("../output") and key != "output":
            return os.path.normpath(self.output_root + raw[len("../output"):])
        if key in self.values or key in ("output", "temp"):
            # Explicitly configured (or the roots themselves): resolve like the
            # reference does — against the phase cwd next to the config file.
            return os.path.normpath(os.path.join(self.base_dir, raw))
        root = os.path.dirname(self.output_root)
        if raw.startswith("../"):
            return os.path.normpath(os.path.join(root, raw[3:]))
        return os.path.normpath(os.path.join(self.base_dir, raw))

    def with_overrides(self, **overrides: Any) -> "Config":
        merged = dict(self.values)
        merged.update(overrides)
        return Config(values=merged, base_dir=self.base_dir)

    @property
    def output_root(self) -> str:
        return self.path("output", "../output")


def load_config(config_path: str, overrides: Optional[Dict[str, Any]] = None) -> Config:
    """Load a reference-format YAML config file.

    Reference equivalent: ``load_config`` at src/utils/global_utils.py:464-476
    (plain ``yaml.safe_load``). Relative paths inside the file are interpreted
    relative to the *file's directory* (see :meth:`Config.path`).
    """
    # PyYAML is imported here, not at the top: default_config needs none
    import yaml

    with open(config_path, "r") as f:
        values = yaml.safe_load(f) or {}
    if not isinstance(values, dict):
        raise TypeError(f"config root must be a mapping, got {type(values)}")
    if overrides:
        values.update(overrides)
    # Reference layout: config lives in <repo>/src/, and each phase runs with
    # cwd = a FIRST-LEVEL repo dir (e.g. <repo>/segmentor — run.py:235), so
    # "../output" resolves to "<repo>/output". Anchor a virtual phase dir at
    # the repo root (the config dir's parent).
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(config_path)))
    return Config(values=values, base_dir=os.path.join(repo_root, "_phase"))


def default_config(output_root: str, **overrides: Any) -> Config:
    """Build an in-memory config rooted at ``output_root`` (for tests/tools).

    ``base_dir`` uses the same virtual ``_phase`` subdir convention as
    :func:`load_config` so reference-layout relative defaults ("../tmp")
    resolve to SIBLINGS of the output root (<workdir>/tmp) instead of
    escaping the workdir (dirname(workdir)/tmp)."""
    values = {"output": os.path.abspath(output_root)}
    values.update(overrides)
    workdir = os.path.dirname(os.path.abspath(output_root))
    return Config(values=values, base_dir=os.path.join(workdir, "_phase"))
