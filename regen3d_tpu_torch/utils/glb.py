"""Minimal glTF 2.0 / GLB mesh IO, from scratch (no trimesh/pygltflib).

Covers the subset the pipeline's artifact bus needs (reference:
``output/3D/<name>/<name>.glb`` assets, ``output/glb/<name>.glb`` fitted
objects, ``combined_scene.glb`` — global_utils.py:506-601):
  * read/write triangle meshes with positions, indices, optional normals,
    UVs, vertex colors
  * PBR metallic-roughness materials: baseColorFactor, metallic/roughness
    factors, optional embedded baseColor PNG texture
  * node transforms (matrix or TRS), flattened into vertices on load
  * multiple named meshes per file (scene assembly)
"""

from __future__ import annotations

import base64
import json
import os
import struct
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

_GLB_MAGIC = 0x46546C67  # 'glTF'
_CHUNK_JSON = 0x4E4F534A
_CHUNK_BIN = 0x004E4942

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_WIDTHS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


@dataclass
class MeshData:
    """One named triangle mesh with optional attributes and PBR material."""

    name: str
    vertices: np.ndarray                      # (V, 3) float32
    faces: np.ndarray                         # (F, 3) int32
    normals: Optional[np.ndarray] = None      # (V, 3) float32
    uvs: Optional[np.ndarray] = None          # (V, 2) float32
    vertex_colors: Optional[np.ndarray] = None  # (V, 4) float32 in [0,1]
    base_color: Optional[np.ndarray] = None   # (4,) float
    metallic: float = 0.0
    roughness: float = 1.0
    texture_png: Optional[bytes] = None       # baseColor texture (PNG bytes)
    mr_texture_png: Optional[bytes] = None    # metallicRoughness texture
    #                                           (glTF: G=roughness, B=metallic)

    def transformed(self, M: np.ndarray) -> "MeshData":
        """Apply a 4x4 column-vector transform to vertices (and normals)."""
        v = self.vertices @ M[:3, :3].T + M[:3, 3]
        n = self.normals
        if n is not None:
            lin = np.linalg.inv(M[:3, :3]).T
            n = n @ lin.T
            n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
        out = MeshData(**{**self.__dict__})
        out.vertices = v.astype(np.float32)
        out.normals = None if n is None else n.astype(np.float32)
        return out


@dataclass
class SceneData:
    meshes: List[MeshData] = field(default_factory=list)

    @property
    def total_vertices(self) -> int:
        return sum(m.vertices.shape[0] for m in self.meshes)


def _pad(b: bytes, align: int, fill: bytes) -> bytes:
    rem = len(b) % align
    return b if rem == 0 else b + fill * (align - rem)


def save_glb(path: str, scene: SceneData) -> None:
    """Write a GLB file with one node per mesh (flat scene graph)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    bin_parts: List[bytes] = []
    buffer_views = []
    accessors = []
    images = []
    textures = []
    samplers = []
    materials = []
    meshes_json = []
    nodes = []
    bin_len = 0

    def add_view(data: bytes, target: Optional[int]) -> int:
        nonlocal bin_len
        data = _pad(data, 4, b"\x00")
        view = {"buffer": 0, "byteOffset": bin_len, "byteLength": len(data)}
        if target is not None:
            view["target"] = target
        buffer_views.append(view)
        bin_parts.append(data)
        bin_len += len(data)
        return len(buffer_views) - 1

    def add_accessor(arr: np.ndarray, gltf_type: str, target: Optional[int],
                     normalized: bool = False) -> int:
        comp = {np.dtype(np.float32): 5126, np.dtype(np.uint32): 5125,
                np.dtype(np.uint16): 5123, np.dtype(np.uint8): 5121}[arr.dtype]
        view_idx = add_view(arr.tobytes(), target)
        acc = {
            "bufferView": view_idx,
            "componentType": comp,
            "count": int(arr.shape[0]),
            "type": gltf_type,
        }
        if normalized:
            acc["normalized"] = True
        if gltf_type in ("VEC2", "VEC3", "VEC4") and arr.dtype == np.float32:
            acc["min"] = [float(x) for x in arr.min(axis=0)]
            acc["max"] = [float(x) for x in arr.max(axis=0)]
        elif gltf_type == "SCALAR":
            acc["min"] = [int(arr.min()) if arr.size else 0]
            acc["max"] = [int(arr.max()) if arr.size else 0]
        accessors.append(acc)
        return len(accessors) - 1

    for mi, m in enumerate(scene.meshes):
        attrs = {"POSITION": add_accessor(
            np.ascontiguousarray(m.vertices, dtype=np.float32), "VEC3", 34962)}
        if m.normals is not None:
            attrs["NORMAL"] = add_accessor(
                np.ascontiguousarray(m.normals, dtype=np.float32), "VEC3", 34962)
        if m.uvs is not None:
            attrs["TEXCOORD_0"] = add_accessor(
                np.ascontiguousarray(m.uvs, dtype=np.float32), "VEC2", 34962)
        if m.vertex_colors is not None:
            vc = np.ascontiguousarray(m.vertex_colors, dtype=np.float32)
            if vc.shape[-1] == 3:
                vc = np.concatenate([vc, np.ones_like(vc[:, :1])], axis=-1)
            attrs["COLOR_0"] = add_accessor(vc, "VEC4", 34962)
        idx = np.ascontiguousarray(m.faces.reshape(-1), dtype=np.uint32)
        idx_acc = add_accessor(idx, "SCALAR", 34963)

        mat = {
            "name": f"{m.name}_mat",
            "pbrMetallicRoughness": {
                "metallicFactor": float(m.metallic),
                "roughnessFactor": float(m.roughness),
            },
        }
        if m.base_color is not None:
            mat["pbrMetallicRoughness"]["baseColorFactor"] = [float(x) for x in m.base_color]
        def _add_texture(png_bytes: bytes) -> int:
            img_view = add_view(png_bytes, None)
            images.append({"bufferView": img_view, "mimeType": "image/png"})
            if not samplers:
                samplers.append({"magFilter": 9729, "minFilter": 9729,
                                 "wrapS": 10497, "wrapT": 10497})
            textures.append({"sampler": 0, "source": len(images) - 1})
            return len(textures) - 1

        if m.texture_png is not None:
            mat["pbrMetallicRoughness"]["baseColorTexture"] = {
                "index": _add_texture(m.texture_png)}
        if m.mr_texture_png is not None:
            # glTF metallicRoughnessTexture (G=roughness, B=metallic); the
            # factors act as multipliers, so force them to 1 when a map is
            # present unless explicitly set
            mat["pbrMetallicRoughness"]["metallicRoughnessTexture"] = {
                "index": _add_texture(m.mr_texture_png)}
        materials.append(mat)

        meshes_json.append({
            "name": m.name,
            "primitives": [{
                "attributes": attrs,
                "indices": idx_acc,
                "material": len(materials) - 1,
                "mode": 4,
            }],
        })
        nodes.append({"name": m.name, "mesh": mi})

    gltf = {
        "asset": {"version": "2.0", "generator": "regen3d_tpu"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": nodes,
        "meshes": meshes_json,
        "accessors": accessors,
        "bufferViews": buffer_views,
        "buffers": [{"byteLength": bin_len}],
        "materials": materials,
    }
    if images:
        gltf["images"] = images
        gltf["textures"] = textures
        gltf["samplers"] = samplers

    json_bytes = _pad(json.dumps(gltf, separators=(",", ":")).encode("utf-8"), 4, b" ")
    bin_bytes = _pad(b"".join(bin_parts), 4, b"\x00")
    total = 12 + 8 + len(json_bytes) + 8 + len(bin_bytes)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", _GLB_MAGIC, 2, total))
        f.write(struct.pack("<II", len(json_bytes), _CHUNK_JSON))
        f.write(json_bytes)
        f.write(struct.pack("<II", len(bin_bytes), _CHUNK_BIN))
        f.write(bin_bytes)


def save_pointcloud_glb(path: str, points: np.ndarray,
                        colors: Optional[np.ndarray] = None) -> None:
    """Write a GLB whose single primitive is a point cloud (mode 0 =
    POINTS) — the dust3r `as_pointcloud` scene.glb format
    (minimal_demo_dust3r.py:42-46 exports a trimesh.PointCloud)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    points = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
    bin_parts: List[bytes] = []
    buffer_views = []
    accessors = []
    bin_len = 0

    def add_accessor(arr: np.ndarray, gltf_type: str,
                     normalized: bool = False) -> int:
        nonlocal bin_len
        comp = {np.dtype(np.float32): 5126, np.dtype(np.uint8): 5121,
                np.dtype(np.uint16): 5123}[arr.dtype]
        data = _pad(arr.tobytes(), 4, b"\x00")
        buffer_views.append({"buffer": 0, "byteOffset": bin_len,
                             "byteLength": len(data), "target": 34962})
        bin_parts.append(data)
        bin_len += len(data)
        acc = {"bufferView": len(buffer_views) - 1, "componentType": comp,
               "count": int(arr.shape[0]), "type": gltf_type}
        if normalized:
            acc["normalized"] = True
        if arr.dtype == np.float32 and arr.size:
            acc["min"] = [float(x) for x in arr.min(axis=0)]
            acc["max"] = [float(x) for x in arr.max(axis=0)]
        accessors.append(acc)
        return len(accessors) - 1

    attrs = {"POSITION": add_accessor(points, "VEC3")}
    if colors is not None and len(colors):
        c = np.ascontiguousarray(colors)
        if c.dtype != np.uint8:
            c = np.clip(c * 255 if c.max() <= 1.0 else c, 0, 255
                        ).astype(np.uint8)
        if c.shape[-1] == 3:
            c = np.concatenate([c, np.full_like(c[:, :1], 255)], -1)
        attrs["COLOR_0"] = add_accessor(c, "VEC4", normalized=True)

    gltf = {
        "asset": {"version": "2.0", "generator": "regen3d_tpu"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"name": "pointcloud", "mesh": 0}],
        "meshes": [{"name": "pointcloud",
                    "primitives": [{"attributes": attrs, "mode": 0}]}],
        "accessors": accessors,
        "bufferViews": buffer_views,
        "buffers": [{"byteLength": bin_len}],
    }
    json_bytes = _pad(json.dumps(gltf, separators=(",", ":")).encode("utf-8"),
                      4, b" ")
    bin_bytes = _pad(b"".join(bin_parts), 4, b"\x00")
    total = 12 + 8 + len(json_bytes) + 8 + len(bin_bytes)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", _GLB_MAGIC, 2, total))
        f.write(struct.pack("<II", len(json_bytes), _CHUNK_JSON))
        f.write(json_bytes)
        f.write(struct.pack("<II", len(bin_bytes), _CHUNK_BIN))
        f.write(bin_bytes)


def _read_accessor(gltf: dict, bin_chunk: bytes, idx: int) -> np.ndarray:
    acc = gltf["accessors"][idx]
    width = _TYPE_WIDTHS[acc["type"]]
    dtype = np.dtype(_COMPONENT_DTYPES[acc["componentType"]]).newbyteorder("<")
    count = acc["count"]
    if "bufferView" not in acc:
        return np.zeros((count, width), dtype=dtype)
    view = gltf["bufferViews"][acc["bufferView"]]
    base = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride", 0)
    elem_size = dtype.itemsize * width
    if stride and stride != elem_size:
        rows = []
        for i in range(count):
            off = base + i * stride
            rows.append(np.frombuffer(bin_chunk, dtype=dtype, count=width, offset=off))
        out = np.stack(rows)
    else:
        out = np.frombuffer(bin_chunk, dtype=dtype, count=count * width, offset=base)
        out = out.reshape(count, width)
    if acc.get("normalized") and out.dtype != np.float32:
        out = out.astype(np.float32) / np.iinfo(out.dtype).max
    return out


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], dtype=np.float64).reshape(4, 4).T  # column-major
    M = np.eye(4)
    if "scale" in node:
        M[:3, :3] = np.diag(node["scale"])
    if "rotation" in node:  # xyzw quaternion
        x, y, z, w = node["rotation"]
        R = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])
        M[:3, :3] = R @ M[:3, :3]
    if "translation" in node:
        M[:3, 3] = node["translation"]
    return M


def load_glb(path: str, apply_transforms: bool = True) -> SceneData:
    """Read a GLB file into a flat list of world-space MeshData."""
    with open(path, "rb") as f:
        raw = f.read()
    magic, _version, _length = struct.unpack_from("<III", raw, 0)
    if magic != _GLB_MAGIC:
        raise ValueError(f"{path}: not a GLB file")
    offset = 12
    gltf = None
    bin_chunk = b""
    while offset < len(raw):
        clen, ctype = struct.unpack_from("<II", raw, offset)
        offset += 8
        chunk = raw[offset: offset + clen]
        offset += clen
        if ctype == _CHUNK_JSON:
            gltf = json.loads(chunk.decode("utf-8"))
        elif ctype == _CHUNK_BIN:
            bin_chunk = chunk
    if gltf is None:
        raise ValueError(f"{path}: GLB missing JSON chunk")

    # Support data-URI buffers for .gltf-style content embedded in GLB JSON.
    buffers = gltf.get("buffers", [])
    if buffers and "uri" in buffers[0] and buffers[0]["uri"].startswith("data:"):
        bin_chunk = base64.b64decode(buffers[0]["uri"].split(",", 1)[1])

    # Flatten the node hierarchy with accumulated transforms.
    scene_idx = gltf.get("scene", 0)
    roots = gltf.get("scenes", [{}])[scene_idx].get("nodes", [])
    nodes = gltf.get("nodes", [])
    world: List[tuple] = []  # (node, 4x4)
    stack = [(r, np.eye(4)) for r in roots]
    if not stack and nodes:
        stack = [(i, np.eye(4)) for i in range(len(nodes))]
    while stack:
        ni, parent = stack.pop()
        node = nodes[ni]
        M = parent @ _node_matrix(node)
        if "mesh" in node:
            world.append((node, M))
        for c in node.get("children", []):
            stack.append((c, M))

    out = SceneData()
    for node, M in world:
        mesh = gltf["meshes"][node["mesh"]]
        mesh_name = node.get("name") or mesh.get("name") or f"mesh{node['mesh']}"
        for pi, prim in enumerate(mesh.get("primitives", [])):
            if prim.get("mode", 4) != 4:
                continue
            attrs = prim["attributes"]
            verts = _read_accessor(gltf, bin_chunk, attrs["POSITION"]).astype(np.float32)
            if "indices" in prim:
                faces = _read_accessor(gltf, bin_chunk, prim["indices"]).reshape(-1, 3)
            else:
                faces = np.arange(verts.shape[0], dtype=np.int64).reshape(-1, 3)
            faces = faces.astype(np.int32)
            normals = uvs = colors = None
            if "NORMAL" in attrs:
                normals = _read_accessor(gltf, bin_chunk, attrs["NORMAL"]).astype(np.float32)
            if "TEXCOORD_0" in attrs:
                uvs = _read_accessor(gltf, bin_chunk, attrs["TEXCOORD_0"]).astype(np.float32)
            if "COLOR_0" in attrs:
                colors = _read_accessor(gltf, bin_chunk, attrs["COLOR_0"]).astype(np.float32)

            base_color = None
            metallic, roughness = 0.0, 1.0
            tex_png = None
            if "material" in prim and "materials" in gltf:
                mat = gltf["materials"][prim["material"]]
                pbr = mat.get("pbrMetallicRoughness", {})
                if "baseColorFactor" in pbr:
                    base_color = np.asarray(pbr["baseColorFactor"], dtype=np.float32)
                metallic = float(pbr.get("metallicFactor", 1.0))
                roughness = float(pbr.get("roughnessFactor", 1.0))
                def _tex_bytes(slot):
                    if slot not in pbr or "textures" not in gltf:
                        return None
                    tex = gltf["textures"][pbr[slot]["index"]]
                    img = gltf["images"][tex["source"]]
                    if "bufferView" not in img:
                        return None
                    view = gltf["bufferViews"][img["bufferView"]]
                    s = view.get("byteOffset", 0)
                    return bin_chunk[s: s + view["byteLength"]]

                tex_png = _tex_bytes("baseColorTexture")
                mr_png = _tex_bytes("metallicRoughnessTexture")
            else:
                mr_png = None

            md = MeshData(
                name=mesh_name if pi == 0 else f"{mesh_name}_{pi}",
                vertices=verts, faces=faces, normals=normals, uvs=uvs,
                vertex_colors=colors, base_color=base_color,
                metallic=metallic, roughness=roughness, texture_png=tex_png,
                mr_texture_png=mr_png,
            )
            if apply_transforms and not np.allclose(M, np.eye(4)):
                md = md.transformed(M)
            out.meshes.append(md)
    return out
