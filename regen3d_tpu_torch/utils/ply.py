"""PLY point-cloud / mesh IO (binary little-endian + ascii), from scratch.

The reference relies on trimesh/open3d for PLY (e.g. global_utils.py:667-693,
extract_pc_object.py:188-225). This is a dependency-free implementation of
the subset of PLY the pipeline's artifacts use: float vertex positions,
optional uchar colors, optional float normals, optional triangle faces.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


@dataclass
class PlyData:
    vertices: np.ndarray                      # (N, 3) float32
    colors: Optional[np.ndarray] = None       # (N, 3) uint8
    normals: Optional[np.ndarray] = None      # (N, 3) float32
    faces: Optional[np.ndarray] = None        # (F, 3) int32
    extra: Dict[str, np.ndarray] = field(default_factory=dict)


def save_ply(
    path: str,
    vertices: np.ndarray,
    colors: Optional[np.ndarray] = None,
    normals: Optional[np.ndarray] = None,
    faces: Optional[np.ndarray] = None,
    ascii_format: bool = False,
) -> None:
    """Write a PLY file (binary little-endian by default)."""
    vertices = np.asarray(vertices, dtype=np.float32).reshape(-1, 3)
    n = vertices.shape[0]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    header = ["ply"]
    header.append("format ascii 1.0" if ascii_format else "format binary_little_endian 1.0")
    header.append("comment created by regen3d_tpu")
    header.append(f"element vertex {n}")
    header += ["property float x", "property float y", "property float z"]
    if normals is not None:
        normals = np.asarray(normals, dtype=np.float32).reshape(-1, 3)
        header += ["property float nx", "property float ny", "property float nz"]
    if colors is not None:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = np.clip(colors * (255.0 if colors.max() <= 1.0 + 1e-6 else 1.0), 0, 255).astype(np.uint8)
        colors = colors.reshape(-1, 3)
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    if faces is not None:
        faces = np.asarray(faces, dtype=np.int32).reshape(-1, 3)
        header.append(f"element face {faces.shape[0]}")
        header.append("property list uchar int vertex_indices")
    header.append("end_header")

    cols = [vertices]
    fmt_fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if normals is not None:
        cols.append(normals)
        fmt_fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
    struct_fields = list(fmt_fields)
    if colors is not None:
        struct_fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]

    rec = np.empty(n, dtype=np.dtype(struct_fields))
    rec["x"], rec["y"], rec["z"] = vertices[:, 0], vertices[:, 1], vertices[:, 2]
    if normals is not None:
        rec["nx"], rec["ny"], rec["nz"] = normals[:, 0], normals[:, 1], normals[:, 2]
    if colors is not None:
        rec["red"], rec["green"], rec["blue"] = colors[:, 0], colors[:, 1], colors[:, 2]

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if ascii_format:
            for row in rec:
                f.write((" ".join(str(v) for v in row) + "\n").encode("ascii"))
            if faces is not None:
                for tri in faces:
                    f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n".encode("ascii"))
        else:
            f.write(rec.tobytes())
            if faces is not None:
                frec = np.empty(faces.shape[0],
                                dtype=np.dtype([("n", "u1"), ("i", "<i4", (3,))]))
                frec["n"] = 3
                frec["i"] = faces
                f.write(frec.tobytes())


def load_ply(path: str) -> PlyData:
    """Read a PLY file (ascii / binary little- or big-endian)."""
    with open(path, "rb") as f:
        raw = f.read()

    # --- header ---------------------------------------------------------------
    end = raw.find(b"end_header")
    if end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    nl = raw.find(b"\n", end)
    header = raw[:nl].decode("ascii", errors="replace").splitlines()
    body = raw[nl + 1:]

    fmt = None
    elements = []  # list of (name, count, [(prop_name, dtype) or ('list', idx_t, val_t, name)])
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append({"name": parts[1], "count": int(parts[2]), "props": []})
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1]["props"].append(("list", _DTYPES[parts[2]], _DTYPES[parts[3]], parts[4]))
            else:
                elements[-1]["props"].append((parts[2], _DTYPES[parts[1]]))

    endian = "<" if fmt != "binary_big_endian" else ">"
    out_vertex: Dict[str, np.ndarray] = {}
    faces = None

    if fmt == "ascii":
        tokens = body.split()
        pos = 0
        for el in elements:
            if any(p[0] == "list" for p in el["props"]):
                flist = []
                for _ in range(el["count"]):
                    cnt = int(tokens[pos]); pos += 1
                    idx = [int(tokens[pos + k]) for k in range(cnt)]; pos += cnt
                    for k in range(1, cnt - 1):  # fan-triangulate polygons
                        flist.append([idx[0], idx[k], idx[k + 1]])
                if el["name"] == "face":
                    faces = np.asarray(flist, dtype=np.int32) if flist else None
            else:
                names = [p[0] for p in el["props"]]
                width = len(names)
                vals = np.asarray(tokens[pos:pos + el["count"] * width], dtype=np.float64)
                vals = vals.reshape(el["count"], width)
                pos += el["count"] * width
                if el["name"] == "vertex":
                    for i, nm in enumerate(names):
                        out_vertex[nm] = vals[:, i]
    else:
        offset = 0
        for el in elements:
            if any(p[0] == "list" for p in el["props"]):
                # Fast path: homogeneous triangle lists.
                lp = el["props"][0]
                idx_t, val_t = np.dtype(endian + lp[1]), np.dtype(endian + lp[2])
                flist = []
                fixed = None
                # Probe whether all counts equal 3 for vectorized parse.
                probe = np.frombuffer(body, dtype=idx_t, count=1, offset=offset)
                if el["count"] > 0 and probe[0] == 3:
                    stride = idx_t.itemsize + 3 * val_t.itemsize
                    buf = body[offset: offset + stride * el["count"]]
                    rec = np.frombuffer(buf, dtype=np.dtype(
                        [("n", idx_t), ("i", val_t, (3,))]))
                    if np.all(rec["n"] == 3):
                        fixed = rec["i"].astype(np.int32)
                        offset += stride * el["count"]
                if fixed is not None:
                    faces = fixed if el["name"] == "face" else faces
                else:
                    for _ in range(el["count"]):
                        cnt = int(np.frombuffer(body, idx_t, 1, offset)[0])
                        offset += idx_t.itemsize
                        idx = np.frombuffer(body, val_t, cnt, offset).astype(np.int64)
                        offset += cnt * val_t.itemsize
                        for k in range(1, cnt - 1):
                            flist.append([idx[0], idx[k], idx[k + 1]])
                    if el["name"] == "face" and flist:
                        faces = np.asarray(flist, dtype=np.int32)
            else:
                dt = np.dtype([(p[0], endian + p[1]) for p in el["props"]])
                arr = np.frombuffer(body, dtype=dt, count=el["count"], offset=offset)
                offset += dt.itemsize * el["count"]
                if el["name"] == "vertex":
                    for nm in dt.names:
                        out_vertex[nm] = arr[nm]

    verts = np.stack([out_vertex[k] for k in ("x", "y", "z")], axis=-1).astype(np.float32)
    colors = None
    if all(k in out_vertex for k in ("red", "green", "blue")):
        colors = np.stack([out_vertex[k] for k in ("red", "green", "blue")], -1)
        colors = colors.astype(np.uint8) if colors.max(initial=0) > 1.001 else (colors * 255).astype(np.uint8)
    normals = None
    if all(k in out_vertex for k in ("nx", "ny", "nz")):
        normals = np.stack([out_vertex[k] for k in ("nx", "ny", "nz")], -1).astype(np.float32)
    return PlyData(vertices=verts, colors=colors, normals=normals, faces=faces)
