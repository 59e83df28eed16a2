"""Build, load and count the hand-written Hopper kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds) under
``build/kernels/`` at the repository root, at first use, and loaded with
``ctypes``. The library name carries a hash of the source and of the
``csrc/*.cuh`` headers it includes, so an edited source or header is rebuilt
and a stale library is never loaded.

Every C entry point launches on the stream it is given, allocates nothing and
returns ``cudaGetLastError()``; :func:`check` raises when that is not 0.

``LAUNCHES`` counts, per kernel, the launches made through the wrappers in
``ops/``: a wrapper adds one where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("flash_fwd", "flash_bwd", "silhouette")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dq": 0,
                            "flash_bwd_dkv": 0, "flash_gb_fwd": 0,
                            "flash_gb_bwd_dq": 0, "flash_gb_bwd_dkv": 0,
                            "silhouette_fwd": 0, "silhouette_bwd": 0}
BUILD_LOG: Dict[str, str] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of every C entry point, by library
_SIGNATURES = {
    "flash_fwd": {
        # q, k, v, o, lse, bh, sq, sk, d, scale, stream
        "flash_fwd_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
        # q, k, v, bias_h, bias_w, o, lse, bh, sq, sk, kh, kw, d, scale,
        # stream
        "flash_gb_fwd_bf16": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _F, _P],
    },
    "flash_bwd": {
        # q, k, v, g, lse, delta, dq, bh, sq, sk, d, scale, stream
        "flash_bwd_dq_bf16": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                              _P],
        # q, k, v, g, lse, delta, dk, dv, bh, sq, sk, d, scale, stream
        "flash_bwd_dkv_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _F, _P],
        # q, k, v, bias_h, bias_w, g, lse, delta, dq, dbias_h, dbias_w, bh,
        # sq, sk, kh, kw, d, scale, stream
        "flash_gb_bwd_dq_bf16": [_P] * 11 + [_I] * 6 + [_F, _P],
        # q, k, v, bias_h, bias_w, g, lse, delta, dk, dv, bh, sq, sk, kh, kw,
        # d, scale, stream
        "flash_gb_bwd_dkv_bf16": [_P] * 10 + [_I] * 6 + [_F, _P],
    },
    "silhouette": {
        # nvalid, coeffs, valid, tile_uv, acc, n_blocks, n_tiles, k,
        # inv_sigma, ndc, stream
        "silhouette_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _P],
        # nvalid, coeffs, valid, tile_uv, g, dc, n_blocks, n_tiles, k,
        # inv_sigma, ndc, stream
        "silhouette_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _P],
    },
}


def reset_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


def _sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and the ``csrc`` headers it includes, directly or
    through another header, each once."""
    found = [CSRC / f"{name}.cu"]
    for path in found:
        for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"',
                              path.read_text(), re.M):
            if CSRC / inc not in found:
                found.append(CSRC / inc)
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in _sources(name):
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build(names=SOURCES) -> Dict[str, float]:
    """Compile every named source that has no up-to-date library, all
    ``nvcc`` processes started together. Returns seconds per source built."""
    import time

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs: List[tuple] = []
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    times = {}
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        tmp.replace(out)
        times[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return times


def lib(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use (one
    thread builds and loads it; the others wait)."""
    if name not in _LIBS:
        with _LOAD_LOCK:
            if name not in _LIBS:
                path = _lib_path(name)
                if not path.exists():
                    build((name,))
                cdll = ctypes.CDLL(str(path))
                for fn, argtypes in _SIGNATURES[name].items():
                    getattr(cdll, fn).argtypes = argtypes
                    getattr(cdll, fn).restype = ctypes.c_int
                _LIBS[name] = cdll
    return _LIBS[name]


def load_all() -> Dict[str, float]:
    """Build every source that needs it (all ``nvcc`` processes at once) and
    load every library, as before threads that launch kernels start.
    Returns ``build``'s seconds per source built."""
    built = build()
    for name in SOURCES:
        lib(name)
    return built


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
