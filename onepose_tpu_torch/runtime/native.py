"""On-demand build and ctypes loading of the port's native track builder.

The port's own copy of ``onepose_tpu/runtime/native.py``. The C++ side
(``track_builder.cpp``) exposes a plain C ABI and numpy arrays cross as
ctypes pointers. ``g++`` compiles it once per source hash into
``build/onepose_tpu_torch/`` at the repository root; when it cannot, the
union-find runs in Python, with the same results, more slowly
(:func:`load_library` returns None and says why; ``chip_smoke.py``
requires the library).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import os.path as osp
import subprocess
import sys

import numpy as np

_SRC_DIR = osp.dirname(osp.abspath(__file__))
_LIB = None
_TRIED = False


BUILD_DIR = osp.join(osp.dirname(osp.dirname(_SRC_DIR)), "build",
                     "onepose_tpu_torch")


def _build_dir() -> str:
    os.makedirs(BUILD_DIR, exist_ok=True)
    return BUILD_DIR


def load_library():
    """Compile (if needed) and load libtrack_builder; None on failure."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    src = osp.join(_SRC_DIR, "track_builder.cpp")
    try:
        with open(src, "rb") as f:
            tag = hashlib.sha256(f.read()).hexdigest()[:16]
        lib_path = osp.join(_build_dir(), f"libtrack_builder-{tag}.so")
        if not osp.exists(lib_path):
            tmp = f"{lib_path}.{os.getpid()}.tmp"
            cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                   "-o", tmp, src]
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(lib_path)
        lib.uf_components.argtypes = [
            ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ]
        lib.uf_components.restype = None
        _LIB = lib
    except Exception as e:  # missing toolchain, sandbox, etc.
        print(f"[runtime] native build unavailable ({e}); "
              "falling back to Python union-find", file=sys.stderr)
        _LIB = None
    return _LIB


def uf_components(n_nodes: int, edges: np.ndarray) -> np.ndarray:
    """Connected components. edges: [E, 2] int; returns [n_nodes] canonical
    (min-index) root per node. Uses the C++ library when available."""
    edges = np.ascontiguousarray(edges, np.int64)
    lib = load_library()
    if lib is not None:
        roots = np.empty(n_nodes, np.int64)
        lib.uf_components(n_nodes, len(edges), edges.reshape(-1), roots)
        return roots

    # Python fallback (same semantics)
    parent = np.arange(n_nodes, dtype=np.int64)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in edges:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra
    min_of = np.arange(n_nodes, dtype=np.int64)
    for i in range(n_nodes):
        r = find(i)
        if i < min_of[r]:
            min_of[r] = i
    return np.array([min_of[find(i)] for i in range(n_nodes)], np.int64)


def uf_components_imgsafe(n_nodes: int, edges: np.ndarray,
                          node_img: np.ndarray) -> np.ndarray:
    """Conflict-aware connected components: refuse unions whose two
    components already observe a common image (two keypoints of one image
    in one track = outlier-link signature; merging corrupts both points'
    tracks — see track_builder.cpp). node_img: [n_nodes] int image id.
    Deterministic for a fixed edge order."""
    edges = np.ascontiguousarray(edges, np.int64)
    node_img = np.ascontiguousarray(node_img, np.int32)
    lib = load_library()
    if lib is not None and hasattr(lib, "uf_components_imgsafe"):
        lib.uf_components_imgsafe.argtypes = [
            ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ]
        lib.uf_components_imgsafe.restype = None
        roots = np.empty(n_nodes, np.int64)
        lib.uf_components_imgsafe(
            n_nodes, len(edges), edges.reshape(-1), node_img, roots)
        return roots

    # Python fallback (same semantics)
    parent = np.arange(n_nodes, dtype=np.int64)
    imgs = [{int(node_img[i])} for i in range(n_nodes)]

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in edges:
        ra, rb = find(a), find(b)
        if ra == rb:
            continue
        if imgs[ra] & imgs[rb]:
            continue
        if len(imgs[ra]) < len(imgs[rb]):
            ra, rb = rb, ra
        parent[rb] = ra
        imgs[ra] |= imgs[rb]
        imgs[rb] = set()
    min_of = np.arange(n_nodes, dtype=np.int64)
    for i in range(n_nodes):
        r = find(i)
        if i < min_of[r]:
            min_of[r] = i
    return np.array([min_of[find(i)] for i in range(n_nodes)], np.int64)
