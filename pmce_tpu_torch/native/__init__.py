"""The demo's native (C++) components, built with g++ at first use and
loaded with ctypes.

The port's own copies of the JAX package's ``native/`` sources: the
z-buffer rasterizer of the mesh overlay (``rasterizer.cc``) and the
tracker's Hungarian assignment on 1 − IoU (``tracker.cc``). They are
compiled once per checkout into ``pmce_tpu_torch/_build/`` (git-ignored).
A failed build raises: nothing falls back quietly to numpy. The numpy
versions (``demo.renderer.rasterize_plain``, ``demo.tracker.assign_greedy``)
stay as the plain references the tests hold the library to.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

_THIS_DIR = Path(__file__).resolve().parent
_BUILD_DIR = _THIS_DIR.parent / "_build"
_SOURCES = ("rasterizer.cc", "tracker.cc")
_LIB_NAME = "libpmce_torch_native.so"

_lib = None

F32P = ctypes.POINTER(ctypes.c_float)
I32P = ctypes.POINTER(ctypes.c_int32)
U8P = ctypes.POINTER(ctypes.c_uint8)


def _build() -> Path:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _BUILD_DIR / _LIB_NAME
    srcs = [_THIS_DIR / s for s in _SOURCES]
    newest_src = max(s.stat().st_mtime for s in srcs)
    if out.is_file() and out.stat().st_mtime > newest_src:
        return out
    # Compile to a per-process name and rename: two processes building at
    # once (parallel tests) must never load a half-written library.
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", str(tmp),
           *map(str, srcs)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                               f"{out.name}: {proc.stderr[-2000:]}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def load() -> ctypes.CDLL:
    """Build (if needed) and load the native library; raises on failure."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(_build()))
    lib.rasterize_mesh.argtypes = [
        F32P, ctypes.c_int, I32P, ctypes.c_int, U8P, F32P,
        ctypes.c_int, ctypes.c_int, F32P, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, I32P,
    ]
    lib.rasterize_mesh.restype = None
    lib.iou_assign.argtypes = [
        F32P, ctypes.c_int32, F32P, ctypes.c_int32, ctypes.c_float, I32P,
    ]
    lib.iou_assign.restype = ctypes.c_int32
    _lib = lib
    return lib
