"""Build + load the native library (g++ → .so, ctypes ABI).

Usage: `python -m cadrays_tpu.native.build` (or automatic on first use —
build takes ~2 s and is cached next to the sources).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "bvh_builder.cpp")
if os.access(_DIR, os.W_OK):
    _LIB = os.path.join(_DIR, "libcadrays_native.so")
else:
    # pip-installed into a read-only site-packages: build into the
    # user cache instead
    _cache = os.path.join(
        os.environ.get("XDG_CACHE_HOME",
                       os.path.join(os.path.expanduser("~"), ".cache")),
        "cadrays_tpu")
    os.makedirs(_cache, exist_ok=True)
    _LIB = os.path.join(_cache, "libcadrays_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def build(force: bool = False) -> bool:
    """Compile the shared library; returns success."""
    if not force and os.path.exists(_LIB) \
            and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC):
        return True
    # compile beside the target, then rename: processes that find the
    # library meanwhile never load a half-written file
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
           "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, _LIB)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError,
            subprocess.TimeoutExpired) as e:
        sys.stderr.write(f"[cadrays_tpu.native] build failed: {e}\n")
        if isinstance(e, subprocess.CalledProcessError):
            sys.stderr.write(e.stderr.decode(errors="replace")[-2000:] + "\n")
        return False


def load_library() -> Optional[ctypes.CDLL]:
    """Build-if-needed and dlopen; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not build():
            return None
        lib = ctypes.CDLL(_LIB)
        lib.crt_build_bvh.restype = ctypes.c_int32
        lib.crt_build_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return load_library() is not None


if __name__ == "__main__":
    ok = build(force="--force" in sys.argv)
    print("native build:", "ok" if ok else "FAILED", "->", _LIB)
    sys.exit(0 if ok else 1)
