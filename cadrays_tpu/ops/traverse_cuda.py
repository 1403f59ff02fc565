"""Per-ray BVH traversal on NVIDIA GPUs: CUDA through `jax.ffi`.

The kernel (native/traverse.cu) runs the threaded skip-link walk of
`ops.traverse.trace_gather` with one thread per ray, its state in
registers, each thread leaving when its own ray is done. XLA cannot
express that early exit: its `while_loop` runs every iteration over the
whole wavefront until the longest ray finishes.

The library is compiled from the repository's source for `sm_90a` with
`nvcc` into `<repo>/build/` at first use, or ahead of time with
`python -m cadrays_tpu.ops.traverse_cuda`. A failed build or load raises;
nothing falls back to another traversal.

Everything here but the kernel itself (operand shapes and dtypes, the
`t_max` broadcast, the any-hit and instancing attributes) is plain Python
that the CPU tests reach through `kernel_operands`.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np

from cadrays_tpu.scene.flatten import GeometryData

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "traverse.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
TARGET = "cadrays_trace"
_LIB_NAME = "libcadrays_traverse.so"

_lock = threading.Lock()
_registered = False


def nvcc_path() -> str:
    """`nvcc` from PATH, else the CUDA toolkit's default location."""
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def build(build_dir: str = BUILD_DIR, force: bool = False) -> str:
    """Compile the traversal library; returns its path, raises on failure."""
    lib = os.path.join(build_dir, _LIB_NAME)
    if not force and os.path.exists(lib) \
            and os.path.getmtime(lib) >= os.path.getmtime(SOURCE):
        return lib
    os.makedirs(build_dir, exist_ok=True)
    # -fmad=false: no multiply-add contraction, so the kernel rounds
    # exactly as XLA's gather walk does and the two agree to ~1 ulp; with
    # contraction, u and v of small far triangles differ by up to 1e-1.
    cmd = [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-fmad=false", "-shared",
           "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", f"{lib}.{os.getpid()}.tmp",
           SOURCE]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=600)
        os.replace(f"{lib}.{os.getpid()}.tmp", lib)
    except FileNotFoundError as e:
        raise RuntimeError(f"cannot build the CUDA traversal: {e}") from e
    except subprocess.CalledProcessError as e:
        raise RuntimeError("nvcc failed building the CUDA traversal:\n"
                           + e.stderr.decode(errors="replace")[-4000:]) from e
    return lib


def load(build_dir: str = BUILD_DIR) -> None:
    """Build if needed and register the FFI target (once per process)."""
    global _registered
    with _lock:
        if _registered:
            return
        lib = ctypes.CDLL(build(build_dir))
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(lib.CadraysTrace), platform="CUDA")
        _registered = True


def kernel_operands(geom: GeometryData, origin, direction, t_max,
                    any_hit: bool = False):
    """The kernel's operands, result types and attributes.

    Operands: nodes (N, 8), tris (T, 12), node_inst (N,) or a (1,)
    placeholder for single-level scenes, inst_inv (I, 3, 4), origin and
    direction (R, 3), t_max broadcast to (R,).
    """
    R = origin.shape[0]
    f32 = jnp.float32
    node_inst = (geom.node_inst.astype(jnp.int32) if geom.instanced
                 else jnp.full((1,), -1, jnp.int32))
    operands = (
        geom.nodes_packed.astype(f32),
        geom.tris_packed.astype(f32),
        node_inst,
        geom.inst_inv.astype(f32).reshape(-1, 3, 4),
        jnp.asarray(origin, f32).reshape(R, 3),
        jnp.asarray(direction, f32).reshape(R, 3),
        jnp.broadcast_to(jnp.asarray(t_max, f32), (R,)),
    )
    results = (jax.ShapeDtypeStruct((R,), f32),
               jax.ShapeDtypeStruct((R,), jnp.int32),
               jax.ShapeDtypeStruct((R,), f32),
               jax.ShapeDtypeStruct((R,), f32))
    attrs = dict(any_hit=np.int32(any_hit), instanced=np.int32(geom.instanced))
    return operands, results, attrs


def trace_cuda(geom: GeometryData, origin, direction, t_max,
               any_hit: bool = False):
    """Same contract as `ops.traverse.trace`; GPU only."""
    load()
    operands, results, attrs = kernel_operands(geom, origin, direction,
                                               t_max, any_hit)
    t, tri, u, v = jax.ffi.ffi_call(TARGET, results,
                                    vmap_method="sequential")(*operands,
                                                              **attrs)
    return {"t": t, "tri": tri, "u": u, "v": v}


if __name__ == "__main__":
    t0 = time.perf_counter()
    path = build(force=True)
    print(f"built {path} in {time.perf_counter() - t0:.1f} s")
