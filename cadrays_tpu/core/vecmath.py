"""Vector math over trailing-dim-3 arrays.

All functions operate on arrays whose *last* axis is the vector dimension
(3 for points/directions), broadcasting over every leading axis — the
SoA/wavefront layout that XLA vectorizes over the ray batch, as opposed
to the per-ray scalar structs of a C++ tracer.
"""
from __future__ import annotations

import jax.numpy as jnp


def dot(a: jnp.ndarray, b: jnp.ndarray, keepdims: bool = False) -> jnp.ndarray:
    return jnp.sum(a * b, axis=-1, keepdims=keepdims)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.cross(a, b)


def length(v: jnp.ndarray, keepdims: bool = False) -> jnp.ndarray:
    return jnp.sqrt(jnp.maximum(dot(v, v, keepdims=keepdims), 1e-30))


def normalize(v: jnp.ndarray) -> jnp.ndarray:
    return v / length(v, keepdims=True)


def reflect(d: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Reflect direction ``d`` about normal ``n`` (d points *into* surface)."""
    return d - 2.0 * dot(d, n, keepdims=True) * n


def refract(d: jnp.ndarray, n: jnp.ndarray, eta: jnp.ndarray):
    """Refract ``d`` through normal ``n`` with relative IOR ``eta`` (n_i/n_t).

    Returns (refracted_dir, total_internal_reflection_mask). ``d`` points
    into the surface; ``n`` opposes ``d`` (dot(d, n) < 0).
    """
    cos_i = -dot(d, n, keepdims=True)
    eta = jnp.asarray(eta)
    if eta.ndim < d.ndim:
        eta = eta[..., None]
    sin2_t = eta * eta * jnp.maximum(0.0, 1.0 - cos_i * cos_i)
    tir = sin2_t >= 1.0
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 1e-12))
    refr = eta * d + (eta * cos_i - cos_t) * n
    return refr, tir[..., 0]


def orthonormal_basis(n: jnp.ndarray):
    """Build tangent/bitangent for unit normal ``n`` (branchless, Duff et al. style)."""
    sign = jnp.where(n[..., 2:3] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2:3])
    b = n[..., 0:1] * n[..., 1:2] * a
    t = jnp.concatenate(
        [1.0 + sign * n[..., 0:1] * n[..., 0:1] * a, sign * b, -sign * n[..., 0:1]],
        axis=-1,
    )
    bt = jnp.concatenate(
        [b, sign + n[..., 1:2] * n[..., 1:2] * a, -n[..., 1:2]], axis=-1
    )
    return t, bt


def to_world(local: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Rotate a local-frame (z-up) vector into the frame of unit normal ``n``."""
    t, bt = orthonormal_basis(n)
    return (
        local[..., 0:1] * t + local[..., 1:2] * bt + local[..., 2:3] * n
    )


def to_local(world: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Inverse of :func:`to_world`."""
    t, bt = orthonormal_basis(n)
    return jnp.stack(
        [dot(world, t), dot(world, bt), dot(world, n)], axis=-1
    )


def luminance(rgb: jnp.ndarray, keepdims: bool = False) -> jnp.ndarray:
    w = jnp.asarray([0.2126, 0.7152, 0.0722], dtype=rgb.dtype)
    return jnp.sum(rgb * w, axis=-1, keepdims=keepdims)


def spherical_to_dir(theta: jnp.ndarray, phi: jnp.ndarray) -> jnp.ndarray:
    st = jnp.sin(theta)
    return jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), jnp.cos(theta)], axis=-1)


# ---------------------------------------------------------------------------
# 4x4 / 3x4 affine transforms (host + device)
# ---------------------------------------------------------------------------

def transform_points(m: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Apply a (..., 4, 4) affine matrix to (..., 3) points.

    precision="float32": XLA dispatches batched f32 matmuls/einsums to
    reduced-precision GEMM paths by default (observed: bf16-rounded
    coordinates at batch>=8 even on the CPU backend), which is
    catastrophic for geometry — every transform in the repo pins full
    f32."""
    return jnp.matmul(p, m[..., :3, :3].mT,
                      precision="float32") + m[..., :3, 3]


def transform_dirs(m: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Apply the linear part of a (..., 4, 4) matrix to (..., 3) directions."""
    return jnp.matmul(d, m[..., :3, :3].mT, precision="float32")


def transform_normals(m_inv: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Transform normals by the inverse-transpose: pass the *inverse* matrix."""
    return normalize(jnp.matmul(n, m_inv[..., :3, :3],
                                precision="float32"))
