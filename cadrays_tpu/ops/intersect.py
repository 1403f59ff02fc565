"""Ray-primitive intersection math (vectorized, wavefront layout).

Pure jnp functions. All inputs broadcast over leading ray dims.
"""
from __future__ import annotations

import jax.numpy as jnp

INF = jnp.float32(1e30)
EPS = jnp.float32(1e-7)


def ray_aabb(origin, inv_dir, box_min, box_max, t_min, t_max):
    """Slab test. Returns hit mask. inv_dir precomputed (1/d, inf-safe)."""
    t0 = (box_min - origin) * inv_dir
    t1 = (box_max - origin) * inv_dir
    tsm = jnp.minimum(t0, t1)
    tbg = jnp.maximum(t0, t1)
    t_near = jnp.maximum(jnp.max(tsm, axis=-1), t_min)
    t_far = jnp.minimum(jnp.min(tbg, axis=-1), t_max)
    return t_near <= t_far


def ray_triangle(origin, direction, p0, p1, p2):
    """Moller-Trumbore. Returns (t, u, v, hit_mask); t=INF on miss.

    Culls nothing (two-sided geometry); orientation is decided by the
    shader via the geometric normal.
    """
    e1 = p1 - p0
    e2 = p2 - p0
    pvec = jnp.cross(direction, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    tvec = origin - p0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(direction * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    hit = (
        (jnp.abs(det) > 1e-12)
        & (u >= -EPS)
        & (v >= -EPS)
        & (u + v <= 1.0 + EPS)
        & (t > EPS)
    )
    t = jnp.where(hit, t, INF)
    return t, u, v, hit


def safe_inv_dir(direction):
    """1/d with huge-but-finite values for near-zero components."""
    d = jnp.where(jnp.abs(direction) < 1e-12,
                  jnp.where(direction >= 0, 1e-12, -1e-12), direction)
    return 1.0 / d


def offset_ray_origin(p, n_geom, direction):
    """Offset a secondary-ray origin off the surface to dodge self-hits."""
    side = jnp.where(jnp.sum(n_geom * direction, axis=-1, keepdims=True) >= 0.0,
                     1.0, -1.0)
    return p + n_geom * side * 1e-4
