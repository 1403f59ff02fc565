"""Fresnel reflectance models.

Capability contract (reference MaterialEditor.cxx:88-261 Fresnel editor and
ImportExport.cxx:164-231 `-coatFresnel/-baseFresnel {Schlick rgb | Constant w
| Conductor n k | Dielectric n}` serialization): four variants selectable
independently for the coat and base layers.

Array encoding: a Fresnel record is (type:int32, params:float32[4]);
evaluation is a branchless `lax.switch`-free blend over all four closed
forms so a whole wavefront of mixed materials evaluates as one
vectorized op (no divergence, no gather of function pointers).
"""
from __future__ import annotations

import jax.numpy as jnp

FRESNEL_CONSTANT = 0  # params = [w, w, w, _]
FRESNEL_SCHLICK = 1  # params = [F0.r, F0.g, F0.b, _]
FRESNEL_CONDUCTOR = 2  # params = [n, k, _, _]
FRESNEL_DIELECTRIC = 3  # params = [ior, _, _, _]


def fresnel(kind: int, *args) -> tuple:
    """Host-side constructor -> (type, params[4]) numpy-compatible tuple."""
    import numpy as np

    p = np.zeros(4, np.float32)
    if kind == FRESNEL_CONSTANT:
        (w,) = args
        p[:3] = w
    elif kind == FRESNEL_SCHLICK:
        if len(args) == 1:
            p[:3] = args[0]
        else:
            p[:3] = args
    elif kind == FRESNEL_CONDUCTOR:
        p[0], p[1] = args
    elif kind == FRESNEL_DIELECTRIC:
        p[0] = args[0]
    else:
        raise ValueError(f"unknown fresnel kind {kind}")
    return int(kind), p


def schlick(f0: jnp.ndarray, cos_t: jnp.ndarray) -> jnp.ndarray:
    m = jnp.clip(1.0 - cos_t, 0.0, 1.0)
    m2 = m * m
    return f0 + (1.0 - f0) * (m2 * m2 * m)


def dielectric_reflectance(ior: jnp.ndarray, cos_i: jnp.ndarray) -> jnp.ndarray:
    """Exact unpolarized dielectric Fresnel; ior = n_t / n_i, cos_i >= 0."""
    ior = jnp.maximum(ior, 1.0 + 1e-4)
    eta = 1.0 / ior
    sin2_t = eta * eta * jnp.maximum(0.0, 1.0 - cos_i * cos_i)
    tir = sin2_t >= 1.0
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 1e-12))
    rs = (cos_i - ior * cos_t) / jnp.maximum(cos_i + ior * cos_t, 1e-8)
    rp = (ior * cos_i - cos_t) / jnp.maximum(ior * cos_i + cos_t, 1e-8)
    f = 0.5 * (rs * rs + rp * rp)
    return jnp.where(tir, 1.0, f)


def conductor_reflectance(n: jnp.ndarray, k: jnp.ndarray, cos_i: jnp.ndarray) -> jnp.ndarray:
    """Unpolarized conductor Fresnel with complex IOR n + ik."""
    c2 = cos_i * cos_i
    s2 = 1.0 - c2
    t0 = n * n - k * k - s2
    a2b2 = jnp.sqrt(jnp.maximum(t0 * t0 + 4.0 * n * n * k * k, 1e-12))
    t1 = a2b2 + c2
    a = jnp.sqrt(jnp.maximum(0.5 * (a2b2 + t0), 1e-12))
    t2 = 2.0 * a * cos_i
    rs2 = (t1 - t2) / jnp.maximum(t1 + t2, 1e-8)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp2 = rs2 * (t3 - t4) / jnp.maximum(t3 + t4, 1e-8)
    return 0.5 * (rs2 + rp2)


def eval_fresnel(ftype: jnp.ndarray, fparams: jnp.ndarray, cos_t: jnp.ndarray) -> jnp.ndarray:
    """Branchless RGB Fresnel for a wavefront.

    ftype: (...,) int32; fparams: (..., 4) float32; cos_t: (...,) >= 0.
    Returns (..., 3) reflectance. All four variants are evaluated and
    blended by one-hot masks — cheap VPU math, zero divergence.
    """
    cos_t = jnp.clip(cos_t, 0.0, 1.0)
    c = cos_t[..., None]

    f_const = jnp.broadcast_to(fparams[..., 0:3], fparams[..., 0:3].shape)
    f_schlick = schlick(fparams[..., 0:3], c)
    f_cond = conductor_reflectance(fparams[..., 0:1], fparams[..., 1:2], c)
    f_cond = jnp.broadcast_to(f_cond, f_schlick.shape)
    f_diel = dielectric_reflectance(fparams[..., 0:1], c)
    f_diel = jnp.broadcast_to(f_diel, f_schlick.shape)

    t = ftype[..., None]
    out = jnp.where(t == FRESNEL_CONSTANT, f_const, 0.0)
    out = jnp.where(t == FRESNEL_SCHLICK, f_schlick, out)
    out = jnp.where(t == FRESNEL_CONDUCTOR, f_cond, out)
    out = jnp.where(t == FRESNEL_DIELECTRIC, f_diel, out)
    return jnp.clip(out, 0.0, 1.0)
