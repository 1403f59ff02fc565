"""Counter-based sampler for path tracing.

The reference renderer gets reproducibility from fixed progressive frame
counts; here determinism is *structural*: every random number is a pure
function of (pixel_id, sample_id, dimension, seed) via a PCG4D hash
(Jarzynski & Olano, JCGT 2020 — public construction). No sampler state is
carried across bounces, so the integrator stays a pure function — the
property jit/vjp/shard_map need. It replaces a stateful per-thread GPU
RNG (uint32 ops only).
"""
from __future__ import annotations

import jax.numpy as jnp

_U32 = jnp.uint32


def _pcg4d(a, b, c, d):
    """PCG4D hash: four uint32 in, four decorrelated uint32 out."""
    v0 = a.astype(_U32)
    v1 = b.astype(_U32)
    v2 = c.astype(_U32)
    v3 = d.astype(_U32)
    mul = _U32(1664525)
    inc = _U32(1013904223)
    v0 = v0 * mul + inc
    v1 = v1 * mul + inc
    v2 = v2 * mul + inc
    v3 = v3 * mul + inc
    v0 = v0 + v1 * v3
    v1 = v1 + v2 * v0
    v2 = v2 + v0 * v1
    v3 = v3 + v1 * v2
    v0 = v0 ^ (v0 >> 16)
    v1 = v1 ^ (v1 >> 16)
    v2 = v2 ^ (v2 >> 16)
    v3 = v3 ^ (v3 >> 16)
    v0 = v0 + v1 * v3
    v1 = v1 + v2 * v0
    v2 = v2 + v0 * v1
    v3 = v3 + v1 * v2
    return v0, v1, v2, v3


def _to_unit_float(u: jnp.ndarray) -> jnp.ndarray:
    """uint32 -> float32 in [0, 1) with 24-bit mantissa precision."""
    return (u >> 8).astype(jnp.float32) * jnp.float32(1.0 / 16777216.0)


def sample4(pixel_id, sample_id, dim, seed):
    """Four independent uniforms in [0,1) for the given counter tuple.

    All arguments broadcast; integer arrays of any shape are fine.
    """
    v0, v1, v2, v3 = _pcg4d(
        jnp.asarray(pixel_id), jnp.asarray(sample_id), jnp.asarray(dim),
        jnp.asarray(seed),
    )
    return (
        _to_unit_float(v0),
        _to_unit_float(v1),
        _to_unit_float(v2),
        _to_unit_float(v3),
    )


def sample2(pixel_id, sample_id, dim, seed):
    a, b, _, _ = sample4(pixel_id, sample_id, dim, seed)
    return a, b


def sample1(pixel_id, sample_id, dim, seed):
    a, _, _, _ = sample4(pixel_id, sample_id, dim, seed)
    return a
