"""Analytic light sources: directional (+smooth angle) and positional
(+smooth radius = sphere light).

Capability contract (reference LightSourcesEditor.cxx:155-310): the path
tracer supports directional and positional lights only (ambient/spot are
skipped, :155-179); directional lights carry a "smooth angle" 0-180deg for
soft shadows, positional lights a "smooth radius" making them sphere
lights; both have color and intensity; a directional light may be a
headlight (direction follows the camera).

These are *virtual* lights sampled by next-event estimation only (they are
not scene geometry). Intensity conventions (validated against the
exposure of the reference's CornellBox.tcl `int 25` sphere light — with a
candela/inverse-square reading that scene blows out by ~30x):
  positional, smooth radius r > 0: intensity = emitted *radiance* of the
      sphere surface; unoccluded contribution = I * Omega(cone).
  positional, r == 0: classic point light, irradiance I cos(t) / d^2.
  directional: irradiance I regardless of smooth angle (the cone only
      softens shadows).
Emissive geometry (Le) and the environment map are handled by the
integrator's area/env sampling, not here.
"""
from __future__ import annotations

from cadrays_tpu.utils import struct
import jax.numpy as jnp
import numpy as np

from cadrays_tpu.core import sampling as smp
from cadrays_tpu.core import vecmath as vm

LIGHT_DIRECTIONAL = 0
LIGHT_POSITIONAL = 1


@struct.dataclass
class Lights:
    """SoA light table (leading dim L). Differentiable leaves."""

    kind: jnp.ndarray  # (L,) int32
    color: jnp.ndarray  # (L, 3)
    intensity: jnp.ndarray  # (L,)
    vec: jnp.ndarray  # (L, 3): direction of travel (dir) or position (pos)
    smooth: jnp.ndarray  # (L,): half-angle rad (dir) or radius (pos)
    enabled: jnp.ndarray  # (L,) float32 0/1
    headlight: jnp.ndarray  # (L,) float32 0/1 (directional only)

    @property
    def count(self) -> int:
        return self.kind.shape[0]

    def gather(self, idx):
        return Lights(
            kind=self.kind[idx],
            color=self.color[idx],
            intensity=self.intensity[idx],
            vec=self.vec[idx],
            smooth=self.smooth[idx],
            enabled=self.enabled[idx],
            headlight=self.headlight[idx],
        )


def directional_light(direction=(0.0, 0.0, -1.0), color=(1.0, 1.0, 1.0),
                      intensity=1.0, smooth_angle_deg=0.0, headlight=False) -> Lights:
    d = np.asarray(direction, np.float32)
    d = d / max(float(np.linalg.norm(d)), 1e-12)
    return Lights(
        kind=np.int32([LIGHT_DIRECTIONAL]),
        color=np.asarray(color, np.float32).reshape(1, 3),
        intensity=np.float32([intensity]),
        vec=d.reshape(1, 3),
        smooth=np.float32([np.deg2rad(smooth_angle_deg)]),
        enabled=np.float32([1.0]),
        headlight=np.float32([1.0 if headlight else 0.0]),
    )


def positional_light(position=(0.0, 0.0, 1.0), color=(1.0, 1.0, 1.0),
                     intensity=1.0, smooth_radius=0.0) -> Lights:
    return Lights(
        kind=np.int32([LIGHT_POSITIONAL]),
        color=np.asarray(color, np.float32).reshape(1, 3),
        intensity=np.float32([intensity]),
        vec=np.asarray(position, np.float32).reshape(1, 3),
        smooth=np.float32([smooth_radius]),
        enabled=np.float32([1.0]),
        headlight=np.float32([0.0]),
    )


def concat_lights(lights) -> Lights:
    import jax

    return jax.tree.map(lambda *xs: np.concatenate(xs, axis=0), *lights)


def empty_lights() -> Lights:
    z3 = np.zeros((0, 3), np.float32)
    z = np.zeros((0,), np.float32)
    return Lights(kind=np.zeros((0,), np.int32), color=z3, intensity=z, vec=z3,
                  smooth=z, enabled=z, headlight=z)


def pack_lights(lights: Lights) -> jnp.ndarray:
    """(L, 10) packed rows [kind color(3) intensity vec(3) smooth enabled]
    so a per-ray light lookup is ONE row gather instead of `gather()`'s
    7 field gathers.
    Differentiable w.r.t. the light leaves."""
    return jnp.concatenate([
        lights.kind.astype(jnp.float32)[:, None], lights.color,
        lights.intensity[:, None], lights.vec, lights.smooth[:, None],
        lights.enabled[:, None],
    ], axis=1)


def sample_light_rows(rows: jnp.ndarray, p, u1, u2):
    """`sample_light` on pre-gathered packed rows (R, 10)."""
    lt = Lights(
        kind=rows[:, 0].astype(jnp.int32), color=rows[:, 1:4],
        intensity=rows[:, 4], vec=rows[:, 5:8], smooth=rows[:, 8],
        enabled=rows[:, 9], headlight=jnp.zeros_like(rows[:, 9]),
    )
    return _sample_light_fields(lt, p, u1, u2)


def sample_light(lights: Lights, light_idx, p, u1, u2):
    """Sample one NEE connection to light ``light_idx`` from point ``p``.

    Returns dict with: wi (unit, toward light), dist (occlusion test
    length), radiance (L * |cone or sphere| folded in so the estimator is
    radiance / pdf already — i.e. the *unoccluded contribution before the
    BSDF term*), valid mask.
    """
    return _sample_light_fields(lights.gather(light_idx), p, u1, u2)


def _sample_light_fields(lt: Lights, p, u1, u2):
    is_dir = lt.kind == LIGHT_DIRECTIONAL
    emit = lt.color * (lt.intensity * lt.enabled)[..., None]

    # --- directional ------------------------------------------------------
    # Cone of half-angle `smooth` about -direction (toward the light).
    to_light = -lt.vec
    cos_max = jnp.cos(jnp.clip(lt.smooth, 0.0, jnp.pi * 0.5))
    local = smp.uniform_cone(u1, u2, cos_max)
    wi_dir = vm.to_world(local, vm.normalize(to_light))
    # estimator: L / pdf = [I/Omega] / [1/Omega] = I  (soft or sharp alike)
    contrib_dir = emit
    dist_dir = jnp.full(p.shape[:-1], 1e30, p.dtype)

    # --- positional (sphere light of radius `smooth`) --------------------
    to_c = lt.vec - p
    d2 = jnp.maximum(vm.dot(to_c, to_c), 1e-12)
    d = jnp.sqrt(d2)
    is_sphere = lt.smooth > 1e-5
    r = jnp.maximum(lt.smooth, 1e-5)
    sin2_max = jnp.clip(r * r / d2, 0.0, 0.9999)
    cos_amax = jnp.sqrt(1.0 - sin2_max)
    local_p = smp.uniform_cone(u1, u2, cos_amax)
    wi_sphere = vm.to_world(local_p, to_c / d[..., None])
    # sphere: estimator L/pdf = I * Omega = I * 2 pi (1 - cos_amax)
    contrib_sphere = emit * (2.0 * jnp.pi * (1.0 - cos_amax))[..., None]
    # delta point light: irradiance I/d^2 along the center direction
    wi_point = to_c / d[..., None]
    contrib_point = emit / d2[..., None]
    wi_pos = jnp.where(is_sphere[..., None], wi_sphere, wi_point)
    contrib_pos = jnp.where(is_sphere[..., None], contrib_sphere,
                            contrib_point)
    # Occlusion segment: to just before the sphere surface.
    dist_pos = jnp.maximum(d - jnp.where(is_sphere, r, 0.0), 1e-4)

    wi = jnp.where(is_dir[..., None], wi_dir, wi_pos)
    contrib = jnp.where(is_dir[..., None], contrib_dir, contrib_pos)
    dist = jnp.where(is_dir, dist_dir, dist_pos)
    valid = (lt.enabled > 0.0) & (vm.luminance(contrib) > 0.0)
    return {"wi": wi, "dist": dist, "contrib": contrib, "valid": valid}
