"""Tone mapping: Disabled / Filmic with exposure and white point.

Capability contract (reference SettingsWidget.cxx:339-409: method
{Disabled, Filmic}, WhitePoint, Exposure; AppGui.cxx:345-350: the HDR
radiance buffer can be dumped before tone mapping). Exposure is in photo
stops (scale = 2^exposure). The filmic operator is the standard
Uncharted-2-style rational curve normalized by the white point.
"""
from __future__ import annotations

from cadrays_tpu.utils import struct
import jax.numpy as jnp

TONE_DISABLED = 0
TONE_FILMIC = 1


@struct.dataclass
class ToneMapParams:
    method: int = struct.field(pytree_node=False, default=TONE_DISABLED)
    exposure: jnp.ndarray = struct.field(default_factory=lambda: jnp.float32(0.0))
    white_point: jnp.ndarray = struct.field(default_factory=lambda: jnp.float32(1.0))


def _filmic_curve(x):
    a, b, c, d, e, f = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((x * (a * x + c * b) + d * e) / (x * (a * x + b) + d * f)) - e / f


def apply_tonemap(hdr: jnp.ndarray, params: ToneMapParams) -> jnp.ndarray:
    """HDR linear radiance -> display-linear [0,1] (gamma applied separately)."""
    x = hdr * jnp.exp2(params.exposure)
    if params.method == TONE_FILMIC:
        wp = jnp.maximum(params.white_point, 1e-3)
        x = _filmic_curve(x) / jnp.maximum(_filmic_curve(wp), 1e-6)
    return jnp.clip(x, 0.0, 1.0)


def linear_to_srgb(x: jnp.ndarray) -> jnp.ndarray:
    x = jnp.clip(x, 0.0, 1.0)
    return jnp.where(x <= 0.0031308, x * 12.92, 1.055 * x ** (1.0 / 2.4) - 0.055)


def srgb_to_linear(x: jnp.ndarray) -> jnp.ndarray:
    x = jnp.clip(x, 0.0, 1.0)
    return jnp.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)
