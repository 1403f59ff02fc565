"""Render parameter surface.

Mirrors the engine-knob contract the reference drives through
Graphic3d_RenderingParams (SettingsWidget.cxx: render mode GI/RT/raster
:261-302, bounces :310-316, radiance clamping :318-326, two-sided BSDF
:328-334, tone mapping :339-409, coherent sampling :419-425, adaptive
screen sampling + tiles :427-484, RT-mode toggles :575-607).

Static fields (python values) specialize the jitted integrator; traced
fields (jnp scalars) can change without recompilation — the split that
XLA's compilation model forces on a jitted renderer.
"""
from __future__ import annotations

from cadrays_tpu.utils import struct
import jax.numpy as jnp

from cadrays_tpu.core.tonemap import ToneMapParams


class RenderMode:
    GI = "gi"  # full path tracing (Graphic3d_RM_RAYTRACING + GI)
    RT = "rt"  # Whitted ray tracing (shadows/reflections, no GI)
    RASTER = "raster"  # rasterization preview (direct shading, no shadows)


@struct.dataclass
class RenderParams:
    # --- static (recompile on change) -----------------------------------
    mode: str = struct.field(pytree_node=False, default=RenderMode.GI)
    ray_depth: int = struct.field(pytree_node=False, default=5)  # 1..32
    two_sided: bool = struct.field(pytree_node=False, default=True)
    coherent: bool = struct.field(pytree_node=False, default=False)
    adaptive: bool = struct.field(pytree_node=False, default=False)
    # debug tile view: display the adaptive sample-density heatmap
    # instead of the radiance image (SettingsWidget.cxx:443-449)
    adaptive_debug: bool = struct.field(pytree_node=False,
                                             default=False)
    tile_size: int = struct.field(pytree_node=False, default=32)
    rr_start: int = struct.field(pytree_node=False, default=3)
    # RT-mode toggles (SettingsWidget.cxx:575-607)
    rt_shadows: bool = struct.field(pytree_node=False, default=True)
    rt_reflections: bool = struct.field(pytree_node=False, default=True)
    # RT-mode adaptive anti-aliasing (the reference's FSAA checkbox):
    # luminance-contrast edge mask + 4 rotated-grid subsamples traced
    # only on edge lanes (integrator/whitted.py)
    rt_aa: bool = struct.field(pytree_node=False, default=False)
    # sort bounce rays by (octant, origin cell) before traversal so that
    # neighbouring lanes walk similar paths; pure reordering, estimator
    # unchanged. These two defaults were tuned for an earlier platform
    # and have not been re-measured on the GPU kernel.
    sort_rays: bool = struct.field(pytree_node=False, default=True)
    # re-sort cadence: permute the wavefront on bounces where
    # bounce % sort_every == 0
    sort_every: int = struct.field(pytree_node=False, default=1)
    # GI rendering via the persistent wavefront
    # (integrator/persistent.py): lane regeneration, with a host-side
    # top-up loop guaranteeing every per-pixel quota completes
    # (integrator/progressive.py). ON by default — it is the production
    # path the headline bench measures; the fixed-depth wavefront stays
    # selectable
    # (vrenderparams -persistent off) and keeps its own goldens.
    persistent: bool = struct.field(pytree_node=False, default=True)

    # --- traced ----------------------------------------------------------
    radiance_clamp: jnp.ndarray = struct.field(
        default_factory=lambda: jnp.float32(30.0))  # 1..1000
    background_color: jnp.ndarray = struct.field(
        default_factory=lambda: jnp.zeros(3, jnp.float32))
    seed: jnp.ndarray = struct.field(
        default_factory=lambda: jnp.uint32(0))
    tonemap: ToneMapParams = struct.field(default_factory=ToneMapParams)
