"""Whitted ray tracing and rasterization-preview modes.

Contract: the reference's render-mode switch offers GI (path tracing),
RT (Whitted ray tracing with toggles for shadows / specular reflections /
depth 1-10) and OpenGL rasterization (SettingsWidget.cxx:261-302,
575-618). Both share the scene/material/traversal stack
with the GI integrator:

* RT: deterministic primary + mirror-reflection chain (`lax.scan` over
  depth), direct lighting with optional shadow rays, no randomness.
* RASTER: one primary hit, Lambert + Blinn-style direct shading, no
  shadow rays — the "preview" mode.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from cadrays_tpu.core import vecmath as vm
from cadrays_tpu.core.bsdf import absorption_sigma, dielectric_split, eval_bsdf
from cadrays_tpu.core.camera import Camera
from cadrays_tpu.core.fresnel import eval_fresnel
from cadrays_tpu.core.lights import LIGHT_DIRECTIONAL
from cadrays_tpu.integrator.params import RenderParams
from cadrays_tpu.ops import envmap as envops
from cadrays_tpu.ops.hit import hit_attributes
from cadrays_tpu.ops.intersect import INF, offset_ray_origin
from cadrays_tpu.ops.texture import sample_texture
from cadrays_tpu.ops.traverse import trace
from cadrays_tpu.scene.flatten import SceneData


def _direct_lighting(scene: SceneData, h, wo, mat, params: RenderParams,
                     shadows: bool):
    """Sum direct contributions of every analytic light (no sampling)."""
    R = h["t"].shape[0]
    n = h["n_shade"]
    total = jnp.zeros((R, 3), jnp.float32)
    L = scene.lights.count
    for li in range(L):
        lt = scene.lights.gather(jnp.full((R,), li, jnp.int32))
        is_dir = lt.kind == LIGHT_DIRECTIONAL
        to_l_dir = -lt.vec
        to_c = lt.vec - h["position"]
        d2 = jnp.maximum(vm.dot(to_c, to_c), 1e-12)
        dist = jnp.sqrt(d2)
        wi = jnp.where(is_dir[..., None], vm.normalize(to_l_dir),
                       to_c / dist[..., None])
        falloff = jnp.where(is_dir, 1.0, 1.0 / d2)
        radiant = lt.color * (lt.intensity * lt.enabled * falloff)[..., None]
        f, _ = eval_bsdf(mat, wo, wi, n)
        cos_i = jnp.clip(vm.dot(wi, n), 0.0, 1.0)
        contrib = radiant * f * cos_i[..., None]
        if shadows:
            t_shadow = jnp.where(is_dir, INF, dist * (1.0 - 1e-4))
            occ = trace(
                scene.geometry,
                offset_ray_origin(h["position"], h["n_geom"], wi),
                wi, jnp.where(h["hit"] & (cos_i > 0), t_shadow, 0.0),
                any_hit=True,
            )["tri"] >= 0
            contrib = jnp.where(occ[..., None], 0.0, contrib)
        total = total + contrib
    return total


def render_whitted(scene: SceneData, camera: Camera, params: RenderParams,
                   width: int, height: int):
    """Deterministic Whitted pass -> (H*W, 3) radiance.

    params.rt_aa (SettingsWidget.cxx:575-607, the RT-mode adaptive
    anti-aliasing checkbox): adaptive FSAA under static
    shapes — the center pass renders everywhere, a luminance-contrast
    edge mask is computed from it (catches silhouettes AND shadow /
    highlight boundaries), and four rotated-grid subsample passes run
    with NON-edge lanes dead (t_max=0, which traversal skips), so only
    edge pixels pay the 4 extra rays. Edge pixels
    average the 5 samples; smooth pixels keep the center sample.
    """
    pixel_ids = jnp.arange(width * height, dtype=jnp.int32)
    pxc = (pixel_ids % width).astype(jnp.float32)
    pyc = (pixel_ids // width).astype(jnp.float32)
    z = jnp.zeros_like(pxc)
    origin, direction = camera.generate_rays(pxc, pyc, z, z,
                                             width, height)
    R = origin.shape[0]

    def whitted_pass(origin, direction, live):
        return _whitted_scan(scene, camera, params, width, height,
                             origin, direction, live)

    center = whitted_pass(origin, direction, jnp.ones((R,), bool))
    if not params.rt_aa:
        return center

    # luminance-contrast edge mask on the center pass (4-neighborhood)
    lum = vm.luminance(center).reshape(height, width)
    dx = jnp.abs(jnp.diff(lum, axis=1, append=lum[:, -1:]))
    dy = jnp.abs(jnp.diff(lum, axis=0, append=lum[-1:, :]))
    contrast = jnp.maximum(jnp.maximum(dx, jnp.roll(dx, 1, axis=1)),
                           jnp.maximum(dy, jnp.roll(dy, 1, axis=0)))
    # threshold: relative to local luminance so shadow-boundary and
    # silhouette steps trigger but smooth falloff gradients do not
    edge = (contrast > 0.08 * (0.1 + lum)).reshape(-1)

    # rotated-grid subsamples (the classic RGSS quad)
    acc = center
    for (ox, oy) in ((0.125, 0.625), (0.375, 0.125),
                     (0.625, 0.875), (0.875, 0.375)):
        o2, d2 = camera.generate_rays(pxc + (ox - 0.5), pyc + (oy - 0.5),
                                      z, z, width, height)
        acc = acc + whitted_pass(o2, d2, edge)
    return jnp.where(edge[..., None], acc / 5.0, center)


def _whitted_scan(scene: SceneData, camera: Camera, params: RenderParams,
                  width: int, height: int, origin, direction, live):
    """One deterministic Whitted chain over `live` lanes."""
    R = origin.shape[0]
    state = dict(
        origin=origin, direction=direction,
        throughput=jnp.ones((R, 3), jnp.float32),
        radiance=jnp.zeros((R, 3), jnp.float32),
        alive=live,
        sigma=jnp.zeros((R, 3), jnp.float32),  # Beer-Lambert extinction
    )
    depth = params.ray_depth if params.rt_reflections else 1

    def step(state, bounce):
        o, d = state["origin"], state["direction"]
        # dead lanes (masked-out AA subsamples, terminated chains) trace
        # with t_max=0, which traversal skips
        res = trace(scene.geometry, o, d,
                    jnp.where(state["alive"], INF, 0.0))
        h = hit_attributes(scene.geometry, o, d, res["tri"])
        hit = h["hit"] & state["alive"]
        miss = (~h["hit"]) & state["alive"]
        seg = jnp.where(h["hit"], h["t"], 0.0)
        throughput = state["throughput"] * jnp.exp(
            -state["sigma"] * seg[..., None])
        radiance = state["radiance"]

        if scene.envmap.enabled and scene.envmap.background:
            env = envops.eval_env(scene.envmap, d)
            radiance = radiance + jnp.where(miss[..., None],
                                            throughput * env, 0.0)
        else:
            radiance = radiance + jnp.where(
                miss[..., None] & (bounce == 0),
                throughput * params.background_color, 0.0)

        mat = scene.materials.gather(h["mat_id"])
        tex = sample_texture(scene.textures, mat.tex_id, h["uv"], mat.uv_scale)
        ks_tex = sample_texture(scene.textures, mat.ks_tex_id, h["uv"],
                                mat.uv_scale)
        mat = mat.replace(kd=mat.kd * tex, ks=mat.ks * ks_tex)
        wo = -d
        transmissive = vm.luminance(mat.kt) > 1e-3
        if not params.two_sided:
            # One-sided BSDFs: opaque backfaces absorb (black).
            hit = hit & (h["front"] | transmissive)

        direct = _direct_lighting(scene, h, wo, mat, params,
                                  shadows=params.rt_shadows)
        radiance = radiance + jnp.where(hit[..., None],
                                        throughput * (direct + mat.le), 0.0)

        # One secondary ray per lane: reflection (Ks * base Fresnel) or —
        # for transmissive materials — dielectric refraction with
        # Fresnel-split transmittance (SettingsWidget.cxx:575-607: RT mode
        # handles transparency). The stronger branch is followed; a tree
        # of both branches is hostile to the lockstep wavefront.
        n = h["n_shade"]
        cos_o = jnp.clip(vm.dot(wo, n), 1e-6, 1.0)
        fb = eval_fresnel(mat.base_ftype, mat.base_fparams, cos_o)
        w_refl = mat.ks * fb
        dir_refl = vm.normalize(vm.reflect(d, n))

        f_d, dir_refr, tir = dielectric_split(mat.eta, wo, n, h["front"])
        dir_refr = vm.normalize(dir_refr)
        w_refr = mat.kt * (1.0 - f_d)[..., None]
        # TIR: fall back to a mirror ray at full strength.
        w_refr = jnp.where(tir[..., None], jnp.ones_like(w_refr), w_refr)
        dir_refr = jnp.where(tir[..., None], dir_refl, dir_refr)

        take_refr = transmissive & (vm.luminance(w_refr) >=
                                    vm.luminance(w_refl))
        new_dir = jnp.where(take_refr[..., None], dir_refr, dir_refl)
        weight = jnp.where(take_refr[..., None], w_refr, w_refl)

        # Medium tracking across a refraction (not on TIR reflections).
        crossed = take_refr & (~tir)
        sig_mat = absorption_sigma(mat)
        sigma = state["sigma"]
        sigma = jnp.where((crossed & h["front"])[..., None], sig_mat, sigma)
        sigma = jnp.where((crossed & ~h["front"])[..., None], 0.0, sigma)

        # Refracted rays must start on the far side of the surface.
        off_n = jnp.where(crossed[..., None], -h["n_geom"], h["n_geom"])
        alive = hit & (vm.luminance(weight) > 1e-3) if params.rt_reflections \
            else jnp.zeros((R,), bool)
        return dict(
            origin=offset_ray_origin(h["position"], off_n, new_dir),
            direction=new_dir,
            throughput=jnp.where(alive[..., None], throughput * weight, 0.0),
            radiance=radiance,
            alive=alive,
            sigma=sigma,
        ), None

    state, _ = jax.lax.scan(step, state, jnp.arange(depth), length=depth)
    return jnp.nan_to_num(state["radiance"], nan=0.0, posinf=0.0, neginf=0.0)


def render_raster(scene: SceneData, camera: Camera, params: RenderParams,
                  width: int, height: int):
    """Rasterization-style preview: primary hit + unshadowed direct shading."""
    p = params.replace(rt_shadows=False, rt_reflections=False)
    return render_whitted(scene, camera, p, width, height)
