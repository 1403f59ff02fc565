"""Wavefront path-tracing integrator (the heart of the framework).

Reference capability: OCCT's GLSL *megakernel* path tracer with NEE,
double-layer BSDF and progressive accumulation [OCCT-contract, SURVEY.md
§2.5]. Here the integrator is a **wavefront** instead: one
statically-shaped batch of rays advances through `lax.scan` over bounces;
dead lanes are masked, never compacted (static shapes are an XLA
requirement — SURVEY.md §7.3 hard part #3). Each scan step does:

  trace -> medium absorption -> emission/env (MIS) -> NEE (lights,
  emissive triangles, env map) -> BSDF sample -> Russian roulette.

Everything is differentiable: discrete decisions (hit ids, lobe choices,
RR survival) are detached; continuous quantities are recomputed from them
(ops/hit.py, detached-sampling BSDF weights in core/bsdf.py), so pixel
gradients reach material, light, camera and env parameters.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from jax.ad_checkpoint import checkpoint_name

from cadrays_tpu.core import rng as crng
from cadrays_tpu.core import sampling as smp
from cadrays_tpu.core import vecmath as vm
from cadrays_tpu.core.bsdf import absorption_sigma, eval_bsdf, sample_bsdf
from cadrays_tpu.core.camera import Camera
from cadrays_tpu.core.lights import pack_lights, sample_light_rows
from cadrays_tpu.integrator.params import RenderParams
from cadrays_tpu.ops import envmap as envops
from cadrays_tpu.ops.hit import (build_shade_table, gather_rows,
                                 hit_attributes_packed)
from cadrays_tpu.ops.intersect import INF, offset_ray_origin
from cadrays_tpu.ops.texture import sample_texture
from cadrays_tpu.ops.traverse import _coherence_key, trace
from cadrays_tpu.scene.flatten import SceneData

# RNG dimension allocation per bounce (keep decorrelated streams).
_DIM_PIXEL = 0
_DIM_LENS = 1
_DIM_BSDF = 2
_DIM_NEE = 3
_DIM_RR = 4
_DIMS_PER_BOUNCE = 8


def _rng_dim(bounce, slot):
    return _DIMS_PER_BOUNCE * bounce + slot + 16  # 0..15 reserved for camera


def build_wavefront(scene: SceneData, camera: Camera,
                    params: RenderParams, width: int, height: int,
                    sample_id, pixel_ids):
    """Initial wavefront state + the (checkpointed) bounce function.

    The scan driver differs by renderer — render_sample runs exactly
    `ray_depth` steps; integrator/persistent.py wraps each step with
    retire/regenerate — but the bounce physics is THIS closure for both.
    """
    R = pixel_ids.shape[0]
    seed = params.seed
    sample_id = jnp.asarray(sample_id, jnp.uint32)

    px = (pixel_ids % width).astype(jnp.float32)
    py = (pixel_ids // width).astype(jnp.float32)

    # Camera samples: pixel jitter + lens.
    jx, jy, ul0, ul1 = crng.sample4(pixel_ids, sample_id, _DIM_PIXEL, seed)
    origin, direction = camera.generate_rays(
        px + jx, py + jy, ul0, ul1, width, height
    )

    has_lights = scene.lights.count > 0
    has_emissive = scene.emissive.count > 0
    has_env = scene.envmap.enabled

    state = dict(
        origin=origin,
        direction=direction,
        throughput=jnp.ones((R, 3), jnp.float32),
        radiance=jnp.zeros((R, 3), jnp.float32),
        alive=jnp.ones((R,), bool),
        prev_pdf=jnp.zeros((R,), jnp.float32),
        prev_delta=jnp.ones((R,), bool),  # primary rays: no MIS on first hit
        sigma=jnp.zeros((R, 3), jnp.float32),  # current medium extinction
        # lane bookkeeping for the per-bounce wavefront permutation:
        # `pix` = pixel id driving this lane's RNG stream, `lane` = output
        # row the lane's radiance belongs to.
        pix=pixel_ids,
        lane=jnp.arange(R, dtype=jnp.int32),
        # per-lane sample id + bounce-within-sample: constant across the
        # wavefront here, but the persistent renderer
        # (integrator/persistent.py) staggers them per lane, so all
        # sample-indexed RNG and depth logic reads these fields.
        sid=jnp.full((R,), sample_id, jnp.uint32),
        bdepth=jnp.zeros((R,), jnp.int32),
        done_sum=jnp.zeros((R, 3), jnp.float32),
        done_cnt=jnp.zeros((R,), jnp.int32),
    )

    def rng4(pix, sid, bounce, slot):
        pid = pix if not params.coherent else jnp.zeros_like(pix)
        return crng.sample4(pid, sid, _rng_dim(bounce, slot), seed)

    # One (T, C) row per triangle: geometry + its full material. Built
    # once per sample (loop-invariant -> hoisted out of the bounce scan);
    # shading then costs ONE per-ray row gather per bounce instead of ~30.
    shade_tab = build_shade_table(scene.geometry, scene.materials)
    light_tab = pack_lights(scene.lights) if has_lights else None
    em_tab = _build_emissive_table(scene) if has_emissive else None

    def bounce_step(state, bounce):
        o, d = state["origin"], state["direction"]
        bd0 = state["bdepth"] == 0  # first bounce OF THIS LANE'S SAMPLE
        # Dead lanes trace with t_max=0: the CUDA kernel skips their walk
        # (and the sort below gathers them at the tail), so they cost
        # next to nothing under static shapes.
        res = trace(scene.geometry, o, d,
                    jnp.where(state["alive"], INF, 0.0))
        # Rematerialization contract (see the jax.checkpoint wrap at the
        # scan): traversal results are SAVED residuals — the backward pass
        # recomputes the cheap shading math but never re-walks the BVH.
        res = {k: checkpoint_name(v, "trace") for k, v in res.items()}
        h, mat = hit_attributes_packed(scene.geometry, shade_tab, o, d,
                                       res["tri"])
        hit = h["hit"] & state["alive"]
        miss = (~h["hit"]) & state["alive"]
        if not params.two_sided:
            # One-sided BSDFs (SettingsWidget.cxx:328-334): a backface hit
            # on a non-transmissive material absorbs the path (black).
            # Transmissive materials keep both sides so refraction can
            # exit the medium.
            hit = hit & (h["front"] | (vm.luminance(mat.kt) > 0.0))

        # Beer-Lambert absorption through the current medium.
        seg = jnp.where(h["hit"], h["t"], 0.0)
        transmittance = jnp.exp(-state["sigma"] * seg[..., None])
        throughput = state["throughput"] * transmittance
        radiance = state["radiance"]

        # ---- miss: environment / background ----------------------------
        if has_env:
            env_rad = envops.eval_env(scene.envmap, d)
            if scene.envmap.background:
                primary_scale = 1.0
            else:
                primary_scale = 0.0
            w_mis = jnp.where(
                state["prev_delta"],
                1.0,
                smp.power_heuristic(
                    state["prev_pdf"],
                    jax.lax.stop_gradient(envops.pdf_env(scene.envmap, d))),
            )
            scale = jnp.where(bd0, primary_scale, w_mis)
            radiance = radiance + jnp.where(
                miss[..., None], throughput * env_rad * scale[..., None], 0.0
            )
        bg = jnp.where(bd0 & miss, 1.0, 0.0)
        if not (has_env and scene.envmap.background):
            radiance = radiance + bg[..., None] * params.background_color

        # ---- surface shading -------------------------------------------
        tex = sample_texture(scene.textures, mat.tex_id, h["uv"], mat.uv_scale)
        ks_tex = sample_texture(scene.textures, mat.ks_tex_id, h["uv"],
                                mat.uv_scale)
        mat = mat.replace(kd=mat.kd * tex, ks=mat.ks * ks_tex)

        n = h["n_shade"]
        wo = -d
        p_off = offset_ray_origin(h["position"], h["n_geom"], h["n_geom"])

        # Emitted radiance at the hit (MIS against emissive-tri NEE).
        le = mat.le
        emitting = vm.luminance(le) > 0.0
        if has_emissive:
            d2 = jnp.maximum(h["t"] * h["t"], 1e-12)
            cos_l = jnp.clip(vm.dot(wo, h["n_geom"]), 1e-6, 1.0)
            lum_le = vm.luminance(le)
            pdf_light_sa = lum_le * d2 / jnp.maximum(
                scene.emissive.total_power * cos_l, 1e-12
            )
            w_emit = jnp.where(
                state["prev_delta"] | bd0,
                1.0,
                smp.power_heuristic(state["prev_pdf"],
                                    jax.lax.stop_gradient(pdf_light_sa)),
            )
        else:
            w_emit = jnp.ones((R,), jnp.float32)
        # Only front faces emit (one-sided emitters).
        emit_mask = hit & emitting & h["front"]
        radiance = radiance + jnp.where(
            emit_mask[..., None], throughput * le * w_emit[..., None], 0.0
        )

        # ---- next-event estimation -------------------------------------
        # All NEE strategies are evaluated first, their shadow rays are
        # then traced in ONE fused any-hit call (R*n_strategies lanes):
        # shadow queries are 2/3 of all traversal work, and one big
        # wavefront beats three kernel launches (fewer fixed costs, and
        # each strategy's segment stays block-aligned and coherent).
        nee_contribs = []  # (vis_need, contrib, origin, wi, tmax)
        if has_lights:
            u = rng4(state["pix"], state["sid"], bounce, _DIM_NEE)
            if scene.lights.count == 1:
                # static single-light row: a broadcast instead of a per-ray
                # row gather, and no scatter in the backward
                lrows = jnp.broadcast_to(light_tab[0],
                                         (R,) + light_tab.shape[1:])
            else:
                lsel = jnp.minimum(
                    (u[0] * scene.lights.count).astype(jnp.int32),
                    scene.lights.count - 1,
                )
                lrows = checkpoint_name(gather_rows(light_tab, lsel),
                                        "trace")
            ls = sample_light_rows(lrows, h["position"], u[1], u[2])
            f, _ = eval_bsdf(mat, wo, ls["wi"], n)
            cos_i = jnp.clip(vm.dot(ls["wi"], n), 0.0, 1.0)
            vis_need = hit & ls["valid"] & (cos_i > 0.0)
            contrib = ls["contrib"] * f * (cos_i * scene.lights.count)[..., None]
            # Positional-light shadow rays are traced FROM the light
            # toward the surface: occlusion is symmetric, and a shared
            # origin makes neighbouring lanes walk the tree alike, as
            # primary rays do. Directional lights have no finite origin.
            rev = (ls["dist"] < 1e29)[..., None]
            lpt = h["position"] + ls["wi"] * ls["dist"][..., None]
            o_sh = jnp.where(
                rev, lpt,
                offset_ray_origin(h["position"], h["n_geom"], ls["wi"]))
            d_sh = jnp.where(rev, -ls["wi"], ls["wi"])
            nee_contribs.append((
                vis_need, contrib, o_sh, d_sh,
                jnp.where(vis_need, ls["dist"] * (1.0 - 1e-4), 0.0)))

        if has_emissive:
            u = rng4(state["pix"], state["sid"], bounce, _DIM_NEE + 1)
            em = _sample_emissive(scene, em_tab, h["position"], u)
            f, pdf_b = eval_bsdf(mat, wo, em["wi"], n)
            cos_i = jnp.clip(vm.dot(em["wi"], n), 0.0, 1.0)
            vis_need = hit & em["valid"] & (cos_i > 0.0)
            pdf_sa_det = jax.lax.stop_gradient(em["pdf_sa"])
            w_mis = smp.power_heuristic(pdf_sa_det,
                                        jax.lax.stop_gradient(pdf_b))
            contrib = em["le"] * f * (
                cos_i * w_mis / jnp.maximum(pdf_sa_det, 1e-12)
            )[..., None]
            # Reversed like the positional lights: trace from the emitter
            # point (offset off its surface) toward the receiver.
            o_em = offset_ray_origin(em["point"], em["n_l"], -em["wi"])
            nee_contribs.append((
                vis_need, contrib, o_em, -em["wi"],
                jnp.where(vis_need, em["dist"] * (1.0 - 1e-3), 0.0)))

        if has_env:
            u = rng4(state["pix"], state["sid"], bounce, _DIM_NEE + 2)
            wi_e, rad_e, pdf_e = envops.sample_env(scene.envmap, u[0], u[1])
            f, pdf_b = eval_bsdf(mat, wo, wi_e, n)
            cos_i = jnp.clip(vm.dot(wi_e, n), 0.0, 1.0)
            vis_need = hit & (pdf_e > 0.0) & (cos_i > 0.0)
            pdf_e_det = jax.lax.stop_gradient(pdf_e)
            w_mis = smp.power_heuristic(pdf_e_det,
                                        jax.lax.stop_gradient(pdf_b))
            contrib = rad_e * f * (
                cos_i * w_mis / jnp.maximum(pdf_e_det, 1e-12)
            )[..., None]
            nee_contribs.append((
                vis_need, contrib,
                offset_ray_origin(h["position"], h["n_geom"], wi_e),
                wi_e,
                jnp.where(vis_need, INF, 0.0)))

        if nee_contribs:
            occ_all = checkpoint_name(trace(
                scene.geometry,
                jnp.concatenate([c[2] for c in nee_contribs], axis=0),
                jnp.concatenate([c[3] for c in nee_contribs], axis=0),
                jnp.concatenate([c[4] for c in nee_contribs], axis=0),
                any_hit=True,
            )["tri"] >= 0, "trace")
            nee = jnp.zeros((R, 3), jnp.float32)
            for k, (vis_need, contrib, _, _, _) in enumerate(nee_contribs):
                occ = occ_all[k * R:(k + 1) * R]
                nee = nee + jnp.where((vis_need & ~occ)[..., None],
                                      contrib, 0.0)
            radiance = radiance + throughput * nee

        # ---- BSDF sampling ---------------------------------------------
        u = jnp.stack(rng4(state["pix"], state["sid"], bounce, _DIM_BSDF), axis=-1)
        bs = sample_bsdf(mat, wo, n, u, front=h["front"])
        new_dir = bs["wi"]
        new_origin = offset_ray_origin(h["position"], h["n_geom"], new_dir)
        throughput_next = throughput * bs["weight"]

        # Medium tracking on refraction through the surface.
        sig_mat = absorption_sigma(mat)
        entering = bs["transmitted"] & h["front"]
        exiting = bs["transmitted"] & (~h["front"])
        sigma = state["sigma"]
        sigma = jnp.where(entering[..., None], sig_mat, sigma)
        sigma = jnp.where(exiting[..., None], 0.0, sigma)

        alive = hit & bs["valid"] & (vm.luminance(throughput_next) > 0.0)

        # Russian roulette (unbiased, detached survival probability).
        ur = rng4(state["pix"], state["sid"], bounce, _DIM_RR)[0]
        p_sur = jnp.clip(jnp.max(jax.lax.stop_gradient(throughput_next),
                                 axis=-1), 0.05, 0.95)
        do_rr = state["bdepth"] >= params.rr_start
        survive = jnp.where(do_rr, ur < p_sur, True)
        throughput_next = jnp.where(
            (do_rr & survive)[..., None],
            throughput_next / p_sur[..., None], throughput_next
        )
        alive = alive & survive
        # per-lane depth cutoff (RaytracingDepth): the sample ends after
        # ray_depth bounces. A no-op for render_sample's fixed-length
        # scan (the last step's alive is unused); the persistent
        # renderer retires + regenerates on it.
        alive = alive & (state["bdepth"] + 1 < params.ray_depth)

        new_state = dict(
            origin=new_origin,
            direction=new_dir,
            throughput=jnp.where(alive[..., None], throughput_next, 0.0),
            radiance=radiance,
            alive=alive,
            prev_pdf=bs["pdf"],
            prev_delta=bs["is_delta"],
            sigma=sigma,
            pix=state["pix"],
            lane=state["lane"],
            sid=state["sid"],
            bdepth=state["bdepth"] + 1,
            done_sum=state["done_sum"],
            done_cnt=state["done_cnt"],
            **({"extra": state["extra"]} if "extra" in state else {}),
        )
        if params.sort_rays:
            # One wavefront-wide permutation per sorted bounce: live lanes
            # sorted by (direction octant, origin Morton cell) so that
            # neighbouring lanes of the next bounce's closest-hit AND
            # shadow queries take similar paths through the tree; dead
            # lanes (t_max=0, which skip the walk) sink to the tail. The
            # state is packed into a single matrix so the permutation is
            # ONE row gather, not one per field. `sort_every` skips the
            # permutation on off-bounces (lanes keep the previous
            # bounce's order). The permuted state is a saved residual, so
            # the backward does not recompute the gather.
            def _sorted(m):
                s = _unpack_state(m)
                key = _coherence_key(scene.geometry, s["origin"],
                                     s["direction"])
                key = jnp.where(s["alive"], key, jnp.int32(1 << 30))
                perm = jnp.argsort(key)
                return m[perm]

            packed = _pack_state(new_state)
            if params.sort_every <= 1:
                packed = _sorted(packed)
            else:
                packed = jax.lax.cond(
                    bounce % params.sort_every == 0, _sorted,
                    lambda m: m, packed)
            new_state = _unpack_state(checkpoint_name(packed, "trace"))
        return new_state, jnp.sum(state["alive"].astype(jnp.int32))

    # One remat boundary per bounce: saving only the named traversal/
    # permutation results keeps the backward from re-walking the BVH
    # while the elementwise shading chain is recomputed on the fly, and
    # keeps residual traffic through the scan small.
    bounce_fn = jax.checkpoint(
        bounce_step,
        policy=jax.checkpoint_policies.save_only_these_names("trace"))
    return state, bounce_fn


def render_sample(scene: SceneData, camera: Camera, params: RenderParams,
                  width: int, height: int, sample_id, pixel_ids=None,
                  return_stats: bool = False):
    """Trace one sample per pixel; returns (R, 3) linear radiance.

    pixel_ids: optional (R,) int32 subset/permutation of pixels (adaptive
    tiles / sharding); defaults to all H*W pixels in scanline order.
    return_stats: also return the per-bounce live-lane counts (depth,)
    — the honest ray-accounting input for bench.py.
    """
    if pixel_ids is None:
        pixel_ids = jnp.arange(width * height, dtype=jnp.int32)
    state, bounce_fn = build_wavefront(scene, camera, params, width,
                                       height, sample_id, pixel_ids)
    state, n_alive = jax.lax.scan(
        bounce_fn, state, jnp.arange(params.ray_depth),
        length=params.ray_depth
    )

    # Tail: rays still alive after the last bounce pick up the environment
    # through one final miss-check is skipped (bounded depth, like the
    # reference's RaytracingDepth cutoff).
    radiance = state["radiance"]
    if params.sort_rays:
        # Scatter lane-ordered radiance back to the caller's pixel order.
        radiance = jnp.zeros_like(radiance).at[state["lane"]].set(radiance)

    # Radiance clamping (SettingsWidget.cxx:318-326): bound the per-sample
    # contribution to trade energy for variance.
    clamp = jnp.maximum(params.radiance_clamp, 1.0)
    peak = jnp.max(radiance, axis=-1, keepdims=True)
    scale = jnp.where(peak > clamp, clamp / jnp.maximum(peak, 1e-12), 1.0)
    radiance = radiance * scale

    radiance = jnp.nan_to_num(radiance, nan=0.0, posinf=0.0, neginf=0.0)
    if return_stats:
        return radiance, n_alive
    return radiance


def _pack_state(s):
    """Wavefront state dict -> one (R, 26[+E]) f32 matrix (ints/bools
    encoded losslessly) so a lane permutation is a single row gather.
    An optional `extra` (R, E) f32 field (persistent-pool bank slots,
    integrator/persistent.py) rides the same permutation — the gather
    cost is dominated by row count, not width."""
    bc = lambda x: jax.lax.bitcast_convert_type(x, jnp.float32)[:, None]
    cols = [
        s["origin"], s["direction"], s["throughput"], s["radiance"],
        s["sigma"], s["prev_pdf"][:, None],
        s["alive"].astype(jnp.float32)[:, None],
        s["prev_delta"].astype(jnp.float32)[:, None],
        bc(s["pix"]), bc(s["lane"]),
        bc(s["sid"]), bc(s["bdepth"]),
        s["done_sum"], bc(s["done_cnt"]),
    ]
    if "extra" in s:
        cols.append(s["extra"])
    return jnp.concatenate(cols, axis=1)


def _unpack_state(m):
    bi = lambda c: jax.lax.bitcast_convert_type(m[:, c], jnp.int32)
    out = dict(
        origin=m[:, 0:3], direction=m[:, 3:6], throughput=m[:, 6:9],
        radiance=m[:, 9:12], sigma=m[:, 12:15], prev_pdf=m[:, 15],
        alive=m[:, 16] > 0.5, prev_delta=m[:, 17] > 0.5,
        pix=bi(18), lane=bi(19),
        sid=jax.lax.bitcast_convert_type(m[:, 20], jnp.uint32),
        bdepth=bi(21),
        done_sum=m[:, 22:25], done_cnt=bi(25),
    )
    if m.shape[1] > 26:
        out["extra"] = m[:, 26:]
    return out


def _build_emissive_table(scene: SceneData) -> jnp.ndarray:
    """(E, 12/13) packed emissive-triangle rows [p0 p1 p2 le (+inst)] —
    built once per sample so `_sample_emissive` needs one row gather per
    bounce instead of ~20 field gathers."""
    em = scene.emissive
    g = scene.geometry
    tid = em.tri_idx
    tv = g.tri_v[tid]
    p0 = g.vertices[tv[:, 0]]
    p1 = g.vertices[tv[:, 1]]
    p2 = g.vertices[tv[:, 2]]
    le = scene.materials.le[g.tri_mat[tid]]
    cols = [p0, p1, p2, le]
    if g.instanced:
        cols.append(g.tri_inst[tid].astype(jnp.float32)[:, None])
    return jnp.concatenate(cols, axis=1)


def _sample_emissive(scene: SceneData, em_tab, p, u):
    """Sample a point on the emissive-triangle table (power-proportional)."""
    em = scene.emissive
    idx = jnp.searchsorted(em.cdf, u[0], side="left")
    idx = jnp.clip(idx, 0, em.cdf.shape[0] - 1)
    g = scene.geometry
    # the one gather; saved residual + segment-sum VJP (see ops/hit.py)
    rows = checkpoint_name(gather_rows(em_tab, idx), "trace")
    p0 = rows[:, 0:3]
    p1 = rows[:, 3:6]
    p2 = rows[:, 6:9]
    le = rows[:, 9:12]
    if g.instanced:
        tf = g.inst_tf[rows[:, 12].astype(jnp.int32)]  # (R, 3, 4)
        lin = tf[..., :3]
        p0 = jnp.einsum("rij,rj->ri", lin, p0, precision="float32") + tf[..., 3]
        p1 = jnp.einsum("rij,rj->ri", lin, p1, precision="float32") + tf[..., 3]
        p2 = jnp.einsum("rij,rj->ri", lin, p2, precision="float32") + tf[..., 3]
    # uniform point on triangle
    su = jnp.sqrt(jnp.clip(u[1], 1e-12, 1.0))
    b0 = 1.0 - su
    b1 = u[2] * su
    q = (
        p0 * b0[..., None] + p1 * b1[..., None]
        + p2 * (1.0 - b0 - b1)[..., None]
    )
    n_l = vm.normalize(jnp.cross(p1 - p0, p2 - p0))
    to_q = q - p
    d2 = jnp.maximum(vm.dot(to_q, to_q), 1e-12)
    dist = jnp.sqrt(d2)
    wi = to_q / dist[..., None]
    cos_l = vm.dot(-wi, n_l)
    # one-sided emitter: light leaves the front face only
    facing = cos_l > 1e-6
    # pdf: power-proportional triangle choice * uniform area -> solid angle
    lum_le = jnp.maximum(vm.luminance(le), 1e-12)
    pdf_area = lum_le / jnp.maximum(em.total_power, 1e-12)
    pdf_sa = pdf_area * d2 / jnp.clip(cos_l, 1e-6, None)
    return {
        "wi": wi,
        "dist": dist,
        "le": le,
        "pdf_sa": pdf_sa,
        "valid": facing & (em.total_power > 0.0),
        "point": q,
        "n_l": n_l,
    }
