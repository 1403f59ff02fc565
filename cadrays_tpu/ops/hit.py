"""Differentiable hit attributes.

Traversal (ops/traverse.py) returns only discrete topology: the triangle
id per ray. Everything continuous — hit distance, position, barycentrics,
normals, UVs — is *recomputed* here from the gathered triangle and the ray
with plain differentiable jnp math. This is the detached-topology
construction that makes the whole renderer differentiable: gradients flow
through geometry/material/camera parameters while the discrete hit
decision stays fixed (SURVEY.md §7.3 hard part #2).

For two-level instanced scenes the triangle data is object-space: the ray
is transformed into the instance frame (differentiably — gradients reach
instance transforms too), the hit parameter t is shared between frames
(directions stay unnormalized in object space), and normals come back to
world via the inverse-transpose.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from cadrays_tpu.core import vecmath as vm
from cadrays_tpu.scene.flatten import GeometryData


def hit_attributes(geom: GeometryData, origin, direction, tri):
    """Compute shading data for rays whose traversal chose triangle `tri`.

    tri: (R,) int32, -1 for miss (lanes still computed, mask with `hit`).
    Returns dict: hit(bool), t, position, n_geom, n_shade (oriented toward
    the incoming ray), uv, mat_id, front (bool: hit on the front face).
    """
    hit = tri >= 0
    tid = jnp.maximum(tri, 0)
    i0 = geom.tri_v[tid, 0]
    i1 = geom.tri_v[tid, 1]
    i2 = geom.tri_v[tid, 2]
    p0, p1, p2 = geom.vertices[i0], geom.vertices[i1], geom.vertices[i2]

    if geom.instanced:
        inv = geom.inst_inv[geom.tri_inst[tid]]  # (R, 3, 4)
        lin = inv[..., :3]
        o_l = jnp.einsum("rij,rj->ri", lin, origin, precision="float32") + inv[..., 3]
        d_l = jnp.einsum("rij,rj->ri", lin, direction, precision="float32")
    else:
        o_l, d_l = origin, direction

    # Differentiable Moller-Trumbore on the selected triangle
    # (object space; t is world-parameterized because d_l is the linear
    # image of the world direction, not renormalized).
    e1 = p1 - p0
    e2 = p2 - p0
    pvec = jnp.cross(d_l, e2)
    det = vm.dot(e1, pvec)
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-12, det, 1.0)
    tvec = o_l - p0
    u = vm.dot(tvec, pvec) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = vm.dot(d_l, qvec) * inv_det
    t = vm.dot(e2, qvec) * inv_det
    u = jnp.clip(u, 0.0, 1.0)
    v = jnp.clip(v, 0.0, 1.0)
    w = jnp.clip(1.0 - u - v, 0.0, 1.0)

    position = origin + direction * t[..., None]

    n_geom_l = jnp.cross(e1, e2)
    n0, n1, n2 = geom.normals[i0], geom.normals[i1], geom.normals[i2]
    n_shade_l = w[..., None] * n0 + u[..., None] * n1 + v[..., None] * n2

    if geom.instanced:
        # normals: n_world = n_obj @ M^-1 (row-vector inverse-transpose)
        n_geom = vm.normalize(jnp.einsum("rj,rji->ri", n_geom_l, lin, precision="float32"))
        n_shade = vm.normalize(jnp.einsum("rj,rji->ri", n_shade_l, lin, precision="float32"))
    else:
        n_geom = vm.normalize(n_geom_l)
        n_shade = vm.normalize(n_shade_l)

    # Keep the shading normal on the same side as the geometric normal.
    n_shade = jnp.where(
        vm.dot(n_shade, n_geom, keepdims=True) < 0.0, -n_shade, n_shade
    )

    uv0, uv1, uv2 = geom.uvs[i0], geom.uvs[i1], geom.uvs[i2]
    uv = w[..., None] * uv0 + u[..., None] * uv1 + v[..., None] * uv2

    front = vm.dot(direction, n_geom) < 0.0
    # Orient both normals against the incoming ray (two-sided shading).
    flip = jnp.where(front, 1.0, -1.0)[..., None]
    n_geom_o = n_geom * flip
    n_shade_o = n_shade * flip

    return {
        "hit": hit,
        "t": t,
        "position": position,
        "n_geom": n_geom_o,
        "n_shade": n_shade_o,
        "uv": uv,
        "mat_id": geom.tri_mat[tid],
        "front": front,
    }


# ---------------------------------------------------------------------------
# Packed single-gather shading path
# ---------------------------------------------------------------------------
# The 15 per-ray gathers above (+15 more in Material.gather) would each
# be one gather op over the wavefront. The wavefront integrator instead
# builds ONE per-triangle
# table (triangle geometry + its full material row) once per sample —
# loop-invariant, so XLA hoists it out of the bounce scan — and shading
# then needs a single (R, C) row gather per bounce.

def build_shade_table(geom: GeometryData, materials) -> jnp.ndarray:
    """(T, C) per-triangle shading rows: p0 e1 e2 | n0 n1 n2 | uv0 uv1 uv2
    | material row | [instance id]. Differentiable: rows are jnp-derived
    from the scene pytree leaves, so gradients flow back through the
    gather to vertices/normals/uvs/material fields."""
    tv = geom.tri_v
    p0 = geom.vertices[tv[:, 0]]
    p1 = geom.vertices[tv[:, 1]]
    p2 = geom.vertices[tv[:, 2]]
    n0 = geom.normals[tv[:, 0]]
    n1 = geom.normals[tv[:, 1]]
    n2 = geom.normals[tv[:, 2]]
    uv0 = geom.uvs[tv[:, 0]]
    uv1 = geom.uvs[tv[:, 1]]
    uv2 = geom.uvs[tv[:, 2]]
    m = materials.gather(geom.tri_mat)
    cols = [
        p0, p1 - p0, p2 - p0, n0, n1, n2, uv0, uv1, uv2,
        m.kc, m.kd, m.ks, m.kt, m.le,
        m.base_rough[:, None], m.coat_rough[:, None],
        m.absorp_color, m.absorp_coeff[:, None],
        m.base_ftype.astype(jnp.float32)[:, None], m.base_fparams,
        m.coat_ftype.astype(jnp.float32)[:, None], m.coat_fparams,
        m.tex_id.astype(jnp.float32)[:, None],
        m.ks_tex_id.astype(jnp.float32)[:, None], m.uv_scale[:, None],
    ]
    if geom.instanced:
        cols.append(geom.tri_inst.astype(jnp.float32)[:, None])
    return jnp.concatenate(cols, axis=1)


@jax.custom_vjp
def gather_rows(table, tid):
    """`table[tid]` with a fused segment-sum backward.

    XLA's default VJP for a row gather is a duplicate-index scatter-add;
    this one uses `segment_sum`, a sorted segmented reduction. tid is
    integer topology — no tangent."""
    return table[tid]


def _gather_rows_fwd(table, tid):
    return table[tid], (tid, table.shape[0])


def _gather_rows_bwd(res, ct):
    tid, T = res
    return jax.ops.segment_sum(ct, tid, num_segments=T), None


gather_rows.defvjp(_gather_rows_fwd, _gather_rows_bwd)


_MAT0 = 24  # material block offset in the packed row


def _unpack_material(rows):
    from cadrays_tpu.core.bsdf import Material

    b = _MAT0

    def seg(k):
        nonlocal b
        out = rows[:, b:b + k]
        b += k
        return out

    return Material(
        kc=seg(3), kd=seg(3), ks=seg(3), kt=seg(3), le=seg(3),
        base_rough=seg(1)[:, 0], coat_rough=seg(1)[:, 0],
        absorp_color=seg(3), absorp_coeff=seg(1)[:, 0],
        base_ftype=seg(1)[:, 0].astype(jnp.int32), base_fparams=seg(4),
        coat_ftype=seg(1)[:, 0].astype(jnp.int32), coat_fparams=seg(4),
        tex_id=seg(1)[:, 0].astype(jnp.int32),
        ks_tex_id=seg(1)[:, 0].astype(jnp.int32), uv_scale=seg(1)[:, 0],
    )


def hit_attributes_packed(geom: GeometryData, table, origin, direction, tri):
    """Same contract as `hit_attributes` (minus mat_id) plus the gathered
    per-ray `Material` — all from one row gather of `table`."""
    hit = tri >= 0
    tid = jnp.maximum(tri, 0)
    from jax.ad_checkpoint import checkpoint_name

    # THE gather: one (R, C) row lookup. Saved as a remat residual
    # ("trace" policy, integrator/wavefront.py), so the backward reads
    # it back instead of gathering again.
    rows = checkpoint_name(gather_rows(table, tid), "trace")
    p0 = rows[:, 0:3]
    e1 = rows[:, 3:6]
    e2 = rows[:, 6:9]
    n0 = rows[:, 9:12]
    n1 = rows[:, 12:15]
    n2 = rows[:, 15:18]
    uv0 = rows[:, 18:20]
    uv1 = rows[:, 20:22]
    uv2 = rows[:, 22:24]
    mat = _unpack_material(rows)

    if geom.instanced:
        inst = rows[:, -1].astype(jnp.int32)
        inv = geom.inst_inv[inst]  # (R, 3, 4)
        lin = inv[..., :3]
        o_l = jnp.einsum("rij,rj->ri", lin, origin, precision="float32") + inv[..., 3]
        d_l = jnp.einsum("rij,rj->ri", lin, direction, precision="float32")
    else:
        o_l, d_l = origin, direction

    pvec = jnp.cross(d_l, e2)
    det = vm.dot(e1, pvec)
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-12, det, 1.0)
    tvec = o_l - p0
    u = vm.dot(tvec, pvec) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = vm.dot(d_l, qvec) * inv_det
    t = vm.dot(e2, qvec) * inv_det
    u = jnp.clip(u, 0.0, 1.0)
    v = jnp.clip(v, 0.0, 1.0)
    w = jnp.clip(1.0 - u - v, 0.0, 1.0)

    position = origin + direction * t[..., None]

    n_geom_l = jnp.cross(e1, e2)
    n_shade_l = w[..., None] * n0 + u[..., None] * n1 + v[..., None] * n2

    if geom.instanced:
        n_geom = vm.normalize(jnp.einsum("rj,rji->ri", n_geom_l, lin, precision="float32"))
        n_shade = vm.normalize(jnp.einsum("rj,rji->ri", n_shade_l, lin, precision="float32"))
    else:
        n_geom = vm.normalize(n_geom_l)
        n_shade = vm.normalize(n_shade_l)

    n_shade = jnp.where(
        vm.dot(n_shade, n_geom, keepdims=True) < 0.0, -n_shade, n_shade
    )
    uv = w[..., None] * uv0 + u[..., None] * uv1 + v[..., None] * uv2

    front = vm.dot(direction, n_geom) < 0.0
    flip = jnp.where(front, 1.0, -1.0)[..., None]
    return {
        "hit": hit,
        "t": t,
        "position": position,
        "n_geom": n_geom * flip,
        "n_shade": n_shade * flip,
        "uv": uv,
        "front": front,
    }, mat
