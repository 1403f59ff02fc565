"""Stackless threaded-BVH traversal of a ray wavefront.

Two implementations walk the same skip-link tree (see geometry/bvh.py for
the layout) over the same packed tables (GeometryData.nodes_packed (N, 8):
box + skip + leaf bits in one row; tris_packed (T, 12): p0/e1/e2 — see
scene/flatten.py), in the same order, with the same tie-breaks:

* `trace_gather`: plain JAX. One `lax.while_loop` steps every ray in
  lockstep, one node-row gather plus up to MAX_LEAF triangle-row gathers
  per step. It is the reference and the CPU path.
* `ops.traverse_cuda.trace_cuda`: the GPU path, a CUDA kernel that runs
  one thread per ray and lets each thread exit when its ray is done.

Hit topology (triangle ids) is integer output — naturally
non-differentiable; differentiable hit attributes are recomputed from the
ids in ops/hit.py, which is where gradients flow.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from cadrays_tpu.ops.intersect import INF, safe_inv_dir
from cadrays_tpu.scene.flatten import GeometryData

MAX_LEAF = 4  # must match geometry/bvh.py build

_EPS = 1e-7
# Conservative slab widening (robust BVH traversal): lowering-dependent
# rounding (fusion/reassociation varies with array shape) can flip a
# grazing box test, losing a closer hit one walker finds. Shrinking
# t_near / growing t_far by ~4 ulp makes every walker a conservative
# superset of the exact test — a few false-positive leaf tests, never a
# lost hit. The CUDA kernel applies the same widening.
_BOX_SHRINK = 1.0 - 4e-7
_BOX_GROW = 1.0 + 4e-7
_LEAF_MASK = (1 << 24) - 1


def _tri_intersect_packed(origin, direction, trow):
    """Moller-Trumbore against a packed triangle row [p0|e1|e2|...]."""
    p0 = trow[..., 0:3]
    e1 = trow[..., 3:6]
    e2 = trow[..., 6:9]
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
        & (u >= -_EPS)
        & (v >= -_EPS)
        & (u + v <= 1.0 + _EPS)
        & (t > _EPS)
    )
    return jnp.where(hit, t, INF), u, v, hit


def tracer_for(platform: str):
    """The traversal for a JAX platform: the CUDA kernel on "gpu", the
    gather walk on "cpu". Any other platform has none and raises."""
    if platform == "gpu":
        from cadrays_tpu.ops.traverse_cuda import trace_cuda

        return trace_cuda
    if platform == "cpu":
        return trace_gather
    raise NotImplementedError(f"no ray traversal for platform {platform!r}")


def trace(geom: GeometryData, origin, direction, t_max,
          any_hit: bool = False):
    """Trace a wavefront of rays against the scene.

    origin/direction: (R, 3); t_max: (R,).
    Returns dict: t (R,), tri (R,) int32 (-1 miss), u, v (R,).
    With any_hit=True, lanes stop at the first hit (occlusion query) —
    `tri >= 0` then means "occluded", t/u/v are that first hit's.

    Dispatch is by JAX's default platform (`tracer_for`): the per-ray
    CUDA kernel on a GPU, `trace_gather` on the CPU. Both walk the same
    tree in the same order and return the same hits.
    """
    # Traversal is intentionally non-differentiable (detached topology;
    # ops/hit.py recomputes continuous quantities). Detaching the inputs
    # keeps autodiff out of the kernel entirely (it has no JVP rule).
    sg = jax.lax.stop_gradient
    geom_, origin_, direction_, t_max_ = sg((geom, origin, direction, t_max))
    return tracer_for(jax.default_backend())(geom_, origin_, direction_,
                                             t_max_, any_hit=any_hit)


def _coherence_key(geom: GeometryData, origin, direction):
    """Sort key: 3-bit direction octant | 12-bit origin Morton cell."""
    root_lo = geom.nodes_packed[0, 0:3]
    root_hi = geom.nodes_packed[0, 3:6]
    extent = jnp.maximum(root_hi - root_lo, 1e-6)
    q = jnp.clip((origin - root_lo) / extent, 0.0, 0.999)
    cell = (q * 16.0).astype(jnp.int32)  # 4 bits per axis
    morton = _interleave4(cell[:, 0]) | (_interleave4(cell[:, 1]) << 1) \
        | (_interleave4(cell[:, 2]) << 2)
    octant = ((direction[:, 0] >= 0).astype(jnp.int32)
              | ((direction[:, 1] >= 0).astype(jnp.int32) << 1)
              | ((direction[:, 2] >= 0).astype(jnp.int32) << 2))
    return (octant << 12) | morton


def _interleave4(x):
    """Spread 4 bits of x to every 3rd bit (Morton component)."""
    x = x & 0xF
    x = (x | (x << 4)) & 0x0C3
    x = (x | (x << 2)) & 0x249
    return x


@partial(jax.jit, static_argnames=("any_hit",))
def trace_gather(geom: GeometryData, origin, direction, t_max,
                 any_hit: bool = False):
    """Per-ray divergent traversal (one node-row gather per ray per step)."""
    R = origin.shape[0]
    inv_dir = safe_inv_dir(direction)
    nodes = geom.nodes_packed
    tris = geom.tris_packed

    state = dict(
        node=jnp.zeros(R, jnp.int32),
        t=jnp.minimum(jnp.broadcast_to(t_max, (R,)), INF),
        tri=jnp.full(R, -1, jnp.int32),
        u=jnp.zeros(R, jnp.float32),
        v=jnp.zeros(R, jnp.float32),
    )

    def cond(s):
        return jnp.any(s["node"] >= 0)

    def body(s):
        node = jnp.maximum(s["node"], 0)  # clamp finished lanes
        alive = s["node"] >= 0

        row = nodes[node]  # (R, 8) — single gather
        bmin = row[:, 0:3]
        bmax = row[:, 3:6]
        skip = jax.lax.bitcast_convert_type(row[:, 6], jnp.int32)
        leafbits = jax.lax.bitcast_convert_type(row[:, 7], jnp.int32)
        is_leaf = leafbits >= 0
        first = leafbits & _LEAF_MASK
        count = jnp.where(is_leaf, leafbits >> 24, 0)
        descend_to = -leafbits - 2  # valid when not leaf

        if geom.instanced:
            inst = geom.node_inst[node]  # (R,)
            inv = geom.inst_inv[jnp.maximum(inst, 0)]  # (R, 3, 4)
            world = (inst < 0)[:, None]
            o_l = jnp.where(
                world, origin,
                jnp.einsum("rij,rj->ri", inv[:, :, :3], origin, precision="float32")
                + inv[:, :, 3])
            d_l = jnp.where(
                world, direction,
                jnp.einsum("rij,rj->ri", inv[:, :, :3], direction, precision="float32"))
            inv_d_l = safe_inv_dir(d_l)
        else:
            o_l, d_l, inv_d_l = origin, direction, inv_dir

        # slab test against the current best t
        t0 = (bmin - o_l) * inv_d_l
        t1 = (bmax - o_l) * inv_d_l
        t_near = jnp.max(jnp.minimum(t0, t1), axis=-1) * _BOX_SHRINK
        t_far = jnp.min(jnp.maximum(t0, t1), axis=-1) * _BOX_GROW
        hit_box = (jnp.maximum(t_near, 0.0) <= jnp.minimum(t_far, s["t"])) \
            & alive
        at_leaf = hit_box & is_leaf

        # --- leaf: test up to MAX_LEAF triangles (masked unroll) ---------
        t_best, tri_best, u_best, v_best = s["t"], s["tri"], s["u"], s["v"]
        for k in range(MAX_LEAF):
            tid = first + k
            live = at_leaf & (k < count)
            tid_c = jnp.where(live, tid, 0)
            t, u, v, hit = _tri_intersect_packed(o_l, d_l, tris[tid_c])
            better = live & hit & (t < t_best)
            t_best = jnp.where(better, t, t_best)
            tri_best = jnp.where(better, tid_c, tri_best)
            u_best = jnp.where(better, u, u_best)
            v_best = jnp.where(better, v, v_best)

        # --- next node ---------------------------------------------------
        go_down = hit_box & (~is_leaf)
        nxt = jnp.where(go_down, descend_to, skip)
        nxt = jnp.where(alive, nxt, -1)
        if any_hit:
            nxt = jnp.where(tri_best >= 0, -1, nxt)

        return dict(node=nxt, t=t_best, tri=tri_best, u=u_best, v=v_best)

    out = jax.lax.while_loop(cond, body, state)
    return {"t": out["t"], "tri": out["tri"], "u": out["u"], "v": out["v"]}


def occluded(geom: GeometryData, origin, direction, t_max):
    """Boolean shadow query along (origin, direction) up to t_max."""
    res = trace(geom, origin, direction, t_max, any_hit=True)
    return res["tri"] >= 0
