"""Two-level BVH: per-mesh BLAS + TLAS over instances.

Capability contract: the reference's engine keeps "per-object BLAS +
scene TLAS rebuilt on transforms" [OCCT-contract, SURVEY.md §2.5]. Here:

* each unique mesh gets one BLAS in *object* space (cached across
  flattens, built natively);
* the TLAS is built over world-space instance AABBs (max_leaf = 1);
* the two levels are fused into ONE threaded node array so the stream
  traversal stays a single loop: every TLAS leaf becomes a "bridge"
  node whose descend pointer jumps to its instance's BLAS root, and the
  BLAS exit-skips are rewired to the bridge's skip. `node_inst` tags
  each node with its instance (-1 for TLAS/world), and the traversal
  transforms block rays into object space with `inst_inv` (direction
  left unnormalized so t stays world-parameterized).

Editing a transform therefore rebuilds only the TLAS + fixups (O(#inst)),
not the meshes' BVHs — the property that makes interactive manipulation
(gizmo drags, rtrotate) cheap on big CAD scenes.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from cadrays_tpu.core.bsdf import Material, concat_materials
from cadrays_tpu.core.lights import Lights, empty_lights
from cadrays_tpu.geometry.bvh import ThreadedBVH, build_bvh
from cadrays_tpu.geometry.mesh import TriangleMesh
from cadrays_tpu.scene.flatten import (
    EmissiveData,
    EnvMapData,
    GeometryData,
    SceneData,
    TextureAtlas,
    _empty_envmap,
    _empty_textures,
    _to_device,
)

def _mesh_blas(mesh: TriangleMesh):
    """BLAS + reordered object-space arrays, cached ON the mesh object
    (an id()-keyed global cache would go stale when a freed mesh's id is
    recycled — the cache must share the mesh's lifetime)."""
    key = (id(mesh.vertices), id(mesh.indices))
    cached = getattr(mesh, "_blas_cache", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    m = mesh
    if m.normals is None:
        m.compute_vertex_normals()
    uv = m.uvs if m.uvs is not None else np.zeros((m.num_vertices, 2),
                                                  np.float32)
    bvh = build_bvh(m.vertices, m.indices)
    out = (bvh, m.vertices, m.normals, uv, m.indices[bvh.order])
    mesh._blas_cache = (key, out)
    return out


def _transform_aabb(lo, hi, m):
    """Exact AABB of a transformed AABB (per-axis corner extremes)."""
    lin = m[:3, :3]
    t = m[:3, 3]
    c = (lo + hi) * 0.5
    e = (hi - lo) * 0.5
    center = lin @ c + t
    extent = np.abs(lin) @ e
    return center - extent, center + extent


def build_instanced(
    meshes: Sequence[TriangleMesh],
    transforms: Sequence[np.ndarray],
    materials: Sequence[Material],
    mat_ids: Sequence[int],
    lights: Optional[Lights] = None,
    envmap: Optional[EnvMapData] = None,
    textures: Optional[TextureAtlas] = None,
) -> SceneData:
    """Assemble a two-level SceneData; meshes[i] is instanced with
    transforms[i] (4x4 world matrix) and material mat_ids[i]."""
    n_inst = len(meshes)
    if n_inst == 0:
        raise ValueError("cannot flatten an empty scene")

    # BLAS per UNIQUE mesh object (assemblies repeat parts; the SAH tree
    # is built once per distinct mesh)
    _blas_cache: dict = {}

    def _blas_of(m):
        k = id(m)
        if k not in _blas_cache:
            _blas_cache[k] = _mesh_blas(m)
        return _blas_cache[k]

    blases = [_blas_of(m) for m in meshes]

    # ---- instance world AABBs + TLAS (leaf = 1 instance) ---------------
    inst_lo = np.zeros((n_inst, 3), np.float32)
    inst_hi = np.zeros((n_inst, 3), np.float32)
    for i, (bvh, *_rest) in enumerate(blases):
        inst_lo[i], inst_hi[i] = _transform_aabb(
            bvh.node_min[0], bvh.node_max[0],
            np.asarray(transforms[i], np.float32))
    # build the TLAS with the triangle SAH builder over degenerate
    # "triangles" at box corners? No — dedicated box build via the python
    # builder on virtual triangles is wasteful; reuse build over boxes by
    # synthesizing two corner points per box as a degenerate triangle.
    tlas = _build_tlas(inst_lo, inst_hi)

    # ---- fuse node arrays ----------------------------------------------
    Nt = tlas.skip.shape[0]
    blas_sizes = [b[0].skip.shape[0] for b in blases]
    tri_counts = [b[4].shape[0] for b in blases]
    # order BLAS copies by TLAS leaf order (= tlas.order)
    inst_order = tlas.order  # instance i at leaf position
    blas_offset = {}
    off = Nt
    tri_off = {}
    toff = 0
    voff = {}
    vo = 0
    for inst in inst_order:
        blas_offset[int(inst)] = off
        off += blas_sizes[int(inst)]
        tri_off[int(inst)] = toff
        toff += tri_counts[int(inst)]
        voff[int(inst)] = vo
        vo += blases[int(inst)][1].shape[0]
    N = off
    T = toff
    V = vo

    node_min = np.zeros((N, 3), np.float32)
    node_max = np.zeros((N, 3), np.float32)
    skip = np.full(N, -1, np.int32)
    descend = np.zeros(N, np.int64)
    first = np.full(N, -1, np.int32)
    count = np.zeros(N, np.int32)
    node_inst = np.full(N, -1, np.int32)

    # TLAS portion
    node_min[:Nt] = tlas.node_min
    node_max[:Nt] = tlas.node_max
    skip[:Nt] = tlas.skip
    descend[:Nt] = np.arange(Nt) + 1
    # TLAS leaves -> bridge nodes
    leaf_mask = tlas.count > 0
    leaf_ids = np.nonzero(leaf_mask)[0]
    for ln in leaf_ids:
        inst = int(tlas.order[tlas.first[ln]])  # leaf holds one instance
        descend[ln] = blas_offset[inst]
    # mark TLAS leaves as inner (bridge): count=0, first=-1 already

    vertices = np.zeros((V, 3), np.float32)
    normals = np.zeros((V, 3), np.float32)
    uvs = np.zeros((V, 2), np.float32)
    tri_v = np.zeros((T, 3), np.int32)
    tri_mat = np.zeros(T, np.int32)
    tri_inst = np.zeros(T, np.int32)

    for inst in inst_order:
        inst = int(inst)
        bvh, v, nrm, uv, tv = blases[inst]
        o = blas_offset[inst]
        n = blas_sizes[inst]
        to = tri_off[inst]
        tc = tri_counts[inst]
        vo2 = voff[inst]
        node_min[o:o + n] = bvh.node_min
        node_max[o:o + n] = bvh.node_max
        # the bridge node that jumps here:
        bridge = [ln for ln in leaf_ids
                  if int(tlas.order[tlas.first[ln]]) == inst][0]
        exit_skip = tlas.skip[bridge]
        skip[o:o + n] = np.where(bvh.skip >= 0, bvh.skip + o, exit_skip)
        descend[o:o + n] = np.arange(o, o + n) + 1
        leaf = bvh.count > 0
        first[o:o + n] = np.where(leaf, bvh.first + to, -1)
        count[o:o + n] = bvh.count
        node_inst[o:o + n] = inst
        vertices[vo2:vo2 + v.shape[0]] = v
        normals[vo2:vo2 + v.shape[0]] = nrm
        uvs[vo2:vo2 + v.shape[0]] = uv
        tri_v[to:to + tc] = tv + vo2
        tri_mat[to:to + tc] = mat_ids[inst]
        tri_inst[to:to + tc] = inst

    # ---- packed tables --------------------------------------------------
    assert T < (1 << 24)
    nodes_packed = np.zeros((N, 8), np.float32)
    nodes_packed[:, 0:3] = node_min
    nodes_packed[:, 3:6] = node_max
    nodes_packed[:, 6] = skip.view(np.float32)
    leafbits = np.where(count > 0,
                        first.astype(np.int64)
                        | (count.astype(np.int64) << 24),
                        -descend - 2).astype(np.int32)
    nodes_packed[:, 7] = leafbits.view(np.float32)

    tris_packed = np.zeros((max(T, 1), 12), np.float32)
    p0 = vertices[tri_v[:, 0]]
    p1 = vertices[tri_v[:, 1]]
    p2 = vertices[tri_v[:, 2]]
    tris_packed[:T, 0:3] = p0
    tris_packed[:T, 3:6] = p1 - p0
    tris_packed[:T, 6:9] = p2 - p0
    tris_packed[:T, 9] = tri_mat.view(np.float32)

    inst_inv = np.zeros((n_inst, 3, 4), np.float32)
    inst_tf = np.zeros((n_inst, 3, 4), np.float32)
    for i, tf in enumerate(transforms):
        m = np.asarray(tf, np.float64)
        inst_inv[i] = np.linalg.inv(m)[:3, :4].astype(np.float32)
        inst_tf[i] = m[:3, :4].astype(np.float32)

    geom = GeometryData(
        vertices=jnp.asarray(vertices),
        normals=jnp.asarray(normals),
        uvs=jnp.asarray(uvs),
        tri_v=jnp.asarray(tri_v),
        tri_mat=jnp.asarray(tri_mat),
        bvh_min=jnp.asarray(node_min),
        bvh_max=jnp.asarray(node_max),
        bvh_skip=jnp.asarray(skip),
        bvh_first=jnp.asarray(first),
        bvh_count=jnp.asarray(count),
        nodes_packed=jnp.asarray(nodes_packed),
        tris_packed=jnp.asarray(tris_packed),
        node_inst=jnp.asarray(node_inst),
        tri_inst=jnp.asarray(tri_inst),
        inst_inv=jnp.asarray(inst_inv),
        inst_tf=jnp.asarray(inst_tf),
        instanced=True,
    )

    mat_table = concat_materials(list(materials))
    emissive = _build_emissive_instanced(vertices, tri_v, tri_mat, tri_inst,
                                         transforms, mat_table)
    return SceneData(
        geometry=geom,
        materials=_to_device(mat_table),
        lights=_to_device(lights if lights is not None else empty_lights()),
        envmap=envmap if envmap is not None else _empty_envmap(),
        emissive=emissive,
        textures=textures if textures is not None else _empty_textures(),
    )


def _build_tlas(lo: np.ndarray, hi: np.ndarray) -> ThreadedBVH:
    """SAH build over instance boxes using degenerate triangles whose
    AABBs equal the instance boxes (diagonal corner triple)."""
    n = lo.shape[0]
    verts = np.zeros((2 * n, 3), np.float32)
    verts[0::2] = lo
    verts[1::2] = hi
    tris = np.stack([np.arange(n) * 2, np.arange(n) * 2 + 1,
                     np.arange(n) * 2], axis=1).astype(np.int32)
    return build_bvh(verts, tris, max_leaf=1, backend="python")


def _build_emissive_instanced(vertices, tri_v, tri_mat, tri_inst,
                              transforms, mats: Material) -> EmissiveData:
    le = np.asarray(mats.le)
    lum = le @ np.float32([0.2126, 0.7152, 0.0722])
    tri_lum = lum[np.asarray(tri_mat)]
    if not np.any(tri_lum > 0):
        return EmissiveData(
            tri_idx=jnp.zeros((1,), jnp.int32),
            cdf=jnp.ones((1,), jnp.float32),
            area=jnp.ones((1,), jnp.float32),
            total_power=jnp.float32(0.0),
            count=0,
        )
    # world-space areas: transform the emissive triangles
    tfs = np.stack([np.asarray(t, np.float32) for t in transforms])
    lin = tfs[tri_inst][:, :3, :3]  # (T, 3, 3)
    p0 = np.einsum("tij,tj->ti", lin, vertices[tri_v[:, 0]])
    p1 = np.einsum("tij,tj->ti", lin, vertices[tri_v[:, 1]])
    p2 = np.einsum("tij,tj->ti", lin, vertices[tri_v[:, 2]])
    area = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=-1)
    power = tri_lum * area
    sel = np.nonzero(power > 0.0)[0]
    p = power[sel]
    cdf = np.cumsum(p)
    total = cdf[-1]
    return EmissiveData(
        tri_idx=jnp.asarray(sel.astype(np.int32)),
        cdf=jnp.asarray((cdf / total).astype(np.float32)),
        area=jnp.asarray(area[sel].astype(np.float32)),
        total_power=jnp.float32(total),
        count=int(sel.size),
    )
