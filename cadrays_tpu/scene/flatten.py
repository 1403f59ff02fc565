"""Scene flattening: host scene graph -> device SoA pytree (SceneData).

The device consumes one flat, statically-shaped pytree: world-space triangle
soup reordered by the threaded BVH, a material table, light table, texture
atlas, environment CDFs and an emissive-triangle table. This mirrors what
the reference uploads to the GPU per frame (triangle arrays via
Graphic3d_ArrayOfTriangles, AisMesh.cxx:357-423; materials/lights via
Graphic3d_BSDF / V3d_Light), but as one functional snapshot: scene edits
produce a *new* SceneData, which is what makes accumulation-restart
hashing and jit caching trivial.
"""
from __future__ import annotations

from typing import Optional, Sequence

from cadrays_tpu.utils import struct
import jax.numpy as jnp
import numpy as np

from cadrays_tpu.core.bsdf import Material, concat_materials
from cadrays_tpu.core.lights import Lights, empty_lights
from cadrays_tpu.core.vecmath import luminance
from cadrays_tpu.geometry.bvh import build_bvh
from cadrays_tpu.geometry.mesh import TriangleMesh


@struct.dataclass
class GeometryData:
    """World-space triangle soup + threaded BVH (SoA, device-resident).

    Besides the canonical SoA fields, two *packed* row-gather arrays are
    kept for the traversal hot loop (one row read per node or triangle
    instead of five):
      nodes_packed (N, 8) f32: [min xyz | max xyz | bitcast(skip) |
                                bitcast(leafbits)]
        leafbits >= 0: leaf, first | count<<24
        leafbits <  0: inner, descend target = -leafbits - 2
                       (plain DFS inner nodes: descend == node + 1;
                        two-level TLAS->BLAS bridge nodes jump to the
                        instance's BLAS root)
      tris_packed  (T, 12) f32: [p0 xyz | e1 xyz | e2 xyz |
                                 bitcast(mat_id) | pad | pad]

    Two-level instancing (scene/instances.py): triangles/vertices/normals
    are in *object* space, `tri_inst`/`node_inst` map geometry to
    instances, and `inst_inv` holds world->object affine transforms.
    `instanced=False` (baked world-space scene) statically skips every
    per-instance transform in the hot loops.
    """

    vertices: jnp.ndarray  # (V, 3) f32
    normals: jnp.ndarray  # (V, 3) f32 (shading normals)
    uvs: jnp.ndarray  # (V, 2) f32
    tri_v: jnp.ndarray  # (T, 3) i32 — BVH-reordered
    tri_mat: jnp.ndarray  # (T,) i32
    bvh_min: jnp.ndarray  # (N, 3) f32
    bvh_max: jnp.ndarray  # (N, 3) f32
    bvh_skip: jnp.ndarray  # (N,) i32
    bvh_first: jnp.ndarray  # (N,) i32
    bvh_count: jnp.ndarray  # (N,) i32
    nodes_packed: jnp.ndarray  # (N, 8) f32
    tris_packed: jnp.ndarray  # (T, 12) f32
    # --- two-level instancing (identity defaults for baked scenes) ------
    node_inst: jnp.ndarray = struct.field(
        default_factory=lambda: jnp.full((1,), -1, jnp.int32))  # (N,) i32
    tri_inst: jnp.ndarray = struct.field(
        default_factory=lambda: jnp.zeros((1,), jnp.int32))  # (T,) i32
    inst_inv: jnp.ndarray = struct.field(
        default_factory=lambda: jnp.eye(3, 4, dtype=jnp.float32)[None])
    # (I, 3, 4) world->object
    inst_tf: jnp.ndarray = struct.field(
        default_factory=lambda: jnp.eye(3, 4, dtype=jnp.float32)[None])
    # (I, 3, 4) object->world
    instanced: bool = struct.field(pytree_node=False, default=False)

    @property
    def num_triangles(self) -> int:
        return self.tri_v.shape[0]


def pack_geometry(vertices: np.ndarray, tri_v: np.ndarray,
                  tri_mat: np.ndarray, bvh) -> tuple:
    """Build the packed traversal tables (see GeometryData docstring)."""
    N = bvh.skip.shape[0]
    T = tri_v.shape[0]
    assert T < (1 << 24), "triangle count exceeds packed-first limit"
    nodes = np.zeros((N, 8), np.float32)
    nodes[:, 0:3] = bvh.node_min
    nodes[:, 3:6] = bvh.node_max
    nodes[:, 6] = bvh.skip.astype(np.int32).view(np.float32)
    descend = np.arange(N, dtype=np.int64) + 1  # DFS: left child follows
    leafbits = np.where(
        bvh.count > 0,
        bvh.first.astype(np.int64) | (bvh.count.astype(np.int64) << 24),
        -descend - 2,
    ).astype(np.int32)
    nodes[:, 7] = leafbits.view(np.float32)

    tris = np.zeros((max(T, 1), 12), np.float32)
    if T:
        p0 = vertices[tri_v[:, 0]]
        p1 = vertices[tri_v[:, 1]]
        p2 = vertices[tri_v[:, 2]]
        tris[:T, 0:3] = p0
        tris[:T, 3:6] = p1 - p0
        tris[:T, 6:9] = p2 - p0
        tris[:T, 9] = tri_mat.astype(np.int32).view(np.float32)
    return nodes, tris


@struct.dataclass
class EnvMapData:
    """Lat-long environment map + luminance CDFs for importance sampling.

    Contract: `vtextureenv on <image>` + UseEnvironmentMapBackground
    (LightSourcesEditor.cxx:317-369, AppGui.cxx:963)."""

    image: jnp.ndarray  # (H, W, 3) f32 linear radiance
    marginal_cdf: jnp.ndarray  # (H,) f32
    conditional_cdf: jnp.ndarray  # (H, W) f32
    pdf_map: jnp.ndarray  # (H, W) f32 — solid-angle pdf of sampling texel
    intensity: jnp.ndarray  # scalar multiplier (differentiable)
    enabled: bool = struct.field(pytree_node=False, default=False)
    background: bool = struct.field(pytree_node=False, default=True)


@struct.dataclass
class EmissiveData:
    """Area-light table: triangles with Le > 0, sampled by power."""

    tri_idx: jnp.ndarray  # (E,) i32 -> index into tri arrays
    cdf: jnp.ndarray  # (E,) f32 cumulative power
    area: jnp.ndarray  # (E,) f32
    total_power: jnp.ndarray  # scalar f32
    count: int = struct.field(pytree_node=False, default=0)


@struct.dataclass
class TextureAtlas:
    image: jnp.ndarray  # (A, A, 3) f32
    rect: jnp.ndarray  # (Ntex, 4) f32: u0, v0, du, dv (normalized)
    enabled: bool = struct.field(pytree_node=False, default=False)


@struct.dataclass
class SceneData:
    geometry: GeometryData
    materials: Material
    lights: Lights
    envmap: EnvMapData
    emissive: EmissiveData
    textures: TextureAtlas
    # Scene mutation counter (stamped by Scene.flatten): accumulation
    # restart keys on it instead of hashing geometry content per frame.
    # -1 = unstamped snapshot -> fingerprint falls back to content hash.
    version: int = struct.field(pytree_node=False, default=-1)


# ---------------------------------------------------------------------------


def _empty_envmap() -> EnvMapData:
    return EnvMapData(
        image=jnp.zeros((1, 1, 3), jnp.float32),
        marginal_cdf=jnp.ones((1,), jnp.float32),
        conditional_cdf=jnp.ones((1, 1), jnp.float32),
        pdf_map=jnp.full((1, 1), 1.0 / (4.0 * np.pi), jnp.float32),
        intensity=jnp.float32(1.0),
        enabled=False,
        background=True,
    )


def build_envmap(image: np.ndarray, intensity: float = 1.0,
                 background: bool = True) -> EnvMapData:
    """Precompute sampling CDFs for a lat-long radiance map."""
    img = np.asarray(image, np.float32)
    H, W, _ = img.shape
    lum = img @ np.float32([0.2126, 0.7152, 0.0722])
    theta = (np.arange(H, dtype=np.float32) + 0.5) / H * np.pi
    weight = lum * np.sin(theta)[:, None] + 1e-8
    row_sum = weight.sum(axis=1)
    marginal = np.cumsum(row_sum)
    total = marginal[-1]
    marginal /= total
    conditional = np.cumsum(weight, axis=1)
    conditional /= conditional[:, -1:]
    # pdf of picking texel (r, c) in *texel* measure:
    texel_p = weight / total
    # solid angle of a texel: (2pi/W) * (pi/H) * sin(theta)
    omega = (2.0 * np.pi / W) * (np.pi / H) * np.maximum(np.sin(theta), 1e-6)
    pdf_map = texel_p / omega[:, None]
    return EnvMapData(
        image=jnp.asarray(img),
        marginal_cdf=jnp.asarray(marginal.astype(np.float32)),
        conditional_cdf=jnp.asarray(conditional.astype(np.float32)),
        pdf_map=jnp.asarray(pdf_map.astype(np.float32)),
        intensity=jnp.float32(intensity),
        enabled=True,
        background=background,
    )


def _empty_textures() -> TextureAtlas:
    return TextureAtlas(
        image=jnp.zeros((1, 1, 3), jnp.float32),
        rect=jnp.zeros((1, 4), jnp.float32),
        enabled=False,
    )


def build_texture_atlas(images: Sequence[np.ndarray]) -> TextureAtlas:
    """Pack textures into one square atlas (simple shelf packing).

    Returns an atlas whose `rect[i]` maps texture i's [0,1]^2 UVs into
    atlas coordinates. Textures are stored linearly (callers convert from
    sRGB on load).
    """
    if not images:
        return _empty_textures()
    imgs = [np.asarray(im, np.float32) for im in images]
    # shelf pack, sorted by height
    order = sorted(range(len(imgs)), key=lambda i: -imgs[i].shape[0])
    max_w = max(im.shape[1] for im in imgs)
    atlas_w = max(int(2 ** np.ceil(np.log2(max_w))), 64)
    shelves = []  # (y, height, x_used)
    pos = [None] * len(imgs)
    y_used = 0
    for i in order:
        h, w = imgs[i].shape[:2]
        placed = False
        for s in shelves:
            if s[1] >= h and s[2] + w <= atlas_w:
                pos[i] = (s[2], s[0])
                s[2] += w
                placed = True
                break
        if not placed:
            shelves.append([y_used, h, w])
            pos[i] = (0, y_used)
            y_used += h
    atlas_h = int(2 ** np.ceil(np.log2(max(y_used, 1))))
    atlas = np.zeros((atlas_h, atlas_w, 3), np.float32)
    rect = np.zeros((len(imgs), 4), np.float32)
    for i, im in enumerate(imgs):
        x, y = pos[i]
        h, w = im.shape[:2]
        atlas[y:y + h, x:x + w] = im[..., :3]
        rect[i] = [x / atlas_w, y / atlas_h, w / atlas_w, h / atlas_h]
    return TextureAtlas(image=jnp.asarray(atlas), rect=jnp.asarray(rect),
                        enabled=True)


def flatten_parts(
    meshes: Sequence[TriangleMesh],
    materials: Sequence[Material],
    mat_ids: Sequence[int],
    lights: Optional[Lights] = None,
    envmap: Optional[EnvMapData] = None,
    textures: Optional[TextureAtlas] = None,
) -> SceneData:
    """Assemble SceneData from world-space meshes.

    meshes[i] uses material index mat_ids[i] into `materials`.
    """
    if not meshes:
        raise ValueError("cannot flatten an empty scene")
    parts = []
    for mesh, mid in zip(meshes, mat_ids):
        m = mesh
        if m.normals is None:
            m = TriangleMesh(m.vertices, m.indices, None, m.uvs)
            m.compute_vertex_normals()
        uv = m.uvs if m.uvs is not None else np.zeros((m.num_vertices, 2), np.float32)
        parts.append((m.vertices, m.indices, m.normals, uv,
                      np.full(m.num_triangles, mid, np.int32)))

    off = 0
    vs, idx, ns, uvs, mats = [], [], [], [], []
    for v, i, n, uv, mm in parts:
        vs.append(v)
        idx.append(i + off)
        ns.append(n)
        uvs.append(uv)
        mats.append(mm)
        off += v.shape[0]
    vertices = np.concatenate(vs)
    indices = np.concatenate(idx)
    normals = np.concatenate(ns)
    uv_all = np.concatenate(uvs)
    tri_mat = np.concatenate(mats)

    bvh = build_bvh(vertices, indices)
    tri_v = indices[bvh.order]
    tri_mat = tri_mat[bvh.order]
    nodes_packed, tris_packed = pack_geometry(vertices, tri_v, tri_mat, bvh)

    geom = GeometryData(
        vertices=jnp.asarray(vertices),
        normals=jnp.asarray(normals),
        uvs=jnp.asarray(uv_all),
        tri_v=jnp.asarray(tri_v),
        tri_mat=jnp.asarray(tri_mat),
        bvh_min=jnp.asarray(bvh.node_min),
        bvh_max=jnp.asarray(bvh.node_max),
        bvh_skip=jnp.asarray(bvh.skip),
        bvh_first=jnp.asarray(bvh.first),
        bvh_count=jnp.asarray(bvh.count),
        nodes_packed=jnp.asarray(nodes_packed),
        tris_packed=jnp.asarray(tris_packed),
    )

    mat_table = concat_materials(list(materials))
    emissive = _build_emissive(vertices, tri_v, tri_mat, mat_table)

    return SceneData(
        geometry=geom,
        materials=_to_device(mat_table),
        lights=_to_device(lights if lights is not None else empty_lights()),
        envmap=envmap if envmap is not None else _empty_envmap(),
        emissive=emissive,
        textures=textures if textures is not None else _empty_textures(),
    )


def _to_device(tree):
    import jax

    return jax.tree.map(jnp.asarray, tree)


def _build_emissive(vertices: np.ndarray, tri_v: np.ndarray,
                    tri_mat: np.ndarray, mats: Material) -> EmissiveData:
    le = np.asarray(mats.le)
    lum = le @ np.float32([0.2126, 0.7152, 0.0722])
    tri_lum = lum[np.asarray(tri_mat)]
    p0 = vertices[tri_v[:, 0]]
    p1 = vertices[tri_v[:, 1]]
    p2 = vertices[tri_v[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=-1)
    power = tri_lum * area
    sel = np.nonzero(power > 0.0)[0]
    if sel.size == 0:
        return EmissiveData(
            tri_idx=jnp.zeros((1,), jnp.int32),
            cdf=jnp.ones((1,), jnp.float32),
            area=jnp.ones((1,), jnp.float32),
            total_power=jnp.float32(0.0),
            count=0,
        )
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

