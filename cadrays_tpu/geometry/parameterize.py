"""UV parameterization of CAD shapes and triangle soups.

Capability contract (reference): `DataNode::Parameterize`
(/root/reference/src/ImportExport/DataNode.cxx:200-298) wraps an
`AIS_Shape` into an `AIS_TexturedShape` so OCCT generates texture
coordinates for CAD geometry on demand, with a per-shape UV scale edited
in the material panel (MaterialEditor.cxx:1128-1299); Assimp's GenUVCoords
post-process provides the same for imported meshes (`rtmeshread -genuv`,
MeshImporter.cxx:73-97).

Native equivalents (host-side, numpy — runs once per edit, the
result is a static per-vertex array the shading kernels gather):

- ``normalize_part_uvs``: CAD meshes from the STEP/IGES tessellator
  already carry the *raw surface parameters* of each trimmed face
  (radians / parametric extents). Normalize each part's (u,v) domain
  into [0,1] so a texture covers each face once — the "natural surface
  parameterization" the reference gets from OCCT.
- ``generate_uvs_box``: for meshes with no UVs at all, a box (tri-planar)
  projection: each triangle is assigned its dominant-normal axis and its
  vertices projected onto the complementary plane, normalized by the
  mesh bounds. Vertices shared between differently-projected faces are
  split so the per-vertex UV array stays consistent.
- ``parameterize_mesh``: the dispatcher used by ``rtmeshread -genuv``
  and at texture-attach time (``rttexture`` on a shape without UVs).
"""
from __future__ import annotations

import numpy as np

from cadrays_tpu.geometry.mesh import TriangleMesh


def has_valid_uvs(mesh: TriangleMesh) -> bool:
    """True when the mesh carries a non-degenerate UV set (spread > 0 in
    both axes). A mesh whose UVs are all identical (e.g. zero-filled
    placeholders) would sample a single texel everywhere."""
    if mesh.uvs is None or mesh.uvs.shape[0] == 0:
        return False
    spread = mesh.uvs.max(axis=0) - mesh.uvs.min(axis=0)
    return bool((spread > 1e-12).all())


def _part_ranges(mesh: TriangleMesh) -> np.ndarray:
    if mesh.part_ranges is not None and len(mesh.part_ranges):
        return np.asarray(mesh.part_ranges, np.int64)
    return np.array([[0, mesh.num_triangles]], np.int64)


def normalize_part_uvs(mesh: TriangleMesh) -> TriangleMesh:
    """Rescale each part's raw surface-parameter UVs into [0,1]².

    Parts are the tessellator's per-face (or per-solid) triangle ranges;
    vertices are not shared across parts (the STEP/IGES merge
    concatenates them), so per-part vertex sets are disjoint by
    construction — still, we gather the referenced vertex ids per range
    to stay correct for hand-built meshes that do share them.
    """
    if mesh.uvs is None:
        return mesh
    uv = np.array(mesh.uvs, np.float32, copy=True)
    for t0, t1 in _part_ranges(mesh):
        vids = np.unique(mesh.indices[t0:t1].ravel())
        if vids.size == 0:
            continue
        lo = uv[vids].min(axis=0)
        hi = uv[vids].max(axis=0)
        span = np.where(hi - lo > 1e-12, hi - lo, 1.0).astype(np.float32)
        uv[vids] = (uv[vids] - lo) / span
    out = TriangleMesh(mesh.vertices, mesh.indices, mesh.normals, uv)
    out.part_ranges = mesh.part_ranges
    return out


def generate_uvs_box(mesh: TriangleMesh) -> TriangleMesh:
    """Box (tri-planar) projection UVs with per-axis vertex splitting.

    Each face projects along the dominant axis of its geometric normal
    onto the complementary coordinate plane; coordinates are normalized
    by the mesh bounding box so the texture tiles once across the whole
    object at uv_scale=1 (matching the reference's per-shape texture
    scale semantics, MaterialEditor.cxx:1241-1260).
    """
    fn = mesh.face_normals()
    axis = np.abs(fn).argmax(axis=1)  # (T,) dominant axis per face

    # Split vertices per (vertex id, axis class): a cube corner belongs
    # to three faces with three different projections.
    tri = mesh.indices  # (T, 3)
    key = tri.astype(np.int64) * 3 + axis[:, None]  # (T, 3)
    uniq, new_tri = np.unique(key.ravel(), return_inverse=True)
    new_tri = new_tri.reshape(tri.shape).astype(np.int32)
    src_vid = (uniq // 3).astype(np.int64)
    src_axis = (uniq % 3).astype(np.int64)

    verts = mesh.vertices[src_vid]
    normals = mesh.normals[src_vid] if mesh.normals is not None else None

    lo, hi = mesh.bounds()
    span = np.where(hi - lo > 1e-12, hi - lo, 1.0).astype(np.float32)
    rel = (verts - lo) / span  # (V', 3) in [0,1]

    # axis -> the two in-plane coordinates (u, v)
    uv_of_axis = np.array([[1, 2], [0, 2], [0, 1]], np.int64)
    cols = uv_of_axis[src_axis]  # (V', 2)
    rows = np.arange(rel.shape[0])[:, None]
    uv = rel[rows, cols].astype(np.float32)

    out = TriangleMesh(verts, new_tri, normals, uv)
    # part ranges index triangles, whose order is unchanged
    out.part_ranges = mesh.part_ranges
    return out


def parameterize_mesh(mesh: TriangleMesh) -> TriangleMesh:
    """Give the mesh usable texture coordinates (Parameterize analogue).

    CAD tessellator meshes (raw_uvs=True: UVs are raw surface
    parameters) are normalized per part; meshes without usable UVs get
    the box projection. Imported meshes that carry a valid UV set keep
    it verbatim — including UVs outside [0,1], which express intentional
    tiling (the reference only generates UVs when a shape has none and
    tiles via uv_scale; round-2 advisor finding).
    """
    if mesh.uvs is None or not has_valid_uvs(mesh):
        return generate_uvs_box(mesh)
    if getattr(mesh, "raw_uvs", False):
        out = normalize_part_uvs(mesh)
        out.raw_uvs = False
        return out
    return mesh
