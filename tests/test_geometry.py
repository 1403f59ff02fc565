"""Geometry layer: primitives, mesh ops, BVH build + traversal vs brute force."""
import jax.numpy as jnp
import numpy as np
import pytest

from cadrays_tpu.geometry import primitives
from cadrays_tpu.geometry.bvh import build_bvh, bvh_quality
from cadrays_tpu.geometry.mesh import TriangleMesh
from cadrays_tpu.ops.intersect import INF, ray_triangle
from cadrays_tpu.ops.traverse import occluded, trace
from cadrays_tpu.scene.flatten import GeometryData


def _geom_from_mesh(mesh: TriangleMesh) -> GeometryData:
    from cadrays_tpu.scene.flatten import pack_geometry

    if mesh.normals is None:
        mesh.compute_vertex_normals()
    uv = mesh.uvs if mesh.uvs is not None else np.zeros(
        (mesh.num_vertices, 2), np.float32)
    bvh = build_bvh(mesh.vertices, mesh.indices)
    tri_v = mesh.indices[bvh.order]
    tri_mat = np.zeros(mesh.num_triangles, np.int32)
    nodes_packed, tris_packed = pack_geometry(mesh.vertices, tri_v, tri_mat,
                                              bvh)
    return GeometryData(
        vertices=jnp.asarray(mesh.vertices),
        normals=jnp.asarray(mesh.normals),
        uvs=jnp.asarray(uv),
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


def _brute_force_closest(mesh, origins, dirs):
    """Reference numpy intersection over all triangles."""
    v = mesh.vertices
    tri = mesh.indices
    t_best = np.full(origins.shape[0], 1e30, np.float32)
    id_best = np.full(origins.shape[0], -1, np.int64)
    for k in range(tri.shape[0]):
        t, u, vv, hit = ray_triangle(
            jnp.asarray(origins), jnp.asarray(dirs),
            jnp.asarray(v[tri[k, 0]]), jnp.asarray(v[tri[k, 1]]),
            jnp.asarray(v[tri[k, 2]]))
        t = np.asarray(t)
        m = np.asarray(hit) & (t < t_best)
        t_best = np.where(m, t, t_best)
        id_best = np.where(m, k, id_best)
    return t_best, id_best


class TestPrimitives:
    def test_box_closed(self):
        b = primitives.box(1, 2, 3)
        assert b.num_triangles == 12
        lo, hi = b.bounds()
        np.testing.assert_allclose(lo, 0, atol=1e-6)
        np.testing.assert_allclose(hi, [1, 2, 3], atol=1e-6)

    def test_box_outward_normals(self):
        b = primitives.box(1, 1, 1, origin_corner=False)
        fn = b.face_normals()
        centers = b.vertices[b.indices].mean(axis=1)
        # outward: center-to-face dot normal > 0
        assert np.all(np.sum(centers * fn, axis=1) > 0)

    def test_box_face_extraction(self):
        for face in range(1, 7):
            f = primitives.box_face(1, 1, 1, face)
            assert f.num_triangles == 2

    def test_sphere_radius(self):
        s = primitives.sphere(2.0, 32, 16)
        r = np.linalg.norm(s.vertices, axis=1)
        np.testing.assert_allclose(r, 2.0, atol=1e-5)
        # normals point outward
        assert np.all(np.sum(s.vertices * s.normals, axis=1) > 0)

    def test_sphere_area(self):
        s = primitives.sphere(1.0, 96, 48)
        assert abs(s.areas().sum() - 4 * np.pi) / (4 * np.pi) < 0.01

    def test_cylinder_cone_torus_build(self):
        assert primitives.cylinder().num_triangles > 0
        assert primitives.cone().num_triangles > 0
        assert primitives.torus().num_triangles > 0

    def test_quad_uv(self):
        q = primitives.quad()
        assert q.uvs is not None and q.uvs.shape == (4, 2)


class TestMesh:
    def test_vertex_normals_sphere(self):
        s = primitives.sphere(1.0, 48, 24)
        smooth = TriangleMesh(s.vertices, s.indices).compute_vertex_normals()
        # smooth normals on a sphere ~= position direction
        d = np.sum(smooth.normals * s.normals, axis=1)
        interior = np.abs(s.vertices[:, 2]) < 0.99  # poles are degenerate
        assert d[interior].min() > 0.99

    def test_transform(self):
        b = primitives.box(1, 1, 1)
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = (5, 0, 0)
        t = b.transformed(m)
        lo, hi = t.bounds()
        np.testing.assert_allclose(lo, [5, 0, 0], atol=1e-6)

    def test_merge(self):
        a = primitives.box(1, 1, 1)
        b = primitives.sphere(1.0, 8, 4)
        m = TriangleMesh.merge([a, b])
        assert m.num_triangles == a.num_triangles + b.num_triangles
        assert m.indices.max() < m.num_vertices


class TestBVH:
    def test_build_structure(self):
        s = primitives.sphere(1.0, 32, 16)
        bvh = build_bvh(s.vertices, s.indices)
        q = bvh_quality(bvh)
        assert q["leaves"] > 0
        # every triangle appears exactly once in the leaf order
        assert sorted(bvh.order.tolist()) == list(range(s.num_triangles))
        # skip links are in-range
        assert np.all((bvh.skip >= -1) & (bvh.skip < bvh.num_nodes))

    @pytest.mark.parametrize("prim", ["sphere", "box", "torus"])
    def test_traversal_matches_brute_force(self, prim):
        mesh = {
            "sphere": lambda: primitives.sphere(1.0, 24, 12),
            "box": lambda: primitives.box(1, 1, 1, origin_corner=False),
            "torus": lambda: primitives.torus(1.0, 0.4, 24, 12),
        }[prim]()
        geom = _geom_from_mesh(mesh)

        rs = np.random.RandomState(0)
        R = 256
        origins = rs.randn(R, 3).astype(np.float32) * 0.1 + np.float32([0, 0, 4])
        dirs = np.float32([0, 0, -1]) + 0.4 * rs.randn(R, 3).astype(np.float32)
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)

        res = trace(geom, jnp.asarray(origins), jnp.asarray(dirs),
                    jnp.full(R, INF))
        t_ref, _ = _brute_force_closest(mesh, origins, dirs)

        hit_bvh = np.asarray(res["tri"]) >= 0
        hit_ref = t_ref < 1e29
        np.testing.assert_array_equal(hit_bvh, hit_ref)
        np.testing.assert_allclose(np.asarray(res["t"])[hit_ref],
                                   t_ref[hit_ref], rtol=1e-4)

    def test_native_builder_matches_python(self):
        from cadrays_tpu.geometry.bvh import _build_bvh_python
        from cadrays_tpu.native.build import native_available

        if not native_available():
            pytest.skip("native builder not built")
        mesh = primitives.torus(1.0, 0.4, 32, 16)
        bn = build_bvh(mesh.vertices, mesh.indices, backend="native")
        bp = _build_bvh_python(mesh.vertices, mesh.indices)
        qn, qp = bvh_quality(bn), bvh_quality(bp)
        assert sorted(bn.order.tolist()) == list(range(mesh.num_triangles))
        # same build algorithm -> same structure
        assert qn == qp
        np.testing.assert_array_equal(bn.skip, bp.skip)
        np.testing.assert_allclose(bn.node_min, bp.node_min, atol=1e-6)

    def test_occlusion(self):
        mesh = primitives.box(1, 1, 1, origin_corner=False)
        geom = _geom_from_mesh(mesh)
        o = jnp.asarray(np.float32([[0, 0, 4], [3, 3, 4]]))
        d = jnp.asarray(np.float32([[0, 0, -1], [0, 0, -1]]))
        occ = occluded(geom, o, d, jnp.full(2, INF))
        assert bool(occ[0]) and not bool(occ[1])

    def test_tmax_respected(self):
        mesh = primitives.box(1, 1, 1, origin_corner=False)
        geom = _geom_from_mesh(mesh)
        o = jnp.asarray(np.float32([[0, 0, 4]]))
        d = jnp.asarray(np.float32([[0, 0, -1]]))
        # box surface at z=0.5 -> t=3.5; tmax=2 must miss
        res = trace(geom, o, d, jnp.full(1, 2.0))
        assert int(res["tri"][0]) == -1

    def test_single_triangle_scene(self):
        mesh = TriangleMesh(
            np.float32([[0, 0, 0], [1, 0, 0], [0, 1, 0]]),
            np.int32([[0, 1, 2]]))
        geom = _geom_from_mesh(mesh)
        o = jnp.asarray(np.float32([[0.2, 0.2, 1]]))
        d = jnp.asarray(np.float32([[0, 0, -1]]))
        res = trace(geom, o, d, jnp.full(1, INF))
        assert int(res["tri"][0]) == 0
        np.testing.assert_allclose(float(res["t"][0]), 1.0, rtol=1e-5)

    def test_large_mesh_bvh(self):
        mesh = primitives.sphere(1.0, 96, 48)  # ~9k triangles
        geom = _geom_from_mesh(mesh)
        R = 64
        rs = np.random.RandomState(3)
        dirs = rs.randn(R, 3).astype(np.float32)
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        o = jnp.asarray(np.zeros((R, 3), np.float32))
        res = trace(geom, o, jnp.asarray(dirs), jnp.full(R, INF))
        # from inside the sphere every ray hits at t ~= 1
        assert bool(jnp.all(res["tri"] >= 0))
        np.testing.assert_allclose(np.asarray(res["t"]), 1.0, atol=5e-3)
