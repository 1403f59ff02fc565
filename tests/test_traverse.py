"""Ray traversal: the gather walk against a brute-force reference, the
platform dispatch, the CUDA kernel's operand logic, and the kernel itself
on a GPU.

The brute-force reference intersects every ray with every triangle in
float64 numpy, independent of the BVH, the packed tables and JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cadrays_tpu.core.bsdf import material
from cadrays_tpu.geometry import primitives
from cadrays_tpu.geometry.bvh import build_bvh
from cadrays_tpu.ops import traverse, traverse_cuda
from cadrays_tpu.ops.traverse import trace, trace_gather, tracer_for
from cadrays_tpu.scene.flatten import GeometryData, pack_geometry
from cadrays_tpu.scene.instances import build_instanced

INF = 1e30


def _soup(n_tri, seed):
    """Random small triangles in [-1, 1]^3."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1, 1, (n_tri, 3))
    verts = np.concatenate([base, base + rng.normal(0, 0.15, (n_tri, 3)),
                            base + rng.normal(0, 0.15, (n_tri, 3))])
    idx = np.arange(3 * n_tri, dtype=np.int32).reshape(3, n_tri).T
    return verts.astype(np.float32), np.ascontiguousarray(idx)


def _geom(verts, idx) -> GeometryData:
    bvh = build_bvh(verts, idx)
    tri_v = idx[bvh.order]
    tri_mat = np.zeros(idx.shape[0], np.int32)
    nodes, tris = pack_geometry(verts, tri_v, tri_mat, bvh)
    return GeometryData(
        vertices=jnp.asarray(verts), normals=jnp.zeros_like(verts),
        uvs=jnp.zeros((verts.shape[0], 2), jnp.float32),
        tri_v=jnp.asarray(tri_v), tri_mat=jnp.asarray(tri_mat),
        bvh_min=jnp.asarray(bvh.node_min), bvh_max=jnp.asarray(bvh.node_max),
        bvh_skip=jnp.asarray(bvh.skip), bvh_first=jnp.asarray(bvh.first),
        bvh_count=jnp.asarray(bvh.count), nodes_packed=jnp.asarray(nodes),
        tris_packed=jnp.asarray(tris))


def _rays(n, seed, spread=1.5):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _brute(p0, p1, p2, o, d, t_max):
    """float64 Moller-Trumbore of every ray against every triangle.
    Returns (t_closest (R,) with INF on miss, tri (R,) with -1 on miss)."""
    p0, p1, p2 = (np.asarray(x, np.float64)[None] for x in (p0, p1, p2))
    o = np.asarray(o, np.float64)[:, None]
    d = np.asarray(d, np.float64)[:, None]
    e1, e2 = p1 - p0, p2 - p0
    pv = np.cross(d, e2)
    det = np.sum(e1 * pv, -1)
    ok = np.abs(det) > 1e-12
    inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    tv = o - p0
    u = np.sum(tv * pv, -1) * inv
    q = np.cross(tv, e1)
    v = np.sum(d * q, -1) * inv
    t = np.sum(e2 * q, -1) * inv
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-7) \
        & (t < np.asarray(t_max, np.float64)[:, None])
    t = np.where(hit, t, INF)
    tri = np.argmin(t, axis=1)
    t_best = t[np.arange(t.shape[0]), tri]
    return t_best, np.where(t_best < INF, tri, -1)


def _world_tris(geom):
    """World-space corners of every (BVH-ordered) triangle of `geom`."""
    v = np.asarray(geom.vertices, np.float64)
    tv = np.asarray(geom.tri_v)
    corners = [v[tv[:, k]] for k in range(3)]
    if geom.instanced:
        tf = np.asarray(geom.inst_tf, np.float64)[np.asarray(geom.tri_inst)]
        corners = [np.einsum("tij,tj->ti", tf[:, :, :3], c) + tf[:, :, 3]
                   for c in corners]
    return corners


def _check_closest(res, t_ref, tri_ref):
    """Hit masks equal; t agrees; ids agree except at near-ties."""
    tri = np.asarray(res["tri"])
    np.testing.assert_array_equal(tri >= 0, tri_ref >= 0)
    hit = tri_ref >= 0
    np.testing.assert_allclose(np.asarray(res["t"])[hit], t_ref[hit],
                               rtol=1e-4, atol=1e-5)
    assert np.mean(tri[hit] == tri_ref[hit]) > 0.99


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gather_closest_matches_bruteforce(seed):
    verts, idx = _soup(300, seed)
    geom = _geom(verts, idx)
    o, d = _rays(400, seed + 10)
    res = trace_gather(geom, jnp.asarray(o), jnp.asarray(d),
                       jnp.full((400,), INF))
    tv = np.asarray(geom.tri_v)
    t_ref, tri_ref = _brute(verts[tv[:, 0]], verts[tv[:, 1]],
                            verts[tv[:, 2]], o, d, np.full(400, INF))
    _check_closest(res, t_ref, tri_ref)


def test_gather_respects_tmax_and_dead_lanes():
    verts, idx = _soup(200, 4)
    geom = _geom(verts, idx)
    o, d = _rays(512, 5)
    rng = np.random.default_rng(6)
    t_max = rng.uniform(0.2, 3.0, 512).astype(np.float32)
    t_max[::4] = 0.0  # dead lanes, as the integrator issues them
    res = trace_gather(geom, jnp.asarray(o), jnp.asarray(d),
                       jnp.asarray(t_max))
    tv = np.asarray(geom.tri_v)
    t_ref, tri_ref = _brute(verts[tv[:, 0]], verts[tv[:, 1]],
                            verts[tv[:, 2]], o, d, t_max)
    dead = t_max == 0.0
    assert np.all(np.asarray(res["tri"])[dead] == -1)
    np.testing.assert_array_equal(np.asarray(res["t"])[dead], 0.0)
    assert np.all(np.asarray(res["t"]) <= t_max)
    _check_closest(res, t_ref, tri_ref)


@pytest.mark.parametrize("finite", [False, True])
def test_gather_any_hit_matches_bruteforce_occlusion(finite):
    verts, idx = _soup(250, 7)
    geom = _geom(verts, idx)
    o, d = _rays(500, 8)
    t_max = (np.random.default_rng(9).uniform(0.1, 2.0, 500)
             if finite else np.full(500, INF)).astype(np.float32)
    res = trace_gather(geom, jnp.asarray(o), jnp.asarray(d),
                       jnp.asarray(t_max), any_hit=True)
    tv = np.asarray(geom.tri_v)
    _, tri_ref = _brute(verts[tv[:, 0]], verts[tv[:, 1]], verts[tv[:, 2]],
                        o, d, t_max)
    np.testing.assert_array_equal(np.asarray(res["tri"]) >= 0, tri_ref >= 0)


def _assembly():
    """Two-level scene: shared and distinct meshes under rotations and a
    non-uniform scale."""
    tor = primitives.torus(0.6, 0.25, 16, 8)
    sph = primitives.sphere(0.5, 12, 6)
    box = primitives.box(0.8, 0.5, 0.3, origin_corner=False)
    meshes, tfs = [], []
    rng = np.random.default_rng(3)
    for k in range(6):
        m = np.eye(4, dtype=np.float32)
        a = rng.uniform(0, np.pi)
        c, s = np.cos(a), np.sin(a)
        m[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) \
            @ np.diag([1.0, 1.0 + 0.5 * (k == 4), 1.0])
        m[:3, 3] = ((k % 3) * 1.6 - 1.6, (k // 3) * 1.6 - 0.8, 0.2 * k)
        meshes.append((tor, sph, box)[k % 3])
        tfs.append(m)
    mats = [material(kd=(0.8, 0.2, 0.2)), material(kd=(0.2, 0.8, 0.2))]
    return build_instanced(meshes, tfs, mats, [k % 2 for k in range(6)])


@pytest.mark.parametrize("any_hit", [False, True])
def test_gather_instanced_matches_world_bruteforce(any_hit):
    geom = _assembly().geometry
    assert geom.instanced
    o, d = _rays(600, 11, spread=2.5)
    res = trace_gather(geom, jnp.asarray(o), jnp.asarray(d),
                       jnp.full((600,), INF), any_hit=any_hit)
    p0, p1, p2 = _world_tris(geom)
    t_ref, tri_ref = _brute(p0, p1, p2, o, d, np.full(600, INF))
    if any_hit:
        np.testing.assert_array_equal(np.asarray(res["tri"]) >= 0,
                                      tri_ref >= 0)
    else:
        _check_closest(res, t_ref, tri_ref)


# --- dispatch ----------------------------------------------------------


def test_dispatch_cpu_is_gather():
    assert tracer_for("cpu") is trace_gather
    assert jax.default_backend() == "cpu"
    verts, idx = _soup(50, 12)
    geom = _geom(verts, idx)
    o, d = _rays(64, 13)
    a = trace(geom, jnp.asarray(o), jnp.asarray(d), jnp.full((64,), INF))
    b = trace_gather(geom, jnp.asarray(o), jnp.asarray(d),
                     jnp.full((64,), INF))
    for k in ("t", "tri", "u", "v"):
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("platform", ["rocm", "METAL", ""])
def test_dispatch_unknown_platform_raises(platform):
    with pytest.raises(NotImplementedError, match="no ray traversal"):
        tracer_for(platform)


def test_gpu_dispatch_raises_when_library_cannot_build(monkeypatch, tmp_path):
    """A GPU without a loadable kernel library is an error, never a
    silent fall back to another traversal."""
    assert tracer_for("gpu") is traverse_cuda.trace_cuda
    monkeypatch.setattr(traverse_cuda, "_registered", False)
    monkeypatch.setattr(traverse_cuda, "nvcc_path",
                        lambda: str(tmp_path / "no-such-nvcc"))
    monkeypatch.setattr(traverse_cuda, "BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(traverse, "tracer_for",
                        lambda p, _f=traverse.tracer_for: _f("gpu"))
    verts, idx = _soup(10, 14)
    geom = _geom(verts, idx)
    with pytest.raises(RuntimeError, match="cannot build"):
        traverse_cuda.load(str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="cannot build"):
        trace(geom, jnp.zeros((4, 3)), jnp.ones((4, 3)), INF)
    assert not traverse_cuda._registered


# --- the kernel's operands (CPU-checkable wrapper logic) ---------------


@pytest.mark.parametrize("any_hit", [False, True])
def test_kernel_operands_baked(any_hit):
    verts, idx = _soup(40, 15)
    geom = _geom(verts, idx)
    o, d = _rays(37, 16)  # not a multiple of the CUDA block
    ops, results, attrs = traverse_cuda.kernel_operands(
        geom, jnp.asarray(o), jnp.asarray(d), 2.5, any_hit)
    nodes, tris, node_inst, inst_inv, oo, dd, tm = ops
    assert nodes.shape == geom.nodes_packed.shape
    assert tris.shape == (40, 12)
    assert node_inst.shape == (1,) and node_inst.dtype == jnp.int32
    assert inst_inv.shape == (1, 3, 4)
    assert oo.shape == dd.shape == (37, 3)
    assert tm.shape == (37,) and np.all(np.asarray(tm) == 2.5)
    assert [r.shape for r in results] == [(37,)] * 4
    assert [r.dtype for r in results] == [jnp.float32, jnp.int32,
                                          jnp.float32, jnp.float32]
    assert attrs == {"any_hit": np.int32(any_hit), "instanced": np.int32(0)}
    assert all(type(v) is np.int32 for v in attrs.values())


def test_kernel_operands_instanced_and_empty():
    geom = _assembly().geometry
    ops, results, attrs = traverse_cuda.kernel_operands(
        geom, jnp.zeros((0, 3)), jnp.zeros((0, 3)), jnp.zeros((0,)))
    assert ops[2].shape == (geom.nodes_packed.shape[0],)
    assert ops[3].shape == (6, 3, 4)
    assert ops[6].shape == (0,)
    assert [r.shape for r in results] == [(0,)] * 4
    assert attrs["instanced"] == 1 and attrs["any_hit"] == 0


def test_kernel_source_matches_reference_constants():
    """The CUDA walk hard-codes the reference's leaf size, epsilons and
    slab widening; they must stay in step."""
    src = open(traverse_cuda.SOURCE).read()
    assert f"kMaxLeaf = {traverse.MAX_LEAF};" in src
    assert "kEps = 1e-7f;" in src and traverse._EPS == 1e-7
    assert "kBoxShrink = 1.0f - 4e-7f;" in src
    assert traverse._BOX_SHRINK == 1.0 - 4e-7
    assert "kLeafMask = (1 << 24) - 1;" in src
    assert traverse._LEAF_MASK == (1 << 24) - 1
    assert 'XLA_FFI_DEFINE_HANDLER_SYMBOL(CadraysTrace' in src


# --- the kernel on the card --------------------------------------------


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no interpret mode); "
                    "chip_smoke.py phase 3 runs this comparison on the card")
    traverse_cuda.load()


@pytest.mark.gpu
@pytest.mark.parametrize("any_hit", [False, True])
def test_cuda_kernel_matches_gather(gpu, any_hit):
    verts, idx = _soup(2000, 17)
    geom = _geom(verts, idx)
    o, d = _rays(5000, 18)
    t_max = jnp.full((5000,), INF)
    k = traverse_cuda.trace_cuda(geom, jnp.asarray(o), jnp.asarray(d),
                                 t_max, any_hit=any_hit)
    g = trace_gather(geom, jnp.asarray(o), jnp.asarray(d), t_max,
                     any_hit=any_hit)
    np.testing.assert_array_equal(np.asarray(k["tri"]) >= 0,
                                  np.asarray(g["tri"]) >= 0)
    if not any_hit:
        assert np.mean(np.asarray(k["tri"]) == np.asarray(g["tri"])) > 0.999


@pytest.mark.gpu
def test_cuda_kernel_instanced_matches_gather(gpu):
    geom = _assembly().geometry
    o, d = _rays(5000, 19, spread=2.5)
    t_max = jnp.full((5000,), INF)
    k = traverse_cuda.trace_cuda(geom, jnp.asarray(o), jnp.asarray(d), t_max)
    g = trace_gather(geom, jnp.asarray(o), jnp.asarray(d), t_max)
    assert np.mean(np.asarray(k["tri"]) == np.asarray(g["tri"])) > 0.999


# --- the distinct-parts assembly generator ------------------------------


def test_distinct_parts_are_seeded_and_unique():
    from cadrays_tpu.testing.scenes import distinct_parts

    a = distinct_parts(n_parts=5, min_tris=150_000, seed=3)
    b = distinct_parts(n_parts=5, min_tris=150_000, seed=3)
    c = distinct_parts(n_parts=5, min_tris=150_000, seed=4)
    assert sum(p.indices.shape[0] for p in a) >= 150_000
    assert len(a) == len(b) > 5  # topped up with extra parts
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.vertices, y.vertices)
    assert not np.array_equal(a[0].vertices, c[0].vertices)
    # no two parts share vertex data
    keys = {p.vertices.tobytes() for p in a}
    assert len(keys) == len(a)


def test_bounce_rays_are_sorted_hemisphere_samples():
    from cadrays_tpu.ops.traverse import _coherence_key
    from cadrays_tpu.testing.scenes import (bounce_rays, cornell_box,
                                            cornell_camera, primary_rays)

    cam = cornell_camera()
    geom = cornell_box().flatten(cam).geometry
    o, d = primary_rays(cam, 32, 32, stride=2)
    assert o.shape == d.shape == (512, 3)
    hits = trace_gather(geom, o, d, jnp.full((512,), INF))
    ob, db = bounce_rays(geom, o, d, hits)
    assert ob.shape == db.shape == (512, 3)
    np.testing.assert_allclose(np.linalg.norm(np.asarray(db), axis=-1), 1.0,
                               atol=1e-5)
    key = np.asarray(_coherence_key(geom, ob, db))
    assert np.all(np.diff(key) >= 0)
