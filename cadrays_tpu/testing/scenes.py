"""Canonical test/bench scenes.

`cornell_box` reconstructs the reference's CornellBox fixture
(data/scripts/CornellBox.tcl): unit open box (interior [0,1]^3, +Y side
open toward the camera, z up), colored side walls, positional sphere
light at (0.5, 0.5, 0.85) with smooth radius 0.06 and intensity 25,
plus — in the full variant — the glass sphere/boxes/plastic sphere of the
original script. The diffuse-only variant is the minimum end-to-end slice
(SURVEY.md §7.2, BASELINE.json config #1).
"""
from __future__ import annotations

import numpy as np

from cadrays_tpu.core.bsdf import material
from cadrays_tpu.core.camera import Camera
from cadrays_tpu.core.fresnel import (
    FRESNEL_CONSTANT,
    FRESNEL_DIELECTRIC,
    fresnel,
)
from cadrays_tpu.core.lights import positional_light
from cadrays_tpu.geometry import primitives
from cadrays_tpu.scene.scene import Scene


def _translate(v):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = v
    return m


def _rot_z(deg):
    a = np.deg2rad(deg)
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = np.cos(a)
    m[0, 1] = -np.sin(a)
    m[1, 0] = np.sin(a)
    m[1, 1] = np.cos(a)
    return m


def cornell_box(full: bool = False, sphere_res: int = 24) -> Scene:
    scene = Scene()
    scene.clear_lights()
    scene.add_light(positional_light(position=(0.5, 0.5, 0.85),
                                     intensity=25.0, smooth_radius=0.06))

    white = material(kd=(1.0, 1.0, 1.0))
    red = material(kd=(1.0, 0.3, 0.3))
    blue = material(kd=(0.3, 0.5, 1.0))

    # CornellBox.tcl:20-31 — exploded box faces re-positioned into an open
    # box: interior [0,1]^3, +Y face missing (camera side).
    walls = [
        ("b_1", 1, _translate((1, 0, 0)), red),  # right wall at x=1
        ("b_2", 2, _translate((-1, 0, 0)), blue),  # left wall at x=0
        ("b_3", 3, _translate((0, 1, 0)), white),  # back wall at y=1
        ("b_5", 5, _translate((0, 0, 1)), white),  # ceiling at z=1
        ("b_6", 6, _translate((0, 0, -1)), white),  # floor at z=0
    ]
    for name, face, tf, mat in walls:
        mesh = primitives.box_face(1.0, 1.0, 1.0, face)
        scene.add_shape(name, mesh, mat, tf)

    if not full:
        # Diffuse-only contents: one box (the script's 'c', sans gloss).
        scene.add_shape(
            "c", primitives.box(0.3, 0.3, 0.2),
            material(kd=(1.0, 0.8, 0.2)),
            _translate((0.55, 0.3, 0.0)) @ _rot_z(-30),
        )
        return scene

    # CornellBox.tcl:43-72 — full contents.
    glass_blue = material(
        kd=(0, 0, 0), kt=(1.0, 1.0, 1.0),
        absorp_color=(0.8, 0.8, 1.0), absorp_coeff=6.0,
        base_fresnel=fresnel(FRESNEL_DIELECTRIC, 1.5),
    )
    glass_green = material(
        kd=(0, 0, 0), kt=(1.0, 1.0, 1.0),
        absorp_color=(0.8, 1.0, 0.8), absorp_coeff=6.0,
        base_fresnel=fresnel(FRESNEL_DIELECTRIC, 1.5),
    )
    glossy = material(kd=(1.0, 0.8, 0.2), ks=(0.3, 0.3, 0.3),
                      base_rough=0.2)
    mirror_ball = material(kd=(0.5, 0.9, 0.3), ks=(0.3, 0.3, 0.3),
                           base_rough=0.0,
                           base_fresnel=fresnel(FRESNEL_CONSTANT, 1.0))

    scene.add_shape("s", primitives.sphere(0.2, sphere_res * 2, sphere_res),
                    glass_blue, _translate((0.21, 0.3, 0.2)))
    scene.add_shape("c", primitives.box(0.3, 0.3, 0.2), glossy,
                    _translate((0.55, 0.3, 0.0)) @ _rot_z(-30))
    scene.add_shape("g", primitives.box(0.15, 0.15, 0.3), glass_green,
                    _translate((0.7, 0.25, 0.2)) @ _rot_z(10))
    scene.add_shape("r", primitives.sphere(0.1, sphere_res * 2, sphere_res),
                    mirror_ball, _translate((0.5, 0.65, 0.1)))
    return scene


def cornell_camera(aperture: float = 0.0) -> Camera:
    """Front view of the open box (vfront; vfit analogue)."""
    return Camera.look_at(
        eye=(0.5, -1.6, 0.5),
        at=(0.5, 0.5, 0.5),
        up=(0.0, 0.0, 1.0),
        fovy_deg=40.0,
        aperture=aperture,
        focal_dist=2.1,
    )


def emissive_quad_scene(le=(8.0, 8.0, 8.0)) -> Scene:
    """Floor + emissive ceiling quad — exercises area-light NEE + MIS."""
    scene = Scene()
    scene.clear_lights()
    floor = primitives.quad(4.0, 4.0)
    scene.add_mesh("floor", floor, material(kd=(0.7, 0.7, 0.7)))
    panel = primitives.quad(1.0, 1.0)
    tf = np.eye(4, dtype=np.float32)
    tf[:3, :3] = np.diag([1.0, -1.0, -1.0]).astype(np.float32)  # face down
    tf[:3, 3] = (0.0, 0.0, 2.0)
    scene.add_mesh("panel", panel, material(kd=(0, 0, 0), le=le), tf)
    return scene


def _deform(mesh, seed: int, amp: float = 0.08):
    """Displace vertices along their normals by a per-part harmonic field,
    so that no two parts share triangle data (machined/cast surface
    detail; the mesh stays watertight)."""
    from cadrays_tpu.geometry.mesh import TriangleMesh

    rng = np.random.default_rng(seed)
    f = rng.uniform(1.5, 6.0, size=3)
    ph = rng.uniform(0, 2 * np.pi, size=3)
    v = np.asarray(mesh.vertices, np.float32)
    n = np.asarray(mesh.normals, np.float32)
    h = (np.sin(f[0] * v[:, 0] + ph[0])
         * np.sin(f[1] * v[:, 1] + ph[1])
         * np.sin(f[2] * v[:, 2] + ph[2])).astype(np.float32)
    return TriangleMesh(vertices=v + n * (amp * h)[:, None],
                        indices=np.asarray(mesh.indices), normals=n,
                        uvs=np.asarray(mesh.uvs))


def distinct_parts(n_parts: int = 48, min_tris: int = 600_000,
                   seed: int = 0) -> list:
    """`n_parts` unique meshes (five parametric families, each part
    deformed) plus unique high-resolution tori until the total reaches
    `min_tris` triangles."""
    from cadrays_tpu.geometry.primitives import (cone, cylinder, sphere,
                                                 torus)

    parts = []
    for i in range(n_parts):
        fam = i % 5
        if fam == 0:
            m = torus(1.0 + 0.2 * (i % 3), 0.25 + 0.02 * (i % 5),
                      96 + 8 * (i % 4), 64 + 8 * (i % 3))
        elif fam == 1:
            m = sphere(0.9 + 0.1 * (i % 4), 96 + 16 * (i % 3),
                       64 + 8 * (i % 4))
        elif fam == 2:
            m = cylinder(0.5 + 0.1 * (i % 3), 1.6 + 0.2 * (i % 4),
                         384 + 64 * (i % 3))
        elif fam == 3:
            m = cone(0.8 + 0.1 * (i % 3), 0.15 + 0.05 * (i % 4),
                     1.7, 512 + 64 * (i % 3))
        else:
            m = torus(1.3, 0.5 - 0.04 * (i % 5), 80 + 16 * (i % 3),
                      56 + 8 * (i % 4))
        parts.append(_deform(m, seed=seed + 1000 + i))
    total = sum(p.indices.shape[0] for p in parts)
    k = 0
    while total < min_tris:
        extra = torus(1.0 + 0.07 * (k % 7), 0.28 + 0.015 * (k % 5), 128, 96)
        parts.append(_deform(extra, seed=seed + 5000 + k))
        total += extra.indices.shape[0]
        k += 1
    return parts


def distinct_parts_assembly(n_parts: int = 48, min_tris: int = 600_000,
                            seed: int = 0):
    """A CAD assembly of distinct parts on a grid, each under its own
    rotation, as a two-level (instanced) SceneData. The defaults give
    ~611k unique triangles. Returns (SceneData, Camera)."""
    from cadrays_tpu.scene.instances import build_instanced

    parts = distinct_parts(n_parts, min_tris, seed)
    n = len(parts)
    side = int(np.ceil(np.sqrt(n)))
    rng = np.random.default_rng(seed + 11)
    tfs = []
    for k in range(n):
        i, j = divmod(k, side)
        m = np.eye(4, dtype=np.float32)
        ang = rng.uniform(0, np.pi)
        c, s = np.cos(ang), np.sin(ang)
        m[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]],
                             np.float32) @ np.array(
            [[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
        m[:3, 3] = (i * 3.4, j * 3.4, rng.uniform(0.0, 1.2))
        tfs.append(m)
    mats = [material(kd=(0.75, 0.72, 0.68)),
            material(kd=(0.35, 0.45, 0.75), ks=(0.2, 0.2, 0.2),
                     base_rough=0.3)]
    ext = side * 3.4
    lights = positional_light(position=(ext / 2, -ext * 0.3, ext * 1.2),
                              intensity=900.0)
    data = build_instanced(parts, tfs, mats, [k % 2 for k in range(n)],
                           lights=lights)
    cam = Camera.look_at(eye=(ext / 2, -ext * 0.75, ext * 0.6),
                         at=(ext / 2, ext / 2, 0.4), up=(0, 0, 1),
                         fovy_deg=45.0)
    return data, cam


def primary_rays(camera: Camera, width: int, height: int, stride: int = 1):
    """Pinhole rays through every `stride`-th pixel of the frame (strided
    over the whole frame, in scanline order). Returns (origin, direction)."""
    import jax.numpy as jnp

    R = width * height // stride
    pids = jnp.arange(R, dtype=jnp.int32) * stride
    px = (pids % width).astype(jnp.float32)
    py = (pids // width).astype(jnp.float32)
    return camera.generate_rays(px, py, jnp.zeros(R), jnp.zeros(R),
                                width, height)


def bounce_rays(geom, origin, direction, hits, seed: int = 5):
    """Diffuse bounce rays as the renderer issues them after the first
    hit: origins on surfaces the primary rays hit (`hits` = their trace
    result), cosine-hemisphere directions about the facing geometric
    normal, sorted by the integrator's coherence key. Returns
    (origin, direction), as many as there are primary rays."""
    import jax.numpy as jnp

    from cadrays_tpu.ops.traverse import _coherence_key

    o, d = np.asarray(origin), np.asarray(direction)
    tri, t = np.asarray(hits["tri"]), np.asarray(hits["t"])
    R = o.shape[0]
    hit_idx = np.nonzero(tri >= 0)[0]
    if hit_idx.size == 0:
        raise ValueError("no primary ray hit the scene")
    rng = np.random.default_rng(seed)
    src = hit_idx[rng.integers(0, hit_idx.size, R)]

    p = o[src] + t[src, None] * d[src]
    rows = np.asarray(geom.tris_packed)[tri[src]]
    n = np.cross(rows[:, 3:6], rows[:, 6:9])
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    n = np.where(np.sum(n * d[src], axis=-1, keepdims=True) > 0, -n, n)

    u1 = rng.uniform(0, 1, R).astype(np.float32)
    u2 = rng.uniform(0, 1, R).astype(np.float32)
    r = np.sqrt(u1)
    phi = 2 * np.pi * u2
    t_ax = np.cross(n, np.where(np.abs(n[:, 2:3]) < 0.9,
                                [0, 0, 1.0], [1.0, 0, 0]))
    t_ax /= np.maximum(np.linalg.norm(t_ax, axis=-1, keepdims=True), 1e-12)
    b_ax = np.cross(n, t_ax)
    local = np.stack([r * np.cos(phi), r * np.sin(phi),
                      np.sqrt(np.maximum(1 - u1, 0))], -1)
    d_b = (local[:, 0:1] * t_ax + local[:, 1:2] * b_ax
           + local[:, 2:3] * n).astype(np.float32)
    o_b = (p + n * 1e-3).astype(np.float32)

    perm = np.asarray(jnp.argsort(
        _coherence_key(geom, jnp.asarray(o_b), jnp.asarray(d_b))))
    return jnp.asarray(o_b[perm]), jnp.asarray(d_b[perm])
