"""Boolean operations: 3D mesh CSG + 2D face booleans + cross-sections.

One robustness-critical core (native/mesh_csg.cpp, BSP solid clipping)
serves every boolean the scripts use:

* solid x solid  -> `bcut`/`bfuse`/`bcommon`/`bop` (3D, direct);
* face x face    -> the same 3D core on thin extrusions, with the result
  face recovered by cross-sectioning at the shared plane (so 2D booleans
  inherit 3D robustness instead of needing a separate clipper);
* `bsection`     -> mesh/plane cross-section chains;
* `mkoffset`     -> erosion/dilation expressed as booleans against the
  boundary swept by a disk.

Reference capability: OCCT BRepAlgoAPI booleans as driven by
data/scripts/{Bottle,Cpu,Cutter,Drill,Shape}.tcl.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from typing import List, Optional, Tuple

import numpy as np

from cadrays_tpu.modeling.surfaces import Plane
from cadrays_tpu.modeling.topo import (FaceShape, Shape, SolidShape,
                                       chain_polylines, shape_mesh,
                                       weld_vertices)

_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "native")
_SRC = os.path.join(_DIR, "mesh_csg.cpp")
if os.access(_DIR, os.W_OK):
    _LIB = os.path.join(_DIR, "libcadrays_csg.so")
else:
    # read-only site-packages install: build into the user cache
    _cache = os.path.join(
        os.environ.get("XDG_CACHE_HOME",
                       os.path.join(os.path.expanduser("~"), ".cache")),
        "cadrays_tpu")
    os.makedirs(_cache, exist_ok=True)
    _LIB = os.path.join(_cache, "libcadrays_csg.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

UNION, SUBTRACT, INTERSECT = 0, 1, 2


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(_LIB)
                or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            # build beside the target, then rename (atomic for readers)
            tmp = f"{_LIB}.{os.getpid()}.tmp"
            cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                   "-o", tmp, _SRC]
            res = subprocess.run(cmd, capture_output=True, timeout=300)
            if res.returncode != 0:
                raise RuntimeError(
                    "mesh_csg build failed:\n"
                    + res.stderr.decode(errors="replace")[-2000:])
            os.replace(tmp, _LIB)
        lib = ctypes.CDLL(_LIB)
        lib.crt_csg.restype = ctypes.c_int64
        P = ctypes.POINTER
        lib.crt_csg.argtypes = [
            ctypes.c_int32,
            P(ctypes.c_double), ctypes.c_int64, P(ctypes.c_int32),
            ctypes.c_int64, P(ctypes.c_int32),
            P(ctypes.c_double), ctypes.c_int64, P(ctypes.c_int32),
            ctypes.c_int64, P(ctypes.c_int32),
            P(P(ctypes.c_double)), P(ctypes.c_int64),
            P(P(ctypes.c_int32)), P(P(ctypes.c_int32)), P(P(ctypes.c_int32)),
        ]
        lib.crt_csg_free.argtypes = [ctypes.c_void_p]
        lib.crt_ear_clip.restype = ctypes.c_int64
        lib.crt_ear_clip.argtypes = [P(ctypes.c_double), ctypes.c_int64,
                                     P(ctypes.c_int32)]
        _lib = lib
        return lib


def mesh_boolean(va, ta, fa, vb, tb, fb, op: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Raw mesh boolean. Returns (verts, tris, face_id, owner)."""
    lib = _load()
    va = np.ascontiguousarray(va, np.float64)
    vb = np.ascontiguousarray(vb, np.float64)
    ta = np.ascontiguousarray(ta, np.int32)
    tb = np.ascontiguousarray(tb, np.int32)
    fa = np.ascontiguousarray(fa, np.int32)
    fb = np.ascontiguousarray(fb, np.int32)
    P = ctypes.POINTER
    ov = P(ctypes.c_double)()
    onv = ctypes.c_int64()
    ot = P(ctypes.c_int32)()
    of = P(ctypes.c_int32)()
    oo = P(ctypes.c_int32)()
    nt = lib.crt_csg(
        op,
        va.ctypes.data_as(P(ctypes.c_double)), len(va),
        ta.ctypes.data_as(P(ctypes.c_int32)), len(ta),
        fa.ctypes.data_as(P(ctypes.c_int32)),
        vb.ctypes.data_as(P(ctypes.c_double)), len(vb),
        tb.ctypes.data_as(P(ctypes.c_int32)), len(tb),
        fb.ctypes.data_as(P(ctypes.c_int32)),
        ctypes.byref(ov), ctypes.byref(onv), ctypes.byref(ot),
        ctypes.byref(of), ctypes.byref(oo))
    if nt < 0:
        raise ValueError("boolean on empty/degenerate operand")
    verts = np.ctypeslib.as_array(ov, shape=(onv.value, 3)).copy()
    tris = np.ctypeslib.as_array(ot, shape=(nt, 3)).copy()
    face = np.ctypeslib.as_array(of, shape=(nt,)).copy()
    owner = np.ctypeslib.as_array(oo, shape=(nt,)).copy()
    for p in (ov, ot, of, oo):
        lib.crt_csg_free(p)
    return verts, tris, face, owner


def solid_boolean(a: Shape, b: Shape, op: int) -> SolidShape:
    """Boolean of two solids (world space); face ids renumbered so A's
    faces keep low ids and B's contributing faces follow.

    Coplanar-overlap retag: where a face of B lies ON a kept face of A
    (e.g. fusing a thinner pad flush onto a board, Cpu.tcl:22-28), the
    overlap region gets B's face id — OCCT's fuse splits the face there,
    and the scripts color those sub-faces individually."""
    va, ta, fa = shape_mesh(a)
    vb, tb, fb = shape_mesh(b)
    v, t, f, owner = mesh_boolean(va, ta, fa, vb, tb, fb, op)
    na = int(fa.max()) + 1 if len(fa) else 0
    f = _retag_coplanar(v, t, f, owner, vb, tb, fb, na)
    v2, t3, f3 = _weld_with_faces(v, t, f, owner=None, na=na)
    from cadrays_tpu.modeling.ops import simplify_solid

    return simplify_solid(SolidShape(v2, t3, f3))


def _retag_coplanar(v, t, f, owner, vb, tb, fb, na,
                    tol: float = 1e-6) -> np.ndarray:
    """Assign B's (offset) face id to A-owned result triangles coplanar
    with and inside a B face."""
    f = np.where(owner == 0, f, f + na)
    if len(t) == 0 or len(tb) == 0:
        return f
    scale = max(float(np.max(np.ptp(v, axis=0))), 1e-9)
    eps = tol * scale

    def tri_planes(verts, tris):
        n = np.cross(verts[tris[:, 1]] - verts[tris[:, 0]],
                     verts[tris[:, 2]] - verts[tris[:, 0]])
        ln = np.linalg.norm(n, axis=1)
        ok = ln > 1e-20
        n = n / np.maximum(ln, 1e-20)[:, None]
        w = np.einsum("ij,ij->i", n, verts[tris[:, 0]])
        return n, w, ok

    def plane_keys(verts, tris):
        """Sign-canonical quantized plane key rows (K, 4) + validity."""
        n, w, ok = tri_planes(verts, tris)
        flip = (n[:, 0] < -1e-12) | ((np.abs(n[:, 0]) <= 1e-12)
                                     & (n[:, 1] < -1e-12)) \
            | ((np.abs(n[:, 0]) <= 1e-12) & (np.abs(n[:, 1]) <= 1e-12)
               & (n[:, 2] < 0))
        n_c = np.where(flip[:, None], -n, n)
        w_c = np.where(flip, -w, w)
        key = np.round(np.concatenate([n_c, w_c[:, None] / scale], axis=1)
                       / 1e-5).astype(np.int64)
        return key, ok

    keyb, okb = plane_keys(vb, tb)
    keyr, okr = plane_keys(v, t)
    cand = np.flatnonzero((owner == 0) & okr)
    bsel = np.flatnonzero(okb)
    out = f.copy()
    if len(cand) == 0 or len(bsel) == 0:
        return out

    # group both sides by shared plane key: one lexsort over the stacked
    # keys; groups containing rows from both sides get a batched
    # point-in-triangle test (the dict/scalar version measured ~20 s on
    # Bottle.tcl; this is all-numpy)
    from cadrays_tpu.modeling.topo import unique_rows_int

    allk = np.concatenate([keyr[cand], keyb[bsel]])
    _, gid = unique_rows_int(allk)
    gr = gid[:len(cand)]
    gb = gid[len(cand):]
    in_both = np.intersect1d(gr, gb)
    if len(in_both) == 0:
        return out
    for g in in_both:
        ci = cand[gr == g]
        bj = bsel[gb == g]
        inside = _points_in_tris_3d(v[t[ci]].mean(axis=1), vb[tb[bj, 0]],
                                    vb[tb[bj, 1]], vb[tb[bj, 2]])
        hit_any = inside.any(axis=1)
        firstj = inside.argmax(axis=1)
        out[ci[hit_any]] = fb[bj[firstj[hit_any]]] + na
    return out


def _points_in_tris_3d(p, a, b, c):
    """(P, 3) points vs (T, 3)-cornered triangles -> (P, T) bool matrix
    of barycentric containment (coplanarity already established by the
    plane-key grouping)."""
    v0 = (c - a)[None, :, :]  # (1, T, 3)
    v1 = (b - a)[None, :, :]
    v2 = p[:, None, :] - a[None, :, :]  # (P, T, 3)
    d00 = np.einsum("ptk,ptk->pt", v0, v0)
    d01 = np.einsum("ptk,ptk->pt", v0, v1)
    d11 = np.einsum("ptk,ptk->pt", v1, v1)
    d20 = np.einsum("ptk,ptk->pt", v2, v0)
    d21 = np.einsum("ptk,ptk->pt", v2, v1)
    den = d00 * d11 - d01 * d01
    ok = np.abs(den) > 1e-30
    den = np.where(ok, den, 1.0)
    u = (d11 * d20 - d01 * d21) / den
    w = (d00 * d21 - d01 * d20) / den
    return ok & (u >= -1e-9) & (w >= -1e-9) & (u + w <= 1 + 1e-9)


def _weld_with_faces(v, t, f, owner=None, na=0):
    if owner is not None:
        f = np.where(owner == 0, f, f + na)
    scale = max(float(np.max(np.ptp(v, axis=0))), 1e-9) if len(v) else 1.0
    q = np.round(v / (1e-7 * scale)).astype(np.int64)
    from cadrays_tpu.modeling.topo import unique_rows_int

    first, inv = unique_rows_int(q)
    nv = v[first]
    nt = inv[t]
    ok = ((nt[:, 0] != nt[:, 1]) & (nt[:, 1] != nt[:, 2])
          & (nt[:, 0] != nt[:, 2]))
    nt = nt[ok].astype(np.int32)
    nf = f[ok]
    _, nf = np.unique(nf, return_inverse=True)
    return nv, nt, nf.astype(np.int32)


# ---------------------------------------------------------------------------
# cross-sections
# ---------------------------------------------------------------------------


def cross_section(verts: np.ndarray, tris: np.ndarray, plane: Plane,
                  ) -> List[Tuple[np.ndarray, bool]]:
    """Intersect a mesh with a plane -> chained 3D polylines.

    Returns [(points (N, 3), closed)]."""
    verts = np.asarray(verts, np.float64)
    d = verts @ plane.normal - plane.origin @ plane.normal
    dt = d[tris]  # (T, 3)
    segs = []
    for k in range(3):
        a, b, c = (tris[:, k], tris[:, (k + 1) % 3], tris[:, (k + 2) % 3])
        da, db, dc = dt[:, k], dt[:, (k + 1) % 3], dt[:, (k + 2) % 3]
        # triangles where vertex a is on one side, b and c on the other:
        # the two crossing edges are (a,b) and (a,c)
        m = ((da > 0) & (db <= 0) & (dc <= 0)) \
            | ((da < 0) & (db >= 0) & (dc >= 0))
        if not np.any(m):
            continue
        ia, ib, ic = a[m], b[m], c[m]
        ta = d[ia] / np.where(np.abs(d[ia] - d[ib]) < 1e-30, 1e-30,
                              d[ia] - d[ib])
        tb = d[ia] / np.where(np.abs(d[ia] - d[ic]) < 1e-30, 1e-30,
                              d[ia] - d[ic])
        p1 = verts[ia] + (verts[ib] - verts[ia]) * ta[:, None]
        p2 = verts[ia] + (verts[ic] - verts[ia]) * tb[:, None]
        segs.append(np.stack([p1, p2], axis=1))
    if not segs:
        return []
    seglist = [s for s in np.concatenate(segs)]
    return chain_polylines(seglist)


def face_cross_section(verts, tris, face: FaceShape
                       ) -> List[Tuple[np.ndarray, bool]]:
    """Cross-section clipped to a bounded planar face (DRAW `bsection`)."""
    from matplotlib.path import Path

    face = face.baked()
    chains = cross_section(verts, tris, face.plane)
    outers, holes = face.outer_and_holes()
    paths = [Path(o) for o in outers]
    hole_paths = [Path(h) for h in holes]
    out = []
    for pts, closed in chains:
        uv = face.plane.to_2d(pts)
        keep = np.zeros(len(uv), bool)
        for p in paths:
            keep |= p.contains_points(uv, radius=1e-9)
        for h in hole_paths:
            keep &= ~h.contains_points(uv, radius=-1e-9)
        # split into runs of kept points
        idx = np.flatnonzero(keep)
        if len(idx) == 0:
            continue
        splits = np.flatnonzero(np.diff(idx) > 1)
        for run in np.split(idx, splits + 1):
            if len(run) >= 2:
                out.append((pts[run], False))
    return out


# ---------------------------------------------------------------------------
# 2D face booleans through the 3D core
# ---------------------------------------------------------------------------


def _extrude_face_sym(face: FaceShape, h: float
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Thin symmetric extrusion of a planar face: caps at +-h."""
    n = face.plane.normal
    v, t = face.mesh()
    nv = len(v)
    verts = [v - n * h, v + n * h]
    tris = [t[:, [0, 2, 1]], t + nv]  # bottom flipped, top as-is
    face_id = [np.zeros(len(t), np.int32), np.ones(len(t), np.int32)]
    off = 2 * nv
    for li, loop in enumerate(face.loops):
        p3 = face.plane.to_3d(loop)
        p3 = p3 @ face.loc[:3, :3].T + face.loc[:3, 3]
        m = len(p3)
        lo = p3 - n * h
        hi = p3 + n * h
        verts += [lo, hi]
        from cadrays_tpu.modeling.triangulate import signed_area

        ccw = signed_area(loop) > 0
        quad_t = []
        for i in range(m):
            j = (i + 1) % m
            a, b = off + i, off + j
            c, d = off + m + i, off + m + j
            if ccw:
                quad_t += [[a, b, d], [a, d, c]]
            else:
                quad_t += [[a, d, b], [a, c, d]]
        tris.append(np.asarray(quad_t, np.int32))
        face_id.append(np.full(len(quad_t), 2 + li, np.int32))
        off += 2 * m
    return (np.concatenate(verts), np.concatenate(tris),
            np.concatenate(face_id))


def face_boolean(fa: FaceShape, fb: FaceShape, op: int) -> FaceShape:
    """2D boolean of two coplanar faces; result on fa's world plane."""
    fa = fa.baked()
    fb = fb.baked()
    pts = np.concatenate([l for l in fa.loops] + [l for l in fb.loops]) \
        if fa.loops and fb.loops else np.zeros((1, 2))
    scale = max(float(np.max(np.abs(pts))), 1.0)
    h = 1e-3 * scale
    va, ta, ia = _extrude_face_sym(fa, h)
    vb, tb, ib = _extrude_face_sym(fb, h)
    v, t, f, _ = mesh_boolean(va, ta, ia, vb, tb, ib, op)
    chains = cross_section(v, t, fa.plane)
    # Decimate: BSP fragments leave many collinear points and repeated
    # 2D booleans (Cutter.tcl's 25-tooth fuse loop) are quadratic in
    # polygon count. The tolerance is well below tessellation error.
    from cadrays_tpu.modeling.triangulate import decimate_polyline

    loops = []
    for pts, closed in chains:
        if not closed or len(pts) < 3:
            continue
        uv = fa.plane.to_2d(pts)
        span = max(float(np.max(np.ptp(uv, axis=0))), 1e-9)
        loops.append(decimate_polyline(uv, 2e-5 * scale + 1e-4 * span,
                                       closed=True))
    return FaceShape(fa.plane, loops)
