"""Trimmed parametric surface tessellation (the framework's own "CAD
kernel" back half).

The reference gets faces→triangles from OCCT's BRepMesh (`vsetdispmode 1`
/ `incmesh`, SURVEY.md §2.5 "Two-level BVH over tessellated CAD"); here we
own that step: a face is a parametric surface plus trimming loops in UV,
triangulated by ear clipping (holes bridged into the outer loop) and then
refined by longest-edge bisection until the chord deviation from the true
surface is below the deflection tolerance — the same user knob OCCT's
`incmesh <shape> <deflection>` exposes (preview.tcl:24).

Everything is host-side numpy: it runs once per import; the device consumes
only the resulting triangle arrays.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from cadrays_tpu.geometry.nurbs import BSplineCurve, BSplineSurface

TWO_PI = 2.0 * math.pi


# --------------------------------------------------------------------------
# frames
# --------------------------------------------------------------------------

def _unit(v):
    v = np.asarray(v, np.float64)
    return v / max(np.linalg.norm(v), 1e-300)


@dataclass
class Frame:
    """Right-handed placement frame (STEP AXIS2_PLACEMENT_3D)."""
    origin: np.ndarray
    z: np.ndarray
    x: np.ndarray

    def __post_init__(self):
        self.origin = np.asarray(self.origin, np.float64)
        self.z = _unit(self.z)
        x = np.asarray(self.x, np.float64)
        x = x - self.z * np.dot(x, self.z)
        if np.linalg.norm(x) < 1e-12:
            x = np.array([1.0, 0, 0]) if abs(self.z[0]) < 0.9 else np.array([0, 1.0, 0])
            x = x - self.z * np.dot(x, self.z)
        self.x = _unit(x)
        self.y = np.cross(self.z, self.x)

    def to_local(self, p: np.ndarray) -> np.ndarray:
        d = np.atleast_2d(p) - self.origin
        return np.stack([d @ self.x, d @ self.y, d @ self.z], axis=-1)

    def to_world(self, p: np.ndarray) -> np.ndarray:
        p = np.atleast_2d(p)
        return (self.origin + p[:, 0:1] * self.x + p[:, 1:2] * self.y
                + p[:, 2:3] * self.z)


# --------------------------------------------------------------------------
# parametric surfaces
# --------------------------------------------------------------------------

class ParamSurface:
    """eval/normal over (N,2) uv arrays + inverse mapping of 3D points."""
    period_u: Optional[float] = None
    period_v: Optional[float] = None

    def eval(self, uv: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def inverse(self, pts: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    # default numeric normal via central differences in uv
    def normal(self, uv: np.ndarray) -> np.ndarray:
        uv = np.atleast_2d(uv)
        hu = self._h_u()
        hv = self._h_v()
        du = (self.eval(uv + [hu, 0]) - self.eval(uv - [hu, 0])) / (2 * hu)
        dv = (self.eval(uv + [0, hv]) - self.eval(uv - [0, hv])) / (2 * hv)
        n = np.cross(du, dv)
        ln = np.linalg.norm(n, axis=-1, keepdims=True)
        bad = (ln[:, 0] < 1e-12)
        if bad.any():
            # degenerate spots (poles/apex): nudge inward and retry
            uv2 = uv[bad] + [3 * hu, 3 * hv]
            du2 = (self.eval(uv2 + [hu, 0]) - self.eval(uv2 - [hu, 0]))
            dv2 = (self.eval(uv2 + [0, hv]) - self.eval(uv2 - [0, hv]))
            n2 = np.cross(du2, dv2)
            n[bad] = n2
            ln = np.linalg.norm(n, axis=-1, keepdims=True)
        return n / np.maximum(ln, 1e-300)

    def _h_u(self) -> float:
        return 1e-5

    def _h_v(self) -> float:
        return 1e-5


@dataclass
class PlaneSurface(ParamSurface):
    frame: Frame

    def eval(self, uv):
        uv = np.atleast_2d(uv)
        z = np.zeros((uv.shape[0], 1))
        return self.frame.to_world(np.concatenate([uv, z], axis=1))

    def inverse(self, pts):
        return self.frame.to_local(pts)[:, :2]

    def normal(self, uv):
        uv = np.atleast_2d(uv)
        return np.broadcast_to(self.frame.z, (uv.shape[0], 3)).copy()

    def _h_u(self):
        return 1e-4

    _h_v = _h_u


@dataclass
class CylinderSurface(ParamSurface):
    frame: Frame
    radius: float
    period_u = TWO_PI

    def eval(self, uv):
        uv = np.atleast_2d(uv)
        u, v = uv[:, 0], uv[:, 1]
        local = np.stack([self.radius * np.cos(u), self.radius * np.sin(u), v], -1)
        return self.frame.to_world(local)

    def inverse(self, pts):
        l = self.frame.to_local(pts)
        return np.stack([np.arctan2(l[:, 1], l[:, 0]) % TWO_PI, l[:, 2]], -1)


@dataclass
class ConeSurface(ParamSurface):
    """STEP CONICAL_SURFACE: radius at the placement plane, semi-angle."""
    frame: Frame
    radius: float
    semi_angle: float
    period_u = TWO_PI

    def eval(self, uv):
        uv = np.atleast_2d(uv)
        u, v = uv[:, 0], uv[:, 1]
        r = self.radius + v * math.sin(self.semi_angle)
        local = np.stack([r * np.cos(u), r * np.sin(u),
                          v * math.cos(self.semi_angle)], -1)
        return self.frame.to_world(local)

    def inverse(self, pts):
        l = self.frame.to_local(pts)
        v = l[:, 2] / max(math.cos(self.semi_angle), 1e-12)
        return np.stack([np.arctan2(l[:, 1], l[:, 0]) % TWO_PI, v], -1)


@dataclass
class SphereSurface(ParamSurface):
    frame: Frame
    radius: float
    period_u = TWO_PI

    def eval(self, uv):
        uv = np.atleast_2d(uv)
        u, v = uv[:, 0], uv[:, 1]
        cv = np.cos(v)
        local = np.stack([self.radius * cv * np.cos(u),
                          self.radius * cv * np.sin(u),
                          self.radius * np.sin(v)], -1)
        return self.frame.to_world(local)

    def inverse(self, pts):
        l = self.frame.to_local(pts)
        r_xy = np.hypot(l[:, 0], l[:, 1])
        return np.stack([np.arctan2(l[:, 1], l[:, 0]) % TWO_PI,
                         np.arctan2(l[:, 2], r_xy)], -1)


@dataclass
class TorusSurface(ParamSurface):
    frame: Frame
    major_radius: float
    minor_radius: float
    period_u = TWO_PI
    period_v = TWO_PI

    def eval(self, uv):
        uv = np.atleast_2d(uv)
        u, v = uv[:, 0], uv[:, 1]
        r = self.major_radius + self.minor_radius * np.cos(v)
        local = np.stack([r * np.cos(u), r * np.sin(u),
                          self.minor_radius * np.sin(v)], -1)
        return self.frame.to_world(local)

    def inverse(self, pts):
        l = self.frame.to_local(pts)
        u = np.arctan2(l[:, 1], l[:, 0]) % TWO_PI
        r_xy = np.hypot(l[:, 0], l[:, 1]) - self.major_radius
        v = np.arctan2(l[:, 2], r_xy) % TWO_PI
        return np.stack([u, v], -1)


class _NumericInverse:
    """Gauss–Newton inverse seeded from a coarse parameter grid."""

    _grid_cache: Optional[Tuple[np.ndarray, np.ndarray]] = None

    def _domain(self) -> Tuple[Tuple[float, float], Tuple[float, float]]:
        raise NotImplementedError

    def _seed_grid(self, n: int = 24):
        if self._grid_cache is None:
            (u0, u1), (v0, v1) = self._domain()
            uu, vv = np.meshgrid(np.linspace(u0, u1, n), np.linspace(v0, v1, n))
            grid_uv = np.stack([uu.ravel(), vv.ravel()], -1)
            self._grid_cache = (grid_uv, self.eval(grid_uv))
        return self._grid_cache

    def inverse(self, pts):
        pts = np.atleast_2d(pts)
        grid_uv, grid_p = self._seed_grid()
        d = np.linalg.norm(pts[:, None, :] - grid_p[None, :, :], axis=-1)
        uv = grid_uv[np.argmin(d, axis=1)].copy()
        (u0, u1), (v0, v1) = self._domain()
        hu = max(1e-7, 1e-7 * (u1 - u0))
        hv = max(1e-7, 1e-7 * (v1 - v0))
        for _ in range(12):
            p = self.eval(uv)
            r = p - pts
            du = (self.eval(uv + [hu, 0]) - p) / hu
            dv = (self.eval(uv + [0, hv]) - p) / hv
            # 2x2 normal equations per point
            a = np.einsum("nd,nd->n", du, du)
            b = np.einsum("nd,nd->n", du, dv)
            c = np.einsum("nd,nd->n", dv, dv)
            g1 = np.einsum("nd,nd->n", du, r)
            g2 = np.einsum("nd,nd->n", dv, r)
            det = np.maximum(a * c - b * b, 1e-30)
            uv[:, 0] -= (c * g1 - b * g2) / det
            uv[:, 1] -= (a * g2 - b * g1) / det
            if self.period_u is None:
                uv[:, 0] = np.clip(uv[:, 0], u0, u1)
            if self.period_v is None:
                uv[:, 1] = np.clip(uv[:, 1], v0, v1)
        return uv


@dataclass
class ExtrusionSurface(_NumericInverse, ParamSurface):
    """STEP SURFACE_OF_LINEAR_EXTRUSION: swept_curve(u) + v * direction."""
    curve: "ParamCurve"
    direction: np.ndarray
    v_range: Tuple[float, float] = (-1e4, 1e4)

    def __post_init__(self):
        self.direction = np.asarray(self.direction, np.float64)
        self.period_u = getattr(self.curve, "period", None)

    def eval(self, uv):
        uv = np.atleast_2d(uv)
        return self.curve.eval(uv[:, 0]) + uv[:, 1:2] * self.direction

    def _domain(self):
        return self.curve.domain, self.v_range

    def _h_u(self):
        d = self.curve.domain
        return max(1e-7, 1e-5 * (d[1] - d[0]))


@dataclass
class RevolutionSurface(_NumericInverse, ParamSurface):
    """STEP SURFACE_OF_REVOLUTION: curve(v) rotated by u about an axis."""
    curve: "ParamCurve"
    axis_point: np.ndarray
    axis_dir: np.ndarray
    period_u = TWO_PI

    def __post_init__(self):
        self.axis_point = np.asarray(self.axis_point, np.float64)
        self.axis_dir = _unit(self.axis_dir)
        self.period_v = getattr(self.curve, "period", None)

    def eval(self, uv):
        uv = np.atleast_2d(uv)
        u = uv[:, 0]
        p = self.curve.eval(uv[:, 1]) - self.axis_point
        k = self.axis_dir
        cos_u, sin_u = np.cos(u)[:, None], np.sin(u)[:, None]
        # Rodrigues rotation of p about k by angle u
        rot = (p * cos_u + np.cross(k, p) * sin_u
               + k * (p @ k)[:, None] * (1 - cos_u))
        return rot + self.axis_point

    def _domain(self):
        return (0.0, TWO_PI), self.curve.domain

    def _h_v(self):
        d = self.curve.domain
        return max(1e-7, 1e-5 * (d[1] - d[0]))


class BSplineSurfaceAdapter(_NumericInverse, ParamSurface):
    def __init__(self, surf: BSplineSurface):
        self.surf = surf

    def eval(self, uv):
        uv = np.atleast_2d(uv)
        return self.surf.eval(uv[:, 0], uv[:, 1])

    def _domain(self):
        return self.surf.domain_u, self.surf.domain_v

    def _h_u(self):
        d = self.surf.domain_u
        return max(1e-7, 1e-5 * (d[1] - d[0]))

    def _h_v(self):
        d = self.surf.domain_v
        return max(1e-7, 1e-5 * (d[1] - d[0]))


# --------------------------------------------------------------------------
# parametric curves (for edges + swept surfaces)
# --------------------------------------------------------------------------

class ParamCurve:
    domain: Tuple[float, float] = (0.0, 1.0)
    period: Optional[float] = None

    def eval(self, t: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def param_of(self, p: np.ndarray) -> float:
        """Parameter of a point known to lie on the curve."""
        raise NotImplementedError


@dataclass
class LineCurve(ParamCurve):
    origin: np.ndarray
    direction: np.ndarray      # unit; STEP parameterizes by arc length x |vector|

    def __post_init__(self):
        self.origin = np.asarray(self.origin, np.float64)
        self.direction = np.asarray(self.direction, np.float64)
        self.domain = (-1e9, 1e9)

    def eval(self, t):
        t = np.atleast_1d(np.asarray(t, np.float64))
        return self.origin + t[:, None] * self.direction

    def param_of(self, p):
        d2 = np.dot(self.direction, self.direction)
        return float(np.dot(np.asarray(p, np.float64) - self.origin,
                            self.direction) / max(d2, 1e-300))


@dataclass
class CircleCurve(ParamCurve):
    frame: Frame
    radius: float
    period = TWO_PI

    def __post_init__(self):
        self.domain = (0.0, TWO_PI)

    def eval(self, t):
        t = np.atleast_1d(np.asarray(t, np.float64))
        local = np.stack([self.radius * np.cos(t), self.radius * np.sin(t),
                          np.zeros_like(t)], -1)
        return self.frame.to_world(local)

    def param_of(self, p):
        l = self.frame.to_local(np.asarray(p, np.float64))[0]
        return float(np.arctan2(l[1], l[0]) % TWO_PI)


@dataclass
class EllipseCurve(ParamCurve):
    frame: Frame
    major: float
    minor: float
    period = TWO_PI

    def __post_init__(self):
        self.domain = (0.0, TWO_PI)

    def eval(self, t):
        t = np.atleast_1d(np.asarray(t, np.float64))
        local = np.stack([self.major * np.cos(t), self.minor * np.sin(t),
                          np.zeros_like(t)], -1)
        return self.frame.to_world(local)

    def param_of(self, p):
        l = self.frame.to_local(np.asarray(p, np.float64))[0]
        return float(np.arctan2(l[1] / self.minor, l[0] / self.major) % TWO_PI)


class BSplineCurveAdapter(ParamCurve):
    def __init__(self, curve: BSplineCurve):
        self.curve = curve
        self.domain = curve.domain
        self.period = None

    def eval(self, t):
        return self.curve.eval(t)

    def param_of(self, p):
        t = np.linspace(self.domain[0], self.domain[1], 256)
        pts = self.eval(t)
        i = int(np.argmin(np.linalg.norm(
            pts - np.asarray(p, np.float64), axis=-1)))
        # local refinement around the best sample
        lo = t[max(i - 1, 0)]
        hi = t[min(i + 1, len(t) - 1)]
        for _ in range(24):
            mids = np.linspace(lo, hi, 9)
            d = np.linalg.norm(self.eval(mids) - np.asarray(p), axis=-1)
            j = int(np.argmin(d))
            lo = mids[max(j - 1, 0)]
            hi = mids[min(j + 1, 8)]
        return float(0.5 * (lo + hi))


@dataclass
class PolylineCurve(ParamCurve):
    points: np.ndarray   # (N, 3); parameter = segment index in [0, N-1]

    def __post_init__(self):
        self.points = np.asarray(self.points, np.float64)
        self.domain = (0.0, float(len(self.points) - 1))

    def eval(self, t):
        t = np.clip(np.atleast_1d(np.asarray(t, np.float64)),
                    0, len(self.points) - 1)
        i = np.clip(t.astype(int), 0, len(self.points) - 2)
        f = (t - i)[:, None]
        return self.points[i] * (1 - f) + self.points[i + 1] * f

    def param_of(self, p):
        d = np.linalg.norm(self.points - np.asarray(p, np.float64), axis=-1)
        return float(np.argmin(d))


# --------------------------------------------------------------------------
# adaptive curve sampling
# --------------------------------------------------------------------------

def sample_curve(curve: ParamCurve, t0: float, t1: float, deflection: float,
                 min_pts: int = 2, max_pts: int = 512) -> np.ndarray:
    """Sample curve params in [t0, t1] until chord error < deflection."""
    ts = list(np.linspace(t0, t1, max(min_pts, 2)))
    for _ in range(16):
        if len(ts) >= max_pts:
            break
        arr = np.asarray(ts)
        mids = 0.5 * (arr[:-1] + arr[1:])
        p = curve.eval(arr)
        pm = curve.eval(mids)
        err = np.linalg.norm(pm - 0.5 * (p[:-1] + p[1:]), axis=-1)
        bad = err > deflection
        if not bad.any():
            break
        new = sorted(ts + list(mids[bad]))
        ts = new
    return np.asarray(ts, np.float64)


# --------------------------------------------------------------------------
# 2D ear clipping with holes
# --------------------------------------------------------------------------

def _signed_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _point_in_tri(p, a, b, c, eps=1e-12):
    d1 = (p[..., 0] - b[0]) * (a[1] - b[1]) - (a[0] - b[0]) * (p[..., 1] - b[1])
    d2 = (p[..., 0] - c[0]) * (b[1] - c[1]) - (b[0] - c[0]) * (p[..., 1] - c[1])
    d3 = (p[..., 0] - a[0]) * (c[1] - a[1]) - (c[0] - a[0]) * (p[..., 1] - a[1])
    neg = (d1 < -eps) | (d2 < -eps) | (d3 < -eps)
    pos = (d1 > eps) | (d2 > eps) | (d3 > eps)
    return ~(neg & pos)


def _bridge_holes(outer: List[int], holes: List[List[int]],
                  pts: np.ndarray) -> List[int]:
    """Splice holes into the outer ring via mutually-visible bridges
    (classic earcut hole handling: rightmost hole vertex → visible outer
    vertex, duplicated bridge edge)."""
    holes = sorted(holes, key=lambda h: -pts[h, 0].max())
    poly = list(outer)
    for hole in holes:
        hi = int(np.argmax(pts[hole, 0]))
        hv = hole[hi]
        hp = pts[hv]
        # candidate outer vertices to the right of the hole vertex,
        # nearest first; accept the first with an unobstructed segment
        order = sorted(range(len(poly)),
                       key=lambda j: np.sum((pts[poly[j]] - hp) ** 2))
        best = None
        for j in order:
            ov = poly[j]
            a, b = hp, pts[ov]
            blocked = False
            m = len(poly)
            for k in range(m):
                p1, p2 = poly[k], poly[(k + 1) % m]
                if ov in (p1, p2):
                    continue
                if _segs_cross(a, b, pts[p1], pts[p2]):
                    blocked = True
                    break
            if not blocked:
                best = j
                break
        if best is None:
            best = order[0]
        # splice: outer[...best], hole[hi..]+hole[..hi], bridge back
        rot_hole = hole[hi:] + hole[:hi]
        poly = (poly[:best + 1] + rot_hole + [rot_hole[0]] + poly[best:])
    return poly


def _segs_cross(a, b, c, d, eps=1e-12):
    def orient(p, q, r):
        return (q[0] - p[0]) * (r[1] - p[1]) - (q[1] - p[1]) * (r[0] - p[0])

    o1, o2 = orient(a, b, c), orient(a, b, d)
    o3, o4 = orient(c, d, a), orient(c, d, b)
    return (o1 * o2 < -eps) and (o3 * o4 < -eps)


def earcut(pts: np.ndarray, outer: List[int],
           holes: Optional[List[List[int]]] = None) -> np.ndarray:
    """Triangulate a polygon (CCW outer, CW holes) given as index rings
    into pts (N,2). Returns (T,3) int32 indices. O(n^2), fine for CAD
    trimming loops."""
    if holes:
        ring = _bridge_holes(list(outer), [list(h) for h in holes], pts)
    else:
        ring = list(outer)
    tris = []
    guard = 0
    while len(ring) > 3 and guard < 100000:
        guard += 1
        n = len(ring)
        clipped = False
        for i in range(n):
            ia, ib, ic = ring[(i - 1) % n], ring[i], ring[(i + 1) % n]
            a, b, c = pts[ia], pts[ib], pts[ic]
            cross = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
            if cross <= 1e-14:      # reflex or degenerate
                continue
            others = [v for v in ring if v not in (ia, ib, ic)]
            if others:
                inside = _point_in_tri(pts[others], a, b, c)
                # ignore vertices coincident with the ear's corners
                # (duplicated bridge vertices)
                op = pts[others]
                dup = ((np.abs(op - a).sum(-1) < 1e-14)
                       | (np.abs(op - b).sum(-1) < 1e-14)
                       | (np.abs(op - c).sum(-1) < 1e-14))
                if (inside & ~dup).any():
                    continue
            tris.append((ia, ib, ic))
            del ring[i]
            clipped = True
            break
        if not clipped:
            # fallback: clip the least-bad ear to guarantee progress
            best_i, best_cross = 0, -np.inf
            for i in range(n):
                ia, ib, ic = ring[(i - 1) % n], ring[i], ring[(i + 1) % n]
                a, b, c = pts[ia], pts[ib], pts[ic]
                cross = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
                if cross > best_cross:
                    best_cross, best_i = cross, i
            i = best_i
            ia, ib, ic = ring[(i - 1) % n], ring[i], ring[(i + 1) % n]
            if best_cross > 1e-14:
                tris.append((ia, ib, ic))
            del ring[i]
    if len(ring) == 3:
        a, b, c = pts[ring[0]], pts[ring[1]], pts[ring[2]]
        cross = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
        if cross > 1e-14:
            tris.append(tuple(ring))
    return np.asarray(tris, np.int32).reshape(-1, 3)


# --------------------------------------------------------------------------
# Delaunay edge flips (mesh quality)
# --------------------------------------------------------------------------

def _incircle(a, b, c, d):
    """> 0 when d is inside the circumcircle of CCW triangle (a,b,c)."""
    m = np.array([
        [a[0] - d[0], a[1] - d[1], (a[0] - d[0]) ** 2 + (a[1] - d[1]) ** 2],
        [b[0] - d[0], b[1] - d[1], (b[0] - d[0]) ** 2 + (b[1] - d[1]) ** 2],
        [c[0] - d[0], c[1] - d[1], (c[0] - d[0]) ** 2 + (c[1] - d[1]) ** 2],
    ])
    return np.linalg.det(m)


def _cross2(o, p, q):
    return (p[0] - o[0]) * (q[1] - o[1]) - (p[1] - o[1]) * (q[0] - o[0])


def delaunay_flip(uv: np.ndarray, tris: np.ndarray,
                  passes: int = 6) -> np.ndarray:
    """Lawson edge flips toward a Delaunay triangulation in UV.

    Ear clipping of dense trimming loops leaves razor-thin slivers whose
    3D images fold over the surface (overlapping area); flipping restores
    quality without moving any vertex."""
    tris = np.asarray(tris, np.int64).copy()
    for _ in range(passes):
        E = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
        opp = np.concatenate([tris[:, 2], tris[:, 0], tris[:, 1]])
        tid = np.tile(np.arange(len(tris)), 3)
        key = np.sort(E, axis=1)
        uniq, inv, counts = np.unique(
            key, axis=0, return_inverse=True, return_counts=True)
        order = np.argsort(inv, kind="stable")
        starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
        used = np.zeros(len(tris), bool)
        nflip = 0
        for e in np.where(counts == 2)[0]:
            i1, i2 = order[starts[e]], order[starts[e] + 1]
            t1, t2 = tid[i1], tid[i2]
            if used[t1] or used[t2]:
                continue
            u_, v_ = E[i1]
            w1, w2 = opp[i1], opp[i2]
            if w1 == w2:
                continue
            pu, pv, p1, p2 = uv[u_], uv[v_], uv[w1], uv[w2]
            # flip only if strictly Delaunay-improving and both new
            # triangles stay positively oriented (convex quad)
            if _incircle(pu, pv, p1, p2) <= 1e-14:
                continue
            if _cross2(p2, p1, pu) <= 1e-14 or _cross2(p1, p2, pv) <= 1e-14:
                continue
            tris[t1] = (u_, w2, w1)
            tris[t2] = (v_, w1, w2)
            used[t1] = used[t2] = True
            nflip += 1
        if nflip == 0:
            break
    return tris


# --------------------------------------------------------------------------
# refinement: longest-edge bisection until chord error < deflection
# --------------------------------------------------------------------------

def refine_to_deflection(surface: ParamSurface, uv: np.ndarray,
                         tris: np.ndarray, deflection: float,
                         max_iters: int = 12,
                         max_tris: int = 200_000):
    """Split triangle edges whose UV midpoint deviates from the 3D chord
    midpoint by more than `deflection`. Returns (uv, pts3d, tris).

    Edges spanning more than 1/16 of a periodic parameter axis are always
    split: ear clipping of a seam-unwrapped loop produces UV slivers that
    wrap far around the surface — their chord midpoints can lie *on* the
    surface while the linear triangle is wildly wrong, so a pure
    chord-error test converges far too slowly for them."""
    uv = np.asarray(uv, np.float64)
    tris = delaunay_flip(uv, np.asarray(tris, np.int64))
    pts = surface.eval(uv)
    span_cap = np.array([
        (surface.period_u or np.inf) / 16.0,
        (surface.period_v or np.inf) / 16.0,
    ])
    for _ in range(max_iters):
        if len(tris) == 0 or len(tris) >= max_tris:
            break
        edges = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
        ekey = np.sort(edges, axis=1)
        uniq, inv = np.unique(ekey, axis=0, return_inverse=True)
        mid_uv = 0.5 * (uv[uniq[:, 0]] + uv[uniq[:, 1]])
        mid_lin = 0.5 * (pts[uniq[:, 0]] + pts[uniq[:, 1]])
        mid_true = surface.eval(mid_uv)
        err = np.linalg.norm(mid_true - mid_lin, axis=-1)
        uv_span = np.abs(uv[uniq[:, 0]] - uv[uniq[:, 1]])
        split = (err > deflection) | (uv_span > span_cap).any(axis=1)
        if not split.any():
            break
        new_id = np.full(len(uniq), -1, np.int64)
        new_id[split] = len(uv) + np.arange(int(split.sum()))
        uv = np.vstack([uv, mid_uv[split]])
        pts = np.vstack([pts, mid_true[split]])
        e_tri = inv.reshape(3, -1).T          # (T,3): edge ids (01,12,20)
        m = new_id[e_tri]                     # (T,3): mid ids or -1
        out = []
        for t in range(len(tris)):
            a, b, c = tris[t]
            m01, m12, m20 = m[t]
            # int() casts: numpy>=2 defines bool_+bool_ as logical OR
            k = int(m01 >= 0) + int(m12 >= 0) + int(m20 >= 0)
            if k == 0:
                out.append((a, b, c))
            elif k == 3:
                out += [(a, m01, m20), (m01, b, m12),
                        (m20, m12, c), (m01, m12, m20)]
            elif k == 1:
                if m01 >= 0:
                    out += [(a, m01, c), (m01, b, c)]
                elif m12 >= 0:
                    out += [(a, b, m12), (a, m12, c)]
                else:
                    out += [(a, b, m20), (m20, b, c)]
            else:  # k == 2
                if m01 < 0:
                    out += [(m12, c, m20), (a, b, m20), (b, m12, m20)]
                elif m12 < 0:
                    out += [(m01, b, m20), (b, c, m20), (a, m01, m20)]
                else:
                    out += [(a, m01, m12), (m01, b, m12), (a, m12, c)]
        tris = delaunay_flip(uv, np.asarray(out, np.int64))
    return uv, pts, tris.astype(np.int32)


# --------------------------------------------------------------------------
# face pipeline
# --------------------------------------------------------------------------

@dataclass
class TrimLoop:
    """One trimming loop of a face, as a closed UV polyline (last point
    NOT repeated) with matching 3D points."""
    uv: np.ndarray      # (N, 2)
    pts: np.ndarray     # (N, 3)


def unwrap_periodic(uv: np.ndarray, period_u: Optional[float],
                    period_v: Optional[float]) -> np.ndarray:
    """Make a UV polyline continuous across periodic seams: shift each
    point by multiples of the period to stay within half a period of its
    predecessor."""
    uv = uv.copy()
    for axis, period in ((0, period_u), (1, period_v)):
        if period is None:
            continue
        d = np.diff(uv[:, axis])
        shift = -period * np.round(d / period)
        uv[1:, axis] += np.cumsum(shift)
    return uv


def _fix_pole_u(uv: np.ndarray, pts: np.ndarray, surface: ParamSurface):
    """At parametric poles (sphere poles, cone apex) u is arbitrary —
    copy it from the nearest non-degenerate neighbor to avoid seam
    zigzags."""
    if isinstance(surface, SphereSurface):
        pole = np.abs(np.abs(uv[:, 1]) - math.pi / 2) < 1e-9
    elif isinstance(surface, ConeSurface):
        apex_v = -surface.radius / max(math.sin(surface.semi_angle), 1e-12) \
            if surface.semi_angle != 0 else np.inf
        pole = np.abs(uv[:, 1] - apex_v) < 1e-9
    else:
        return uv
    if pole.any() and not pole.all():
        idx = np.where(~pole)[0]
        for i in np.where(pole)[0]:
            j = idx[np.argmin(np.abs(idx - i))]
            uv[i, 0] = uv[j, 0]
    return uv


def tessellate_face(surface: ParamSurface, loops: List[TrimLoop],
                    deflection: float, same_sense: bool = True):
    """Triangulate a trimmed face.

    Returns (vertices (V,3) f32, normals (V,3) f32, uvs (V,2) f32,
    tris (T,3) i32) or None when the face is degenerate.
    """
    if not loops:
        return None
    # normalize each loop: unwrap seams, fix poles
    fixed = []
    for lp in loops:
        uv = unwrap_periodic(lp.uv, surface.period_u, surface.period_v)
        uv = _fix_pole_u(uv, lp.pts, surface)
        fixed.append(TrimLoop(uv, lp.pts))
    # outer loop = largest |area|; orient CCW, holes CW
    areas = [_signed_area(lp.uv) for lp in fixed]
    outer_i = int(np.argmax([abs(a) for a in areas]))
    if abs(areas[outer_i]) < 1e-18:
        return None
    rings = []
    for i, lp in enumerate(fixed):
        uv = lp.uv
        want_ccw = (i == outer_i)
        if (areas[i] > 0) != want_ccw:
            uv = uv[::-1]
        rings.append(uv)
    # hole loops may sit in a different period window than the outer
    # ring on periodic surfaces — shift them to overlap the outer bbox
    if surface.period_u or surface.period_v:
        o_min = rings[outer_i].min(0)
        o_max = rings[outer_i].max(0)
        for i, r in enumerate(rings):
            if i == outer_i:
                continue
            for axis, period in ((0, surface.period_u), (1, surface.period_v)):
                if period is None:
                    continue
                c = 0.5 * (r[:, axis].min() + r[:, axis].max())
                oc = 0.5 * (o_min[axis] + o_max[axis])
                r[:, axis] += period * np.round((oc - c) / period)
    # concatenated point table + index rings
    all_uv = np.vstack(rings)
    offs = np.cumsum([0] + [len(r) for r in rings])
    outer_ring = list(range(offs[outer_i], offs[outer_i + 1]))
    hole_rings = [list(range(offs[i], offs[i + 1]))
                  for i in range(len(rings)) if i != outer_i]
    # scale UV to comparable magnitude for robust ear tests
    span = np.maximum(all_uv.max(0) - all_uv.min(0), 1e-12)
    norm_uv = (all_uv - all_uv.min(0)) / span
    tris = earcut(norm_uv, outer_ring, hole_rings)
    if len(tris) == 0:
        return None
    uv2, pts3, tris = refine_to_deflection(surface, all_uv, tris, deflection)
    normals = surface.normal(uv2)
    if not same_sense:
        normals = -normals
        tris = tris[:, ::-1]
    return (pts3.astype(np.float32), normals.astype(np.float32),
            uv2.astype(np.float32), tris.astype(np.int32))
