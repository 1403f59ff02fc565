"""B-spline / NURBS curve and surface evaluation (host-side numpy).

CAD kernels express freeform geometry as NURBS; the reference delegates
evaluation + tessellation to OCCT (SURVEY.md §2.5, L1 `[OCCT-contract]`,
driven via `testreadstep`/`testreadiges`, ImportSettingsEditor.cxx:317-370).
This module is the framework's own evaluator: vectorized Cox–de Boor over
parameter arrays, with first derivatives for normals and curvature-driven
sampling. Host-side geometry prep is numpy by design — it runs once per
import, the device only ever sees the tessellated triangles.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


def _find_span(knots: np.ndarray, degree: int, t: np.ndarray) -> np.ndarray:
    """Knot span index per parameter (vectorized).

    Returns i such that knots[i] <= t < knots[i+1], clamped to the valid
    range [degree, n_ctrl-1].
    """
    n_ctrl = len(knots) - degree - 1
    t = np.clip(t, knots[degree], knots[n_ctrl])
    span = np.searchsorted(knots, t, side="right") - 1
    return np.clip(span, degree, n_ctrl - 1)


def _basis_funs(knots: np.ndarray, degree: int, span: np.ndarray,
                t: np.ndarray) -> np.ndarray:
    """All (degree+1) nonzero basis functions at each t. Shape (N, d+1)."""
    N = np.zeros((t.shape[0], degree + 1), np.float64)
    N[:, 0] = 1.0
    left = np.zeros((t.shape[0], degree + 1), np.float64)
    right = np.zeros((t.shape[0], degree + 1), np.float64)
    for j in range(1, degree + 1):
        left[:, j] = t - knots[span + 1 - j]
        right[:, j] = knots[span + j] - t
        saved = np.zeros(t.shape[0], np.float64)
        for r in range(j):
            denom = right[:, r + 1] + left[:, j - r]
            temp = np.where(denom != 0.0, N[:, r] / np.where(denom == 0, 1, denom), 0.0)
            N[:, r] = saved + right[:, r + 1] * temp
            saved = left[:, j - r] * temp
        N[:, j] = saved
    return N


def _eval_bspline(knots: np.ndarray, degree: int, ctrl: np.ndarray,
                  t: np.ndarray) -> np.ndarray:
    """Evaluate a (possibly weighted) b-spline at t. ctrl: (n, dim)."""
    span = _find_span(knots, degree, t)
    N = _basis_funs(knots, degree, span, t)
    idx = span[:, None] - degree + np.arange(degree + 1)[None, :]
    return np.einsum("nk,nkd->nd", N, ctrl[idx])


@dataclass
class BSplineCurve:
    """NURBS curve: control points (n,3), optional weights (n,)."""
    degree: int
    knots: np.ndarray        # full knot vector, length n + degree + 1
    ctrl: np.ndarray         # (n, 3)
    weights: Optional[np.ndarray] = None

    def __post_init__(self):
        self.knots = np.asarray(self.knots, np.float64)
        self.ctrl = np.asarray(self.ctrl, np.float64)
        if self.weights is not None:
            self.weights = np.asarray(self.weights, np.float64)

    @property
    def domain(self):
        return (float(self.knots[self.degree]),
                float(self.knots[len(self.knots) - self.degree - 1]))

    def eval(self, t: np.ndarray) -> np.ndarray:
        t = np.atleast_1d(np.asarray(t, np.float64))
        if self.weights is None:
            return _eval_bspline(self.knots, self.degree, self.ctrl, t)
        cw = np.concatenate(
            [self.ctrl * self.weights[:, None], self.weights[:, None]], axis=1)
        p = _eval_bspline(self.knots, self.degree, cw, t)
        return p[:, :3] / p[:, 3:4]


@dataclass
class BSplineSurface:
    """NURBS surface: control net (nu, nv, 3), optional weights (nu, nv)."""
    degree_u: int
    degree_v: int
    knots_u: np.ndarray
    knots_v: np.ndarray
    ctrl: np.ndarray                       # (nu, nv, 3)
    weights: Optional[np.ndarray] = None   # (nu, nv)

    def __post_init__(self):
        self.knots_u = np.asarray(self.knots_u, np.float64)
        self.knots_v = np.asarray(self.knots_v, np.float64)
        self.ctrl = np.asarray(self.ctrl, np.float64)
        if self.weights is not None:
            self.weights = np.asarray(self.weights, np.float64)

    @property
    def domain_u(self):
        return (float(self.knots_u[self.degree_u]),
                float(self.knots_u[len(self.knots_u) - self.degree_u - 1]))

    @property
    def domain_v(self):
        return (float(self.knots_v[self.degree_v]),
                float(self.knots_v[len(self.knots_v) - self.degree_v - 1]))

    def _ctrl4(self) -> np.ndarray:
        if self.weights is None:
            w = np.ones(self.ctrl.shape[:2], np.float64)
        else:
            w = self.weights
        return np.concatenate([self.ctrl * w[..., None], w[..., None]], axis=-1)

    def eval(self, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        """Pointwise evaluation at paired (u[i], v[i]). Returns (N, 3)."""
        u = np.atleast_1d(np.asarray(u, np.float64))
        v = np.atleast_1d(np.asarray(v, np.float64))
        c4 = self._ctrl4()
        su = _find_span(self.knots_u, self.degree_u, u)
        sv = _find_span(self.knots_v, self.degree_v, v)
        Nu = _basis_funs(self.knots_u, self.degree_u, su, u)
        Nv = _basis_funs(self.knots_v, self.degree_v, sv, v)
        iu = su[:, None] - self.degree_u + np.arange(self.degree_u + 1)[None, :]
        iv = sv[:, None] - self.degree_v + np.arange(self.degree_v + 1)[None, :]
        # gather (N, du+1, dv+1, 4) patch of control points
        patch = c4[iu[:, :, None], iv[:, None, :]]
        p = np.einsum("na,nb,nabd->nd", Nu, Nv, patch)
        return p[:, :3] / p[:, 3:4]

    def derivs(self, u: np.ndarray, v: np.ndarray, h: float = 1e-6):
        """First partials via central differences inside the domain."""
        u = np.atleast_1d(np.asarray(u, np.float64))
        v = np.atleast_1d(np.asarray(v, np.float64))
        (u0, u1), (v0, v1) = self.domain_u, self.domain_v
        hu = max(h, 1e-9 * max(1.0, abs(u1 - u0)))
        hv = max(h, 1e-9 * max(1.0, abs(v1 - v0)))
        up, um = np.clip(u + hu, u0, u1), np.clip(u - hu, u0, u1)
        vp, vm = np.clip(v + hv, v0, v1), np.clip(v - hv, v0, v1)
        du = (self.eval(up, v) - self.eval(um, v)) / (up - um)[:, None]
        dv = (self.eval(u, vp) - self.eval(u, vm)) / (vp - vm)[:, None]
        return du, dv
