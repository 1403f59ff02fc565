"""Threaded (skip-link) BVH: SAH build on host, stackless traversal on device.

Design rationale. The reference delegates its two-level BVH to OCCT
("acceleration structures from OCCT", README.md:16-18). We lay the tree
out in depth-first order and store, per node, the index of
the node that follows its whole subtree (``skip``). Traversal is then a
single `while` loop with *no stack at all*:

    node = 0
    while node != -1:
        if ray hits aabb[node]:
            if leaf: intersect its triangles; node = skip[node]
            else:    node = node + 1          # descend into left child
        else:        node = skip[node]        # jump over the subtree

Every ray executes the same loop with no per-ray stack: the XLA walk
(ops/traverse.trace_gather) steps the whole wavefront in lockstep, the
CUDA kernel (native/traverse.cu) runs it in one thread per ray.
Triangles are reordered so each leaf owns a contiguous range.

Build: binned SAH (16 bins) with median-split fallback, max leaf size
configurable. Pure numpy; a C++ builder (cadrays_tpu/native) accelerates
large meshes with the same output layout.
"""
from __future__ import annotations

import dataclasses

import numpy as np

MAX_LEAF = 4
SAH_BINS = 16


@dataclasses.dataclass
class ThreadedBVH:
    """Flat SoA threaded BVH ready for device upload."""

    node_min: np.ndarray  # (N, 3) float32
    node_max: np.ndarray  # (N, 3) float32
    skip: np.ndarray  # (N,) int32, -1 = traversal done
    first: np.ndarray  # (N,) int32: leaf -> first tri in `order`; inner -> -1
    count: np.ndarray  # (N,) int32: leaf tri count; inner -> 0
    order: np.ndarray  # (T,) int32: tri permutation (leaf ranges contiguous)

    @property
    def num_nodes(self) -> int:
        return self.skip.shape[0]


def build_bvh(vertices: np.ndarray, indices: np.ndarray,
              max_leaf: int = MAX_LEAF, backend: str = "auto") -> ThreadedBVH:
    """Build a threaded BVH. backend: auto | native | python.

    `auto` uses the C++ builder (cadrays_tpu/native) when it compiles,
    falling back to this module's pure-numpy builder.
    """
    if backend in ("auto", "native"):
        out = _build_bvh_native(vertices, indices, max_leaf)
        if out is not None:
            return out
        if backend == "native":
            raise RuntimeError("native BVH builder unavailable "
                               "(run python -m cadrays_tpu.native.build)")
    return _build_bvh_python(vertices, indices, max_leaf)


def _build_bvh_native(vertices, indices, max_leaf):
    try:
        from cadrays_tpu.native.build import load_library
    except ImportError:
        return None
    lib = load_library()
    if lib is None:
        return None
    import ctypes

    v = np.ascontiguousarray(vertices, np.float32)
    tri = np.ascontiguousarray(indices, np.int32)
    T = tri.shape[0]
    if T == 0:
        return _build_bvh_python(vertices, indices, max_leaf)
    cap = 2 * T  # preorder binary tree with T leaves has < 2T nodes
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    skip = np.empty(cap, np.int32)
    first = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    order = np.empty(T, np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    n = lib.crt_build_bvh(
        v.ctypes.data_as(fp), v.shape[0],
        tri.ctypes.data_as(ip), T, max_leaf,
        node_min.ctypes.data_as(fp), node_max.ctypes.data_as(fp),
        skip.ctypes.data_as(ip), first.ctypes.data_as(ip),
        count.ctypes.data_as(ip), order.ctypes.data_as(ip))
    return ThreadedBVH(
        node_min=node_min[:n].copy(), node_max=node_max[:n].copy(),
        skip=skip[:n].copy(), first=first[:n].copy(),
        count=count[:n].copy(), order=order)


def _build_bvh_python(vertices: np.ndarray, indices: np.ndarray,
                      max_leaf: int = MAX_LEAF) -> ThreadedBVH:
    """Pure-numpy reference builder (same output layout as the native one)."""
    v = np.asarray(vertices, np.float32)
    tri = np.asarray(indices, np.int64)
    T = tri.shape[0]
    if T == 0:
        return ThreadedBVH(
            node_min=np.zeros((1, 3), np.float32),
            node_max=np.zeros((1, 3), np.float32),
            skip=np.full(1, -1, np.int32),
            first=np.zeros(1, np.int32),
            count=np.zeros(1, np.int32),
            order=np.zeros(0, np.int32),
        )

    p0, p1, p2 = v[tri[:, 0]], v[tri[:, 1]], v[tri[:, 2]]
    tmin = np.minimum(np.minimum(p0, p1), p2)
    tmax = np.maximum(np.maximum(p0, p1), p2)
    cent = (tmin + tmax) * 0.5

    # Recursive build producing (child_left, child_right | leaf range) tree,
    # then a DFS flattening pass computes the threaded layout.
    prims = np.arange(T)

    nodes = []  # list of dicts: {min, max, leaf:(start,count) | children:(l,r)}
    order_out = []

    import sys
    sys.setrecursionlimit(10000)

    def make_node(prim_ids) -> int:
        nid = len(nodes)
        nodes.append(None)
        lo = tmin[prim_ids].min(axis=0)
        hi = tmax[prim_ids].max(axis=0)
        n = prim_ids.size
        if n <= max_leaf:
            start = len(order_out)
            order_out.extend(prim_ids.tolist())
            nodes[nid] = {"min": lo, "max": hi, "leaf": (start, n)}
            return nid

        c = cent[prim_ids]
        clo, chi = c.min(axis=0), c.max(axis=0)
        extent = chi - clo
        axis = int(np.argmax(extent))
        split_ids = None
        if extent[axis] > 1e-12:
            # Binned SAH along the widest centroid axis.
            nb = SAH_BINS
            rel = (c[:, axis] - clo[axis]) / extent[axis]
            bins = np.minimum((rel * nb).astype(np.int64), nb - 1)
            bin_counts = np.bincount(bins, minlength=nb)
            bin_lo = np.full((nb, 3), np.inf, np.float32)
            bin_hi = np.full((nb, 3), -np.inf, np.float32)
            for b in range(nb):
                mask = bins == b
                if bin_counts[b]:
                    bin_lo[b] = tmin[prim_ids[mask]].min(axis=0)
                    bin_hi[b] = tmax[prim_ids[mask]].max(axis=0)

            def area(lo_, hi_):
                d = np.maximum(hi_ - lo_, 0.0)
                return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]

            # prefix/suffix sweep
            lcnt = np.cumsum(bin_counts)[:-1]
            rcnt = n - lcnt
            llo = np.minimum.accumulate(bin_lo, axis=0)[:-1]
            lhi = np.maximum.accumulate(bin_hi, axis=0)[:-1]
            rlo = np.minimum.accumulate(bin_lo[::-1], axis=0)[::-1][1:]
            rhi = np.maximum.accumulate(bin_hi[::-1], axis=0)[::-1][1:]
            cost = area(llo, lhi) * lcnt + area(rlo, rhi) * rcnt
            cost = np.where((lcnt == 0) | (rcnt == 0), np.inf, cost)
            best = int(np.argmin(cost))
            if np.isfinite(cost[best]):
                go_left = bins <= best
                split_ids = (prim_ids[go_left], prim_ids[~go_left])

        if split_ids is None or split_ids[0].size == 0 or split_ids[1].size == 0:
            # Median split fallback.
            key = c[:, axis]
            ordr = np.argsort(key, kind="stable")
            half = n // 2
            split_ids = (prim_ids[ordr[:half]], prim_ids[ordr[half:]])

        l = make_node(split_ids[0])
        r = make_node(split_ids[1])
        nodes[nid] = {"min": lo, "max": hi, "children": (l, r)}
        return nid

    make_node(prims)

    # The recursion above already assigns ids in DFS (pre)order: node, left
    # subtree, right subtree. skip[i] = next sibling-or-ancestor-sibling.
    N = len(nodes)
    node_min = np.zeros((N, 3), np.float32)
    node_max = np.zeros((N, 3), np.float32)
    skip = np.full(N, -1, np.int32)
    first = np.full(N, -1, np.int32)
    count = np.zeros(N, np.int32)

    def fill(nid: int, skip_to: int):
        nd = nodes[nid]
        node_min[nid] = nd["min"]
        node_max[nid] = nd["max"]
        skip[nid] = skip_to
        if "leaf" in nd:
            first[nid], count[nid] = nd["leaf"]
        else:
            l, r = nd["children"]
            fill(l, r)  # after left subtree comes the right child
            fill(r, skip_to)

    fill(0, -1)

    return ThreadedBVH(
        node_min=node_min,
        node_max=node_max,
        skip=skip,
        first=first.astype(np.int32),
        count=count,
        order=np.asarray(order_out, np.int32),
    )


def bvh_quality(bvh: ThreadedBVH) -> dict:
    """Diagnostics: SAH cost proxy + depth stats (host-side, tests/tools)."""
    d = np.maximum(bvh.node_max - bvh.node_min, 0.0)
    area = d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]
    root = max(area[0], 1e-20)
    leaf = bvh.count > 0
    return {
        "nodes": int(bvh.num_nodes),
        "leaves": int(leaf.sum()),
        "avg_leaf_size": float(bvh.count[leaf].mean()) if leaf.any() else 0.0,
        "sah_cost": float((area / root * np.where(leaf, bvh.count, 1)).sum()),
    }
