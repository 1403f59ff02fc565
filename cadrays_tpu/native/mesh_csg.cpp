// Mesh boolean operations via BSP solid clipping (csg.js algorithm,
// re-derived in list form with AABB culling).
//
// Native replacement for the reference's OCCT boolean commands
// (bcut/bfuse/bcommon/bop — driven by data/scripts/*.tcl). The modeling
// layer works on watertight triangle meshes with per-triangle face ids,
// so booleans are mesh-level: build a BSP *classification* tree per
// operand, clip the other operand's polygons through it, merge lists.
// Face ids survive clipping, keeping `explode <r> f` meaningful after a
// boolean.
//
// Two structural optimizations over the textbook csg.js formulation
// (measured ~2.2 s/boolean on Bottle.tcl's threaded-neck fuses before):
//  * polygons whose AABB misses the other operand's AABB are routed
//    straight to the output (or dropped) by op-specific rules — only the
//    overlap region pays BSP clipping;
//  * the final `A.build(B.allPolygons())` merge tree of csg.js is
//    replaced by list concatenation (+ a global flip where the original
//    ended with A.invert()) — the merge build only re-split polygons, it
//    never filtered anything.
//
// ABI (ctypes): flat float64/int32 arrays in, malloc'd arrays out,
// crt_csg_free releases. Operation codes: 0=union 1=subtract 2=intersect.
#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <memory>

namespace {

constexpr double EPS = 1e-7;

struct Vec {
  double x, y, z;
  Vec operator+(const Vec& o) const { return {x + o.x, y + o.y, z + o.z}; }
  Vec operator-(const Vec& o) const { return {x - o.x, y - o.y, z - o.z}; }
  Vec operator*(double s) const { return {x * s, y * s, z * s}; }
  double dot(const Vec& o) const { return x * o.x + y * o.y + z * o.z; }
  Vec cross(const Vec& o) const {
    return {y * o.z - z * o.y, z * o.x - x * o.z, x * o.y - y * o.x};
  }
  double len() const { return std::sqrt(dot(*this)); }
};

struct Plane {
  Vec n;
  double w;
  bool ok = false;
  static Plane from_points(const Vec& a, const Vec& b, const Vec& c) {
    Plane p;
    Vec n = (b - a).cross(c - a);
    double l = n.len();
    if (l < 1e-12) return p;
    p.n = n * (1.0 / l);
    p.w = p.n.dot(a);
    p.ok = true;
    return p;
  }
  void flip() { n = n * -1.0; w = -w; }
};

struct Polygon {
  std::vector<Vec> v;
  Plane plane;
  int32_t face_id;
  int32_t owner;  // 0 = from A, 1 = from B (face id namespaces)
  void flip() {
    std::reverse(v.begin(), v.end());
    plane.flip();
  }
};

void flip_all(std::vector<Polygon>& ps) {
  for (auto& p : ps) p.flip();
}

enum { COPLANAR = 0, FRONT = 1, BACK = 2, SPANNING = 3 };

void split_polygon(const Plane& pl, Polygon&& poly,
                   std::vector<Polygon>& cofront,
                   std::vector<Polygon>& coback,
                   std::vector<Polygon>& front,
                   std::vector<Polygon>& back) {
  int poly_type = 0;
  static thread_local std::vector<int> types;
  types.clear();
  for (const auto& vv : poly.v) {
    double t = pl.n.dot(vv) - pl.w;
    int ty = (t < -EPS) ? BACK : (t > EPS) ? FRONT : COPLANAR;
    poly_type |= ty;
    types.push_back(ty);
  }
  switch (poly_type) {
    case COPLANAR:
      (pl.n.dot(poly.plane.n) > 0 ? cofront : coback)
          .push_back(std::move(poly));
      break;
    case FRONT:
      front.push_back(std::move(poly));
      break;
    case BACK:
      back.push_back(std::move(poly));
      break;
    case SPANNING: {
      Polygon f, b;
      f.plane = b.plane = poly.plane;
      f.face_id = b.face_id = poly.face_id;
      f.owner = b.owner = poly.owner;
      size_t n = poly.v.size();
      for (size_t i = 0; i < n; ++i) {
        size_t j = (i + 1) % n;
        int ti = types[i], tj = types[j];
        const Vec &vi = poly.v[i], &vj = poly.v[j];
        if (ti != BACK) f.v.push_back(vi);
        if (ti != FRONT) b.v.push_back(vi);
        if ((ti | tj) == SPANNING) {
          double t = (pl.w - pl.n.dot(vi)) / pl.n.dot(vj - vi);
          Vec v = vi + (vj - vi) * t;
          f.v.push_back(v);
          b.v.push_back(v);
        }
      }
      if (f.v.size() >= 3) front.push_back(std::move(f));
      if (b.v.size() >= 3) back.push_back(std::move(b));
      break;
    }
  }
}

// Classification-only BSP: planes + children encode the solid; stored
// polygons are not needed after build (clipping uses structure only).
struct Node {
  Plane plane;
  std::unique_ptr<Node> front, back;

  void invert() {
    plane.flip();
    if (front) front->invert();
    if (back) back->invert();
    std::swap(front, back);
  }

  std::vector<Polygon> clip_polygons(std::vector<Polygon> list) const {
    if (!plane.ok) return list;
    std::vector<Polygon> f, b;
    for (auto& p : list) {
      split_polygon(plane, std::move(p), f, b, f, b);
    }
    if (front) f = front->clip_polygons(std::move(f));
    if (back) b = back->clip_polygons(std::move(b));
    else b.clear();  // no back child: back half-space is inside the solid
    f.insert(f.end(), std::make_move_iterator(b.begin()),
             std::make_move_iterator(b.end()));
    return f;
  }

  void build(std::vector<Polygon> list) {
    if (list.empty()) return;
    if (!plane.ok) {
      // pick a splitting plane with some balance heuristics: sample a
      // few candidates, choose fewest spans (cheap median-ish choice
      // keeps depth sane on CAD meshes with many coplanar triangles)
      size_t best = 0;
      long best_cost = -1;
      size_t step = list.size() / 8 + 1;
      for (size_t c = 0; c < list.size(); c += step) {
        if (!list[c].plane.ok) continue;
        long spans = 0, fr = 0, bk = 0;
        for (size_t i = 0; i < list.size(); i += step) {
          int type = 0;
          for (const auto& v : list[i].v) {
            double t = list[c].plane.n.dot(v) - list[c].plane.w;
            type |= (t < -EPS) ? BACK : (t > EPS) ? FRONT : COPLANAR;
          }
          if (type == SPANNING) ++spans;
          else if (type == FRONT) ++fr;
          else if (type == BACK) ++bk;
        }
        long cost = spans * 4 + std::labs(fr - bk);
        if (best_cost < 0 || cost < best_cost) {
          best_cost = cost;
          best = c;
        }
      }
      plane = list[best].plane;
      if (!plane.ok) {
        for (auto& p : list)
          if (p.plane.ok) { plane = p.plane; break; }
        if (!plane.ok) return;
      }
    }
    std::vector<Polygon> co, f, b;
    for (auto& p : list) {
      split_polygon(plane, std::move(p), co, co, f, b);
    }
    if (!f.empty()) {
      if (!front) front = std::make_unique<Node>();
      front->build(std::move(f));
    }
    if (!b.empty()) {
      if (!back) back = std::make_unique<Node>();
      back->build(std::move(b));
    }
  }
};

struct AABB {
  Vec lo{1e300, 1e300, 1e300}, hi{-1e300, -1e300, -1e300};
  void add(const Vec& v) {
    lo.x = std::min(lo.x, v.x); lo.y = std::min(lo.y, v.y);
    lo.z = std::min(lo.z, v.z);
    hi.x = std::max(hi.x, v.x); hi.y = std::max(hi.y, v.y);
    hi.z = std::max(hi.z, v.z);
  }
  bool overlaps(const AABB& o, double eps) const {
    return lo.x <= o.hi.x + eps && hi.x >= o.lo.x - eps &&
           lo.y <= o.hi.y + eps && hi.y >= o.lo.y - eps &&
           lo.z <= o.hi.z + eps && hi.z >= o.lo.z - eps;
  }
};

std::vector<Polygon> mesh_to_polys(const double* verts, const int32_t* tris,
                                   int64_t n_tris, const int32_t* face_id,
                                   int owner, AABB& box) {
  std::vector<Polygon> out;
  out.reserve(n_tris);
  for (int64_t t = 0; t < n_tris; ++t) {
    Polygon p;
    for (int k = 0; k < 3; ++k) {
      const double* v = verts + 3 * tris[3 * t + k];
      p.v.push_back({v[0], v[1], v[2]});
      box.add(p.v.back());
    }
    p.plane = Plane::from_points(p.v[0], p.v[1], p.v[2]);
    if (!p.plane.ok) continue;  // degenerate input triangle
    p.face_id = face_id ? face_id[t] : 0;
    p.owner = owner;
    out.push_back(std::move(p));
  }
  return out;
}

// Partition into (near = AABB overlaps other box, far = disjoint).
void partition_near(std::vector<Polygon>& polys, const AABB& other,
                    double eps, std::vector<Polygon>& near_out,
                    std::vector<Polygon>& far_out) {
  for (auto& p : polys) {
    AABB pb;
    for (const auto& v : p.v) pb.add(v);
    (pb.overlaps(other, eps) ? near_out : far_out).push_back(std::move(p));
  }
  polys.clear();
}

struct Result {
  std::vector<double> verts;
  std::vector<int32_t> tris;
  std::vector<int32_t> face_id;
  std::vector<int32_t> owner;
};

void polys_to_mesh(const std::vector<Polygon>& polys, Result& r) {
  for (const auto& p : polys) {
    if (p.v.size() < 3) continue;
    int32_t base = (int32_t)(r.verts.size() / 3);
    for (const auto& v : p.v) {
      r.verts.push_back(v.x);
      r.verts.push_back(v.y);
      r.verts.push_back(v.z);
    }
    for (size_t k = 1; k + 1 < p.v.size(); ++k) {
      r.tris.push_back(base);
      r.tris.push_back(base + (int32_t)k);
      r.tris.push_back(base + (int32_t)k + 1);
      r.face_id.push_back(p.face_id);
      r.owner.push_back(p.owner);
    }
  }
}

void append(std::vector<Polygon>& dst, std::vector<Polygon>&& src) {
  dst.insert(dst.end(), std::make_move_iterator(src.begin()),
             std::make_move_iterator(src.end()));
}

}  // namespace

extern "C" {

// op: 0=union(A|B) 1=subtract(A-B) 2=intersect(A&B)
// Outputs malloc'd; caller frees with crt_csg_free. Returns #tris or -1.
int64_t crt_csg(int32_t op,
                const double* va, int64_t nva, const int32_t* ta,
                int64_t nta, const int32_t* fa,
                const double* vb, int64_t nvb, const int32_t* tb,
                int64_t ntb, const int32_t* fb,
                double** out_verts, int64_t* out_nv,
                int32_t** out_tris, int32_t** out_face,
                int32_t** out_owner) {
  (void)nva; (void)nvb;
  AABB boxa, boxb;
  auto pa = mesh_to_polys(va, ta, nta, fa, 0, boxa);
  auto pb = mesh_to_polys(vb, tb, ntb, fb, 1, boxb);
  if (pa.empty() || pb.empty()) return -1;
  double diag = std::max({boxa.hi.x - boxa.lo.x, boxa.hi.y - boxa.lo.y,
                          boxa.hi.z - boxa.lo.z, boxb.hi.x - boxb.lo.x,
                          boxb.hi.y - boxb.lo.y, boxb.hi.z - boxb.lo.z});
  double eps = 1e-6 * diag + 1e-12;

  std::vector<Polygon> pa_near, pa_far, pb_near, pb_far;
  partition_near(pa, boxb, eps, pa_near, pa_far);
  partition_near(pb, boxa, eps, pb_near, pb_far);

  // classification trees over the FULL operands (solidity needs every
  // face); only the near lists are clipped through them.
  Node ta_tree, tb_tree;
  {
    std::vector<Polygon> ca = pa_near;
    append(ca, std::vector<Polygon>(pa_far));
    ta_tree.build(std::move(ca));
    std::vector<Polygon> cb = pb_near;
    append(cb, std::vector<Polygon>(pb_far));
    tb_tree.build(std::move(cb));
  }

  std::vector<Polygon> out;
  if (op == 0) {
    // union: A outside B + B outside A (clip flipped-B once more through
    // A to drop opposite-coplanar duplicates, as csg.js does)
    append(out, tb_tree.clip_polygons(std::move(pa_near)));
    append(out, std::move(pa_far));
    auto b1 = ta_tree.clip_polygons(std::move(pb_near));
    flip_all(b1);
    b1 = ta_tree.clip_polygons(std::move(b1));
    flip_all(b1);
    append(out, std::move(b1));
    append(out, std::move(pb_far));
  } else if (op == 1) {
    // subtract: flip(clip_B(flip(A_near))) + A_far
    //         + clip_Ainv(flip(clip_Ainv(B_near)))   (cavity walls,
    //           already inward-facing after the inner flip)
    ta_tree.invert();
    flip_all(pa_near);
    auto a1 = tb_tree.clip_polygons(std::move(pa_near));
    flip_all(a1);
    auto b1 = ta_tree.clip_polygons(std::move(pb_near));
    flip_all(b1);
    auto b2 = ta_tree.clip_polygons(std::move(b1));
    append(out, std::move(a1));
    append(out, std::move(b2));
    append(out, std::move(pa_far));
    // pb_far is outside A: dropped for subtract
  } else {
    // intersect: flip(clip_Binv(flip(A_near)) + clip_Ainv(B_near) twice)
    ta_tree.invert();
    tb_tree.invert();
    auto b1 = ta_tree.clip_polygons(std::move(pb_near));
    flip_all(b1);
    flip_all(pa_near);
    auto a1 = tb_tree.clip_polygons(std::move(pa_near));
    auto b2 = ta_tree.clip_polygons(std::move(b1));
    append(a1, std::move(b2));
    flip_all(a1);
    append(out, std::move(a1));
    // far polys of both operands are outside the intersection: dropped
  }

  Result r;
  polys_to_mesh(out, r);

  *out_nv = (int64_t)(r.verts.size() / 3);
  *out_verts = (double*)std::malloc(
      std::max<size_t>(r.verts.size(), 1) * sizeof(double));
  std::memcpy(*out_verts, r.verts.data(), r.verts.size() * sizeof(double));
  int64_t n_tris = (int64_t)(r.tris.size() / 3);
  *out_tris = (int32_t*)std::malloc(
      std::max<size_t>(r.tris.size(), 1) * sizeof(int32_t));
  std::memcpy(*out_tris, r.tris.data(), r.tris.size() * sizeof(int32_t));
  *out_face = (int32_t*)std::malloc(
      std::max<size_t>(r.face_id.size(), 1) * sizeof(int32_t));
  std::memcpy(*out_face, r.face_id.data(),
              r.face_id.size() * sizeof(int32_t));
  *out_owner = (int32_t*)std::malloc(
      std::max<size_t>(r.owner.size(), 1) * sizeof(int32_t));
  std::memcpy(*out_owner, r.owner.data(), r.owner.size() * sizeof(int32_t));
  return n_tris;
}

void crt_csg_free(void* p) { std::free(p); }

// Ear-clip triangulation of a (weakly) simple CCW polygon — the exact
// algorithm and tolerances of modeling/triangulate.py's python loop,
// ported because the interpreter version measured 33 s on Shape.tcl's
// 1,074 contour faces. verts: (n, 2) float64; out: (n-2, 3) int32
// preallocated by the caller. Returns #tris (or -1 on bad input).
int64_t crt_ear_clip(const double* verts, int64_t n, int32_t* out) {
  if (n < 3) return 0;
  std::vector<int32_t> idx(n);
  for (int64_t i = 0; i < n; ++i) idx[i] = (int32_t)i;
  auto X = [&](int32_t i) { return verts[2 * i]; };
  auto Y = [&](int32_t i) { return verts[2 * i + 1]; };
  auto point_in_tri = [&](int32_t p, int32_t a, int32_t b, int32_t c) {
    // _point_in_triangle(..., eps=-1e-12): strict interior only
    const double E = 1e-12;
    double d1 = (X(b) - X(a)) * (Y(p) - Y(a)) - (Y(b) - Y(a)) * (X(p) - X(a));
    double d2 = (X(c) - X(b)) * (Y(p) - Y(b)) - (Y(c) - Y(b)) * (X(p) - X(b));
    double d3 = (X(a) - X(c)) * (Y(p) - Y(c)) - (Y(a) - Y(c)) * (X(p) - X(c));
    bool has_neg = (d1 < E) || (d2 < E) || (d3 < E);
    bool has_pos = (d1 > -E) || (d2 > -E) || (d3 > -E);
    return !(has_neg && has_pos);
  };
  int64_t nt = 0;
  int64_t guard = 0, guard_max = 4 * n * n;
  while ((int64_t)idx.size() > 3 && guard < guard_max) {
    ++guard;
    bool found = false;
    int64_t m = (int64_t)idx.size();
    for (int64_t k = 0; k < m; ++k) {
      int32_t i0 = idx[(k - 1 + m) % m], i1 = idx[k], i2 = idx[(k + 1) % m];
      double cross = (X(i1) - X(i0)) * (Y(i2) - Y(i0))
                   - (Y(i1) - Y(i0)) * (X(i2) - X(i0));
      if (cross <= 1e-14) continue;
      bool ear = true;
      for (int32_t j : idx) {
        if (j == i0 || j == i1 || j == i2) continue;
        if (point_in_tri(j, i0, i1, i2)) { ear = false; break; }
      }
      if (ear) {
        out[3 * nt] = i0; out[3 * nt + 1] = i1; out[3 * nt + 2] = i2; ++nt;
        idx.erase(idx.begin() + k);
        found = true;
        break;
      }
    }
    if (!found) {
      // numeric degeneracy: clip the least-reflex corner and go on
      int64_t best_k = 0;
      double best_cross = -1e300;
      m = (int64_t)idx.size();
      for (int64_t k = 0; k < m; ++k) {
        int32_t i0 = idx[(k - 1 + m) % m], i1 = idx[k], i2 = idx[(k + 1) % m];
        double cross = (X(i1) - X(i0)) * (Y(i2) - Y(i0))
                     - (Y(i1) - Y(i0)) * (X(i2) - X(i0));
        if (cross > best_cross) { best_cross = cross; best_k = k; }
      }
      int64_t k = best_k;
      m = (int64_t)idx.size();
      out[3 * nt] = idx[(k - 1 + m) % m];
      out[3 * nt + 1] = idx[k];
      out[3 * nt + 2] = idx[(k + 1) % m];
      ++nt;
      idx.erase(idx.begin() + k);
    }
  }
  if (idx.size() == 3) {
    out[3 * nt] = idx[0]; out[3 * nt + 1] = idx[1]; out[3 * nt + 2] = idx[2];
    ++nt;
  }
  return nt;
}

}  // extern "C"
